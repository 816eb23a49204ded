"""The whole-stack decode kernels' weight ring, on the CPU.

``ops/decode_layer.py::stage_plan`` sizes the ring of shared-memory
stages into which each block of ``csrc/decode_layer.cu`` stages its
weight slices by TMA, and ``block_slices`` mirrors the order in which a
block reads (and its ring stages) them. The kernel runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``); here the plan's
promises are held at the two served models' full widths (GPT-2 124M,
llama-124m), both weight types and every batch the kernel takes: the
block's shared memory within the card's and two blocks to an SM, at
least one slice of lookahead (every int8 batch, bf16 up to 8 rows), and
the slice sequences of the grid covering every (tile, split) task of
every weight phase exactly once a layer. The Python constants are held
to the kernel source's.
"""

import os
import re

import pytest

from llm_sharding_demo_tpu_torch.ops import cuda_build
from llm_sharding_demo_tpu_torch.ops import decode_layer as DL
from llm_sharding_demo_tpu_torch.tools import megakernel_sweep as MS

# (d, kv_width, inter, llama) of the served models
MODELS = {"gpt2": (768, 768, 3072, False), "llama": (768, 256, 2048, True)}
# what one block may hold on an H100 (227 KB)
BLOCK_SHARED_MAX = 232448


def _lookahead_ok(seq, quantized, stages):
    """Whether every slice and the one after it are in the ring together
    (each slice's boxes counted as the kernel stages them)."""
    boxes = [DL.slice_boxes(quantized, ph) for _, ph, _, _ in seq]
    return all(a + b <= stages for a, b in zip(boxes, boxes[1:]))


@pytest.mark.parametrize("batch", range(1, DL.MAX_BATCH + 1))
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "bf16"])
@pytest.mark.parametrize("family", sorted(MODELS))
def test_stage_plan_fits_two_blocks_and_looks_ahead(family, quantized,
                                                    batch):
    d, kvw, inter, llama = MODELS[family]
    stages, stage_bytes, smem = DL.stage_plan(quantized, batch, d, kvw,
                                              inter, llama)
    assert stage_bytes == DL.STAGE_BYTES
    assert smem == DL.RING_ALIGN + stages * stage_bytes + batch * d * 2
    per_block = DL.static_smem_bytes(llama) + smem
    assert per_block <= BLOCK_SHARED_MAX
    assert DL.BLOCKS_PER_SM * (per_block + DL.BLOCK_RESERVED_BYTES) \
        <= DL.SM_SHARED_BYTES
    # the largest slice fits; one stage more would not
    assert max(DL.slice_boxes(quantized, ph) for ph in range(4)) <= stages
    assert stages == DL.MAX_STAGES or DL.BLOCKS_PER_SM * (
        per_block + stage_bytes + DL.BLOCK_RESERVED_BYTES) > DL.SM_SHARED_BYTES
    # one slice of lookahead for every block of the grid, across the
    # layer boundary
    if quantized or batch <= 8:
        for block in range(DL.GRID):
            seq = DL.block_slices(block, DL.GRID, 2, d, kvw, inter, llama)
            assert _lookahead_ok(seq, quantized, stages), block


@pytest.mark.parametrize("grid", [DL.GRID, 100, 7])
@pytest.mark.parametrize("family", sorted(MODELS))
def test_block_slices_cover_every_task_once_a_layer(family, grid):
    """Over the grid's blocks, every (tile, split) of every weight phase
    of every layer comes exactly once, each block's in layer order, then
    phase order, then task order; a grid smaller than a phase's tasks
    gives blocks several."""
    d, kvw, inter, llama = MODELS[family]
    n_layer = 3
    seen = {}
    for block in range(grid):
        seq = DL.block_slices(block, grid, n_layer, d, kvw, inter, llama)
        keys = [(layer, ph, split * DL.phase_tiles(ph, d, kvw, inter,
                                                   llama)[0] + tile)
                for layer, ph, tile, split in seq]
        assert keys == sorted(keys)
        for layer, ph, tile, split in seq:
            key = (layer, ph, tile, split)
            assert key not in seen, key
            seen[key] = block
    for layer in range(n_layer):
        for ph in range(4):
            tiles, splits = DL.phase_tiles(ph, d, kvw, inter, llama)
            got = {(t, s) for (li, p, t, s) in seen if (li, p) == (layer, ph)}
            assert got == {(t, s) for t in range(tiles)
                           for s in range(splits)}


def test_served_phase_tasks():
    """The tasks of each weight phase (QKV, OUT, FC, PROJ) at the served
    widths: at most one a block on the 264-block grid."""
    tasks = {f: [a * b for a, b in (DL.phase_tiles(ph, *MODELS[f])
                                    for ph in range(4))] for f in MODELS}
    assert tasks == {"gpt2": [216, 144, 144, 144],
                     "llama": [120, 144, 192, 96]}
    assert max(max(t) for t in tasks.values()) <= DL.GRID


def test_stage_plan_refusals():
    with pytest.raises(ValueError, match="multiples"):
        DL.stage_plan(True, 1, 768, 200, 2048, True)
    with pytest.raises(ValueError, match="batch"):
        DL.stage_plan(True, 17, 768, 768, 3072, False)
    # a width whose activations leave no room for a bf16 slice's two
    # stages
    with pytest.raises(ValueError, match="slice takes 2"):
        DL.stage_plan(False, 16, 2048, 2048, 8192, False)


def test_constants_mirror_the_kernel_source():
    src = open(os.path.join(cuda_build.CSRC_DIR, "decode_layer.cu")).read()

    def const(name):
        (value,) = re.findall(rf"constexpr int {name} = (\d+);", src)
        return int(value)

    assert const("kStageBytes") == DL.STAGE_BYTES
    assert const("kMaxStages") == DL.MAX_STAGES
    assert const("kMaxLayerBoxes") == DL.MAX_LAYER_BOXES
    assert const("kRingAlign") == DL.RING_ALIGN
    assert const("kMaxBlocksPerSm") == DL.BLOCKS_PER_SM
    assert const("kThreads") == DL._THREADS
    assert const("kRowGroup") == DL._ROW_GROUP
    assert const("kTile") == DL._LANE
    assert [const(n) for n in ("kKcQkv", "kKcOut", "kKcFc", "kKcProj")] \
        == list(DL.PHASE_KC)
    assert re.search(r"kMaxG = 4;", src) and DL.LLAMA_MAX_G == 4


@pytest.mark.parametrize("variant", sorted(MS.VARIANTS))
def test_sweep_variants_edit_the_kernel_source(variant):
    """Every variant of ``tools/megakernel_sweep.py`` applies to the current
    source: each text it edits occurs there once."""
    src = open(cuda_build.DECODE_LAYER_LIB.source).read()
    for old, new in MS.VARIANTS[variant][1]:
        assert src.count(old) == 1, old
        assert new not in src or not new
