"""The port's whole-stack decode (ops/decode_layer.py) against the JAX
package's megakernel, on the CPU.

Weights are drawn with numpy from a seed at the JAX test's scale
(tests/test_decode_layer.py: init std 0.02 times 4) and carried into both
packages; the geometry is the smallest eligible one (n_embd 128, two
heads of 64, a 512-slot cache for max_seq 300). On the CPU the kernel's
wrapper runs its plain version, ``decode_layers_plain``, which is held
here against JAX ``decode_layers(..., interpret=True)``, the Pallas kernel
itself; on the card ``chip_smoke.py`` and ``tests/test_torch_cuda.py``
hold the CUDA kernel against the same plain version.

Tolerances: fp32 weights 1e-5 (abs and rel): the two sides differ only in
summation order, online against full softmax and the order of each
product's sum. bf16 and int8 weights: four bf16 ulps of the largest
hidden value (2**-5 relative), a mean error under a quarter ulp, and the
RMS error per row under 2**-5 of what the stack added to its input
(``graftnum.STACK_POLICY``, the bound the card holds the CUDA kernel to;
here it reads about 0.7%): the JAX kernel runs gelu_new in bf16 arithmetic (a rounding per op) where the
port computes it in f32 and rounds once, and a reordered f32 sum may
round a bf16 activation the other way; one such ulp enters the residual
stream and grows through the layers. The cache: row
``offset`` of every (layer, b, head) within the same tolerance, every
other byte equal.

The llama megakernel's plain version, ``decode_layers_llama_plain``, is
held the same way, with the same tolerances, against JAX
``decode_layers_llama(..., interpret=True)`` (n_embd 256, 4 query heads
over 2 kv heads, SwiGLU 256, the tree of tests/test_torch_llama.py), both
fed the same rotary angles. The JAX side is compiled with XLA's
``xla_allow_excess_precision`` off (``jax_llama_kernel``): left on, XLA's
CPU compiler drops the bf16 roundings that the JAX kernel writes between
RMSNorm's normalize and scale and between SwiGLU's products (a mean error
of about 2**-8.7 of the largest value, past the quarter ulp above);
off, the two sides agree bit for bit at most inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.ops import quant as jquant
from llm_sharding_demo_tpu.ops.decode_layer import (
    decode_layers as jdecode_layers,
    decode_layers_llama as jdecode_layers_llama)
from llm_sharding_demo_tpu.ops.rope import rope_angles as jrope_angles
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.ops import decode_layer as DL
from llm_sharding_demo_tpu_torch.ops import quant
from llm_sharding_demo_tpu_torch.ops.cuda_build import launch_counts
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        resolve_decode_kernel)
from llm_sharding_demo_tpu_torch.utils import graftnum
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

DIMS = dict(vocab_size=211, n_positions=1024, n_embd=128, n_layer=2,
            n_head=2)
MAX_SEQ = 300
STD = 0.08          # the JAX test's init_params std 0.02, scaled by 4
RAGGED = [[5, 9, 2, 77, 30], [42, 3]]


def _trees(dims):
    tree = np_gpt2_params(seed=1, std=STD, dims=dims)
    return (jgpt2.GPT2Config(**dims), jax.tree.map(jnp.asarray, tree),
            gpt2.GPT2Config(**dims), params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def model():
    return _trees(DIMS)


@pytest.fixture(scope="module")
def model4():
    return _trees(dict(DIMS, n_layer=4))


def _blocks(jp, tp, regime):
    """The stacked blocks of both packages in one regime."""
    if regime == "float32":
        return jp["blocks"], tp["blocks"], np.float32, torch.float32
    if regime == "bfloat16":
        return (jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp["blocks"]),
                gpt2.map_params(lambda x: x.to(torch.bfloat16), tp["blocks"]),
                jnp.bfloat16, torch.bfloat16)
    return (jquant.quantize_params(jp, jnp.bfloat16)["blocks"],
            quant.quantize_params(tp, torch.bfloat16)["blocks"],
            jnp.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("offset", [0, 5, 255])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("regime", ["float32", "bfloat16", "int8"])
def test_plain_matches_jax_megakernel(model, regime, batch, offset, masked):
    _, jp, _, tp = model
    jb, tb, jdt, tdt = _blocks(jp, tp, regime)
    rng = np.random.default_rng(100 * batch + offset)
    h = rng.standard_normal((batch, 1, 128)).astype(np.float32)
    KV = rng.standard_normal((2, batch, 2, 512, 128)).astype(np.float32)
    vf = (np.asarray([0, 3, offset // 2][:batch], np.int32) if masked
          else None)
    want_h, want_kv = jdecode_layers(
        jb, jnp.asarray(h, jdt), jnp.asarray(KV, jdt), offset,
        None if vf is None else jnp.asarray(vf), n_head=2, eps=1e-5,
        interpret=True)
    tKV = torch.tensor(KV).to(tdt)
    before = launch_counts()["decode_layers"]
    got_h, got_kv = DL.decode_layers(
        tb, torch.tensor(h).to(tdt), tKV, offset,
        None if vf is None else torch.tensor(vf), n_head=2, eps=1e-5)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert launch_counts()["decode_layers"] == before
    assert got_kv is tKV and got_h.dtype == tdt
    want_h = np.asarray(want_h.astype(jnp.float32))
    want_kv = np.asarray(want_kv.astype(jnp.float32))
    got_h, got_kv = got_h.float().numpy(), got_kv.float().numpy()
    if regime == "float32":
        tol = dict(atol=1e-5, rtol=1e-5)
    else:
        tol = dict(atol=2.0 ** -5 * np.abs(want_h).max(), rtol=0)
        assert np.abs(got_h - want_h).mean() <= 2.0 ** -9 * np.abs(
            want_h).max()
        graftnum.compare_stack(torch.tensor(got_h), torch.tensor(want_h),
                               torch.tensor(h).to(tdt))
    np.testing.assert_allclose(got_h, want_h, **tol)
    np.testing.assert_allclose(got_kv[:, :, :, offset],
                               want_kv[:, :, :, offset], **tol)
    assert np.array_equal(np.delete(got_kv, offset, axis=3),
                          np.delete(want_kv, offset, axis=3))


@pytest.mark.parametrize("offset", [5, 255])
@pytest.mark.parametrize("regime", ["bfloat16", "int8"])
def test_stack_check_rejects_a_dropped_mask(model, regime, offset):
    """The stack budget rejects an attention fault: the plain version run
    without its rows' pad masks (half and all of the cached positions),
    against the JAX kernel run with them."""
    _, jp, _, tp = model
    jb, tb, jdt, tdt = _blocks(jp, tp, regime)
    rng = np.random.default_rng(offset)
    h = rng.standard_normal((3, 1, 128)).astype(np.float32)
    KV = rng.standard_normal((2, 3, 2, 512, 128)).astype(np.float32)
    vf = np.asarray([0, offset // 2, offset], np.int32)
    want_h, _ = jdecode_layers(jb, jnp.asarray(h, jdt), jnp.asarray(KV, jdt),
                               offset, jnp.asarray(vf), n_head=2, eps=1e-5,
                               interpret=True)
    want_h = torch.tensor(np.asarray(want_h.astype(jnp.float32)))
    th = torch.tensor(h).to(tdt)
    masked, _ = DL.decode_layers(tb, th, torch.tensor(KV).to(tdt), offset,
                                 torch.tensor(vf), n_head=2, eps=1e-5)
    bad, _ = DL.decode_layers(tb, th, torch.tensor(KV).to(tdt), offset,
                              None, n_head=2, eps=1e-5)
    graftnum.compare_stack(masked, want_h, th)
    with pytest.raises(graftnum.GraftnumError) as e:
        graftnum.compare_stack(bad, want_h, th)
    assert e.value.report["rel_rms_err"] > 2 * graftnum.STACK_POLICY[
        "rel_rms"]


@pytest.fixture(scope="module")
def jax_mega_streams(model, model4):
    """The JAX engine's megakernel streams ("interpret" resolves to
    "mega-interpret" there), fp32."""
    jcfg, jp, _, _ = model
    eng = jengine.DecodeEngine(jp, jcfg, max_seq=MAX_SEQ,
                               decode_kernel="interpret")
    assert eng._decode_kernel == "mega-interpret"
    jcfg4, jp4, _, _ = model4
    staged = jengine.DecodeEngine(jp4, jcfg4, max_seq=MAX_SEQ,
                                  boundaries=[1, 3],
                                  decode_kernel="interpret")
    assert staged._decode_kernel == "mega-interpret"
    return {
        "solo": eng.generate(np.asarray([RAGGED[0]]), 40).tokens,
        "ragged": eng.generate(RAGGED, 24).tokens,
        "one_token": eng.generate(np.asarray([[7]]), 12).tokens,
        "staged": staged.generate(np.asarray([RAGGED[0]]), 24).tokens,
        "staged_ragged": staged.generate([[5, 9, 2], [42]], 16).tokens,
    }


@pytest.mark.parametrize("case", ["solo", "ragged", "one_token", "staged",
                                  "staged_ragged"])
def test_fp32_mega_streams_equal_jax_megakernel(model, model4,
                                                jax_mega_streams, case):
    """fp32 greedy streams of the port's "mega" engine (the plain
    megakernel on the CPU) are byte-equal to the JAX mega-interpret
    engine's: solo, a ragged batch, a 1-token prompt (its prefill at
    depth 0 runs the megakernel too) and a staged engine (one launch per
    stage)."""
    _, _, cfg, tp = model4 if case.startswith("staged") else model
    eng = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, decode_kernel="mega",
                       boundaries=[1, 3] if case.startswith("staged")
                       else None, device="cpu")
    assert eng.decode_kernel_mode == "mega"
    prompt, n = {"solo": (np.asarray([RAGGED[0]]), 40),
                 "ragged": (RAGGED, 24), "one_token": (np.asarray([[7]]), 12),
                 "staged": (np.asarray([RAGGED[0]]), 24),
                 "staged_ragged": ([[5, 9, 2], [42]], 16)}[case]
    assert np.array_equal(eng.generate(prompt, n).tokens,
                          jax_mega_streams[case])


def test_mega_route_runs_the_whole_stack_once_per_step(model, monkeypatch):
    """A mega engine's decode step calls decode_layers once (per stage),
    with the stacked blocks as views of the engine's tensors; a 1-token
    prompt's prefill takes it too, a longer prompt does not."""
    _, _, cfg, tp = model
    calls = []
    real = gpt2.decode_layers

    def spy(blocks, h, KV, offset, *a, **k):
        calls.append((offset, h.shape[0],
                      blocks["attn"]["c_attn"]["kernel"].data_ptr()))
        return real(blocks, h, KV, offset, *a, **k)

    monkeypatch.setattr(gpt2, "decode_layers", spy)
    eng = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, decode_kernel="mega",
                       device="cpu")
    eng.generate(np.asarray([RAGGED[0]]), 4)
    stacked = eng.params["stacked_blocks"]["attn"]["c_attn"]["kernel"]
    assert calls == [(o, 1, stacked.data_ptr()) for o in (5, 6, 7)]
    calls.clear()
    eng.generate(np.asarray([[7]]), 3)
    assert [c[0] for c in calls] == [0, 1, 2]
    staged = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, decode_kernel="mega",
                          boundaries=[1], device="cpu")
    calls.clear()
    staged.generate(np.asarray([RAGGED[0]]), 3)
    assert [c[0] for c in calls] == [5, 5, 6, 6]


def test_batch_past_max_batch_takes_the_per_layer_path(model, monkeypatch):
    """MAX_BATCH + 2 rows: the mega engine runs the per-layer route (no
    whole-stack call) and its greedy streams equal the plain engine's."""
    _, _, cfg, tp = model
    calls = []
    real = gpt2.decode_layers
    monkeypatch.setattr(gpt2, "decode_layers",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    rows = np.random.default_rng(3).integers(0, 211, (DL.MAX_BATCH + 2, 4))
    mega = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, decode_kernel="mega",
                        device="cpu")
    plain = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, decode_kernel="xla",
                         device="cpu")
    assert np.array_equal(mega.generate(rows, 6).tokens,
                          plain.generate(rows, 6).tokens)
    assert calls == []
    mega.generate(rows[:DL.MAX_BATCH], 2)
    assert calls == [1]


@pytest.mark.parametrize("regime", ["bfloat16", "int8"])
def test_auto_resolution_on_cuda(model, regime):
    """What "auto" picks on a card, decided without one: the megakernel
    for bf16/int8 at an eligible geometry (staged or not), the per-layer
    kernels where only they apply, the plain path for fp32."""
    _, _, cfg, _ = model
    assert resolve_decode_kernel("auto", cfg, MAX_SEQ, regime, True) == (
        "mega", 512)
    assert resolve_decode_kernel("layer", cfg, MAX_SEQ, regime, True) == (
        "layer", 512)
    assert resolve_decode_kernel("auto", cfg, MAX_SEQ, "float32", True) == (
        None, MAX_SEQ)
    assert resolve_decode_kernel("auto", cfg, MAX_SEQ, regime, False) == (
        None, MAX_SEQ)
    # n_embd 64, one head of 64: the per-layer kernel applies, the
    # megakernel (n_embd % 128) does not
    narrow = gpt2.GPT2Config(**dict(DIMS, n_embd=64, n_head=1))
    assert not DL.eligible(narrow, 512)
    assert resolve_decode_kernel("auto", narrow, MAX_SEQ, regime, True) == (
        "layer", 512)
    # head_dim 32: neither CUDA kernel; "auto" keeps the plain path
    hd32 = gpt2.GPT2Config(**dict(DIMS, n_head=4))
    assert resolve_decode_kernel("auto", hd32, MAX_SEQ, regime, True) == (
        None, MAX_SEQ)


def test_staged_engine_resolves_to_mega(model4):
    _, _, cfg, tp = model4
    eng = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, dtype="int8",
                       boundaries=[1, 3], decode_kernel="mega", device="cpu")
    assert eng.decode_kernel_mode == "mega"
    assert [c.k.shape[0] for c in eng._fresh_cache(1)] == [1, 2, 1]


def test_refusals(model):
    _, _, cfg, tp = model
    narrow = gpt2.GPT2Config(**dict(DIMS, n_embd=64, n_head=1))
    narrow_params = gpt2.init_params(narrow, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="megakernel is ineligible"):
        DecodeEngine(narrow_params, narrow, max_seq=MAX_SEQ,
                     decode_kernel="mega", device="cpu")
    with pytest.raises(ValueError, match="ineligible"):
        resolve_decode_kernel("mega", narrow, MAX_SEQ, "int8", True)
    with pytest.raises(ValueError, match="float32"):
        resolve_decode_kernel("mega", cfg, MAX_SEQ, "float32", True)
    with pytest.raises(ValueError, match="interpret"):
        DecodeEngine(tp, cfg, max_seq=MAX_SEQ, decode_kernel="mega-interpret",
                     device="cpu")
    with pytest.raises(ValueError, match="single-token"):
        DL.decode_layers(tp["blocks"], torch.zeros(1, 2, 128),
                         torch.zeros(2, 1, 2, 512, 128), 0, n_head=2,
                         eps=1e-5)
    with pytest.raises(ValueError, match="offset"):
        DL.decode_layers(tp["blocks"], torch.zeros(1, 1, 128),
                         torch.zeros(2, 1, 2, 512, 128), 512, n_head=2,
                         eps=1e-5)


def test_phase_clock_splits_work_and_barriers():
    """The phase clock's reduction (tools/megakernel_phases.py): each
    phase's work runs from the previous barrier's release to the last
    block's arrival, its barrier from that arrival to the release; the
    last layer's closing phase has no barrier."""
    from llm_sharding_demo_tpu_torch.tools import megakernel_phases as MP
    slots = MP.CLOCK_LAYERS * MP.CLOCK_PHASES
    arrive, release = [0] * slots, [0] * slots
    t = 1000
    for li in range(2):
        for k in range(len(MP.PHASES)):
            t += 10 * (k + 1)              # work of phase k: 10 (k + 1)
            arrive[li * MP.CLOCK_PHASES + k] = t
            if li == 1 and k == len(MP.PHASES) - 1:
                break
            t += 3                         # every barrier: 3
            release[li * MP.CLOCK_PHASES + k] = t
    work, barrier = MP.phase_times([1000] + arrive + release, 2)
    assert work == [20 * (k + 1) for k in range(len(MP.PHASES))]
    assert barrier == [6] * (len(MP.PHASES) - 1) + [3]


# -- the llama megakernel ------------------------------------------------------

def jax_llama_kernel(jb, h, KV, offset, cos, sin, vf, jdt):
    """JAX ``decode_layers_llama(..., interpret=True)`` on numpy inputs,
    compiled with every bf16 rounding its source writes kept (XLA's
    ``xla_allow_excess_precision`` off). Returns ``(h, KV)`` as f32
    numpy arrays."""
    def run(jb, h, KV, cos, sin, vf):
        return jdecode_layers_llama(jb, h, KV, offset, cos, sin, vf, n_head=4,
                                    eps=1e-5, interpret=True)

    args = (jb, jnp.asarray(h, jdt), jnp.asarray(KV, jdt), jnp.asarray(cos),
            jnp.asarray(sin), None if vf is None else jnp.asarray(vf))
    compiled = jax.jit(run).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return tuple(np.asarray(t.astype(jnp.float32)) for t in compiled(*args))


def llama_case(batch, offset, masked, seed=None):
    """Inputs of one llama megakernel call at the llama test geometry
    (2 layers, 2 kv heads, a 512-slot cache): h, the fused cache, the
    pad starts and the step's angles [B, 64] (rows shifted by their pad,
    as the model computes them), as numpy arrays."""
    rng = np.random.default_rng(100 * batch + offset if seed is None
                                else seed)
    h = rng.standard_normal((batch, 1, 256)).astype(np.float32)
    KV = rng.standard_normal((2, batch, 2, 512, 128)).astype(np.float32)
    vf = np.asarray([0, 3, offset // 2][:batch], np.int32)
    pos = np.maximum(offset - (vf if masked else 0 * vf), 0)
    cos, sin = (np.asarray(t) for t in jrope_angles(jnp.asarray(pos), 64))
    return h, KV, vf, cos, sin


@pytest.fixture(scope="module")
def llama_model():
    from test_torch_llama import DIMS as LDIMS, _trees
    return _trees(LDIMS)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("offset", [0, 5, 255])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("regime", ["float32", "bfloat16", "int8"])
def test_llama_plain_matches_jax_megakernel(llama_model, regime, batch,
                                            offset, masked):
    from test_torch_llama import _llama_blocks
    if regime == "float32":
        _, jp, _, tp = llama_model
        jb, tb, jdt, tdt = jp["blocks"], tp["blocks"], np.float32, \
            torch.float32
    else:
        jb, tb, jdt, tdt = _llama_blocks(llama_model, regime)
    h, KV, vf, cos, sin = llama_case(batch, offset, masked)
    want_h, want_kv = jax_llama_kernel(jb, h, KV, offset, cos, sin,
                                       vf if masked else None, jdt)
    tKV = torch.tensor(KV).to(tdt)
    before = launch_counts()["decode_layers_llama"]
    got_h, got_kv = DL.decode_layers_llama(
        tb, torch.tensor(h).to(tdt), tKV, offset, torch.tensor(cos),
        torch.tensor(sin), torch.tensor(vf) if masked else None, n_head=4,
        eps=1e-5)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert launch_counts()["decode_layers_llama"] == before
    assert got_kv is tKV and got_h.dtype == tdt
    got_h, got_kv = got_h.float().numpy(), got_kv.float().numpy()
    if regime == "float32":
        tol = dict(atol=1e-5, rtol=1e-5)
    else:
        tol = dict(atol=2.0 ** -5 * np.abs(want_h).max(), rtol=0)
        assert np.abs(got_h - want_h).mean() <= 2.0 ** -9 * np.abs(
            want_h).max()
        graftnum.compare_stack(
            torch.tensor(got_h), torch.tensor(want_h),
            torch.tensor(h).to(tdt), torch.tensor(got_kv[:, :, :, offset]),
            torch.tensor(want_kv[:, :, :, offset]))
    np.testing.assert_allclose(got_h, want_h, **tol)
    row_tol = tol if regime == "float32" else dict(
        atol=2.0 ** -5 * np.abs(want_kv[:, :, :, offset]).max(), rtol=0)
    np.testing.assert_allclose(got_kv[:, :, :, offset],
                               want_kv[:, :, :, offset], **row_tol)
    assert np.array_equal(np.delete(got_kv, offset, axis=3),
                          np.delete(want_kv, offset, axis=3))


def test_llama_refusals(llama_model):
    _, _, cfg, tp = llama_model
    h, KV, vf, cos, sin = (torch.tensor(x) for x in llama_case(1, 5, False))
    with pytest.raises(ValueError, match="cos must be float32"):
        DL.decode_layers_llama(tp["blocks"], h, KV, 5, cos[:, :32], sin,
                               n_head=4, eps=1e-5)
    with pytest.raises(ValueError, match="kv heads"):
        DL.decode_layers_llama(tp["blocks"], h, KV, 5, cos, sin, n_head=3,
                               eps=1e-5)
    with pytest.raises(ValueError, match="offset"):
        DL.decode_layers_llama(tp["blocks"], h, KV, 512, cos, sin, n_head=4,
                               eps=1e-5)
