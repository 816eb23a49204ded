"""Per-phase device clock of the whole-stack decode kernels.

Builds ``csrc/decode_layer.cu`` a second time with
``-DDECODE_LAYERS_PHASE_CLOCK``, which stamps ``%globaltimer`` at every
grid barrier (the last block's arrival, block 0's release), and runs the
GPT-2 kernel at GPT-2 124M's full width (``--family gpt2``, the default)
or the llama kernel at llama-124m's (``--family llama``: 4 kv heads,
SwiGLU 2048, a 4096-slot cache), with seeded random weights and inputs
rotated over more than the 50 MB L2 so the weights stream from memory. For each of a
layer's seven phases, summed over the layers, it prints the work (the
previous barrier's release to the last block's arrival) and the barrier
(that arrival to the release), each the median over ``--reps`` launches,
and the clock's own total (block 0's start to the last block's end),
beside the device time per launch of the clock build and of the ordinary
build (``--reps`` launches replayed from a CUDA graph, CUDA events; on
the same inputs in the same run).

    python -m llm_sharding_demo_tpu_torch.tools.megakernel_phases
    python -m llm_sharding_demo_tpu_torch.tools.megakernel_phases --family llama

Needs a CUDA card and nvcc; the last line is a JSON object of the
readings.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys

PHASES = ("QKV", "ATT", "OUT", "RES1", "FC", "PROJ", "RES2")
CLOCK_LAYERS, CLOCK_PHASES = 48, 8     # csrc/decode_layer.cu kClock*
# (weights, layers, batch rows, cached positions) of each family
CASES = {
    "gpt2": (("int8", 12, 1, 255), ("int8", 12, 8, 255),
             ("int8", 12, 16, 255), ("int8", 12, 1, 1000),
             ("bf16", 12, 1, 255), ("int8", 11, 1, 255), ("int8", 1, 1, 255)),
    "llama": (("int8", 12, 1, 255), ("int8", 12, 1, 3000),
              ("int8", 12, 8, 255), ("bf16", 12, 1, 255),
              ("int8", 11, 1, 255), ("int8", 1, 1, 255)),
}


def phase_times(stamps, n_layer: int):
    """``(work, barrier)`` ns per phase, summed over the layers, from one
    launch's stamps (start, arrivals, releases)."""
    slots = CLOCK_LAYERS * CLOCK_PHASES
    start, arrive, release = stamps[0], stamps[1:1 + slots], stamps[1 + slots:]
    work, barrier = [0] * len(PHASES), [0] * len(PHASES)
    prev = start
    for li in range(n_layer):
        for k in range(len(PHASES)):
            a = arrive[li * CLOCK_PHASES + k]
            work[k] += a - prev
            if li == n_layer - 1 and k == len(PHASES) - 1:
                break        # the kernel's end: no barrier follows
            prev = release[li * CLOCK_PHASES + k]
            barrier[k] += prev - a
    return work, barrier


def graph_us(torch, launch, reps: int) -> float:
    """Device time per launch: ``reps`` launches captured in one CUDA
    graph, the median of five replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            launch(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            launch(i)
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    del graph
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--family", choices=sorted(CASES), default="gpt2")
    args = parser.parse_args(argv)
    reps, family = args.reps, args.family

    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    from ..models import gpt2, llama
    from ..ops import cuda_build as cb
    from ..ops import quant as Q
    from ..ops.decode_layer import decode_layers, decode_layers_llama
    from ..ops.rope import rope_angles

    clock = cb.KernelLibrary(
        "decode_layer.cu", dict(cb.DECODE_LAYER_LIB.functions,
                                decode_layers_phase_clock=(ctypes.c_void_p,)),
        cb.DECODE_LAYER_LIB.error_fn, defines=("DECODE_LAYERS_PHASE_CLOCK",))
    libs = (cb.DECODE_LAYER_LIB, clock)
    for lib, proc in [(lib, lib.start_build()) for lib in libs]:
        lib.finish_build(proc)
    so = clock.load()
    stamps = (ctypes.c_ulonglong * (1 + 2 * CLOCK_LAYERS * CLOCK_PHASES))()

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    is_llama = family == "llama"
    model = llama if is_llama else gpt2
    cfg = llama.CONFIGS["llama-124m"] if is_llama else gpt2.CONFIGS["gpt2"]
    kernel = cb.DECODE_LAYERS_LLAMA if is_llama else cb.DECODE_LAYERS
    n_kv = cfg.n_kv_head if is_llama else cfg.n_head
    eps = cfg.rms_norm_eps if is_llama else cfg.layer_norm_epsilon
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    rows = []
    for regime, n_layer, B, off in CASES[family]:
        sets = []
        per_set = 0
        while not sets or (len(sets) * per_set < 160 << 20 and len(sets) < 24):
            blocks = model.init_params(cfg, g)["blocks"]
            blocks = gpt2.map_params(lambda x: x[:n_layer], blocks)
            if regime == "int8":
                blocks = Q.quantize_params({"blocks": blocks})["blocks"]
            else:
                blocks = gpt2.map_params(lambda x: x.to(torch.bfloat16),
                                         blocks)
            per_set = sum(t.numel() * t.element_size()
                          for t in _tensors(blocks))
            sets.append((blocks, torch.randn(
                B, 1, cfg.n_embd, generator=g, device=dev).to(torch.bfloat16),
                torch.randn(n_layer, B, n_kv, cfg.n_positions, 128,
                            generator=g, device=dev).to(torch.bfloat16)))
        cos, sin = rope_angles(torch.full((B,), off, device=dev),
                               cfg.head_dim)

        def launch(i):
            s = sets[i % len(sets)]
            if is_llama:
                decode_layers_llama(s[0], s[1], s[2], off, cos, sin,
                                    n_head=cfg.n_head, eps=eps)
            else:
                decode_layers(s[0], s[1], s[2], off, n_head=cfg.n_head,
                              eps=eps)

        us = {}
        works, barriers, totals = [], [], []
        for lib in libs:
            kernel.library = lib
            try:
                us[lib is clock] = graph_us(torch, launch, reps)
                if lib is clock:
                    so.decode_layers_phase_clock(ctypes.addressof(stamps))
                    for i in range(reps):
                        launch(i)
                        torch.cuda.synchronize()
                        code = so.decode_layers_phase_clock(
                            ctypes.addressof(stamps))
                        if code:
                            raise RuntimeError(f"phase clock read: {code}")
                        w, b = phase_times(list(stamps), n_layer)
                        works.append(w)
                        barriers.append(b)
                        totals.append(sum(w) + sum(b))
            finally:
                kernel.library = cb.DECODE_LAYER_LIB
        work = [statistics.median(w[k] for w in works) / 1e3
                for k in range(len(PHASES))]
        barrier = [statistics.median(b[k] for b in barriers) / 1e3
                   for k in range(len(PHASES))]
        n_barriers = 7 * n_layer - 1
        row = dict(family=family, weights=regime, layers=n_layer, B=B,
                   offset=off,
                   device_us=us[False], clock_build_device_us=us[True],
                   clock_total_us=statistics.median(totals) / 1e3,
                   work_us=dict(zip(PHASES, work)),
                   barrier_us=dict(zip(PHASES, barrier)),
                   us_per_barrier=sum(barrier) / n_barriers)
        rows.append(row)
        print(f"{family} {regime} {n_layer} layers B={B} offset={off}: device "
              f"{row['device_us']:.1f} us per launch (clock build "
              f"{row['clock_build_device_us']:.1f} us, its clock "
              f"{row['clock_total_us']:.1f} us); over the layers, work / "
              f"barrier us: " + ", ".join(
                  f"{p} {w:.1f}/{b:.1f}" for p, w, b in
                  zip(PHASES, work, barrier))
              + f"; all work {sum(work):.1f}, all {n_barriers} barriers "
              f"{sum(barrier):.1f} ({row['us_per_barrier']:.2f} each)",
              flush=True)
        del sets
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "reps": reps, "cases": rows}))
    return 0


def _tensors(tree):
    """Every tensor of a parameter tree (int8 codes and scales)."""
    from ..ops.quant import is_quantized
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif is_quantized(tree):
        yield from (tree.q, tree.scale)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
