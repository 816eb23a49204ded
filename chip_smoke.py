#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root: ``python3 chip_smoke.py``. Phases, each of
which must pass or the script exits non-zero:

1. probe: the card's name, capability and power limit;
2. build: every CUDA kernel of ``llm_sharding_demo_tpu_torch/csrc``,
   one nvcc per source, all started together, with each kernel's
   registers, spills and shared memory; the SASS (``cuobjdump -sass``)
   of the bf16 flash forward and of bf16 dK/dV must hold wgmma (HGMMA)
   and TMA loads (UTMALDG) and no thread load from global memory (LDG),
   each printed with its dynamic shared memory;
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the shapes the served paths give it (GPT-2 124M and
   llama-124m: decode attention with one and with three query heads per
   kv head, the int8 linear at both models' projections and llama's
   untied head at rows 1..16, two launches bit-identical, each timed
   shape printed with its ``linear_plan`` (column tile, split, CTAs) and
   registers a thread, the int8 tied head at GPT-2's table at rows 1..16,
   bit-identical, timed at rows 1, 8 and 16 with its ``head_plan`` (CTAs,
   span) and registers, both whole-stack kernels; decode attention also at the
   edges of its cluster split, with rows masked past whole spans or
   entirely, B 1/8/16, two launches bit-identical), with each kernel's
   time beside its plain version's, one library call's (for a
   whole-stack kernel: the per-layer kernel path's) and the card's lower
   bound for the same work (decode attention's cluster size with each);
3b. flash: the three flash-attention kernels (forward, dQ, dK/dV)
   against their plain versions (bf16 and f32, B=1 and 4 at S=2048 and
   4096, a ragged S=333), bit-identical across launches, and timed at
   llama-124m's training shape beside their plain versions, SDPA (its
   backward captured in a CUDA graph and replayed, as the kernels are
   timed) and their bounds;
4. engine: GPT-2 124M and llama-124m at full width (12 layers, seeded
   random weights), bf16 and int8, the per-layer kernel path ("layer")
   and the whole-stack kernel path ("mega") each held against the plain
   path on the same card, teacher-forced, within the declared tolerance
   budgets, with their exact launch counts; decode time per token at
   batch 1 and 8, and one decode step's eager time beside the device's
   time for it (the step replayed from a CUDA graph), which gives the
   device's busy share of the eager step; a 17-row GPT-2 batch on the
   mega engine takes the per-layer kernels; a 2048-token prompt into a
   llama-124m engine with attention_impl="pallas" prefills through the
   flash forward (12 launches), within ``decode.bf16`` of the plain
   engine's logits;
5. server: ``python -m llm_sharding_demo_tpu_torch.serving`` with
   INFERENCE_DTYPE=int8, once with MODEL_ID=gpt2 and once with
   MODEL_ID=llama-124m MAX_SEQ=4096, answers /generate (greedy and
   seeded sampling, each twice, each pair equal; greedy equal to an
   in-process engine on the same weights), /healthz reports cuda and the
   whole-stack kernel, launched once per stage per decode step;
6. train: 5 llama-124m train steps (bf16, B=4, S=2048, remat, AdamW) on
   the flash kernels with exact launch counts (24 forwards, 12 dQ and 12
   dK/dV a step) and a falling loss, the same steps on the plain
   attention, step ms, tokens/s and peak memory for both; one f32 step
   of each path from the same weights, loss and gradients held together.

The last lines are the card's name and power limit, one JSON object with
the kernels' numbers (each kernel's launches counted on the path that
runs it: each server for its whole-stack kernel, the GPT-2 "layer" int8
engine run for the per-layer kernels, with the llama paths' counts
beside them, the 5 bf16 train steps for the flash kernels), and
``{"ok": true, "device": {...}}``. ``--phases`` runs a subset (the
default runs all).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s and dense
# operations/s by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# the served models: GPT-2 124M, and llama-124m (the same depth, width and
# query heads; 4 kv heads, SwiGLU 2048, an untied 32000-row head, RoPE up
# to 4096 positions)
L, H, HD, D, V, NPOS = 12, 12, 64, 768, 50257, 1024
HKV, INTER, LV, LNPOS = 4, 2048, 32000, 4096


class SmokeError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# -- timing -------------------------------------------------------------------

def time_ms(calls, reps: int = 7, rounds: int = 4):
    """``(device_ms, call_ms)`` per call, each the median of ``reps`` timed
    runs of ``rounds`` passes over ``calls`` (closures over distinct input
    sets, together larger than the 50 MB L2 where the inputs are large,
    so the weights stream from HBM as they do on the served path).

    ``device_ms`` replays the calls captured in one CUDA graph, so the
    launches run back to back and the time is the device's; ``call_ms``
    makes the calls from Python, host overhead included, as the eager
    engine makes them."""
    import torch

    def median_ms(run, n_calls):
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / n_calls)
        return statistics.median(times)

    def eager():
        for _ in range(rounds):
            for c in calls:
                c()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    device = median_ms(graph.replay, rounds * len(calls))
    call = median_ms(eager, rounds * len(calls))
    del graph
    return device, call


def timed(results_row: dict, key: str, calls) -> None:
    results_row[key], results_row["call_" + key] = time_ms(calls)


def bits(t):
    """A float tensor's bits, for exact comparisons."""
    import torch
    return t.view({torch.bfloat16: torch.int16,
                   torch.float32: torch.int32}.get(t.dtype, t.dtype))


def copies_for(nbytes: int, target: int = 160 << 20, cap: int = 64) -> int:
    return max(1, min(cap, -(-target // max(nbytes, 1))))


def bound_ms(nbytes: float, ops: float, op_type: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 3: kernels against their plain versions ---------------------------

def attention_masks(B, off, span, device):
    """``valid_from`` rows of the decode-attention cases: "odd" (odd rows
    masked over part of the cache), "spans" (rows masked past 0-3 whole
    spans of the kernel's cluster split, row 0 past two) and "all" (every
    cached position masked: the output is v_new to rounding)."""
    import torch
    odd = [(7 * b) % (off + 1) if b % 2 else 0 for b in range(B)]
    spans = [min(off, ((b + 2) % 4) * span + b % 3) for b in range(B)]
    return {k: torch.tensor(v, dtype=torch.int32, device=device)
            for k, v in (("odd", odd), ("spans", spans),
                         ("all", [off] * B))}


def check_attention(randn, KV, B, hkv, off, dtype, tol) -> float:
    """The decode-attention kernel against its plain version on one case
    (``H`` query heads over the cache's ``hkv`` kv heads) under each of
    ``attention_masks``: the output within ``tol``, the cache equal to
    the input but for the row written at ``off``, two launches
    bit-identical. Returns the max error."""
    import torch

    from llm_sharding_demo_tpu_torch.ops import decode_attention as DA

    q = randn(B, H, 1, HD, dtype=dtype)
    kn = randn(B, hkv, 1, HD, dtype=dtype)
    vn = randn(B, hkv, 1, HD, dtype=dtype)
    li = off % L
    c, span = DA.cluster_plan(off, B, hkv)
    want = KV.clone()
    want[li, :, :, off] = torch.cat([kn, vn], -1)[:, :, 0]
    what = (f"decode_attention {str(dtype)[6:]} B={B} g={H // hkv} "
            f"Smax={KV.shape[3]} off={off} C={c} span={span}")
    worst, line = 0.0, []
    for kind, vf in attention_masks(B, off, span, KV.device).items():
        kv_k, kv_p = KV.clone(), KV.clone()
        out_k, _ = DA.decode_attention(q, kn, vn, kv_k, li, off, vf)
        again, _ = DA.decode_attention(q, kn, vn, kv_k, li, off, vf)
        out_p, _ = DA.decode_attention_plain(q, kn, vn, kv_p, li, off, vf)
        torch.cuda.synchronize()
        err = (out_k.float() - out_p.float()).abs().max().item()
        check(torch.allclose(out_k.float(), out_p.float(), atol=tol,
                             rtol=tol), f"{what} mask {kind}: max err {err}")
        check(torch.equal(bits(out_k), bits(again)),
              f"{what} mask {kind}: two launches differ")
        check(torch.equal(bits(kv_k), bits(want)),
              f"{what} mask {kind}: the cache differs from the expected "
              f"in-place row write")
        worst = max(worst, err)
        line.append(f"{kind} {err:.1e}")
    print(f"  {what}  max_abs_err " + " ".join(line) + "  bit-identical  ok")
    return worst


def kernel_phase(results: dict) -> None:
    import torch

    from llm_sharding_demo_tpu_torch.ops import decode_attention as DA
    from llm_sharding_demo_tpu_torch.ops import quant as Q

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    # kernel 1: decode attention at the served shapes: GPT-2 (a kv head
    # per query head, 1024 slots) and llama (g = 3 query heads per kv
    # head, 4096 slots)
    # head and cache geometry, with offsets at the cluster split's edges
    # (one span of MIN_SPAN positions and one more, a second span, the
    # spans of C=16 at 3000 cached) and at the served depths
    attention_shapes = ((H, NPOS, (0, 1, 37, 63, 64, 65, 127, 128, 129, 255,
                                   256, 1000, 1023)),
                        (HKV, LNPOS, (0, 1, 63, 64, 65, 187, 188, 189, 255,
                                      256, 1000, 3000, 4095)))
    tol = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8, 16):
            for hkv, slots, offs in attention_shapes:
                KV = randn(L, B, hkv, slots, 2 * HD, dtype=dtype)
                for off in offs:
                    worst = max(worst, check_attention(
                        randn, KV, B, hkv, off, dtype, tol[dtype]))
                del KV

    def attention_timing(hkv, slots, off, B=1):
        """bf16: kernel, plain and SDPA device times and the bound."""
        dtype = torch.bfloat16
        n = copies_for(L * B * hkv * slots * 2 * HD * 2)
        sets = [(randn(B, H, 1, HD, dtype=dtype),
                 randn(B, hkv, 1, HD, dtype=dtype),
                 randn(B, hkv, 1, HD, dtype=dtype),
                 randn(L, B, hkv, slots, 2 * HD, dtype=dtype))
                for _ in range(n)]
        calls = [(lambda s=s, li=i % L: DA.decode_attention(
            s[0], s[1], s[2], s[3], li, off)) for i, s in enumerate(sets)]
        plain = [(lambda s=s, li=i % L: DA.decode_attention_plain(
            s[0], s[1], s[2], s[3], li, off)) for i, s in enumerate(sets)]

        def sdpa(s, li):
            kv = s[3][li, :, :, :off + 1]
            gqa = {} if hkv == H else {"enable_gqa": True}
            return torch.nn.functional.scaled_dot_product_attention(
                s[0], kv[..., :HD], kv[..., HD:], **gqa)
        lib = [(lambda s=s, li=i % L: sdpa(s, li))
               for i, s in enumerate(sets)]
        isz = 2
        nbytes = (B * H * HD * isz * 2             # q, out
                  + B * hkv * HD * isz * 2         # k_new, v_new
                  + B * hkv * off * 2 * HD * isz   # cached rows read
                  + B * hkv * 2 * HD * isz)        # the row written
        ops = 2 * 2 * B * H * (off + 1) * HD
        bms, by = bound_ms(nbytes, ops, "bfloat16")
        c, span = DA.cluster_plan(off, B, hkv)
        row = dict(shape=f"bf16 B={B} H={H} Hkv={hkv} hd={HD} Smax={slots} "
                   f"offset={off}", bound_ms=bms, bound_by=by, cluster=c,
                   span=span)
        timed(row, "ms", calls)
        timed(row, "plain_ms", plain)
        try:
            timed(row, "library_ms", lib)
        except TypeError:    # a PyTorch without SDPA's enable_gqa
            row["library_ms"] = row["call_library_ms"] = None
        return row

    results["decode_attention"] = dict(attention_timing(H, NPOS, 255),
                                       max_abs_err=worst)
    results["decode_attention"]["other_shapes"] = [
        attention_timing(HKV, LNPOS, off) for off in (255, 3000, 4095)] + [
        attention_timing(HKV, LNPOS, 3000, B=8)]

    # kernel 2: int8 block linear at rows 1..16 x GPT-2's four
    # projections and llama's new shapes (k/v, gate/up, down, the untied
    # head; its q and o are GPT-2's 768 -> 768), each at the plan
    # Q.linear_plan gives it; two launches bit-identical
    shapes = [(D, 3 * D), (D, D), (D, 4 * D), (4 * D, D)]
    llama_shapes = [(D, HKV * HD), (D, INTER), (INTER, D), (D, LV)]
    worst = 0.0
    for d, n_out in shapes + llama_shapes:
        qt = Q.quantize_array(randn(d, n_out) * 0.02, torch.bfloat16)
        shape_worst = 0.0
        for rows in range(1, Q.MAX_KERNEL_ROWS + 1):
            x = randn(rows, d, dtype=torch.bfloat16)
            y_k = Q.quant_linear(x, qt.q, qt.scale)
            again = Q.quant_linear(x, qt.q, qt.scale)
            y_p = Q.linear_plain(x, qt.q, qt.scale)
            torch.cuda.synchronize()
            err = (y_k.float() - y_p.float()).abs().max().item()
            # two bf16 ulps of the largest output: the f32 sums differ only
            # in order, then round once
            lim = 2.0 ** -7 * y_p.float().abs().max().item()
            check(err <= lim, f"quant_linear rows={rows} {d}->{n_out}: max "
                              f"err {err} > {lim}")
            check(torch.equal(bits(y_k), bits(again)),
                  f"quant_linear rows={rows} {d}->{n_out}: two launches "
                  f"differ")
            shape_worst = max(shape_worst, err / lim)
            worst = max(worst, err)
        bn, split = Q.linear_plan(1, d, n_out)
        print(f"  quant_linear {d}->{n_out} (bn={bn} split={split}) rows "
              f"1..16: worst max_abs_err {shape_worst:.3f} of its limit "
              f"(2^-7 of the largest output)  bit-identical  ok")

    def linear_timing(d, n_out, rows=1):
        sets = []
        for _ in range(copies_for(d * n_out)):
            qt = Q.quantize_array(randn(d, n_out) * 0.02, torch.bfloat16)
            sets.append((randn(rows, d, dtype=torch.bfloat16), qt.q, qt.scale,
                         Q.dequantize_array(qt, torch.bfloat16)))
        calls = [(lambda s=s: Q.quant_linear(s[0], s[1], s[2])) for s in sets]
        plain = [(lambda s=s: Q.linear_plain(s[0], s[1], s[2])) for s in sets]
        lib = [(lambda s=s: torch.matmul(s[0], s[3])) for s in sets]
        nbytes = rows * d * 2 + d * n_out + n_out * 2 + rows * n_out * 2
        bms, by = bound_ms(nbytes, 2 * rows * d * n_out, "bfloat16")
        bn, split = Q.linear_plan(rows, d, n_out)
        row = dict(shape=f"bf16 rows={rows} {d}->{n_out} int8", bound_ms=bms,
                   bound_by=by, bn=bn, split=split,
                   ctas=n_out // bn * split,
                   registers=linear_registers.get((bn, 1 if rows <= 8
                                                   else 2)))
        timed(row, "ms", calls)
        timed(row, "plain_ms", plain)
        timed(row, "library_ms", lib)
        return row

    # GPT-2's c_fc (the JSON row), then llama's untied head, on every
    # llama decode step, at 1 and 8 rows (the mega path at B=8), and the
    # projections whose output is 768 or 256 wide at one row
    linear_registers = quant_registers("quant_linear_kernel")
    row = results["quant_linear"] = dict(linear_timing(D, 4 * D),
                                         max_abs_err=worst)
    row["other_shapes"] = [linear_timing(D, LV), linear_timing(D, LV, rows=8),
                           linear_timing(4 * D, D), linear_timing(INTER, D),
                           linear_timing(D, HKV * HD)]
    # one layer's four projections at rows=1, as a decode step calls them
    layer_bytes = sum(d * n_out for d, n_out in shapes)
    sets = []
    for _ in range(copies_for(layer_bytes)):
        layer = []
        for d, n_out in shapes:
            qt = Q.quantize_array(randn(d, n_out) * 0.02, torch.bfloat16)
            layer.append((randn(1, d, dtype=torch.bfloat16), qt.q, qt.scale,
                          Q.dequantize_array(qt, torch.bfloat16)))
        sets.append(layer)
    row["layer_ms"], _ = time_ms([(lambda s=s: [
        Q.quant_linear(x, q, sc) for x, q, sc, _ in s]) for s in sets])
    row["layer_library_ms"], _ = time_ms([(lambda s=s: [
        torch.matmul(x, w) for x, _, _, w in s]) for s in sets])
    row["layer_bound_ms"], _ = bound_ms(
        sum(2 * d + d * n_out + 4 * n_out for d, n_out in shapes),
        sum(2 * d * n_out for d, n_out in shapes), "bfloat16")
    print(f"  quant_linear, one layer's four projections at rows=1 "
          f"({layer_bytes} weight bytes): device time kernel "
          f"{row['layer_ms']:.4f} ms, library {row['layer_library_ms']:.4f}"
          f" ms, bound {row['layer_bound_ms']:.4f} ms")
    del sets

    # kernel 3: int8 tied head at rows 1..16 x GPT-2's table (51200 x
    # 768), two launches bit-identical; timed at rows 1, 8 and 16 with its
    # head_plan (CTAs, the longest span of m16 tiles)
    v_pad = Q.round_up_vocab(V)
    qt = Q.quantize_params({"wte": randn(V, D) * 0.02})["wte"]
    worst = 0.0
    for rows in range(1, Q.MAX_KERNEL_ROWS + 1):
        x = randn(rows, D, dtype=torch.bfloat16)
        o_k = Q.quant_head(x, qt.q)
        again = Q.quant_head(x, qt.q)
        o_p = Q.head_plain(x, qt.q)
        torch.cuda.synchronize()
        err = (o_k - o_p).abs().max().item()
        check(torch.allclose(o_k, o_p, atol=1e-3, rtol=1e-5),
              f"quant_head rows={rows}: max err {err}")
        check(torch.equal(bits(o_k), bits(again)),
              f"quant_head rows={rows}: two launches differ")
        worst = max(worst, err)
    print(f"  quant_head {v_pad}x{D} rows 1..16: worst max_abs_err "
          f"{worst:.3e} (atol 1e-3, rtol 1e-5)  bit-identical  ok")
    del qt
    head_registers = quant_registers("quant_head_kernel")

    def head_timing(rows):
        sets = []
        for _ in range(copies_for(v_pad * D)):
            qt = Q.quantize_params({"wte": randn(V, D) * 0.02})["wte"]
            sets.append((randn(rows, D, dtype=torch.bfloat16), qt.q,
                         qt.q.to(torch.bfloat16)))
        calls = [(lambda s=s: Q.quant_head(s[0], s[1])) for s in sets]
        plain = [(lambda s=s: Q.head_plain(s[0], s[1])) for s in sets]
        lib = [(lambda s=s: torch.matmul(s[0], s[2].t())) for s in sets]
        nbytes = rows * D * 2 + v_pad * D + rows * v_pad * 4
        bms, by = bound_ms(nbytes, 2 * rows * D * v_pad, "bfloat16")
        ctas, span = Q.head_plan(rows, v_pad, D)
        row = dict(shape=f"bf16 rows={rows} {v_pad}x{D} int8", bound_ms=bms,
                   bound_by=by, ctas=ctas, tile_span=span,
                   registers=head_registers.get((1 if rows <= 8 else 2,)))
        timed(row, "ms", calls)
        timed(row, "plain_ms", plain)
        timed(row, "library_ms", lib)
        return row

    row = results["quant_head"] = dict(head_timing(1), max_abs_err=worst)
    row["other_shapes"] = [head_timing(8), head_timing(16)]
    for name, res in results.items():
        for r in [res] + res.get("other_shapes", []):
            print(f"  {name}: {r['shape']}: device time per call: kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{fmt_ms(r['library_ms'])} ms, bound {r['bound_ms']:.4f} "
                  f"ms ({r['bound_by']}); called from Python: kernel "
                  f"{r['call_ms']:.4f} ms, plain {r['call_plain_ms']:.4f} ms,"
                  f" library {fmt_ms(r['call_library_ms'])} ms"
                  + (f"; cluster C={r['cluster']} (span {r['span']})"
                     if "cluster" in r else "")
                  + (f"; plan bn={r['bn']} split={r['split']} CTAs="
                     f"{r['ctas']}, {r['registers']} registers a thread"
                     if "bn" in r else "")
                  + (f"; plan CTAs={r['ctas']} span {r['tile_span']} m16 "
                     f"tiles, {r['registers']} registers a thread"
                     if "tile_span" in r else ""))
    megakernel_phase(results, "gpt2")
    megakernel_phase(results, "llama")


def fmt_ms(ms) -> str:
    return "n/a" if ms is None else f"{ms:.4f}"


def megakernel_phase(results: dict, family: str) -> None:
    """A whole-stack kernel against its plain version at its model's full
    width (``family`` "gpt2": ``decode_layers`` at GPT-2 124M; "llama":
    ``decode_layers_llama`` at llama-124m, 4 kv heads, a 4096-slot cache):
    the 12-layer stack and the served stages (SPLIT_AT=1: the 1-layer
    first stage, where layer 0 is also the last, and the 11-layer second),
    bf16 and int8 weights, B 1/8/16, five or six offsets (llama's up to
    4095), odd rows masked over half or all of their cached positions.
    The hidden state and the written cache rows must meet
    ``graftnum.STACK_POLICY`` (four bf16 ulps of the largest value at
    most, and an RMS error per row under 2^-5 of what the stack added to
    its input), the cache must equal the input outside row ``offset``,
    and two launches on the same inputs must be bit-identical. Then the
    kernel's device time beside its bound, its plain version's and the
    per-layer kernel path's over the same stack."""
    import torch

    from llm_sharding_demo_tpu_torch.models import gpt2, llama
    from llm_sharding_demo_tpu_torch.ops import decode_layer as DL
    from llm_sharding_demo_tpu_torch.ops import quant as Q
    from llm_sharding_demo_tpu_torch.ops.attention import KVCache
    from llm_sharding_demo_tpu_torch.ops.rope import rope_angles
    from llm_sharding_demo_tpu_torch.utils import graftnum

    dev = torch.device("cuda")
    is_llama = family == "llama"
    g = torch.Generator(device=dev).manual_seed(4322 if is_llama else 4321)
    model = llama if is_llama else gpt2
    cfg = llama.CONFIGS["llama-124m"] if is_llama else gpt2.CONFIGS["gpt2"]
    hkv, npos = (HKV, LNPOS) if is_llama else (H, NPOS)
    offsets = ((0, 37, 255, 1000, 3000, 4095) if is_llama
               else (0, 37, 255, 256, 1000))
    name = "decode_layers_llama" if is_llama else "decode_layers"
    norms = ("ln_attn", "ln_mlp") if is_llama else ("ln_1", "ln_2")

    def weights(regime):
        p = model.init_params(cfg, g)["blocks"]
        # non-trivial norm scales and biases (init_params makes 1 and 0)
        for grp in norms:
            p[grp]["scale"] = p[grp]["scale"] + 0.1 * torch.randn(
                p[grp]["scale"].shape, generator=g, device=dev)
        for grp in ("attn", "mlp"):
            for lin in p[grp].values():
                if "bias" in lin:
                    lin["bias"] = 0.02 * torch.randn(
                        lin["bias"].shape, generator=g, device=dev)
        if regime == "int8":
            return Q.quantize_params({"blocks": p})["blocks"]
        return gpt2.map_params(lambda x: x.to(torch.bfloat16), p)

    def angles(B, off, vf):
        """The step's [B, 64] rotary angles, each row at its own position
        (its offset less its pad, as the model computes them)."""
        pos = off if vf is None else torch.clamp(off - vf.long(), min=0)
        cos, sin = rope_angles(torch.as_tensor(pos, device=dev)
                               .expand(B).contiguous(), HD)
        return cos, sin

    def call(fn, blocks, h, kv, off, vf, cs):
        """One stack call; ``cs`` the step's (cos, sin), for llama."""
        if is_llama:
            return fn(blocks, h, kv, off, *cs, vf, n_head=H, eps=1e-5)
        return fn(blocks, h, kv, off, vf, n_head=H, eps=1e-5)

    kernel_fn, plain_fn = ((DL.decode_layers_llama, DL.decode_layers_llama_plain)
                           if is_llama else
                           (DL.decode_layers, DL.decode_layers_plain))
    stacks = {"bf16": weights("bf16"), "int8": weights("int8")}
    worst, worst_rel = 0.0, 0.0
    for B in (1, 8, 16):
        KV = randn_bf16(g, L, B, hkv, npos, 2 * HD)
        for off in offsets:
            h = randn_bf16(g, B, 1, D)
            # rows 1, 5, 9, 13 see their second half of cached positions,
            # rows 3, 7, 11, 15 only the self term
            vf = torch.tensor([off * (b % 4 + 1) // 4 if b % 2 else 0
                               for b in range(B)], dtype=torch.int32,
                              device=dev)
            cs = angles(B, off, vf)
            for regime, full in stacks.items():
                for stack, layers in (("12-layer stack", slice(0, L)),
                                      ("1-layer stage", slice(0, 1)),
                                      ("11-layer stage", slice(1, L))):
                    blocks = gpt2.map_params(lambda x: x[layers], full)
                    cache = KV[layers]
                    ka, kb, kp = cache.clone(), cache.clone(), cache.clone()
                    out_a, _ = call(kernel_fn, blocks, h, ka, off, vf, cs)
                    out_b, _ = call(kernel_fn, blocks, h, kb, off, vf, cs)
                    out_p, _ = call(plain_fn, blocks, h, kp, off, vf, cs)
                    torch.cuda.synchronize()
                    what = f"{name} {regime} {stack} B={B} off={off}"
                    try:
                        rep = graftnum.compare_stack(
                            out_a, out_p, h, ka[:, :, :, off],
                            kp[:, :, :, off])
                    except graftnum.GraftnumError as e:
                        raise SmokeError(f"{what}: {e} ({e.report})")
                    check(torch.equal(bits(out_a), bits(out_b))
                          and torch.equal(bits(ka), bits(kb)),
                          f"{what}: two launches differ")
                    ka[:, :, :, off] = cache[:, :, :, off]
                    check(torch.equal(bits(ka), bits(cache)),
                          f"{what}: the cache changed outside row {off}")
                    worst = max(worst, rep["max_abs_err"])
                    worst_rel = max(worst_rel, rep["rel_rms_err"])
                    print(f"  {what}  max_abs_err={rep['max_abs_err']:.3e} "
                          f"(limit {rep['max_abs_limit']:.3e}) rel_rms_err="
                          f"{rep['rel_rms_err']:.3e} (limit "
                          f"{rep['rel_rms_limit']:.3e}) row_err="
                          f"{rep['row_err']:.3e} (limit "
                          f"{rep['row_limit']:.3e})  bit-identical  ok")
                    del ka, kb, kp
        del KV
    print(f"  {name}: worst max_abs_err {worst:.3e}, worst rel_rms_err "
          f"{worst_rel:.3e} over the cases above")
    # timing: B=1 at 255 cached positions, the 12-layer int8 stack first
    # (the JSON row), then the served stages, bf16, B=8 (and llama's long
    # context)
    cases = [("int8", slice(0, L), 1, 255), ("int8", slice(1, L), 1, 255),
             ("int8", slice(0, 1), 1, 255), ("bf16", slice(0, L), 1, 255),
             ("int8", slice(0, L), 8, 255)]
    if is_llama:
        cases.append(("int8", slice(0, L), 1, 3000))
    kvw, inter = hkv * HD, (INTER if is_llama else 4 * D)
    # multiply-adds per layer and row of the weight products
    macs = (2 * D * D + 2 * D * kvw + 3 * D * inter if is_llama
            else 12 * D * D)
    runs = []
    for regime, layers, B, off in cases:
        n_l = layers.stop - layers.start
        wbytes = weight_bytes(gpt2.map_params(lambda x: x[layers],
                                              stacks[regime]))
        sets = []
        for _ in range(copies_for(wbytes)):
            blocks = gpt2.map_params(lambda x: x[layers], weights(regime))
            sets.append((blocks, gpt2.unstack_blocks(blocks),
                         randn_bf16(g, B, 1, D),
                         randn_bf16(g, n_l, B, hkv, npos, 2 * HD)))
        empty = torch.zeros((0,), dtype=torch.bfloat16, device=dev)
        cs = angles(B, off, None)

        def layer_path(s):
            cache = KVCache(k=s[3], v=empty, length=off)
            if is_llama:
                return llama.apply_blocks(s[1], s[2], cfg, cs[0][:1],
                                          cs[1][:1], cache,
                                          decode_kernel="layer")
            return gpt2.apply_blocks(s[1], s[2], cfg, cache,
                                     decode_kernel="layer")
        kernel = [(lambda s=s: call(kernel_fn, s[0], s[2], s[3], off, None,
                                    cs)) for s in sets]
        plains = [(lambda s=s: call(plain_fn, s[0], s[2], s[3], off, None,
                                    cs)) for s in sets]
        per_layer = [(lambda s=s: layer_path(s)) for s in sets]
        nbytes = (wbytes + 2 * B * D * 2                  # weights, h in/out
                  + n_l * B * hkv * off * 2 * HD * 2      # cached rows read
                  + n_l * B * hkv * 2 * HD * 2            # the rows written
                  + (2 * B * HD * 4 if is_llama else 0))  # cos, sin
        ops = n_l * B * (2 * macs + 2 * 2 * H * (off + 1) * HD)
        bms, by = bound_ms(nbytes, ops, "bfloat16")
        row = dict(shape=f"{regime} weights, {n_l} layers, B={B} D={D} "
                   f"H={H} Hkv={hkv} hd={HD} Smax={npos} offset={off}",
                   bound_ms=bms, bound_by=by, weight_bytes=wbytes)
        timed(row, "ms", kernel)
        timed(row, "plain_ms", plains)
        timed(row, "layer_path_ms", per_layer)
        runs.append(row)
        print(f"  {name} {row['shape']}: device time per call: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, per-layer "
              f"kernel path {row['layer_path_ms']:.4f} ms, bound "
              f"{bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB); called from "
              f"Python: kernel {row['call_ms']:.4f} ms, plain "
              f"{row['call_plain_ms']:.4f} ms, per-layer path "
              f"{row['call_layer_path_ms']:.4f} ms")
        del sets
    results[name] = dict(runs[0], max_abs_err=worst, rel_rms_err=worst_rel,
                         library_ms=None, other_shapes=runs[1:])


def randn_bf16(g, *shape):
    import torch
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def weight_bytes(tree) -> int:
    """Bytes of every tensor of a parameter tree (int8 codes and scales
    included)."""
    from llm_sharding_demo_tpu_torch.ops.quant import is_quantized
    if isinstance(tree, dict):
        return sum(weight_bytes(v) for v in tree.values())
    if is_quantized(tree):
        return weight_bytes(tree.q) + weight_bytes(tree.scale)
    return tree.numel() * tree.element_size()


# -- phase 3b: the flash-attention kernels -------------------------------------

FLASH_BH = (4, 12)     # llama-124m training: batch 4, 12 query heads
FLASH_SEQ = 2048


def flash_bounds(B: int, S: int, dtype) -> dict:
    """Each flash kernel's bound at [B, 12, S, 64]: the bytes it must move
    (inputs read once, outputs written once) over the memory rate, and
    the multiply-adds of its products over the causal lower triangle
    (two per pair and product: QK^T and PV forward; QK^T, dO V^T and dS K
    for dQ; QK^T, P^T dO, dO V^T and dS^T Q for dK/dV) over the card's
    peak for the operand type (bf16 tensor cores, or f32 outside them)."""
    import torch
    bh, hd = B * H, HD
    isz = torch.empty((), dtype=dtype).element_size()
    mat = bh * S * hd * isz          # one [B, H, S, 64] tensor
    row = bh * S * 4                 # one f32 row statistic (lse, D)
    pairs = bh * S * (S + 1) // 2
    op_type = "bfloat16" if dtype == torch.bfloat16 else "float32"
    out = {}
    for name, nbytes, products in (("flash_fwd", 4 * mat + row, 2),
                                   ("flash_bwd_dq", 5 * mat + 2 * row, 3),
                                   ("flash_bwd_dkv", 6 * mat + 2 * row, 4)):
        ms, by = bound_ms(nbytes, 2 * products * pairs * hd, op_type)
        out[name] = dict(bound_ms=ms, bound_by=by, bytes=nbytes,
                         flop=2 * products * pairs * hd)
    return out


def sdpa_backward_ms(sets, reps: int = 7, rounds: int = 4):
    """SDPA's backward (``is_causal=True``; dq, dk and dv in one call),
    timed as the kernels are: a forward of each input set ``(q, k, v,
    do, ...)`` on a side stream, then the backward of every set captured
    in one CUDA graph (``rounds`` passes) and replayed between CUDA
    events. Returns the median device ms per backward over ``reps``
    replays and the replays' ``(min, max)``."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        forwards = []
        for s in sets:
            leaves = tuple(x.detach().clone().requires_grad_() for x in s[:3])
            forwards.append((sdpa(*leaves, is_causal=True), leaves, s[3]))

        def backward():
            for out, leaves, do in forwards:
                torch.autograd.grad(out, leaves, do, retain_graph=True)
        backward()  # warm-up, on the stream the backward will run on
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(rounds):
            backward()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / (rounds * len(sets)))
    del graph, forwards
    return statistics.median(times), (min(times), max(times))


def flash_phase(results: dict) -> None:
    """The three flash kernels against their plain versions on the card
    (``graftnum.FLASH_POLICY``: out, lse, dq, dk, dv; bf16 and f32; B=4
    at S=2048, B=1 at S=4096, a ragged S=333), two launches
    bit-identical; then each kernel's device time at the training shape
    (bf16 [4, 12, 2048, 64]) beside its plain version's, the library
    yardstick's (SDPA with is_causal=True forward; its backward through
    autograd, which computes dq, dk and dv together, ``sdpa_backward_ms``)
    and its bound."""
    import torch

    from llm_sharding_demo_tpu_torch.ops import flash_attention as FA
    from llm_sharding_demo_tpu_torch.utils import graftnum

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2048)

    def inputs(B, S, dtype):
        return [torch.randn(B, H, S, HD, generator=g, device=dev).to(dtype)
                for _ in range(4)]

    def run(q, k, v, do):
        out, lse = FA.flash_forward(q, k, v)
        delta = FA.flash_delta(out, do)
        dq = FA.flash_bwd_dq(q, k, v, do, lse, delta)
        dk, dv = FA.flash_bwd_dkv(q, k, v, do, lse, delta)
        return dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv), delta

    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for B, S in ((4, FLASH_SEQ), (1, FLASH_SEQ), (1, 2 * FLASH_SEQ),
                     (4, 2 * FLASH_SEQ), (2, 333)):
            q, k, v, do = inputs(B, S, dtype)
            got, delta = run(q, k, v, do)
            again, _ = run(q, k, v, do)
            out_p, lse_p = FA._forward_plain(q, k, v)
            # the backward's plain versions read the kernel's own lse, so
            # each kernel is held alone
            dq_p = FA._bwd_dq_plain(q, k, v, do, got["lse"], delta)
            dk_p, dv_p = FA._bwd_dkv_plain(q, k, v, do, got["lse"], delta)
            want = dict(out=out_p, lse=lse_p, dq=dq_p, dk=dk_p, dv=dv_p)
            torch.cuda.synchronize()
            what = f"flash {str(dtype)[6:]} B={B} H={H} S={S} hd={HD}"
            line = []
            for name in got:
                check(torch.equal(bits(got[name]), bits(again[name])),
                      f"{what}: two launches differ in {name}")
                try:
                    rep = graftnum.compare_flash(name, got[name], want[name],
                                                 dtype)
                except graftnum.GraftnumError as e:
                    raise SmokeError(f"{what}: {e} ({e.report})")
                kern = {"out": "flash_fwd", "lse": "flash_fwd",
                        "dq": "flash_bwd_dq"}.get(name, "flash_bwd_dkv")
                worst[kern] = max(worst.get(kern, 0.0), rep["max_abs_err"])
                line.append(f"{name} max {rep['max_rel_err']:.2e} rms "
                            f"{rep['rms_rel_err']:.2e}")
            print(f"  {what}: " + ", ".join(line) + " (of the largest value /"
                  f" the RMS; limits {graftnum.FLASH_POLICY[str(dtype)[6:]]})"
                  "  bit-identical  ok")
            del q, k, v, do, got, again, want
    torch.cuda.empty_cache()

    # timing at the training shape, inputs rotated past the L2
    B, S, dtype = FLASH_BH[0], FLASH_SEQ, torch.bfloat16
    bounds = flash_bounds(B, S, dtype)
    sets = []
    for _ in range(copies_for(4 * B * H * S * HD * 2)):
        q, k, v, do = inputs(B, S, dtype)
        out, lse = FA.flash_forward(q, k, v)
        sets.append((q, k, v, do, out, lse, FA.flash_delta(out, do)))
    shape = f"bf16 B={B} H={H} S={S} hd={HD} causal"
    calls = {
        "flash_fwd": (
            [(lambda s=s: FA.flash_forward(s[0], s[1], s[2])) for s in sets],
            [(lambda s=s: FA._forward_plain(s[0], s[1], s[2]))
             for s in sets]),
        "flash_bwd_dq": (
            [(lambda s=s: FA.flash_bwd_dq(s[0], s[1], s[2], s[3], s[5],
                                          s[6])) for s in sets],
            [(lambda s=s: FA._bwd_dq_plain(s[0], s[1], s[2], s[3], s[5],
                                           s[6])) for s in sets]),
        "flash_bwd_dkv": (
            [(lambda s=s: FA.flash_bwd_dkv(s[0], s[1], s[2], s[3], s[5],
                                           s[6])) for s in sets],
            [(lambda s=s: FA._bwd_dkv_plain(s[0], s[1], s[2], s[3], s[5],
                                            s[6])) for s in sets]),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = [(lambda s=s: sdpa(s[0], s[1], s[2], is_causal=True))
               for s in sets]
    lib_bwd, (bwd_lo, bwd_hi) = sdpa_backward_ms(sets)
    print(f"  SDPA backward (is_causal, dq, dk and dv in one call; CUDA-graph "
          f"replay over {len(sets)} input sets): {lib_bwd:.4f} ms, replays "
          f"{bwd_lo:.4f}-{bwd_hi:.4f} ms")
    for name, (kernel, plain) in calls.items():
        row = dict(shape=shape, max_abs_err=worst[name], **bounds[name])
        timed(row, "ms", kernel)
        timed(row, "plain_ms", plain)
        if name == "flash_fwd":
            timed(row, "library_ms", lib_fwd)
        else:
            # SDPA's backward computes dq, dk and dv in one call: the
            # yardstick of the two backward kernels together
            row["library_ms"] = row["call_library_ms"] = lib_bwd
        results[name] = row
        print(f"  {name}: {shape}: device time per call: kernel "
              f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
              f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']}, {row['flop'] / 1e9:.1f} GFLOP, "
              f"{row['bytes'] / 1e6:.1f} MB; the kernel at "
              f"{row['flop'] / row['ms'] / 1e9:.0f} TFLOP/s); called from "
              f"Python: kernel "
              f"{row['call_ms']:.4f} ms, plain {row['call_plain_ms']:.4f} ms")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = FA.dkv_plan(B * H, S, sms)
    loads = [sum(FA.dkv_tile_cost(S, kt) for kt, _ in c) for c in plan]
    print(f"  flash_bwd_dkv (bf16) work list: {sum(map(len, plan))} tiles of "
          f"{FA.DKV_KEYS} keys on {len(plan)} CTAs, {min(loads)}-"
          f"{max(loads)} q tiles of {FA.DKV_QUERIES} a CTA")
    del sets
    torch.cuda.empty_cache()


# -- phase 6: training ----------------------------------------------------------

TRAIN_STEPS = 5


def train_phase() -> dict:
    """llama-124m training on the card: ``LlamaTrainStep(attention_impl=
    "pallas", adamw(1e-3), remat=True)``, bf16 parameters, B=4, ids
    [4, 2049] from a numpy seed (S=2048 reaches the flash kernels), 5
    steps on the same batch with exact launch counts and a falling loss;
    the same 5 steps on the plain attention ("xla"); step ms, tokens/s
    and peak device memory for both. Then one f32 step of each path from
    the same parameters: loss within 1e-5 relative, each gradient's
    difference within 1e-4 of its norm. Returns the flash path's launch
    counts over its 5 steps."""
    import dataclasses

    import torch

    from llm_sharding_demo_tpu_torch.models import gpt2, llama
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.training import train

    base = llama.CONFIGS["llama-124m"]
    cfgs = {impl: dataclasses.replace(base, attention_impl=impl)
            for impl in ("pallas", "xla")}
    B = FLASH_BH[0]
    ids = np.random.default_rng(11).integers(0, base.vocab_size,
                                             (B, FLASH_SEQ + 1))
    params = llama.init_params(
        base, torch.Generator(device="cuda").manual_seed(5))
    tokens = B * FLASH_SEQ
    counts = {}
    for impl, cfg in cfgs.items():
        step = train.LlamaTrainStep(cfg, train.adamw(1e-3), remat=True)
        p, state = step.init(gpt2.map_params(
            lambda x: x.to(torch.bfloat16), params))
        batch = step.shard_batch(ids)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_build.reset_launch_counts()
        losses, times = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            p, state, loss = step(p, state, batch)
            losses.append(float(loss))   # a sync: the step is done
            times.append((time.perf_counter() - t0) * 1e3)
        got = cuda_build.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = {k.name: 0 for k in cuda_build.KERNELS}
        if impl == "pallas":
            want.update(flash_fwd=2 * L * TRAIN_STEPS,
                        flash_bwd_dq=L * TRAIN_STEPS,
                        flash_bwd_dkv=L * TRAIN_STEPS)
            counts = got
        check(got == want, f"train {impl}: launches {got}, expected {want}")
        check(all(np.isfinite(losses)), f"train {impl}: losses {losses}")
        check(losses[-1] < losses[0],
              f"train {impl}: loss did not fall over {TRAIN_STEPS} steps: "
              f"{losses}")
        steady = statistics.median(times[1:])
        print(f"  llama-124m train, attention_impl={impl!r}, bf16, B={B} "
              f"S={FLASH_SEQ}, remat, adamw(1e-3): losses "
              f"{[round(x, 4) for x in losses]}; step ms {[round(t, 1) for t in times]}"
              f" (median of steps 2-{TRAIN_STEPS}: {steady:.1f} ms, "
              f"{tokens / steady * 1e3:.0f} tokens/s); peak memory "
              f"{peak:.2f} GiB; launches {got}")
        del p, state, step
        torch.cuda.empty_cache()

    # f32: one step of each path from the same parameters
    grads, losses = {}, {}
    cuda_build.reset_launch_counts()
    for impl, cfg in cfgs.items():
        step = train.LlamaTrainStep(cfg, train.adamw(1e-3), remat=True)
        p, _ = step.init(params)
        losses[impl], grads[impl] = step.loss_and_grads(p, ids)
        del p, step
    got = cuda_build.launch_counts()
    check(got["flash_fwd"] == 2 * L and got["flash_bwd_dq"] == L
          and got["flash_bwd_dkv"] == L, f"train f32: launches {got}")
    rel_loss = abs(float(losses["pallas"]) - float(losses["xla"])) / abs(
        float(losses["xla"]))
    check(rel_loss <= 1e-5, f"train f32: loss {float(losses['pallas'])} vs "
                            f"{float(losses['xla'])} ({rel_loss:.2e} relative)")
    worst = 0.0
    for a, b in zip(grads["pallas"], grads["xla"]):
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        worst = max(worst, rel)
    check(worst <= 1e-4, f"train f32: a gradient differs by {worst:.2e} of "
                         "its norm")
    print(f"  llama-124m f32 step, pallas vs xla: loss "
          f"{float(losses['pallas']):.7f} vs {float(losses['xla']):.7f} "
          f"({rel_loss:.2e} relative, limit 1e-5); worst gradient "
          f"difference {worst:.2e} of its norm (limit 1e-4) over "
          f"{len(grads['xla'])} leaves")
    del grads
    torch.cuda.empty_cache()
    return counts


def flash_prefill_check() -> None:
    """A 2048-token prompt into an unstaged llama-124m bf16 engine at
    max_seq 4096 with attention_impl="pallas": the prefill runs the flash
    forward once per layer (12 launches, nothing else), its logits at
    every position within ``decode.bf16`` of the "xla" engine's; then a
    short greedy generate goes through the same prefill and the
    whole-stack kernel."""
    import dataclasses

    import torch

    from llm_sharding_demo_tpu_torch.models import llama
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.utils import graftnum

    base = llama.CONFIGS["llama-124m"]
    params = llama.init_params(
        base, torch.Generator(device="cuda").manual_seed(6))
    prompt = np.random.default_rng(12).integers(0, base.vocab_size,
                                                (1, FLASH_SEQ))
    logits = {}
    for impl in ("pallas", "xla"):
        eng = DecodeEngine(params, dataclasses.replace(
            base, attention_impl=impl), max_seq=LNPOS, dtype="bfloat16")
        check(eng._flash_prefill(FLASH_SEQ, None) == (impl == "pallas"),
              f"flash prefill gate for {impl}")
        cuda_build.reset_launch_counts()
        with torch.inference_mode():
            lg, _ = eng._prefill(eng._ids(prompt), None)
        got = cuda_build.launch_counts()
        want = {k.name: 0 for k in cuda_build.KERNELS}
        if impl == "pallas":
            want["flash_fwd"] = L
        check(got == want, f"prefill {impl}: launches {got}, expected {want}")
        logits[impl] = lg[0].float()
        if impl == "pallas":
            cuda_build.reset_launch_counts()
            out = eng.generate(prompt, 4).tokens
            got = cuda_build.launch_counts()
            check(out.shape == (1, FLASH_SEQ + 4) and got["flash_fwd"] == L
                  and got["decode_layers_llama"] == 3,
                  f"flash-prefill generate: {out.shape}, launches {got}")
        del eng
    check(bool(torch.isfinite(logits["pallas"]).all()),
          "flash prefill: non-finite logits")
    rep = graftnum.compare("decode.bf16", logits["pallas"], logits["xla"])
    print(f"  llama-124m bf16 flash prefill of {FLASH_SEQ} tokens "
          f"(max_seq {LNPOS}) vs the xla engine's: logit_mse="
          f"{rep['logit_mse']:.3e} (cap {rep['policy']['logit_mse']:.0e}) "
          f"top1_agreement={rep['top1_agreement']:.4f} over "
          f"{rep['n_positions']} positions; flash_fwd launched {L} times; a "
          f"4-token generate: flash prefill, then decode_layers_llama")
    del params, logits
    torch.cuda.empty_cache()


# -- phase 4: the engines at full width ---------------------------------------

def engine_phase(family: str) -> dict:
    """GPT-2 124M (``family`` "gpt2") or llama-124m ("llama") at full
    width: the kernel paths against the plain path, teacher-forced, with
    exact launch counts, then decode timings. Returns the launch counts of
    the int8 "layer" engine's teacher-forced run (the path of the
    per-layer kernels)."""
    import torch

    from llm_sharding_demo_tpu_torch.models import gpt2, llama
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.ops.decode_layer import MAX_BATCH
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.utils import graftnum

    is_llama = family == "llama"
    model = llama if is_llama else gpt2
    cfg = llama.CONFIGS["llama-124m"] if is_llama else gpt2.CONFIGS["gpt2"]
    npos = LNPOS if is_llama else NPOS
    mega = "decode_layers_llama" if is_llama else "decode_layers"
    # int8 linear launches of one forward whose rows fit the kernel: GPT-2
    # has four projections a layer and a tied head (its own kernel); llama
    # seven and an untied head (the int8 linear)
    per_forward = 7 * L + 1 if is_llama else 4 * L
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, 16).tolist()
    forced = rng.integers(0, cfg.vocab_size, 48).tolist()
    steps = len(forced) - 1
    layer_counts = {}
    for regime, path in (("bfloat16", "decode.bf16"), ("int8", "decode.int8")):
        engines = {mode: DecodeEngine(params, cfg, max_seq=npos, dtype=regime,
                                      decode_kernel=mode)
                   for mode in ("layer", "mega", "xla")}
        auto = DecodeEngine(params, cfg, max_seq=npos, dtype=regime)
        check(auto.decode_kernel_mode == "mega",
              f"{family} {regime}: 'auto' resolved to "
              f"{auto.decode_kernel_mode}")
        del auto
        lp = teacher_forced_logits(engines["xla"], prompt, forced)
        for mode in ("layer", "mega"):
            eng = engines[mode]
            check(eng.decode_kernel_mode == mode, f"{mode} did not engage")
            cuda_build.reset_launch_counts()
            lk = teacher_forced_logits(eng, prompt, forced)
            counts = cuda_build.launch_counts()
            check(bool(torch.isfinite(lk).all()),
                  f"{family} {regime} {mode}: non-finite logits")
            check(tuple(lk.shape) == (len(forced), cfg.vocab_size),
                  f"{family} {regime} {mode}: logits shape "
                  f"{tuple(lk.shape)}")
            rep = graftnum.compare(path, lk, lp)
            int8 = regime == "int8"
            # int8: the 16-row prefill (rows <= 16) takes the int8 linear
            # kernel on either path, as does llama's head on every step
            forwards = steps + 1 if mode == "layer" else 1
            linear = forwards * per_forward
            if is_llama and mode == "mega":
                linear += steps
            want = {k.name: 0 for k in cuda_build.KERNELS}
            want.update({
                "decode_attention": steps * L if mode == "layer" else 0,
                "quant_linear": linear if int8 else 0,
                "quant_head": steps + 1 if int8 and not is_llama else 0,
                mega: steps if mode == "mega" else 0})
            check(counts == want, f"{family} {regime} {mode}: launches "
                                  f"{counts}, expected {want}")
            if int8 and mode == "layer":
                layer_counts = counts
            print(f"  {family} {path} {mode}: kernel path vs plain path over "
                  f"{rep['n_positions']} teacher-forced positions: "
                  f"logit_mse={rep['logit_mse']:.3e} (cap "
                  f"{rep['policy']['logit_mse']:.0e}) top1_agreement="
                  f"{rep['top1_agreement']:.4f} (floor "
                  f"{rep['policy']['top1_agreement']})  launches {counts}")
        for batch in (1, 8):
            ids = rng.integers(0, cfg.vocab_size, (batch, 32))
            times = {}
            for mode in ("mega", "layer", "xla"):
                eng = engines[mode]
                eng.generate(ids, 8)   # warm-up
                r = eng.generate(ids, 65)
                eager, device = step_ms(eng, ids)
                times[mode] = (r.per_token_latency * 1e3, eager, device)
            print(f"  {family} {regime} decode bs={batch}, 65 new tokens "
                  f"after a 32-token prompt: " + "; ".join(
                      f"{mode} path {t:.3f} ms/token, one step {e:.3f} ms "
                      f"eager vs {d:.3f} ms device (busy {d / e:.1%})"
                      for mode, (t, e, d) in times.items()))
        if regime == "int8" and not is_llama:
            # past MAX_BATCH rows the mega engine takes the per-layer kernels
            ids = rng.integers(0, cfg.vocab_size, (MAX_BATCH + 1, 8))
            cuda_build.reset_launch_counts()
            got = engines["mega"].generate(ids, 6).tokens
            counts = cuda_build.launch_counts()
            check(counts["decode_layers"] == 0
                  and counts["decode_attention"] == 5 * L
                  and counts["quant_linear"] == 0,
                  f"{MAX_BATCH + 1}-row batch: launches {counts}")
            check(np.array_equal(got, engines["layer"].generate(ids, 6).tokens),
                  f"{MAX_BATCH + 1}-row batch: mega engine differs from the "
                  "layer engine")
            print(f"  int8 {MAX_BATCH + 1}-row batch on the mega engine: "
                  f"per-layer kernels, tokens equal to the layer engine's, "
                  f"launches {counts}")
        del engines
        torch.cuda.empty_cache()
    return layer_counts


def teacher_forced_logits(eng, prompt, forced):
    """f32 logits ``[len(forced), vocab]``: row t predicts ``forced[t]``
    after the prompt and ``forced[:t]``. Row 0 comes from the prefill,
    every later row from a cached single-token step (the decode path,
    kernels included)."""
    import torch

    with torch.inference_mode():
        cache = eng._fresh_cache(1)
        logits, cache = eng._forward_cached(eng._ids([list(prompt)]), cache,
                                            None)
        rows = [logits[0, -1]]
        for tok in forced[:-1]:
            logits, cache = eng._forward_cached(eng._ids([[tok]]), cache,
                                                None)
            rows.append(logits[0, -1])
    return torch.stack(rows).float()


def step_ms(eng, ids: np.ndarray, steps: int = 20):
    """``(eager_ms, device_ms)`` of one cached decode step after a prefill
    of ``ids``: the host clock around ``steps`` eager steps ending in a
    sync, and the device's own time for the same step, replayed from a
    CUDA graph (no host dispatch between its launches). Their ratio is the
    share of the eager step in which the device is busy. Every step
    writes the same cache position, which is harmless for timing."""
    import torch

    with torch.inference_mode():
        cache = eng._fresh_cache(ids.shape[0])
        logits, cache = eng._forward_cached(eng._ids(ids), cache, None)
        token = logits[:, -1].argmax(-1)[:, None]

        def step():
            eng._forward_cached(token, cache, None)

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                step()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        eager = (time.perf_counter() - t0) * 1e3 / steps
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        graph.replay()
        start.record()
        for _ in range(steps):
            graph.replay()
        end.record()
        end.synchronize()
        device = start.elapsed_time(end) / steps
        del graph
    return eager, device


# -- phase 5: the server process ---------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, body=None, timeout: float = 300.0) -> dict:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def server_phase(model_id: str, npos: int) -> dict:
    """``python -m llm_sharding_demo_tpu_torch.serving`` with MODEL_ID
    ``model_id``, int8, MAX_SEQ ``npos``: /generate greedy and seeded
    sampling, twice each; /healthz before and after. Returns the server's
    launch counts."""
    import torch

    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.serving import loader
    from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig

    port = _free_port()
    env = dict(os.environ, MODEL_ID=model_id, INFERENCE_DTYPE="int8",
               MAX_SEQ=str(npos), SHARD_PORT=str(port))
    os.makedirs(LOG_DIR, exist_ok=True)
    log_path = os.path.join(LOG_DIR, f"server-{model_id}.log")
    base = f"http://127.0.0.1:{port}"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "llm_sharding_demo_tpu_torch.serving",
             "--host", "127.0.0.1"], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 300
            while True:
                check(proc.poll() is None,
                      f"server exited early (see {log_path})")
                try:
                    health = _http(base + "/healthz", timeout=5)
                    break
                except OSError:
                    check(time.monotonic() < deadline,
                          "server not ready after 300 s")
                    time.sleep(1)
            check(health["device"].startswith("cuda"), f"healthz {health}")
            check(health["decode_kernel"] == "mega", f"healthz {health}")
            before = health["kernel_launches"]
            check(all(v == 0 for v in before.values()),
                  f"launch counts before the requests: {before}")
            prompt = "The port of the sharded server answers: "
            greedy = {"prompt": prompt, "max_new_tokens": 24,
                      "mode": "greedy"}
            sample = {"prompt": prompt, "max_new_tokens": 24,
                      "mode": "sample", "seed": 1234}
            t0 = time.perf_counter()
            g1 = _http(base + "/generate", greedy)
            t1 = time.perf_counter()
            g2 = _http(base + "/generate", greedy)
            s1 = _http(base + "/generate", sample)
            s2 = _http(base + "/generate", sample)
            health = _http(base + "/healthz")
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
    for r in (g1, g2, s1, s2):
        check(isinstance(r.get("generated"), str)
              and r["generated"].startswith(prompt), f"bad reply {r}")
    check(g1 == g2, f"greedy replies differ: {g1} vs {g2}")
    check(s1 == s2, f"seeded sample replies differ: {s1} vs {s2}")
    counts = health["kernel_launches"]
    # two stages (SPLIT_AT=1): one whole-stack launch per stage and decode
    # step, one head launch per decode step (GPT-2's tied head kernel,
    # llama's untied head on the int8 linear; the 41-token prefills exceed
    # the int8 kernels' 16 rows); every other kernel stays idle
    mega, head = (("decode_layers_llama", "quant_linear")
                  if model_id.startswith("llama")
                  else ("decode_layers", "quant_head"))
    check(counts[head] > 0 and counts[mega] == 2 * counts[head]
          and all(v == 0 for k, v in counts.items() if k not in (mega, head)),
          f"served path launches {counts}")
    # the same weights in this process: the greedy reply must match
    cfg = ServingConfig(model_id=model_id, inference_dtype="int8",
                        max_seq=npos)
    config, params = loader.resolve_model(cfg, torch.device("cuda"))
    eng = DecodeEngine(params, config, max_seq=npos, dtype="int8",
                       boundaries=list(cfg.boundaries))
    tok = ByteTokenizer()
    ref = eng.generate(np.asarray(tok.encode(prompt)), 24)
    want = tok.decode([int(t) for t in ref.row_tokens(0)])
    check(g1["generated"] == want,
          "server greedy reply differs from the in-process engine")
    print(f"  {model_id}: /generate greedy x2 equal, seeded sample x2 equal, "
          f"greedy equal to the in-process engine; first greedy request "
          f"{(t1 - t0) * 1e3:.1f} ms for 24 tokens; server launches "
          f"{counts}")
    del eng, params
    torch.cuda.empty_cache()
    return counts


# -- main ----------------------------------------------------------------------

def kernel_name(mangled: str) -> str:
    """The function name (and its first template argument) of a mangled
    ``_ZN<namespace><name>...`` kernel symbol, for the build report."""
    names, i = [], mangled.find("_ZN") + 3
    while i < len(mangled) and mangled[i].isdigit() and len(names) < 3:
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        names.append(mangled[j:j + n])
        i = j + n
        if i < len(mangled) and mangled[i] == "I":
            i += 1
            if mangled[i] == "f":  # a float template argument
                names.append("float")
    # decode attention's query-head group g, an integer template
    # argument: "Li<n>E"
    m = re.search(r"Li(\d+)E", mangled)
    if m and names[1:2] == ["decode_attention_kernel"]:
        names.append(f"g={m.group(1)}")
    # the int8 linear's column tile and n8 tiles of activation rows
    ints = re.findall(r"Li(\d+)E", mangled)
    if names[1:2] == ["quant_linear_kernel"] and len(ints) == 2:
        names += [f"bn={ints[0]}", f"row_tiles={ints[1]}"]
    if names[1:2] == ["quant_head_kernel"] and len(ints) == 1:
        names.append(f"row_tiles={ints[0]}")
    return "::".join(names[1:]) or mangled


def quant_registers(kernel: str) -> dict:
    """Registers a thread of each instantiation of ``kernel``
    (``quant_linear_kernel``: ``{(bn, n8 tiles of activation rows):
    registers}``; ``quant_head_kernel``: ``{(n8 tiles,): registers}``),
    from the quant library's ``-Xptxas -v`` log (empty when the library
    was built by an earlier process)."""
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    regs, key = {}, None
    for line in cuda_build.QUANT_LIB.build_log.splitlines():
        if "Function properties for" in line:
            name = line.split()[-1]
            m = re.search(kernel + r"((?:ILi\d+E|Li\d+E)+)", name)
            key = (tuple(int(i) for i in re.findall(r"Li(\d+)E", m.group(1)))
                   if m else None)
        elif key is not None and "registers" in line:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs[key] = int(m.group(1))
            key = None
    return regs


def find_cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, or the copy Triton ships."""
    import shutil
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    candidates = [os.path.join(os.path.dirname(cuda_build.find_nvcc()),
                               "cuobjdump"), shutil.which("cuobjdump")]
    try:
        import triton
        candidates.append(os.path.join(os.path.dirname(triton.__file__),
                                       "backends", "nvidia", "bin",
                                       "cuobjdump"))
    except ImportError:
        pass
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise SmokeError("cuobjdump not found (CUDA toolkit or Triton)")


FLASH_TMA_KERNELS = ("fwd_bf16", "dkv_bf16")  # wgmma fed by TMA rings


def flash_sass(lib_path: str) -> dict:
    """``{kernel: counts}`` of HGMMA (wgmma), UTMALDG (TMA loads) and LDG
    (thread loads from global memory) in the SASS of each bf16 flash
    kernel of ``FLASH_TMA_KERNELS`` (the forward, dK/dV) in the built
    flash library."""
    out = subprocess.run([find_cuobjdump(), "-sass", lib_path],
                         capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr}")
    found = {k: {"HGMMA": 0, "UTMALDG": 0, "LDG": 0}
             for k in FLASH_TMA_KERNELS}
    counts = None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            counts = next((found[k] for k in FLASH_TMA_KERNELS if k in line),
                          None)
        elif counts is not None:
            # "/*0b50*/  HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], ... ;
            # /* 0x... */": the instruction between the comments
            words = re.sub(r"/\*.*?\*/", " ", line).replace(";", " ").split()
            base = words[0].split(".")[0] if words else ""
            if words and words[0].startswith("@"):  # a predicated one
                base = words[1].split(".")[0] if len(words) > 1 else ""
            if base in counts:
                counts[base] += 1
    for k, counts in found.items():
        check(any(counts.values()),
              f"no {k} function in the SASS of {lib_path}")
    return found


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="kernels,flash,engine,server,train",
                        help="comma-separated subset of kernels,flash,engine,"
                             "server,train")
    phases = set(parser.parse_args().phases.split(","))

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke test "
              "needs a CUDA GPU", file=sys.stderr)
        return 1
    from llm_sharding_demo_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[probe] {name} capability {torch.cuda.get_device_capability(0)} "
          f"torch {torch.__version__} cuda {torch.version.cuda}; {smi}")

    t0 = time.perf_counter()
    libs = cuda_build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall")
    for lib in libs:
        print(f"  {os.path.basename(lib.path)}: nvcc {lib.build_seconds:.1f} s")
        for line in lib.build_log.splitlines():
            if "Function properties for" in line:
                print("    kernel", kernel_name(line.split()[-1]))
            elif "registers" in line or "spill" in line:
                print("   ", line.strip())

    flash_lib = cuda_build.FLASH_ATTENTION_LIB
    smem = {"fwd_bf16": flash_lib.load().flash_fwd_smem_bytes(),
            "dkv_bf16": flash_lib.load().flash_dkv_smem_bytes()}
    for kernel, counts in flash_sass(flash_lib.path).items():
        print(f"  {kernel} SASS: {counts['HGMMA']} HGMMA (wgmma), "
              f"{counts['UTMALDG']} UTMALDG (TMA tile loads), "
              f"{counts['LDG']} LDG (thread loads from global memory); "
              f"dynamic shared memory {smem[kernel]} bytes a CTA")
        check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
              and counts["LDG"] == 0,
              f"the bf16 flash kernel {kernel} must issue wgmma and TMA "
              f"loads and no thread loads from global memory: {counts}")

    results: dict = {}
    if "kernels" in phases:
        print("[kernels] each kernel against its plain version on the card")
        kernel_phase(results)
    if "flash" in phases:
        print("[flash] the flash-attention kernels against their plain "
              "versions")
        flash_phase(results)
    # each kernel's launches on the path that runs it: the GPT-2 server for
    # its whole-stack kernel, the llama server for llama's, the int8
    # "layer" GPT-2 engine run for the per-layer kernels (and the llama
    # paths' counts beside them)
    launches = {k.name: None for k in cuda_build.KERNELS}
    llama_launches = {}
    if "engine" in phases:
        print("[engine] GPT-2 124M and llama-124m, kernel paths vs plain path")
        layer_counts = engine_phase("gpt2")
        for kernel in ("decode_attention", "quant_linear", "quant_head"):
            launches[kernel] = layer_counts[kernel]
        llama_launches["layer engine run"] = engine_phase("llama")
        flash_prefill_check()
    if "server" in phases:
        print("[server] python -m llm_sharding_demo_tpu_torch.serving, int8")
        launches["decode_layers"] = server_phase(
            "gpt2", NPOS)["decode_layers"]
        counts = server_phase("llama-124m", LNPOS)
        launches["decode_layers_llama"] = counts["decode_layers_llama"]
        llama_launches["server"] = counts
    if "train" in phases:
        print("[train] llama-124m train steps, flash kernels vs plain "
              "attention")
        counts = train_phase()
        for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            launches[kernel] = counts[kernel]

    sources = {"decode_attention": "csrc/decode_attention.cu",
               "quant_linear": "csrc/quant.cu",
               "quant_head": "csrc/quant.cu",
               "decode_layers": "csrc/decode_layer.cu",
               "decode_layers_llama": "csrc/decode_layer.cu",
               "flash_fwd": "csrc/flash_attention.cu",
               "flash_bwd_dq": "csrc/flash_attention.cu",
               "flash_bwd_dkv": "csrc/flash_attention.cu"}
    replaces = {
        "decode_attention":
            "llm_sharding_demo_tpu/ops/decode_attention.py:74",
        "quant_linear": "llm_sharding_demo_tpu/ops/quant.py:217",
        "quant_head": "llm_sharding_demo_tpu/ops/quant.py:249",
        "decode_layers": "llm_sharding_demo_tpu/ops/decode_layer.py:319",
        "decode_layers_llama":
            "llm_sharding_demo_tpu/ops/decode_layer.py:534",
        "flash_fwd": "llm_sharding_demo_tpu/ops/flash_attention.py:117",
        "flash_bwd_dq": "llm_sharding_demo_tpu/ops/flash_attention.py:216",
        "flash_bwd_dkv": "llm_sharding_demo_tpu/ops/flash_attention.py:252",
    }
    requests = "four 24-token int8 /generate requests"
    paths = {"decode_layers": f"GPT-2 server: {requests}",
             "decode_layers_llama": f"llama-124m server: {requests}",
             "decode_attention": "GPT-2 engine: int8 'layer' teacher-forced run",
             "quant_linear": "GPT-2 engine: int8 'layer' teacher-forced run",
             "quant_head": "GPT-2 engine: int8 'layer' teacher-forced run",
             **{k: f"llama-124m train: {TRAIN_STEPS} bf16 steps, B=4, "
                   f"S={FLASH_SEQ}, remat"
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}}
    rows = []
    for k in cuda_build.KERNELS:
        r = results.get(k.name, {})
        rows.append({
            "name": k.name, "route": "cuda",
            "source": "llm_sharding_demo_tpu_torch/" + sources[k.name],
            "replaces": replaces[k.name], "launches": launches[k.name],
            "launches_on": paths[k.name],
            "llama_launches": {where: c[k.name]
                               for where, c in llama_launches.items()},
            "max_abs_err": r.get("max_abs_err"), "ms": r.get("ms"),
            "plain_ms": r.get("plain_ms"), "bound_ms": r.get("bound_ms"),
            "bound_by": r.get("bound_by"),
            "library_ms": r.get("library_ms"), "shape": r.get("shape"),
            "call_ms": r.get("call_ms"),
            **({"layer_path_ms": r.get("layer_path_ms")}
               if "layer_path_ms" in r else {})})
    print(f"[done] {time.perf_counter() - t_start:.1f} s wall")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        sys.exit(1)
