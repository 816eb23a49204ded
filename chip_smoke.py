#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root: ``python3 chip_smoke.py``. Phases, each of
which must pass or the script exits non-zero:

1. probe: the card's name, capability and power limit;
2. build: every CUDA kernel of ``llm_sharding_demo_tpu_torch/csrc``,
   one nvcc per source, all started together, with each kernel's
   registers, spills and shared memory; the SASS (``cuobjdump -sass``)
   of the bf16 flash forward, of bf16 dQ and of bf16 dK/dV must hold
   wgmma (HGMMA) and TMA loads (UTMALDG) and no thread load from global
   memory (LDG), each printed with its dynamic shared memory;
3. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the shapes the served paths give it (GPT-2 124M and
   llama-124m: decode attention with one and with three query heads per
   kv head, the int8 linear at both models' projections and llama's
   untied head at rows 1..16, two launches bit-identical, each timed
   shape printed with its ``linear_plan`` (column tile, split, CTAs) and
   registers a thread, the int8 tied head at GPT-2's table at rows 1..16,
   bit-identical, timed at rows 1, 7, 8, 14 and 16 with its ``head_plan``
   (CTAs, span) and registers (the int8 linear's c_fc also at rows 7 and
   14: a verify window of one and of two streams), both whole-stack kernels (each timed case printed
   with its weight-ring plan: stages, stage bytes, shared memory);
   decode attention also at the edges of its cluster split, with rows
   masked past whole spans or entirely, B 1/8/16/32, two launches
   bit-identical; the whole-stack kernels at B 1/2/4/8/16), with each
   kernel's
   time beside its plain version's, one library call's (for a
   whole-stack kernel: the per-layer kernel path's) and the card's lower
   bound for the same work (decode attention's cluster size with each);
3b. flash: the three flash-attention kernels (forward, dQ, dK/dV)
   against their plain versions (bf16 and f32, B=1 and 4 at S=2048 and
   4096, a ragged S=333), bit-identical across launches, and timed at
   llama-124m's training shape beside their plain versions, SDPA (its
   backward captured in a CUDA graph and replayed, as the kernels are
   timed) and their bounds, with the two backward kernels' work lists;
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
6. batch: in process, GPT-2 124M fp32 on the plain path (TF32 off):
   the admission batcher and the iteration-level batcher, 24 ragged
   greedy and then 24 seeded sampled requests from threads (the iter
   batcher's in four groups 0.03 s apart over 8-step segments, so that
   rows join a live batch and widen it: at least one join and one grow
   each), each row byte-equal to the engine's solo run (a row that is
   not is shown at its first differing token and held, teacher-forced,
   at the fp32 parity bar 1e-5 against the solo path); chunked prefill
   (PREFILL_CHUNK=16) byte-equal to monolithic; an int8 chunked prefill
   on the kernels within ``decode.int8`` of the int8 plain path's
   monolithic prefill, with exact launch counts, both beside fp32; for
   each family a 32-row ragged int8 batch on the served staged engine,
   teacher-forced past the megakernels' 16 rows (decode attention on
   every layer of every step, exact launch counts), within
   ``decode.int8`` of the int8 plain path, and one 32-row decode step's
   eager and device time (the busy share); then two batched int8
   servers, GPT-2 with
   MAX_BATCH=32 BATCH_MODE=admission PREFILL_CHUNK=16 and llama-124m
   with MAX_BATCH=32 BATCH_MODE=iter MAX_SEQ=4096, each taking waves of
   1, 8 and 32 concurrent 64-token requests (greedy, then seeded
   sampled, after one untimed request of each; the iter server's
   arrivals in four groups 0.05 s apart), each
   wave's launches exactly those its forwards (``/healthz``
   ``forward_shapes``) must show, the megakernels at <= 16 rows and
   decode attention past 16, its aggregate tokens/s and p50 per-token
   latency; a seeded request alone twice replays;
7. train: 5 llama-124m train steps (bf16, B=4, S=2048, remat, AdamW) on
   the flash kernels with exact launch counts (24 forwards, 12 dQ and 12
   dK/dV a step) and a falling loss, the same steps on the plain
   attention, step ms, tokens/s and peak memory for both; one f32 step
   of each path from the same weights, loss and gradients held together.
8. paged: the paged KV pool (no kernel of its own: gathers and scatters
   of PyTorch ops). The movers at GPT-2's and llama-124m's served
   geometries (16-slot fp32 blocks) byte-equal on the card to the CPU
   movers, trash duplicates included, int8 and fp8 codes and scales
   bit-equal to the CPU codec, and one 32-row segment's gather and
   scatter timed beside their bytes bound; ``PagedKVRunner`` on GPT-2
   fp32, greedy and seeded sampled (B=1, ragged B=4), byte-equal to the
   contiguous engine; llama-124m fp32 on int8 and fp8 pools,
   teacher-forced 48 positions, held to ``kv.int8`` / ``kv.fp8`` against
   the fp32 pool (a miss is printed with its numbers), bytes a block;
   the pooled iter batcher over 128 blocks, wave 32 in process (every
   row equal to its solo run or held at the fp32 parity bar,
   preemptions > 0); the server ``MAX_BATCH=32 BATCH_MODE=iter
   MAX_SEQ=1024 KV_BLOCK_SIZE=16 KV_POOL_BLOCKS=128`` (fp32 GPT-2) with
   waves of 1, 8 and 32 greedy 64-token requests (replies equal to the
   solo runs' text, blocks conserved, preemptions > 0 at 32), 429 with
   Retry-After once 32 requests wait on a saturated pool, tokens/s and
   p50 per-token latency beside the same server without the pool;
   ``KV_POOL_BLOCKS`` with ``INFERENCE_DTYPE=bfloat16`` refused at
   startup with the JAX package's reason (the engine would run a decode
   kernel; int8 pages on its matmul kernels, phase 15).
9. prefix: the prefix cache (``runtime.prefix_cache``, chunk 64) and the
   host tier (``runtime.kv_tier``). GPT-2 124M and llama-124m at full
   width: fp32 greedy streams through the store (cold, exact hit,
   partial hit, deeper extension) against the engine with the cache off
   (a stream that parts must do so at a near tie); on the int8 mega
   path a hit's stream equal to the cold walk's, teacher-forced logits
   through the store within ``decode.int8`` of the int8 plain path and
   exact launch counts; time to first token of a cold walk against a
   hit (768 + 32 and 3072 + 32 tokens; wall and device ms, tokens
   forwarded) and the hit's entry clone beside its bytes bound; a
   512-token entry's demote and promote beside a pinned ``copy_`` of
   the same bytes; the tiered fp32 GPT-2 iter server (MAX_BATCH=4
   KV_POOL_BLOCKS=256 PREFIX_CACHE=8 KV_HOST_BLOCKS=256, six 512-token
   system prompts cycled three times) replying as the same server
   without the store and the tier, conserved after every wave, with
   demotions and promotions; an int8 GPT-2 admission server with
   PREFIX_CACHE=8 MAX_BATCH=8 whose warm wave equals its cold wave, with
   exact launch counts.
10. spec: speculative decoding (``runtime.spec_decode``, K = 6). GPT-2
   124M and llama-124m at full width: fp32 greedy spec streams against
   the same plain engine's (a stream that parts must do so at a near
   tie): solo on a repetitive and a random prompt (tokens a verify), 4
   ragged rows batched, the iteration batcher with a mid-flight join,
   the pooled iteration batcher under preemption; the int8 spec engine
   at one stream and two, its launches exactly what its forwards
   predict (the int8 linear at every projection and GPT-2's tied head,
   once a verify window of <= 16 rows; no attention kernel), its
   teacher-forced verify-window logits against the int8 plain path
   under ``decode.int8`` (a miss printed with its numbers), a verify's
   eager and device time, the host-sync share, tokens a verify and ms a
   token beside the mega engine's step and the plain int8 step; a GPT-2
   int8 ``SPEC_DECODE=6`` server answering four /generate requests
   with ``spec_decode_stats`` in /healthz and exact launches.
11. remote: ``DISPATCH=remote``, the reference's three-role topology:
   shard a and shard b (GPT-2 124M at full width, ``SPLIT_AT=1``, on the
   card) and a coordinator relaying ``/forward`` -> ``/forward_b`` to
   them once a token, which holds no engine. 16-token greedy and seeded
   sampled requests, each twice and each pair equal: the greedy stream
   equal, token for token, to the shards' functions run in this process
   and to the local fp32 path (or parted from it at a near tie), the
   seeded one to the seed contract (one numpy draw a token from
   ``sampler_pmf``), both shards' JSON equal to ``stage_apply`` here; no
   kernel launched in any of the three processes (fp32). The relay's ms
   a token and the JSON bytes a hop. Then shard b stops: a typed 502
   naming it, then 503 ``circuit_open`` with Retry-After, and a 1 ms
   ``X-Deadline-Ms`` 503 ``deadline_exceeded``; ``X-Request-ID`` echoed
   on every reply.
12. ckpt: ``utils.checkpoint.save`` writes GPT-2 124M (seed-0 fp32
   weights) to a temporary directory (bytes and seconds printed); an
   ``INFERENCE_DTYPE=int8`` coordinator and a ``SHARD_ROLE=a`` shard,
   both started with ``CHECKPOINT_DIR``: the coordinator's greedy stream
   (the mega path) equal, token for token, to an in-process int8 engine
   on the seeded weights, with exact launches; shard a's ``/forward``
   bit-equal to ``stage_apply`` here, having read only its stage's files
   (from its log).
13. moe: GPT-2-MoE at the JAX package's geometry (GPT-2 124M's attention,
   8 experts, top 2; ~521M parameters) saved as an fp32 checkpoint, with
   tokenizer assets that give every id a string of its own, and loaded;
   the int8 engine ("auto" resolves to "layer": no whole-stack kernel for
   the family) teacher-forced 48 positions at batch 1 (the routed
   experts) and 8 (the dense dispatch) on the plain path's replayed
   routing within ``decode.int8`` of the int8 plain path, its own routing
   choices held to the flip bars (``MOE_NEAR_TIE``, ``MOE_FLIP_SHARE``),
   which planted faults cross, with exactly the launches its forwards
   predict (decode attention, the int8 linear at c_attn and c_proj, the
   tied head; no megakernel, no flash kernel); eager and device ms a
   token at B 1 and 8 beside the B=1 step's bytes bound; an fp32
   ``CHECKPOINT_DIR`` server's greedy stream equal to the in-process fp32
   engine's; an int8 ``MAX_BATCH=8 BATCH_MODE=admission`` server taking a
   wave of 8 (tokens/s, exact launches), each reply equal, token for
   token, to the same round run in process, whose tokens are the kernel
   path's teacher-forced argmax and within ``decode.int8`` of the plain
   path on its routing; ``BATCH_MODE=iter`` refused at startup; three f32
   ``MoETrainStep`` steps at B=2 x 256 tokens (losses falling, step ms,
   peak memory).
14. obs: the observability surfaces, on servers built in this process
   (``create_app`` behind ``serve``). An int8 GPT-2 admission server
   with the store (MAX_BATCH=8 PREFIX_CACHE=8; decode on the megakernel,
   prefill on the per-layer kernels, exact launches from its forwards):
   three solo 64-token requests, a wave of 8, two requests on one system
   prompt, and a burst of 4 whose 1 ms X-Deadline-Ms is spent by a
   tokenizer slowed to 5 ms. ``/metrics`` parses as Prometheus text
   and counts the answered requests, their tokens, the burst's 503s and
   the TTFT/TPOT observations; ``/debug/requests`` holds every request,
   each span inside its request, and ``?errors=1`` exactly the burst;
   after a synchronize ``/debug/profile`` has no CUDA event pair pending
   and every window above 0, and the batch-1 decode step's mean stream
   window is at least 0.9 x the graph-replay device step of an engine
   like the server's; ``/debug/memory`` is conserved and its
   engine_cache + prefix_store bytes on the card are at most
   ``torch.cuda.memory_allocated``; ``/debug/trend`` trips
   ``slo_deadline_burn`` once, latched on a second scrape and in
   ``/healthz``. Then the recorders' cost on that server: batch-1
   64-token requests with GRAFTTIME, GRAFTSCOPE and GRAFTMEM on, off,
   on with a 50 us busy wait planted in every ``grafttime.emit`` and on
   with a 50 us ``time.sleep`` there, in rotating turns; the medians of
   ms a token of a request's work over off's held to ``OBS_WALL_BAR``
   (the sleep must cross it), those of its ms outside its prefill and
   decode to ``OBS_HOST_BAR`` (the busy wait must cross it). A tiered
   fp32 GPT-2 iter server (KV_POOL_BLOCKS=256 PREFIX_CACHE=8, a host
   tier of 24 blocks): 16 waves of four on 512- and 128-token system
   prompts; its timeline,
   read through the cursor after each wave, carries admissions, spans,
   evictions, demotions and promotions, as many as the pool and tier
   count, and its Chrome export validates; the ledger's pool_codes are
   the planes' bytes on the card and the host tier's bytes on the host.
15. fleet: ``fleet.build_fleet`` at GPT-2 124M width (seeded weights, a
   tokenizer whose replies name their token ids): a router in front of
   one prefill and two decode replicas over one ``KVBlockPool``, chunk
   16. fp32: serial ``bursty_chat`` and ``long_context`` (12 arrivals
   each) through the router, every reply byte-equal to
   ``fleet.build_single``'s on the same schedule, no kernel launched.
   int8 (the pool sanitizing, ``GRAFTSAN``): the same drive, whose
   launches equal what its forwards predict (paged replicas run the int8
   linear at every projection and the tied head on each forward of <= 16
   rows, and no attention or whole-stack kernel); each reply equal to the
   int8 single replica's, or held teacher-forced within ``decode.int8``
   of the int8 plain path; then 16 open-loop ``bursty_chat`` arrivals at
   rate_scale 2: every outcome 200 or a typed 429/503, affinity hits,
   fallbacks and sheds, ``prefix_len()``, the pool conserved at
   ``/healthz`` during the run and after it, no leaked ref, tokens/s and
   one stitched ``/debug/requests`` tree.
16. plan: an in-process GPT-2 124M int8 server from the env contract
   ``AUTO_PLAN_CONTINUOUS=1 KV_POOL_BLOCKS=256 KV_BLOCK_SIZE=16
   MAX_BATCH=8 BATCH_MODE=iter MAX_SEQ=1024``, ``AUTO_PLAN_TRAFFIC``
   from the agentic schedule's own classes (seeded weights, the id
   tokenizer): 10 agentic arrivals serial, open at 60x the profile's
   rate, serial, then the whole mix again. A switch each way (the
   switcher's events); every reply 200; launches equal to what the
   forwards predict (the int8 linear at every projection and the tied
   head on each forward of <= 16 rows, every other kernel 0); every
   forward shape inside the certified set and none of one row new on
   the replay; the pool conserved at ``/healthz``; tokens/s and p50 e2e
   of each run and the switcher's host cost an admission. Replies
   against the first run and against the same schedule on each static
   plan (solo paged at MAX_BATCH=1, pooled iter at MAX_BATCH=8): equal,
   or held teacher-forced within ``decode.int8``. The same burst under
   ``GRAFTSCHED=trace`` (per lock: wait seconds, acquisitions,
   contended), and a serial pass on the pooled iter plan with
   ``GRAFTFAULT=1`` (injections by site; its 200 replies against the
   unfaulted run's).

The last lines are the card's name and power limit, one JSON object with
the kernels' numbers (each kernel's launches counted on the path that
runs it: each server for its whole-stack kernel, the GPT-2 "layer" int8
engine run for the per-layer kernels, with the llama paths' counts
beside them, each batched server's counts under ``batch_launches``, the prefix
paths' under ``prefix_launches``, the spec paths' under ``spec_launches``,
the three remote processes' under ``remote_launches``, the checkpoint
coordinator's under ``ckpt_launches``, the MoE paths' under
``moe_launches``, the observability server's under ``obs_launches``,
the int8 fleet's runs under ``fleet_launches``, the continuous server's
runs under ``plan_launches``, the 5 bf16 train steps
for the flash kernels), and
``{"ok": true, "device": {...}}``. ``--phases`` runs a subset (the
default runs all).
"""

from __future__ import annotations

import argparse
import ast
import collections
import contextlib
import gc
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
    # spans of C=16 at 3000 cached) and at the served depths; B=32 is the
    # batched servers' width past the megakernels' 16 rows
    attention_shapes = ((H, NPOS, (0, 1, 37, 63, 64, 65, 127, 128, 129, 255,
                                   256, 1000, 1023)),
                        (HKV, LNPOS, (0, 1, 63, 64, 65, 187, 188, 189, 255,
                                      256, 1000, 3000, 4095)))
    tol = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for B in (1, 8, 16, 32):
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
    # c_fc at a one-stream (7 rows) and a two-stream (14 rows) verify
    # window of SPEC_DECODE=6
    row["other_shapes"] = [linear_timing(D, LV), linear_timing(D, LV, rows=8),
                           linear_timing(4 * D, D), linear_timing(INTER, D),
                           linear_timing(D, HKV * HD),
                           linear_timing(D, 4 * D, rows=SPEC_K + 1),
                           linear_timing(D, 4 * D, rows=2 * (SPEC_K + 1))]
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
    row["other_shapes"] = [head_timing(8), head_timing(16),
                           head_timing(SPEC_K + 1),
                           head_timing(2 * (SPEC_K + 1))]
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
    bf16 and int8 weights, B 1/2/4/8/16 (the batchers' power-of-two
    widths), five or six offsets (llama's up to 4095), odd rows masked
    over half or all of their cached positions.
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
    for B in (1, 2, 4, 8, 16):
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
        stages, stage_bytes, smem = DL.stage_plan(regime == "int8", B, D, kvw,
                                                  inter, is_llama)
        print(f"  {name} {regime} weights, {n_l} layers, B={B}, offset "
              f"{off}: weight ring plan {stages} stages of {stage_bytes} "
              f"bytes, {smem} bytes of dynamic shared memory beside "
              f"{DL.static_smem_bytes(is_llama)} static")
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
                   bound_ms=bms, bound_by=by, weight_bytes=wbytes,
                   stages=stages, stage_bytes=stage_bytes, smem_bytes=smem)
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
    for name, plan, cost, tile, step in (
            ("flash_bwd_dq", FA.dq_plan, FA.dq_tile_cost,
             f"{FA.DQ_ROWS} rows", f"k tiles of {FA.DQ_KEYS}"),
            ("flash_bwd_dkv", FA.dkv_plan, FA.dkv_tile_cost,
             f"{FA.DKV_KEYS} keys", f"q tiles of {FA.DKV_QUERIES}")):
        ctas = plan(B * H, S, sms)
        loads = [sum(cost(S, blk) for blk, _ in c) for c in ctas]
        print(f"  {name} (bf16) work list: {sum(map(len, ctas))} tiles of "
              f"{tile} on {len(ctas)} CTAs, {min(loads)}-{max(loads)} "
              f"{step} a CTA")
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


def _stop(proc) -> None:
    """SIGTERM, then SIGKILL after 30 s; a process already gone is left."""
    if proc.poll() is not None:
        return
    proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)


@contextlib.contextmanager
def serving_processes(*specs):
    """One ``python -m llm_sharding_demo_tpu_torch.serving`` a ``(name,
    env_vars)`` of ``specs``, all started at once, each on its
    ``SHARD_PORT`` (a free port where it has none) with its output in
    ``build/chip_smoke/<name>.log``; yields ``[(base url, first /healthz,
    stop)]`` once every one answers, and stops them (SIGTERM, then
    SIGKILL) on the way out."""
    os.makedirs(LOG_DIR, exist_ok=True)
    started = []
    with contextlib.ExitStack() as stack:
        for name, env_vars in specs:
            port = int(env_vars.get("SHARD_PORT") or _free_port())
            env = dict(os.environ, **dict(env_vars, SHARD_PORT=str(port)))
            log_path = os.path.join(LOG_DIR, f"{name}.log")
            log = stack.enter_context(open(log_path, "w"))
            proc = subprocess.Popen(
                [sys.executable, "-m", "llm_sharding_demo_tpu_torch.serving",
                 "--host", "127.0.0.1"], cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT)
            stack.callback(_stop, proc)
            started.append((proc, f"http://127.0.0.1:{port}", log_path))
        deadline = time.monotonic() + 300
        ready = []
        for proc, base, log_path in started:
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
            ready.append((base, health, lambda p=proc: _stop(p)))
        yield ready


@contextlib.contextmanager
def serving_process(name: str, **env_vars):
    """``serving_processes`` of one server: yields ``(base url, first
    /healthz)``."""
    with serving_processes((name, env_vars)) as [(base, health, _)]:
        yield base, health


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

    with serving_process(f"server-{model_id}", MODEL_ID=model_id,
                         INFERENCE_DTYPE="int8", MAX_SEQ=str(npos)) as (
            base, health):
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


# -- phase 6: batched serving and chunked prefill ---------------------------

BATCH_WAVES = (1, 8, 32)
WAVE_TOKENS = 64
N_ROWS = 24             # the in-process fp32 batchers' ragged requests
CHUNK = 16              # PREFILL_CHUNK of the chunked checks and server


def _threads(fn, n: int, delays=None, timeout: float = 600.0) -> list:
    """``fn(i)`` for i < n, each on its own thread (after ``delays[i]``
    seconds); returns the results in order. Raises if a thread did not
    finish within ``timeout`` or raised."""
    import threading

    out, errs = [None] * n, []

    def run(i):
        if delays:
            time.sleep(delays[i])
        try:
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — reported below
            errs.append(f"{i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        check(not t.is_alive(), "a request thread did not finish")
    check(not errs, f"requests failed: {errs[:3]}")
    return out


def tf_rows(eng, prompts, forced):
    """f32 logits ``[B, T, vocab]`` of a ragged batch, teacher-forced:
    row b's position t predicts ``forced[b][t]`` after its prompt and
    ``forced[b][:t]``. The prefill is the engine's: chunked where it has
    ``prefill_chunk`` (and chunking applies), else monolithic."""
    from llm_sharding_demo_tpu_torch.runtime.engine import left_pad

    ids, pad = left_pad(prompts)
    return tf_padded(eng, ids, pad, forced)


def tf_padded(eng, ids: np.ndarray, pad: np.ndarray, forced):
    """``tf_rows`` of a batch already left-padded: ``ids`` ``[B, S]``,
    ``pad`` ``[B]`` pad columns a row."""
    import torch

    with torch.inference_mode():
        ids, pad, _, chunk = eng._align_chunks(ids, pad, ids.shape[1],
                                               len(forced[0]))
        pad_t = eng._pad(pad)
        last, cache = eng._prefill_last(ids, pad_t, chunk)
        rows = [last]
        tok = torch.as_tensor(np.asarray(forced), device=eng.device)
        for t in range(tok.shape[1] - 1):
            logits, cache = eng._forward_cached(tok[:, t:t + 1], cache,
                                                pad_t)
            rows.append(logits[:, -1])
    return torch.stack(rows, dim=1).float()


def hold_row(eng, other, prompts, row, got, want, what: str, smi: str,
             greedy: bool = False) -> bool:
    """A row whose tokens differ from its solo run's: print the first
    step that differs and the solo run's top-2 gap there, then hold the
    row's logits, teacher-forced at its own tokens, on the path that
    produced it (engine ``other`` over all of ``prompts``: the batch
    beside its peers, or the chunked prefill) against the solo path at
    the fp32 parity bar (1e-5). Within it, the difference is the card's
    summation order at another shape (the GEMM), not the batcher or the
    chunking: a wrong pad, position or cache row moves logits by far
    more. A ``greedy`` row may part from its solo run only at a near tie:
    the solo top-2 gap there within twice the bar (a join's cache rows
    are not on the teacher-forced path, so this is what holds a joined
    row)."""
    import torch

    t = int(np.flatnonzero(got != want)[0])
    forced = got[:t + 1].tolist()
    solo = tf_rows(eng, [prompts[row]], [forced])[0]
    theirs = tf_rows(other, prompts, [forced] * len(prompts))[row]
    top2 = torch.topk(solo[t], 2).values
    gap = float(top2[0] - top2[1])
    err = float((theirs - solo).abs().max())
    scale = float(solo.abs().max())
    bar = 1e-5 + 1e-5 * scale
    print(f"    {what}: first difference at new token {t} "
          f"(solo {int(want[t])}, batched {int(got[t])}; solo top-2 gap "
          f"{gap:.3e}); teacher-forced max |diff| {err:.3e} of max |logit| "
          f"{scale:.3e} [{smi}]")
    return err <= bar and (not greedy or gap <= 2 * bar)


def batch_rows(eng, batcher, prompts, budgets, sampling, gens_for,
               want, smi: str, name: str, delays=None):
    """Send ``prompts`` through ``batcher`` (fresh, over ``eng``) from one
    thread each, thread i after ``delays[i]`` seconds; every row must
    equal its solo run or hold the fp32 parity bar (``hold_row``).
    Returns the batcher's stats."""
    got = _threads(lambda i: batcher.generate(
        np.asarray(prompts[i]), budgets[i], sampling=sampling,
        generator=gens_for(i), timeout=600).tokens[0], len(prompts),
        delays)
    same = 0
    for i, (g, w) in enumerate(zip(got, want)):
        if np.array_equal(g, w):
            same += 1
            continue
        n = len(prompts[i])
        greedy = sampling.mode == "greedy"
        check(hold_row(eng, eng, prompts, i, g[n:], w[n:],
                       f"{name} row {i}", smi, greedy),
              f"{name} row {i}: batched logits off the solo path past the "
              "fp32 parity bar" + (", or parted from it away from a near "
                                   "tie" if greedy else ""))
    stats = batcher.stats()
    print(f"  fp32 {name} {sampling.mode}: {same}/{len(prompts)} rows "
          f"byte-equal to the solo runs, the rest within the fp32 parity "
          f"bar; batcher {stats} [{smi}]")
    return stats


def batch_inprocess(smi: str) -> None:
    """GPT-2 124M at full width, fp32 plain path (TF32 off): both
    batchers against the same engine's solo runs, greedy and seeded
    sampled; chunked prefill against monolithic, fp32 byte for byte and
    int8 within ``decode.int8`` with exact launch counts."""
    import torch

    from llm_sharding_demo_tpu_torch.models import gpt2
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.runtime.batcher import BatchingEngine
    from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                            SamplingConfig)
    from llm_sharding_demo_tpu_torch.runtime.iterbatch import (
        IterBatchingEngine)
    from llm_sharding_demo_tpu_torch.utils import graftnum

    cfg = gpt2.CONFIGS["gpt2"]
    params = gpt2.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    eng = DecodeEngine(params, cfg, max_seq=NPOS, dtype="float32")
    check(eng.decode_kernel_mode == "xla", "fp32 engine left the plain path")
    # the card's GEMM at one row against the same row among 24
    x = torch.randn(N_ROWS, D, device="cuda")
    w = torch.randn(D, 3 * D, device="cuda")
    gemm_same = bool(torch.equal(x[:1] @ w, (x @ w)[:1]))
    print(f"  fp32 GEMM [1,{D}]x[{D},{3 * D}] bit-equal to row 0 of "
          f"[{N_ROWS},{D}]x[{D},{3 * D}]: {gemm_same} [{smi}]")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, V, int(n)).tolist()
               for n in rng.integers(4, 41, N_ROWS)]
    budgets = [int(n) for n in rng.integers(8, 33, N_ROWS)]
    sample = SamplingConfig(mode="sample", temperature=0.8, top_k=40)

    def gen(i):
        return torch.Generator(device="cuda").manual_seed(100 + i)

    for sampling in (SamplingConfig(), sample):
        greedy = sampling.mode == "greedy"
        t0 = time.perf_counter()
        want = [eng.generate(np.asarray(p), n, sampling=sampling,
                             generator=None if greedy else gen(i)).tokens[0]
                for i, (p, n) in enumerate(zip(prompts, budgets))]
        solo_s = time.perf_counter() - t0
        print(f"  fp32 solo {sampling.mode} runs: {N_ROWS} requests in "
              f"{solo_s:.2f} s [{smi}]")
        gens = (lambda i: None) if greedy else gen
        batch_rows(eng, BatchingEngine(eng, max_batch=32, max_wait_ms=200.0),
                   prompts, budgets, sampling, gens, want, smi, "admission")
        # the iter batcher's arrivals in four groups 0.03 s apart, its
        # segments 8 steps long: later groups join the live batch at a
        # segment boundary (a solo prefill copied into the cache at the
        # batch's depth) and widen it past its seeded power of two
        stats = batch_rows(
            eng, IterBatchingEngine(eng, max_batch=32, seg_steps=8,
                                    max_wait_ms=5.0),
            prompts, budgets, sampling, gens, want, smi, "iter",
            delays=[0.03 * (4 * i // N_ROWS) for i in range(N_ROWS)])
        check(stats["joins"] > 0 and stats["grows"] > 0,
              f"iter {sampling.mode}: no join or no grow: {stats}")

    # chunked prefill (PREFILL_CHUNK=16), fp32: byte-equal to monolithic
    chunked = DecodeEngine(params, cfg, max_seq=NPOS, dtype="float32",
                           prefill_chunk=CHUNK)
    for n in (41, 64, 100):
        p = rng.integers(0, V, n).tolist()
        mono = eng.generate(np.asarray(p), 32).row_tokens(0)[n:]
        got = chunked.generate(np.asarray(p), 32).row_tokens(0)[n:]
        lm = tf_rows(eng, [p], [mono[:1].tolist()])[0, 0]
        lc = tf_rows(chunked, [p], [mono[:1].tolist()])[0, 0]
        err = float((lc - lm).abs().max())
        check(err <= 1e-5 + 1e-5 * float(lm.abs().max()),
              f"chunked prefill logits off monolithic by {err}")
        equal = np.array_equal(got, mono)
        if not equal:
            check(hold_row(eng, chunked, [p], 0, got, mono,
                           f"chunked prefill n={n}", smi, greedy=True),
                  f"chunked prefill n={n}: past the fp32 parity bar")
        print(f"  fp32 chunked prefill, {n}-token prompt in {CHUNK}-token "
              f"chunks: 32 tokens {'byte-equal to' if equal else 'held to'}"
              f" monolithic, last logits max |diff| {err:.3e} [{smi}]")
    del chunked

    # int8 chunked prefill on the GPT-2 server's staged engine (the
    # kernels: the int8 linear and head on each 16-row chunk, then the
    # megakernels), teacher-forced, within decode.int8 of the int8 plain
    # path's monolithic prefill, with exact launch counts; both beside
    # the fp32 run
    prompt = rng.integers(0, V, 41).tolist()
    forced = rng.integers(0, V, 48).tolist()
    lp = tf_rows(eng, [prompt], [forced])[0]
    plain = DecodeEngine(params, cfg, max_seq=NPOS, dtype="int8",
                         decode_kernel="xla")
    lq = tf_rows(plain, [prompt], [forced])[0]
    del plain
    q = DecodeEngine(params, cfg, max_seq=NPOS, dtype="int8",
                     boundaries=[1], prefill_chunk=CHUNK)
    check(q.decode_kernel_mode == "mega", "int8 engine not on mega")
    cuda_build.reset_launch_counts()
    lk = tf_rows(q, [prompt], [forced])[0]
    counts = cuda_build.launch_counts()
    rep = graftnum.compare("decode.int8", lk, lq)

    def fp32_distance(logits):
        return (f"logit_mse {float(((logits - lp) ** 2).mean()):.3e}, "
                f"top1 {float((logits.argmax(-1) == lp.argmax(-1)).float().mean()):.4f}")

    print(f"  int8 vs fp32 at full width, teacher-forced: plain monolithic "
          f"{fp32_distance(lq)}; kernels, chunked {fp32_distance(lk)} "
          f"[{smi}]")
    n_chunks, steps = -(-41 // CHUNK), len(forced) - 1
    want = {k.name: 0 for k in cuda_build.KERNELS}
    want.update({"quant_linear": n_chunks * 4 * L,
                 "quant_head": n_chunks + steps,
                 "decode_layers": 2 * steps})
    check(counts == want, f"int8 chunked prefill launches {counts}, "
                          f"expected {want}")
    print(f"  int8 chunked prefill ({n_chunks} chunks of {CHUNK}) + {steps} "
          f"mega steps vs the int8 plain path's monolithic prefill, "
          f"teacher-forced: logit_mse="
          f"{rep['logit_mse']:.3e} (cap {rep['policy']['logit_mse']:.0e}) "
          f"top1={rep['top1_agreement']:.4f} (floor "
          f"{rep['policy']['top1_agreement']}); launches {counts} [{smi}]")
    del q, eng, params
    torch.cuda.empty_cache()


def step32_checks(smi: str) -> None:
    """For each family, the served int8 staged engine at 32 rows, past
    the megakernels' 16 (the per-layer path: decode attention on every
    layer, the matmuls on the plain path): a ragged 32-row batch,
    teacher-forced, within ``decode.int8`` of the int8 plain path on the
    same weights, with exact launch counts; then one 32-row decode step
    eager beside the device's own time (CUDA-graph replay): the device's
    busy share."""
    import torch

    from llm_sharding_demo_tpu_torch.models import gpt2, llama
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.utils import graftnum

    rows, steps = 32, 24
    for family, model, cfg, npos in (
            ("gpt2", gpt2, gpt2.CONFIGS["gpt2"], NPOS),
            ("llama", llama, llama.CONFIGS["llama-124m"], LNPOS)):
        params = model.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        eng = DecodeEngine(params, cfg, max_seq=npos, dtype="int8",
                           boundaries=[1])
        check(eng.decode_kernel_mode == "mega", f"{family} int8 engine not "
                                                f"on mega")
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
                   for n in rng.integers(8, 49, rows)]
        forced = rng.integers(0, cfg.vocab_size, (rows, steps)).tolist()
        plain = DecodeEngine(params, cfg, max_seq=npos, dtype="int8",
                             boundaries=[1], decode_kernel="xla")
        lp = tf_rows(plain, prompts, forced)
        del plain
        cuda_build.reset_launch_counts()
        lk = tf_rows(eng, prompts, forced)
        counts = cuda_build.launch_counts()
        check(bool(torch.isfinite(lk).all())
              and tuple(lk.shape) == (rows, steps, cfg.vocab_size),
              f"{family} 32-row logits: shape {tuple(lk.shape)} or "
              f"non-finite")
        # the 32-row prefill is past the int8 kernels' 16 rows: nothing
        # launches; each of the steps - 1 single-token forwards runs decode
        # attention once a layer
        want = {k.name: 0 for k in cuda_build.KERNELS}
        want["decode_attention"] = (steps - 1) * L
        check(counts == want, f"{family} 32-row teacher-forced run: "
                              f"launches {counts}, expected {want}")
        rep = graftnum.compare("decode.int8", lk.flatten(0, 1),
                               lp.flatten(0, 1))
        print(f"  {family} int8 staged engine, 32 ragged rows, teacher-forced"
              f" over {steps} positions vs the int8 plain path: logit_mse="
              f"{rep['logit_mse']:.3e} (cap {rep['policy']['logit_mse']:.0e})"
              f" top1={rep['top1_agreement']:.4f} (floor "
              f"{rep['policy']['top1_agreement']}); launches {counts} [{smi}]")
        ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (rows, 48))
        cuda_build.reset_launch_counts()
        eager, device = step_ms(eng, ids)
        check(cuda_build.launch_counts()["decode_attention"] > 0,
              f"{family} 32-row step did not launch decode attention")
        print(f"  {family} int8 staged decode step, 32 rows, 48 cached: "
              f"{eager:.3f} ms eager vs {device:.3f} ms device (busy "
              f"{device / eager:.1%}) [{smi}]")
        del eng, params
        torch.cuda.empty_cache()


def expected_launches(shapes: dict, is_llama: bool, stages: int) -> dict:
    """The launch counts a mega int8 engine's cached forwards must show,
    from its ``forward_shapes`` (``{"BxT": forwards}``): a single token
    at <= 16 rows runs one whole-stack launch a stage and the head kernel
    (GPT-2's int8 tied head; llama's untied head on the int8 linear);
    past 16 rows the per-layer path, decode attention once a layer, with
    the matmuls on the plain path (the int8 kernels take <= 16 rows); a
    window of <= 16 rows in all runs the int8 linear at every projection
    and the head."""
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.ops.decode_layer import MAX_BATCH

    mega = "decode_layers_llama" if is_llama else "decode_layers"
    want = {k.name: 0 for k in cuda_build.KERNELS}
    for key, n in shapes.items():
        b, t = (int(v) for v in key.split("x"))
        if t == 1 and b <= MAX_BATCH:
            want[mega] += stages * n
            want["quant_linear" if is_llama else "quant_head"] += n
        elif t == 1:
            want["decode_attention"] += L * n
        elif b * t <= MAX_BATCH:
            want["quant_linear"] += (7 * L + 1 if is_llama else 4 * L) * n
            if not is_llama:
                want["quant_head"] += n
    return want


def batch_server(model_id: str, npos: int, mode: str, smi: str) -> dict:
    """A batched int8 server (MAX_BATCH=32): waves of 1, 8 and 32
    concurrent 64-token requests, greedy and seeded sampled (the iter
    server's arrivals staggered so that some join mid-flight); each
    wave's launch counts exactly those its forwards must show, its
    aggregate tokens/s and p50 per-token latency; a seeded request sent
    alone twice replays. Returns the server's launch counts."""
    is_llama = model_id.startswith("llama")
    knobs = dict(MODEL_ID=model_id, INFERENCE_DTYPE="int8",
                 MAX_SEQ=str(npos), MAX_BATCH="32", BATCH_MODE=mode,
                 BATCH_WAIT_MS="100" if mode == "admission" else "5")
    if mode == "admission":
        knobs["PREFILL_CHUNK"] = str(CHUNK)
    label = f"{model_id} {mode}" + (f" PREFILL_CHUNK={CHUNK}"
                                    if mode == "admission" else "")
    wide = 0
    with serving_process(f"batch-{model_id}-{mode}", **knobs) as (base,
                                                                  health):
        check(health["decode_kernel"] == "mega"
              and health["max_batch"] == 32 and health["batch_mode"] == mode
              and all(v == 0 for v in health["kernel_launches"].values()),
              f"healthz {health}")
        # one untimed request of each policy first: the process's first
        # launches load the kernels' modules
        for warm in ({"mode": "greedy"}, {"mode": "sample", "seed": 1}):
            _http(base + "/generate", {"prompt": "Warm-up: ",
                                       "max_new_tokens": 4, **warm})
        for sampling in ("greedy", "sample"):
            for n in BATCH_WAVES:
                bodies = [{"prompt": f"Request {i} of a wave of {n}: "
                                     + "abcdefghij"[:i % 10],
                           "max_new_tokens": WAVE_TOKENS, "mode": sampling,
                           **({"seed": 1000 + i} if sampling == "sample"
                              else {})} for i in range(n)]
                # the iter server's arrivals come in four groups 0.05 s
                # apart, so later groups join the live batch
                delays = ([0.05 * (4 * i // n) for i in range(n)]
                          if mode == "iter" else None)
                h0 = _http(base + "/healthz")
                t0 = time.perf_counter()

                def post(i):
                    ts = time.perf_counter()
                    r = _http(base + "/generate", bodies[i], timeout=600)
                    return r, time.perf_counter() - ts

                res = _threads(post, n, delays)
                wall = time.perf_counter() - t0
                h1 = _http(base + "/healthz")
                for (r, _), b in zip(res, bodies):
                    check(isinstance(r.get("generated"), str)
                          and r["generated"].startswith(b["prompt"]),
                          f"bad reply {r}")
                shapes = {k: v - h0["forward_shapes"].get(k, 0)
                          for k, v in h1["forward_shapes"].items()
                          if v != h0["forward_shapes"].get(k, 0)}
                got = {k: v - h0["kernel_launches"][k]
                       for k, v in h1["kernel_launches"].items()}
                want = expected_launches(shapes, is_llama, 2)
                check(got == want, f"{label} wave {n} {sampling}: launches "
                                   f"{got}, expected {want} from the "
                                   f"forwards {shapes}")
                stats = {k: v - h0["batch_stats"][k]
                         for k, v in h1["batch_stats"].items()}
                wide += got["decode_attention"]
                per_tok = statistics.median(t / WAVE_TOKENS for _, t in res)
                print(f"  {label} wave {n} {sampling}: "
                      f"{n * WAVE_TOKENS / wall:.1f} tokens/s aggregate, p50 "
                      f"{per_tok * 1e3:.2f} ms/token per request, wall "
                      f"{wall:.2f} s; forwards {shapes}; launches {got}; "
                      f"batcher {stats} [{smi}]")
        body = {"prompt": "A seeded request, alone: ", "max_new_tokens":
                WAVE_TOKENS, "mode": "sample", "seed": 4242}
        a = _http(base + "/generate", body)
        b = _http(base + "/generate", body)
        check(a == b and a["generated"].startswith(body["prompt"]),
              f"{label}: a seeded request did not replay: {a} vs {b}")
        counts = _http(base + "/healthz")["kernel_launches"]
    check(wide > 0, f"{label}: no decode-attention launch past 16 rows")
    print(f"  {label}: seeded request alone twice equal; server launches "
          f"{counts} [{smi}]")
    return counts


def batch_phase(smi: str) -> dict:
    """Returns each batched server's launch counts."""
    batch_inprocess(smi)
    step32_checks(smi)
    return {"GPT-2 admission server": batch_server("gpt2", NPOS,
                                                   "admission", smi),
            "llama-124m iter server": batch_server("llama-124m", LNPOS,
                                                   "iter", smi)}


# -- phase 8: paged KV -------------------------------------------------------

PAGED_BS = 16           # KV_BLOCK_SIZE of every paged check
PAGED_BLOCKS = 128      # the pooled server's KV_POOL_BLOCKS
PAGED_ROWS = 32
PAGED_HOLD_TOKENS = 256  # the budget of the requests that saturate the pool


def paged_tables(rng, rows: int, nbm: int, owned, trash: int, ids):
    """``[rows, nbm]`` int32 block tables: row r owns ``owned[r]`` columns
    from a pad-prefix column on, drawn without repeat from ``ids``; every
    other entry points at the trash block (a ghost row owns 0)."""
    t = np.full((rows, nbm), trash, np.int32)
    free = list(rng.permutation(ids))
    for r in range(rows):
        lo = int(rng.integers(0, nbm - owned[r] + 1)) if owned[r] else 0
        t[r, lo:lo + owned[r]] = [free.pop() for _ in range(owned[r])]
    return t


def mover_ms(fn, reps: int = 5) -> float:
    """Median ms of one eager call of ``fn`` (CUDA events; the movers copy
    their host tables to the card, so they are not graph-captured)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def paged_movers(smi: str) -> None:
    """The pool's movers at the served geometries (GPT-2: 12 kv heads,
    1024 slots; llama-124m: 4 kv heads, 4096 slots; 16-slot blocks, fp32):
    scatter, gather and copy on the card byte-equal to the same movers on
    CPU tensors, trash duplicates included; int8 and fp8 codes and scales
    on the card bit-equal to the CPU codec's; one 32-row segment's gather
    and scatter timed beside their bytes bound."""
    import torch

    from llm_sharding_demo_tpu_torch.ops import kv_quant as KVQ
    from llm_sharding_demo_tpu_torch.ops import paged_attention as PA

    rng = np.random.default_rng(13)
    for name, hkv, slots in (("GPT-2", H, NPOS), ("llama-124m", HKV, LNPOS)):
        nbm = slots // PAGED_BS
        slot_bytes = L * 2 * hkv * HD * 4
        # exactness: 4 rows (one a ghost, one full, two partial) against
        # the CPU movers on the same tensors
        nb = 3 * nbm
        owned = [0, nbm, 5, nbm // 2]
        t = paged_tables(rng, 4, nbm, owned, nb, range(nb))
        g = torch.Generator(device="cuda").manual_seed(1)
        pool = torch.randn(PA.pool_shape(L, nb, hkv, PAGED_BS, HD),
                           generator=g, device="cuda")
        k, v = (torch.randn(L, 4, hkv, slots, HD, generator=g,
                            device="cuda") for _ in range(2))
        want = PA.scatter_kv(pool.cpu(), k.cpu(), v.cpu(), t)
        got = PA.scatter_kv(pool, k, v, t)
        check(torch.equal(got.cpu(), want),
              f"{name}: scatter on the card differs from the CPU movers")
        gk, gv = PA.gather_kv(got, t)
        real = [r for r in range(4) if owned[r] == nbm]
        check(torch.equal(gk[:, real], k[:, real])
              and torch.equal(gv[:, real], v[:, real]),
              f"{name}: gather after scatter is not the identity")
        wk, wv = PA.gather_kv(want, t)
        check(torch.equal(gk.cpu(), wk) and torch.equal(gv.cpu(), wv),
              f"{name}: gather on the card differs from the CPU movers")
        src, dst = [int(t[1, 0]), int(t[1, 1])], [nb - 1, int(t[1, 0])]
        check(torch.equal(PA.copy_blocks(got.clone(), src, dst).cpu(),
                          PA.copy_blocks(want.clone(), src, dst)),
              f"{name}: copy_blocks on the card differs from the CPU")
        for regime in ("int8", "fp8"):
            blocks = got[:, :nb].clone()
            blocks[:, 0] = 0.0                       # the 1e-8 floor
            q, s = KVQ.QUANTIZERS[regime](blocks)
            qc, sc = KVQ.QUANTIZERS[regime](blocks.cpu())
            codes_off = int((q.view(torch.uint8).cpu()
                             != qc.view(torch.uint8)).sum())
            scales_off = int((s.cpu() != sc).sum())
            check(codes_off == 0 and scales_off == 0,
                  f"{name}: {regime} on the card differs from the CPU "
                  f"codec in {codes_off} of {q.numel()} codes and "
                  f"{scales_off} of {s.numel()} scales")
        del pool, got, want, k, v
        # one 32-row segment: the served wave-32 footprint (7 blocks a
        # row), then every entry a block of its own
        for label, owned in (("7 blocks a row", [7] * PAGED_ROWS),
                             ("full rows", [nbm] * PAGED_ROWS)):
            nb = sum(owned)
            t = paged_tables(rng, PAGED_ROWS, nbm, owned, nb, range(nb))
            pool = torch.zeros(PA.pool_shape(L, nb, hkv, PAGED_BS, HD),
                               device="cuda")
            k, v = PA.gather_kv(pool, t)
            g_ms = mover_ms(lambda: PA.gather_kv(pool, t))
            s_ms = mover_ms(lambda: PA.scatter_kv(pool, k, v, t))
            view = PAGED_ROWS * slots * slot_bytes
            block = PAGED_BS * slot_bytes
            g_bound, _ = bound_ms(2 * view, 0, "float32")
            # the scatter reads and writes each distinct target's block
            s_bound, _ = bound_ms(2 * len(set(t.reshape(-1))) * block, 0,
                                  "float32")
            print(f"  {name} fp32 32-row segment ({label}): view "
                  f"{view / 1e9:.3f} GB ({slot_bytes} B a slot); gather "
                  f"{g_ms:.3f} ms (bound {g_bound:.3f}, {g_ms / g_bound:.1f}"
                  f"x), scatter {s_ms:.3f} ms (bound {s_bound:.3f}, "
                  f"{s_ms / s_bound:.1f}x) [{smi}]")
            del pool, k, v
            torch.cuda.empty_cache()
    print(f"  movers on the card byte-equal to the CPU movers (trash "
          f"duplicates included); int8 and fp8 codes and scales bit-equal "
          f"to the CPU codec, both geometries [{smi}]")


def tf_paged(eng, pool, prompt, forced):
    """f32 logits ``[len(forced), vocab]`` of one row teacher-forced
    through ``pool``: the prefill scattered into blocks, then each forced
    token one gather, one cached forward and one scatter (so a quantized
    pool re-quantizes at every position, as a served row's segments
    do)."""
    import torch

    alloc = pool.allocator
    tables = np.full((1, pool.nbm), pool.trash, np.int32)
    row = alloc.alloc(alloc.blocks_for(len(prompt) + len(forced)))
    tables[0, :len(row)] = row
    try:
        with torch.inference_mode():
            logits, cache = eng._prefill(eng._ids([list(prompt)]), None)
            pool.scatter(cache, tables)
            rows = [logits[0, -1]]
            for t, tok in enumerate(forced[:-1]):
                cache = pool.gather(tables, len(prompt) + t)
                logits, cache = eng._forward_cached(eng._ids([[tok]]),
                                                    cache, None)
                pool.scatter(cache, tables)
                rows.append(logits[0, -1])
    finally:
        alloc.free(row)
    return torch.stack(rows).float()


def probe_paged(eng, pool, prompt, forced):
    """f32 logits ``[len(forced), vocab]`` measured as the ``kv.*``
    budgets are defined (the JAX package's ``_QuantizedKVProbe``): for
    each position, the history before its last token prefilled exactly,
    its cache sent once through the pool (scatter, gather), and the last
    token forwarded on the gathered cache."""
    import torch

    alloc = pool.allocator
    rows = []
    with torch.inference_mode():
        for t in range(len(forced)):
            hist = list(prompt) + list(forced[:t])
            _, cache = eng._prefill(eng._ids([hist[:-1]]), None)
            row = alloc.alloc(pool.nbm)
            try:
                tables = np.asarray([row], np.int32)
                pool.scatter(cache, tables)
                working = pool.gather(tables, len(hist) - 1)
                logits, _ = eng._forward_cached(eng._ids([hist[-1:]]),
                                                working, None)
            finally:
                alloc.free(row)
            rows.append(logits[0, -1])
    return torch.stack(rows).float()


def paged_runner(smi: str, eng) -> None:
    """``PagedKVRunner`` on GPT-2 124M fp32 (TF32 off): greedy streams at
    B = 1 and a ragged batch of 4, and seeded sampled streams, byte-equal
    to the contiguous engine on the card; every block back after each."""
    import torch

    from llm_sharding_demo_tpu_torch.runtime.engine import SamplingConfig
    from llm_sharding_demo_tpu_torch.runtime.kv_pool import (KVBlockPool,
                                                             PagedKVRunner)

    runner = PagedKVRunner(eng, KVBlockPool.for_engine(
        eng, num_blocks=PAGED_BLOCKS, block_size=PAGED_BS))
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, V, int(n)) for n in (23, 9, 31, 17)]
    sample = SamplingConfig(mode="sample", temperature=0.8, top_k=40)

    def gens(n):
        return [torch.Generator(device="cuda").manual_seed(200 + i)
                for i in range(n)]

    t0 = time.perf_counter()
    for what, batch, sampling in (
            ("greedy B=1", prompts[:1], SamplingConfig()),
            ("greedy ragged B=4", prompts, SamplingConfig()),
            ("sampled B=1", prompts[:1], sample),
            ("sampled ragged B=4", prompts, sample)):
        n = 0 if sampling.mode == "greedy" else len(batch)
        want = eng.generate(batch, 64, sampling=sampling,
                            generator=gens(n) if n else None).tokens
        got = runner.generate(batch, 64, sampling=sampling,
                              generator=gens(n) if n else None).tokens
        check(np.array_equal(got, want),
              f"PagedKVRunner {what}: stream differs from the contiguous "
              "engine")
        st = runner.pool.allocator.stats()
        check(st.blocks_in_use == 0 and st.blocks_free == PAGED_BLOCKS,
              f"PagedKVRunner {what}: blocks not returned: {st}")
    print(f"  PagedKVRunner GPT-2 fp32: greedy and seeded sampled streams "
          f"(B=1, ragged B=4, 64 tokens) byte-equal to the contiguous "
          f"engine; {time.perf_counter() - t0:.1f} s [{smi}]")


def paged_quant(smi: str) -> None:
    """llama-124m fp32 on pools of int8 and fp8 blocks, 48 positions after
    a 41-token prompt, against the fp32 engine under ``kv.int8`` /
    ``kv.fp8`` as the budgets are measured (``probe_paged``: one trip
    through the pool a position); beside it, the same positions
    teacher-forced through the pool a token at a time (``tf_paged``: a
    trip a token, as no served segment is shorter), a reading. A miss is
    reported with its numbers, as the int8 engine's at full width was
    (ROADMAP Queue 3), not failed: the budgets stay as declared."""
    import torch

    from llm_sharding_demo_tpu_torch.models import llama
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.runtime.kv_pool import KVBlockPool
    from llm_sharding_demo_tpu_torch.utils import graftnum

    cfg = llama.CONFIGS["llama-124m"]
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    eng = DecodeEngine(params, cfg, max_seq=LNPOS, dtype="float32")
    check(eng.decode_kernel_mode == "xla", "fp32 llama engine left the "
                                           "plain path")
    rng = np.random.default_rng(19)
    prompt = rng.integers(0, cfg.vocab_size, 41).tolist()
    forced = rng.integers(0, cfg.vocab_size, 48).tolist()
    full = KVBlockPool.for_engine(eng, num_blocks=LNPOS // PAGED_BS,
                                  block_size=PAGED_BS)
    exact = tf_paged(eng, full, prompt, forced)
    check(bool(torch.equal(exact, teacher_forced_logits(eng, prompt,
                                                        forced))),
          "llama fp32 paged logits differ from the contiguous engine's")
    print(f"  llama-124m fp32 pool: {full.stats()['bytes_per_block']} B a "
          f"block; teacher-forced logits bit-equal to the contiguous "
          f"engine [{smi}]")
    for regime, path in (("int8", "kv.int8"), ("fp8", "kv.fp8")):
        pool = KVBlockPool.for_engine(eng, num_blocks=LNPOS // PAGED_BS,
                                      block_size=PAGED_BS,
                                      block_dtype=regime)
        codes = pool.data[0, 0].numel() * pool.data.element_size() * L
        scales = pool.scales[0, 0].numel() * 4 * L
        check(pool.stats()["bytes_per_block"] == codes + scales,
              f"{regime}: bytes a block {pool.stats()} vs {codes} + "
              f"{scales}")
        approx = probe_paged(eng, pool, prompt, forced)
        per_token = tf_paged(eng, pool, prompt, forced)
        check(bool(torch.isfinite(approx).all())
              and bool(torch.isfinite(per_token).all())
              and approx.shape == per_token.shape == exact.shape,
              f"{regime} pool: logits non-finite or of shape "
              f"{tuple(approx.shape)}")
        check(torch.equal(tf_paged(eng, pool, prompt, forced), per_token),
              f"{regime} pool: a replay differs")
        try:
            rep = graftnum.compare(path, approx, exact)
            verdict = "within"
        except graftnum.GraftnumError as e:
            rep, verdict = e.report, "MISSES"
        mse = float(((per_token - exact) ** 2).mean(-1).mean())
        top1 = float((per_token.argmax(-1) == exact.argmax(-1)).float()
                     .mean())
        print(f"  llama-124m {regime} pool ({codes} B of codes + {scales} B "
              f"of scales a block) vs fp32, {rep['n_positions']} positions "
              f"a trip each: logit_mse {rep['logit_mse']:.3e} top1 "
              f"{rep['top1_agreement']:.4f}, {verdict} {path} (cap "
              f"{rep['policy']['logit_mse']:.0e}, floor "
              f"{rep['policy']['top1_agreement']}); a trip a token: "
              f"logit_mse {mse:.3e} top1 {top1:.4f}, replay bit-identical "
              f"[{smi}]")
        del pool
    del eng, params, full
    torch.cuda.empty_cache()


def paged_prompts(n: int, seed: int):
    """``n`` byte-tokenizer prompts of 20-35 tokens."""
    rng = np.random.default_rng(seed)
    return [f"Paged request {i}: " + "".join(
        chr(int(c)) for c in rng.integers(97, 123, int(rng.integers(3, 18))))
        for i in range(n)]


def paged_server(smi: str, eng) -> None:
    """The pooled iter server (GPT-2 fp32, MAX_BATCH=32 BATCH_MODE=iter
    MAX_SEQ=1024 KV_BLOCK_SIZE=16 KV_POOL_BLOCKS=128): in process, the
    same batcher over a 128-block pool takes wave 32 (each row byte-equal
    to its solo contiguous run, or held at the fp32 parity bar, with
    preemptions > 0); then the server process takes waves of 1, 8 and 32
    greedy 64-token requests (each reply equal to the solo run's text,
    blocks conserved after each wave, preemptions > 0 at 32), a burst past
    its queue limit (429 with Retry-After), and the same server without
    the pool takes the same waves: tokens/s and p50 per-token latency
    side by side, a health reading."""
    import threading
    import urllib.error

    from llm_sharding_demo_tpu_torch.runtime.engine import SamplingConfig
    from llm_sharding_demo_tpu_torch.runtime.iterbatch import (
        IterBatchingEngine)
    from llm_sharding_demo_tpu_torch.runtime.kv_pool import KVBlockPool
    from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    waves = {n: paged_prompts(n, n) for n in BATCH_WAVES}
    want = {n: [eng.generate(np.asarray(tok.encode(p)), WAVE_TOKENS).tokens[0]
                for p in ps] for n, ps in waves.items()}
    pool = KVBlockPool.for_engine(eng, num_blocks=PAGED_BLOCKS,
                                  block_size=PAGED_BS)
    ids = [tok.encode(p) for p in waves[32]]
    stats = batch_rows(
        eng, IterBatchingEngine(eng, max_batch=32, max_wait_ms=5.0,
                                pool=pool),
        ids, [WAVE_TOKENS] * 32, SamplingConfig(), lambda i: None, want[32],
        smi, "pooled iter (128 blocks)")
    check(stats["preemptions"] > 0 and stats["resumes"] > 0,
          f"pooled iter batcher, wave 32: no preemption: {stats}")
    check(pool.allocator.stats().blocks_free == PAGED_BLOCKS,
          f"pooled iter batcher: blocks not returned {pool.stats()}")

    knobs = dict(MODEL_ID="gpt2", INFERENCE_DTYPE="float32",
                 MAX_SEQ=str(NPOS), MAX_BATCH="32", BATCH_MODE="iter",
                 BATCH_WAIT_MS="5")
    readings = {}
    for label, extra in (("pooled", dict(KV_BLOCK_SIZE=str(PAGED_BS),
                                         KV_POOL_BLOCKS=str(PAGED_BLOCKS))),
                         ("contiguous", {})):
        with serving_process(f"paged-{label}", **knobs, **extra) as (
                base, health):
            check(health["decode_kernel"] == "xla"
                  and health["kv_pool_blocks"] == (
                      PAGED_BLOCKS if extra else 0), f"healthz {health}")
            _http(base + "/generate", {"prompt": "Warm-up: ",
                                       "max_new_tokens": 4,
                                       "mode": "greedy"})
            for n, prompts in waves.items():
                h0 = _http(base + "/healthz")["batch_stats"]
                t0 = time.perf_counter()

                def post(i):
                    ts = time.perf_counter()
                    r = _http(base + "/generate",
                              {"prompt": prompts[i], "mode": "greedy",
                               "max_new_tokens": WAVE_TOKENS}, timeout=600)
                    return r, time.perf_counter() - ts

                res = _threads(post, n)
                wall = time.perf_counter() - t0
                h1 = _http(base + "/healthz")
                for i, (r, _) in enumerate(res):
                    check(r["generated"].startswith(prompts[i]) and (
                        not extra or r["generated"] == tok.decode(
                            [int(x) for x in want[n][i]])),
                          f"{label} server wave {n} row {i}: reply differs "
                          "from the solo contiguous run's text")
                st = {k: v - h0[k] for k, v in h1["batch_stats"].items()}
                per_tok = statistics.median(t / WAVE_TOKENS for _, t in res)
                readings[(label, n)] = (n * WAVE_TOKENS / wall, per_tok)
                pool_note = ""
                if extra:
                    ps = h1["kv_pool_stats"]
                    check(ps["blocks_free"] == ps["blocks_total"]
                          == PAGED_BLOCKS and ps["blocks_in_use"] == 0,
                          f"pooled wave {n}: blocks not conserved {ps}")
                    if n == 32:
                        check(st["preemptions"] > 0,
                              f"pooled wave 32: no preemption {st}")
                    pool_note = (f"; preemptions {st['preemptions']}, "
                                 f"watermark deferrals {st['deferrals']}, "
                                 f"resumes {st['resumes']}, blocks free "
                                 f"{ps['blocks_free']}/{ps['blocks_total']}")
                print(f"  {label} fp32 iter server wave {n}: "
                      f"{n * WAVE_TOKENS / wall:.1f} tokens/s aggregate, p50 "
                      f"{per_tok * 1e3:.2f} ms/token per request, wall "
                      f"{wall:.2f} s{pool_note} [{smi}]")
            if not extra:
                continue
            # a burst past the queue limit is shed with 429 + Retry-After:
            # 32 long requests saturate the pool, then 64 more arrive; once
            # 32 wait, the rest are refused
            def post_status(prompts, new_tokens):
                def post(i):
                    req = urllib.request.Request(
                        base + "/generate", data=json.dumps(
                            {"prompt": prompts[i], "mode": "greedy",
                             "max_new_tokens": new_tokens}).encode(),
                        headers={"Content-Type": "application/json"})
                    try:
                        with urllib.request.urlopen(req, timeout=600) as r:
                            return r.status, None
                    except urllib.error.HTTPError as e:
                        return e.code, e.headers.get("Retry-After")
                return post

            box = {}
            hold = threading.Thread(target=lambda: box.update(codes=_threads(
                post_status(paged_prompts(32, 7), PAGED_HOLD_TOKENS), 32)),
                                    daemon=True)
            hold.start()
            deadline = time.monotonic() + 120
            while _http(base + "/healthz")["kv_pool_stats"][
                    "blocks_in_use"] < 0.9 * PAGED_BLOCKS:
                check(time.monotonic() < deadline and hold.is_alive(),
                      "the pool never saturated under 32 long requests")
                time.sleep(0.02)
            burst = paged_prompts(64, 64)
            codes = _threads(post_status(burst, WAVE_TOKENS), len(burst))
            hold.join(timeout=600)
            check(not hold.is_alive() and all(
                c == 200 for c, _ in box["codes"]),
                  f"the 32 long requests: {box.get('codes')}")
            shed = [ra for c, ra in codes if c == 429]
            check(shed and all(ra and int(ra) >= 1 for ra in shed),
                  f"a burst of {len(burst)} past the queue limit: no 429 "
                  f"with Retry-After ({sorted(set(codes))})")
            check(all(c in (200, 429) for c, _ in codes),
                  f"burst: unexpected statuses {sorted(set(codes))}")
            h = _http(base + "/healthz")
            ps = h["kv_pool_stats"]
            check(ps["blocks_free"] == PAGED_BLOCKS,
                  f"after the burst: blocks not conserved {ps}")
            print(f"  pooled server, 64 requests while 32 long ones hold "
                  f"the pool: {len(shed)} shed with 429 (Retry-After "
                  f"{sorted(set(shed))} s), {len(burst) - len(shed)} "
                  f"served; blocks free {ps['blocks_free']}/"
                  f"{ps['blocks_total']}; batcher {h['batch_stats']} [{smi}]")
    print("  pooled vs contiguous iter server, tokens/s | p50 ms/token: "
          + "; ".join(
              f"wave {n} {readings[('pooled', n)][0]:.1f} | "
              f"{readings[('pooled', n)][1] * 1e3:.2f} vs "
              f"{readings[('contiguous', n)][0]:.1f} | "
              f"{readings[('contiguous', n)][1] * 1e3:.2f}"
              for n in BATCH_WAVES) + f" [{smi}]")


def paged_refusal(smi: str) -> None:
    """KV_POOL_BLOCKS with INFERENCE_DTYPE=bfloat16 on the card: the
    engine runs a decode kernel, and the app refuses at startup with the
    JAX package's reason."""
    from llm_sharding_demo_tpu_torch.serving.app import create_app
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig

    reason = ("KV pool paging drives the XLA cache layout; the Pallas "
              "decode kernel owns its fused in-place cache "
              "(decode_kernel='xla' composes)")
    try:
        create_app(ServingConfig(model_id="gpt2",
                                 inference_dtype="bfloat16", max_seq=NPOS,
                                 kv_pool_blocks=PAGED_BLOCKS,
                                 kv_block_size=PAGED_BS))
    except NotImplementedError as e:
        check(str(e) == reason, f"bf16 + KV_POOL_BLOCKS refused with {e}")
    else:
        raise SmokeError("bf16 + KV_POOL_BLOCKS started on the card")
    print(f"  KV_POOL_BLOCKS with INFERENCE_DTYPE=bfloat16 refuses at "
          f"startup: {reason} [{smi}]")


def paged_phase(smi: str) -> None:
    """The paged KV path on the card (module docstring, phase 8)."""
    import torch

    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.serving import loader
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig

    t0 = time.perf_counter()
    paged_movers(smi)
    # the served weights (MODEL_ID=gpt2, seed 0), as the server draws them
    config, params = loader.resolve_model(ServingConfig(model_id="gpt2"),
                                          torch.device("cuda"))
    eng = DecodeEngine(params, config, max_seq=NPOS, dtype="float32")
    check(eng.decode_kernel_mode == "xla", "fp32 engine left the plain path")
    paged_runner(smi, eng)
    paged_quant(smi)
    paged_server(smi, eng)
    del eng, params
    torch.cuda.empty_cache()
    paged_refusal(smi)
    print(f"  [paged] {time.perf_counter() - t0:.1f} s wall [{smi}]")


# -- phase 9: the prefix cache and the host tier -----------------------------

PREFIX_CHUNK = 64        # the store's chunk on every prefix check
PREFIX_NEW = 24          # new tokens of the in-process prefix streams
TIER_BLOCKS = 256        # the tiered server's KV_POOL_BLOCKS and KV_HOST_BLOCKS
TIER_PROMPT = 512        # its system prompts' length (bytes = tokens)


def prefix_models(family: str, regime: str):
    """``(cfg, npos, engine)`` at full width, seeded weights (seed 0);
    int8 resolves to the megakernel path on the card, fp32 to the plain
    path."""
    import torch

    from llm_sharding_demo_tpu_torch.models import gpt2, llama
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine

    is_llama = family == "llama"
    model = llama if is_llama else gpt2
    cfg = llama.CONFIGS["llama-124m"] if is_llama else gpt2.CONFIGS["gpt2"]
    npos = LNPOS if is_llama else NPOS
    params = model.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    return cfg, npos, params, DecodeEngine(params, cfg, max_seq=npos,
                                           dtype=regime)


def tf_prefix(pce, prompt, forced):
    """f32 logits ``[len(forced), vocab]`` through the prefix store: the
    store walk of ``prompt`` (hit or miss), then ``forced[:-1]`` one
    cached step each on the engine's decode path."""
    import torch

    eng = pce.plain
    with torch.inference_mode():
        with pce._lock:
            logits, cache, _ = pce._prefill_walk(np.asarray(prompt))
        rows = [logits[0, -1]]
        for tok in forced[:-1]:
            logits, cache = eng._forward_cached(eng._ids([[tok]]), cache,
                                                None)
            rows.append(logits[0, -1])
    return torch.stack(rows).float()


def prefix_fp32_streams(smi: str) -> None:
    """fp32 greedy streams through the store (cold, exact hit, partial
    hit, deeper extension) against the same engine with the cache off,
    both families at full width. A stream that parts from the plain one
    must do so at a near tie (``hold_row``'s rule): teacher-forced at
    its own tokens, the store path's logits within the fp32 parity bar of
    the plain path's, and the plain top-2 gap there within twice it."""
    import torch

    from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
        PrefixCachingEngine)

    for family in ("gpt2", "llama"):
        cfg, _, _, eng = prefix_models(family, "float32")
        check(eng.decode_kernel_mode == "xla", "fp32 left the plain path")
        pce = PrefixCachingEngine(eng, capacity=4, chunk=PREFIX_CHUNK)
        rng = np.random.default_rng(21)
        system = rng.integers(0, cfg.vocab_size, 300)
        prompts = {"cold": np.concatenate([system, rng.integers(
                       0, cfg.vocab_size, 20)])}
        prompts["hit"] = prompts["cold"]
        prompts["partial hit"] = np.concatenate(
            [system[:256], rng.integers(0, cfg.vocab_size, 100)])
        prompts["extension"] = np.concatenate(
            [prompts["cold"], rng.integers(0, cfg.vocab_size, 150)])
        same = []
        for kind, p in prompts.items():
            got = pce.generate(p, PREFIX_NEW).tokens[0][len(p):]
            want = eng.generate(p[None], PREFIX_NEW).tokens[0][len(p):]
            if np.array_equal(got, want):
                same.append(kind)
                continue
            t = int(np.flatnonzero(got != want)[0])
            forced = got[:t + 1].tolist()
            mine = tf_prefix(PrefixCachingEngine(eng, chunk=PREFIX_CHUNK),
                             p, forced)
            plain = teacher_forced_logits(eng, p, forced)
            top2 = torch.topk(plain[t], 2).values
            gap = float(top2[0] - top2[1])
            err = float((mine - plain).abs().max())
            bar = 1e-5 + 1e-5 * float(plain.abs().max())
            print(f"    {family} fp32 {kind}: first difference at new token "
                  f"{t}; plain top-2 gap {gap:.3e}; teacher-forced max "
                  f"|diff| {err:.3e} (bar {bar:.3e}) [{smi}]")
            check(err <= bar and gap <= 2 * bar,
                  f"{family} fp32 prefix {kind}: the store's stream parted "
                  "from the plain engine's away from a near tie")
        st = pce.stats()
        check((st["hits"], st["misses"]) == (3, 1), f"{family} stats {st}")
        print(f"  {family} fp32 prefix store: {len(same)}/4 streams "
              f"({', '.join(same)}) byte-equal to the cache-off engine, "
              f"{PREFIX_NEW} new tokens each; stats {st} [{smi}]")
        del eng, pce
        torch.cuda.empty_cache()


def prefix_int8(smi: str) -> dict:
    """The int8 mega path through the store, both families: a hit's
    stream equals the cold walk's, teacher-forced logits through the
    store within ``decode.int8`` of the int8 plain path, the launches of
    the two generates exactly what their forwards must show; then time to
    first token of a cold walk against a hit (768 + 32 tokens for GPT-2,
    3072 + 32 for llama-124m) and the hit's entry clone beside its bytes
    bound. Returns each family's launch counts."""
    import torch

    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
        PrefixCachingEngine, clone_cache)
    from llm_sharding_demo_tpu_torch.utils import graftmem, graftnum

    out = {}
    for family in ("gpt2", "llama"):
        is_llama = family == "llama"
        cfg, npos, params, eng = prefix_models(family, "int8")
        check(eng.decode_kernel_mode == "mega", "int8 left the mega path")
        plain = DecodeEngine(params, cfg, max_seq=npos, dtype="int8",
                             decode_kernel="xla")
        rng = np.random.default_rng(22)
        # 4 chunks and a 14-token tail: the tail takes the int8 kernels
        prompt = rng.integers(0, cfg.vocab_size, 4 * PREFIX_CHUNK + 14)
        forced = rng.integers(0, cfg.vocab_size, 32).tolist()
        pce = PrefixCachingEngine(eng, capacity=4, chunk=PREFIX_CHUNK)
        shapes0 = eng.forward_shapes()
        cuda_build.reset_launch_counts()
        cold = pce.generate(prompt, PREFIX_NEW).tokens
        hit = pce.generate(prompt, PREFIX_NEW).tokens
        counts = cuda_build.launch_counts()
        shapes = {f"{b}x{t}": n - shapes0.get((b, t), 0)
                  for (b, t), n in eng.forward_shapes().items()
                  if n != shapes0.get((b, t), 0)}
        want = expected_launches(shapes, is_llama, 1)
        check(counts == want, f"{family} int8 prefix: launches {counts}, "
                              f"expected {want} from {shapes}")
        check(np.array_equal(cold, hit),
              f"{family} int8: the hit's stream differs from the cold walk's")
        check(pce.stats()["hits"] == 1, f"{family}: {pce.stats()}")
        lk = tf_prefix(pce, prompt, forced)
        lp = teacher_forced_logits(plain, prompt, forced)
        check(bool(torch.isfinite(lk).all()) and tuple(lk.shape) == (
            len(forced), cfg.vocab_size), f"{family}: bad logits")
        rep = graftnum.compare("decode.int8", lk, lp)
        out[f"{family} int8 in process"] = counts
        print(f"  {family} int8 mega through the store: hit stream equal to "
              f"the cold walk's; teacher-forced (a hit) vs the int8 plain "
              f"path: logit_mse={rep['logit_mse']:.3e} (cap "
              f"{rep['policy']['logit_mse']:.0e}) top1_agreement="
              f"{rep['top1_agreement']:.4f}; forwards {shapes}; launches "
              f"{counts} [{smi}]")
        del plain
        # time to first token, cold against a hit, int8 mega
        shared = PREFIX_CHUNK * (48 if is_llama else 12)
        long = rng.integers(0, cfg.vocab_size, shared + 32)
        hot = PrefixCachingEngine(eng, capacity=2, chunk=PREFIX_CHUNK)
        hot.prefill_state(long)        # stores the 768 / 3072-token entry
        walks = {"cold": lambda: PrefixCachingEngine(
                     eng, capacity=2, chunk=PREFIX_CHUNK).prefill_state(long),
                 "hit": lambda: hot.prefill_state(long)}
        readings = {}
        for kind, walk in walks.items():
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                walk()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            readings[kind] = (statistics.median(walls), device_ms(walk))
        entry, = hot._store.values()
        nbytes = graftmem.measure(entry)
        clone = time_ms_events(lambda: clone_cache(entry))
        bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        print(f"  {family} int8 time to first token ({shared} shared + 32 "
              f"new tokens, chunk {PREFIX_CHUNK}): cold walk forwards "
              f"{len(long)} tokens, wall {readings['cold'][0]:.2f} ms, "
              f"device {fmt_ms(readings['cold'][1])} ms; hit forwards 32, "
              f"wall {readings['hit'][0]:.2f} ms, device "
              f"{fmt_ms(readings['hit'][1])} ms; the hit's entry clone "
              f"({tuple(entry.k.shape)} {str(entry.k.dtype)[6:]}, "
              f"{nbytes / 1e6:.1f} MB) {clone:.4f} ms vs bound "
              f"{bound:.4f} ms (read + write at 3.35 TB/s) [{smi}]")
        del eng, pce, hot, entry, params
        torch.cuda.empty_cache()
    return out


def device_ms(fn):
    """The device's kernel time for ``fn`` (ms, summed over the kernels
    ``torch.profiler`` records), or None when the profiler records no
    device time here."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        total += float(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0)))
    return total / 1e3 if total > 0 else None


def time_ms_events(fn, reps: int = 20) -> float:
    """Median device ms of ``fn`` between CUDA events, one call each."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tier_moves(smi: str) -> None:
    """The host tier's moves on the card (GPT-2 fp32 pool, 16-slot
    blocks): one 32-block entry (512 tokens) demoted and promoted, each
    timed, beside a pinned ``copy_`` of the same bytes each way, and the
    round trip bit-exact."""
    import torch

    from llm_sharding_demo_tpu_torch.runtime.kv_pool import KVBlockPool
    from llm_sharding_demo_tpu_torch.runtime.kv_tier import HostKVTier

    _, _, _, eng = prefix_models("gpt2", "float32")
    pool = KVBlockPool.for_engine(eng, num_blocks=TIER_BLOCKS,
                                  block_size=PAGED_BS)
    tier = HostKVTier(TIER_BLOCKS)
    pool.attach_tier(tier)
    n = TIER_PROMPT // PAGED_BS
    a = pool.allocator
    demote, promote = [], []
    for i in range(5):
        ids = a.alloc(n)
        pool.data[:, ids] = torch.randn_like(pool.data[:, ids])
        before = pool.data[:, ids]
        key = f"entry {i}".encode()
        a.register_prefix(key, ids)
        a.free(ids)
        t0 = time.perf_counter()
        check(tier.demote_lru(pool), "demote refused")
        demote.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        new = tier.promote(pool, key)
        torch.cuda.synchronize()
        promote.append((time.perf_counter() - t0) * 1e3)
        check(torch.equal(pool.data[:, list(new)], before),
              "a promoted entry differs from the demoted one")
        a.free(new)
        a.drop_prefix(key)
    nbytes = n * pool._bytes_per_block
    dev = torch.empty(nbytes // 4, dtype=torch.float32, device="cuda")
    host = torch.empty(nbytes // 4, dtype=torch.float32, pin_memory=True)

    def copy_ms(dst, src):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dst.copy_(src)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    d2h, h2d = copy_ms(host, dev), copy_ms(dev, host)
    print(f"  host tier, one {n}-block entry ({nbytes / 1e6:.1f} MB fp32): "
          f"demote {statistics.median(demote):.3f} ms vs a pinned copy_ "
          f"device->host {d2h:.3f} ms; promote "
          f"{statistics.median(promote):.3f} ms vs host->device "
          f"{h2d:.3f} ms (medians of 5); round trip bit-exact; tier "
          f"{tier.stats()} [{smi}]")
    del pool, eng
    torch.cuda.empty_cache()


def tier_prompts(seed: int):
    """Six 512-byte system prompts and, for each, a wave's four suffixes:
    the lead's 48 bytes, then 16-40."""
    rng = np.random.default_rng(seed)

    def text(n):
        return "".join(chr(int(c)) for c in rng.integers(97, 123, n))

    systems = [f"System prompt {i}: " + text(TIER_PROMPT - 16)
               for i in range(6)]
    suffixes = [[text(48)] + [text(int(k)) for k in rng.integers(16, 41, 3)]
                for _ in range(6)]
    return systems, suffixes


def tier_server(smi: str) -> None:
    """The pooled fp32 GPT-2 iter server with the prefix store and the
    host tier (MAX_BATCH=4 BATCH_MODE=iter MAX_SEQ=1024 KV_BLOCK_SIZE=16
    KV_POOL_BLOCKS=256 PREFIX_CACHE=8 KV_HOST_BLOCKS=256) beside the same
    server without the store and the tier. Six 512-token system prompts
    cycled three times, a wave of four requests on one prompt: the lead
    (a 48-byte suffix, 96 new tokens) seeds a batch, the other three
    (16-40-byte suffixes, 32 new tokens) arrive 0.1 s later and join it
    through the store. Replies equal the other server's; after every wave
    the tier is conserved and the pool holds only the registry's blocks;
    demotions and promotions > 0."""
    systems, suffixes = tier_prompts(31)
    waves = [(w % 6) for w in range(18)]
    knobs = dict(MODEL_ID="gpt2", INFERENCE_DTYPE="float32",
                 MAX_SEQ=str(NPOS), MAX_BATCH="4", BATCH_MODE="iter",
                 BATCH_WAIT_MS="5", KV_BLOCK_SIZE=str(PAGED_BS),
                 KV_POOL_BLOCKS=str(TIER_BLOCKS))
    replies = {}
    for label, extra in (("tiered", dict(PREFIX_CACHE="8",
                                         KV_HOST_BLOCKS=str(TIER_BLOCKS))),
                         ("plain", {})):
        t_server = time.perf_counter()
        with serving_process(f"prefix-{label}", **knobs, **extra) as (
                base, health):
            check(health["decode_kernel"] == "xla", f"healthz {health}")
            got = []
            for wi, s in enumerate(waves):
                bodies = [{"prompt": systems[s] + suf, "mode": "greedy",
                           "max_new_tokens": 96 if j == 0 else 32}
                          for j, suf in enumerate(suffixes[s])]
                res = _threads(lambda i: _http(base + "/generate", bodies[i],
                                               timeout=600),
                               4, [0.0, 0.1, 0.1, 0.1])
                got.append([r["generated"] for r in res])
                if not extra:
                    continue
                deadline = time.monotonic() + 10
                while True:
                    h = _http(base + "/healthz")
                    ps = h["kv_pool_stats"]
                    if ps["blocks_in_use"] == ps["blocks_evictable"]:
                        break
                    check(time.monotonic() < deadline,
                          f"wave {wi}: a row's blocks left in the pool {ps}")
                    time.sleep(0.05)
                tier = ps["tier"]
                check(tier["host_entries"] == tier["demotions"]
                      - tier["promotions"] - tier["discards"]
                      and tier["host_blocks_in_use"]
                      <= tier["host_blocks_total"],
                      f"wave {wi}: tier not conserved {tier}")
            wall = time.perf_counter() - t_server
            if extra:
                st = h["prefix_cache_stats"]
                check(tier["demotions"] > 0 and tier["promotions"] > 0,
                      f"no demotion or promotion: {tier}")
                check(h["batch_stats"]["joins"] > 0 and st["hits"] > 0,
                      f"no store-backed join: {h['batch_stats']} {st}")
                per = tier["promote_ms_total"] / max(tier["promotions"], 1)
                print(f"  tiered fp32 iter server, 18 waves of 4 on six "
                      f"{TIER_PROMPT}-token system prompts: prefix "
                      f"{st}; tier {tier} (promote {per:.3f} ms an entry, "
                      f"wall clock); pool {ps['blocks_in_use']} blocks in "
                      f"use = the registry's {ps['blocks_evictable']}; "
                      f"batcher {h['batch_stats']}; {wall:.1f} s with "
                      f"startup [{smi}]")
            replies[label] = got
    same = sum(a == b for wa, wb in zip(replies["tiered"], replies["plain"])
               for a, b in zip(wa, wb))
    check(same == 4 * len(waves),
          f"tiered server: {4 * len(waves) - same} replies differ from the "
          "server without the store")
    print(f"  tiered server: all {same} replies equal the server without "
          f"PREFIX_CACHE and KV_HOST_BLOCKS [{smi}]")


def prefix_server(smi: str) -> dict:
    """An int8 GPT-2 admission server with the store (PREFIX_CACHE=8
    MAX_BATCH=8, chunk 64): a wave of 8 greedy requests on a shared
    system prompt, then the same wave again (warm); warm replies equal
    the cold ones, hits counted in /healthz, each wave's launches exactly
    what its forwards must show. Returns the server's launch counts."""
    rng = np.random.default_rng(41)
    system = "You answer briefly and exactly. " + "".join(
        chr(int(c)) for c in rng.integers(97, 123, 200))
    bodies = [{"prompt": system + f" Question {i}: " + "xyz"[:i % 3],
               "max_new_tokens": 24, "mode": "greedy"} for i in range(8)]
    knobs = dict(MODEL_ID="gpt2", INFERENCE_DTYPE="int8", MAX_SEQ=str(NPOS),
                 MAX_BATCH="8", BATCH_MODE="admission", BATCH_WAIT_MS="100",
                 PREFIX_CACHE="8")
    with serving_process("prefix-int8-admission", **knobs) as (base,
                                                                health):
        check(health["decode_kernel"] == "mega"
              and health["prefix_cache"] == 8, f"healthz {health}")
        waves = []
        for kind in ("cold", "warm"):
            h0 = _http(base + "/healthz")
            res = _threads(lambda i: _http(base + "/generate", bodies[i],
                                           timeout=600), len(bodies))
            h1 = _http(base + "/healthz")
            shapes = {k: v - h0["forward_shapes"].get(k, 0)
                      for k, v in h1["forward_shapes"].items()
                      if v != h0["forward_shapes"].get(k, 0)}
            got = {k: v - h0["kernel_launches"][k]
                   for k, v in h1["kernel_launches"].items()}
            want = expected_launches(shapes, False, 2)
            check(got == want, f"int8 prefix server {kind} wave: launches "
                               f"{got}, expected {want} from {shapes}")
            st = {k: h1["prefix_cache_stats"][k]
                  - h0["prefix_cache_stats"][k] for k in ("hits", "misses")}
            waves.append([r["generated"] for r in res])
            print(f"  int8 GPT-2 admission server with the store, {kind} "
                  f"wave of 8: prefix {st}; forwards {shapes}; launches "
                  f"{got} [{smi}]")
        check(waves[0] == waves[1], "warm replies differ from the cold ones")
        check(h1["prefix_cache_stats"]["hits"] > 0,
              f"no hit counted: {h1['prefix_cache_stats']}")
        counts = h1["kernel_launches"]
    print(f"  int8 prefix server: warm wave equal to the cold wave; "
          f"launches {counts} [{smi}]")
    return counts


def prefix_phase(smi: str) -> dict:
    """The prefix cache and the host tier (module docstring, phase 9).
    Returns the launch counts of the prefix paths."""
    t0 = time.perf_counter()
    prefix_fp32_streams(smi)
    launches = prefix_int8(smi)
    tier_moves(smi)
    tier_server(smi)
    launches["GPT-2 int8 admission server"] = prefix_server(smi)
    print(f"  [prefix] {time.perf_counter() - t0:.1f} s wall [{smi}]")
    return launches


# -- phase 10: speculative decoding ------------------------------------------

SPEC_K = 6          # SPEC_DECODE: the served default draft depth
SPEC_NEW = 48       # new tokens of the in-process spec streams
SPEC_SEQ = 1024     # max_seq of the in-process spec engines (both families)


def spec_prompts(vocab: int, seed: int):
    """A repetitive 40-token prompt (drafts get accepted) and a random
    one (they mostly do not)."""
    rng = np.random.default_rng(seed)
    period = rng.integers(0, vocab, 8)
    return {"repetitive": np.tile(period, 5),
            "random": rng.integers(0, vocab, 40)}


def expected_spec_launches(shapes: dict, is_llama: bool) -> dict:
    """The launch counts a spec engine's forwards must show from its
    ``forward_shapes`` (``{(B, T): forwards}``): a forward of <= 16 rows
    in all runs the int8 linear at every projection (llama: 7 a layer
    and the untied head) and GPT-2's tied head kernel; attention is plain
    and no whole-stack or decode-attention kernel runs."""
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.ops.quant import MAX_KERNEL_ROWS

    want = {k.name: 0 for k in cuda_build.KERNELS}
    for (b, t), n in shapes.items():
        if b * t <= MAX_KERNEL_ROWS:
            want["quant_linear"] += (7 * L + 1 if is_llama else 4 * L) * n
            if not is_llama:
                want["quant_head"] += n
    return want


def spec_hold(eng, prompt, got, want, what: str, smi: str) -> bool:
    """Equal to the plain stream, or parted from it only at a near tie
    (``hold_row``'s greedy rule on the plain path's teacher-forced
    logits)."""
    if np.array_equal(got, want):
        return True
    n = len(prompt)
    check(hold_row(eng, eng, [list(prompt)], 0, got[n:], want[n:], what,
                   smi, greedy=True),
          f"{what}: the spec stream parted from the plain one away from a "
          "near tie")
    return False


def spec_fp32(smi: str) -> None:
    """fp32 greedy spec streams against the same plain engine's, both
    families at full width: solo (a repetitive and a random prompt, with
    tokens per verify), 4 ragged rows batched, the iteration batcher with
    a mid-flight join, the pooled iteration batcher under preemption."""
    import torch

    from llm_sharding_demo_tpu_torch.models import gpt2, llama
    from llm_sharding_demo_tpu_torch.runtime.engine import SamplingConfig
    from llm_sharding_demo_tpu_torch.runtime.iterbatch import (
        IterBatchingEngine)
    from llm_sharding_demo_tpu_torch.runtime.kv_pool import KVBlockPool
    from llm_sharding_demo_tpu_torch.runtime.spec_decode import (
        SpecDecodeEngine)

    flagged = SamplingConfig(spec=True)
    for family in ("gpt2", "llama"):
        model = llama if family == "llama" else gpt2
        cfg = (llama.CONFIGS["llama-124m"] if family == "llama"
               else gpt2.CONFIGS["gpt2"])
        params = model.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        spec = SpecDecodeEngine(params, cfg, max_seq=SPEC_SEQ,
                                draft_len=SPEC_K)
        eng = spec.plain
        check(eng.decode_kernel_mode == "xla", "fp32 left the plain path")
        prompts = spec_prompts(cfg.vocab_size, 23)
        rng = np.random.default_rng(24)

        def plain(p, n=SPEC_NEW):
            return eng.generate(np.asarray(p)[None], n).tokens[0]

        same, total, notes = 0, 0, []
        for kind, p in prompts.items():
            r = spec.generate(p, SPEC_NEW)
            total += 1
            same += spec_hold(eng, p, r.tokens[0], plain(p),
                              f"{family} fp32 solo {kind}", smi)
            notes.append(f"{kind} prompt {(SPEC_NEW - 1) / r.verify_steps:.2f}"
                         f" tokens a verify ({r.verify_steps} verifies)")
        ragged = [prompts["repetitive"][:24], prompts["random"],
                  rng.integers(0, cfg.vocab_size, 9),
                  np.tile(prompts["random"][:3], 6)]
        r = spec.generate(ragged, SPEC_NEW)
        for i, p in enumerate(ragged):
            total += 1
            same += spec_hold(eng, p, r.row_tokens(i), plain(p),
                              f"{family} fp32 batched row {i}", smi)
        ib = IterBatchingEngine(eng, max_batch=4, seg_steps=14,
                                max_wait_ms=20.0, spec=spec)
        pa, pb = prompts["repetitive"], rng.integers(0, cfg.vocab_size, 12)
        done = []

        def join(i):
            if i:
                t_end = time.monotonic() + 60
                while (ib.stats()["segments"] < 1
                       and time.monotonic() < t_end):
                    time.sleep(0.001)
            return ib.generate((pa, pb)[i], (96, 40)[i], sampling=flagged,
                               timeout=600).tokens[0]
        for i, got in enumerate(_threads(join, 2)):
            total += 1
            p = (pa, pb)[i]
            same += spec_hold(eng, p, got, plain(p, (96, 40)[i]),
                              f"{family} fp32 iter row {i}", smi)
        st = ib.stats()
        check(st["joins"] >= 1 and st["spec_segments"] >= 2,
              f"{family} spec iter batcher: no mid-flight join: {st}")
        # a pool of one full row: the two rows outgrow it together
        pool = KVBlockPool.for_engine(eng, num_blocks=SPEC_SEQ // PAGED_BS,
                                      block_size=PAGED_BS, watermark=1.0)
        pib = IterBatchingEngine(eng, max_batch=4, seg_steps=14,
                                 max_wait_ms=200.0, spec=spec, pool=pool)
        pc, pd = prompts["repetitive"][:16], rng.integers(0, cfg.vocab_size,
                                                          60)
        budgets = (600, 560)
        got = _threads(lambda i: pib.generate(
            (pc, pd)[i], budgets[i], sampling=flagged,
            timeout=600).tokens[0], 2)
        for i, g in enumerate(got):
            total += 1
            p = (pc, pd)[i]
            same += spec_hold(eng, p, g, plain(p, budgets[i]),
                              f"{family} fp32 pooled iter row {i}", smi)
        pst = pib.stats()
        check(pst["preemptions"] >= 1 and pst["resumes"] >= 1
              and pool.allocator.stats().blocks_in_use == 0,
              f"{family} pooled spec iter: no preemption or a leak: {pst}")
        print(f"  {family} fp32 spec (K={SPEC_K}) vs the plain engine: "
              f"{same}/{total} greedy streams byte-equal (solo x2, 4 ragged "
              f"rows, iter batcher with a join, pooled iter under "
              f"{pst['preemptions']} preemptions), the rest parted at a "
              f"near tie; solo {', '.join(notes)}; iter {st}; pooled "
              f"{pst} [{smi}]")
        del spec, eng, ib, pib, pool, params
        torch.cuda.empty_cache()


def spec_windows_logits(eng, prompt, forced, k: int):
    """f32 logits ``[len(forced), vocab]``, teacher-forced in verify
    windows: row 0 from the prefill, then ``forced`` in windows of k + 1
    tokens (each forward's logits predict the window's next tokens)."""
    import torch

    with torch.inference_mode():
        cache = eng._fresh_cache(1)
        logits, cache = eng._forward_cached(eng._ids([list(prompt)]), cache,
                                            None)
        rows = [logits[0, -1:]]
        for w0 in range(0, len(forced) - 1, k + 1):
            window = forced[w0:w0 + k + 1]
            logits, cache = eng._forward_cached(eng._ids([window]), cache,
                                                None)
            rows.append(logits[0])
    return torch.cat(rows)[:len(forced)].float()


def verify_ms(spec, prompt, steps: int = 20):
    """``(eager_ms, device_ms)`` of one verify (a K+1-token forward of
    one stream and its greedy acceptance): the host clock around
    ``steps`` eager verifies ending in a sync, and the device's time for
    one replayed from a CUDA graph. Every verify writes the same slots."""
    import torch

    from llm_sharding_demo_tpu_torch.runtime.engine import SamplingConfig

    eng, k = spec.plain, spec.draft_len
    with torch.inference_mode():
        cache = eng._fresh_cache(1)
        _, cache = eng._forward_cached(eng._ids([list(prompt)]), cache, None)
        x = eng._ids([list(prompt[-(k + 1):])])
        greedy = SamplingConfig()

        def step():
            logits, _ = eng._forward_cached(x, cache, None)
            spec._accept_patch(logits[0], x[0, 1:], None, greedy)

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


def spec_int8(smi: str) -> dict:
    """The int8 spec engine, both families at full width: one stream and
    two, launches exactly what ``forward_shapes`` predicts (48 int8
    linear launches and one tied head a GPT-2 verify window, 85 linear
    launches a llama window); teacher-forced verify-window logits of the
    kernel path against the int8 plain path under ``decode.int8`` (a miss
    is printed with its numbers); then the verify's eager and device
    time, the host-sync share, tokens a verify and ms a token, beside
    the "auto" mega engine's step and the plain "xla" int8 step. Returns
    the launch counts."""
    import torch

    from llm_sharding_demo_tpu_torch.models import gpt2, llama
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.runtime.spec_decode import (
        SpecDecodeEngine)
    from llm_sharding_demo_tpu_torch.utils import graftnum

    out = {}
    for family in ("gpt2", "llama"):
        is_llama = family == "llama"
        model = llama if is_llama else gpt2
        cfg = (llama.CONFIGS["llama-124m"] if is_llama
               else gpt2.CONFIGS["gpt2"])
        params = model.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
        spec = SpecDecodeEngine(params, cfg, max_seq=SPEC_SEQ, dtype="int8",
                                draft_len=SPEC_K)
        eng = spec.plain
        check(eng.decode_kernel_mode == "xla" and eng.matmul_kernels,
              f"{family} int8 spec engine: {eng.decode_kernel_mode}")
        prompts = spec_prompts(cfg.vocab_size, 25)
        per_window = 7 * L + 1 if is_llama else 4 * L
        for streams in (1, 2):
            rows = [prompts["repetitive"], prompts["random"]][:streams]
            eng._forward_shapes.clear()
            cuda_build.reset_launch_counts()
            r = spec.generate(rows if streams > 1 else rows[0], SPEC_NEW)
            counts = cuda_build.launch_counts()
            shapes = eng.forward_shapes()
            want = expected_spec_launches(shapes, is_llama)
            windows = shapes.get((streams, SPEC_K + 1), 0)
            check(windows == r.verify_steps >= 1 and counts == want
                  and want["quant_linear"] == per_window * windows
                  and want["quant_head"] == (0 if is_llama else windows),
                  f"{family} int8 spec, {streams} stream(s): launches "
                  f"{counts}, expected {want} from {shapes}")
            out[f"{family} int8 spec, {streams} stream(s)"] = counts
            print(f"  {family} int8 spec, {streams} stream(s), {SPEC_NEW} "
                  f"new tokens: {windows} verify windows of "
                  f"{streams * (SPEC_K + 1)} rows, quant_linear "
                  f"{per_window} a window"
                  + ("" if is_llama else ", quant_head 1 a window")
                  + f"; forwards {shapes}; launches {counts} (as predicted)"
                  f" [{smi}]")
        plain = DecodeEngine(params, cfg, max_seq=SPEC_SEQ, dtype="int8",
                             decode_kernel="xla")
        check(not plain.matmul_kernels, "the plain int8 reference engine")
        rng = np.random.default_rng(26)
        prompt = rng.integers(0, cfg.vocab_size, 40).tolist()
        forced = rng.integers(0, cfg.vocab_size, 43).tolist()
        cuda_build.reset_launch_counts()
        lp = spec_windows_logits(plain, prompt, forced, SPEC_K)
        check(all(v == 0 for v in cuda_build.launch_counts().values()),
              "the plain int8 engine launched a kernel")
        lk = spec_windows_logits(eng, prompt, forced, SPEC_K)
        check(bool(torch.isfinite(lk).all()) and lk.shape == lp.shape == (
            len(forced), cfg.vocab_size), f"{family}: bad window logits")
        try:
            rep = graftnum.compare("decode.int8", lk, lp)
            verdict = "within"
        except graftnum.GraftnumError as e:
            rep, verdict = e.report, "MISSES"
        print(f"  {family} int8 verify windows (K+1 = {SPEC_K + 1} rows), "
              f"kernel path vs the int8 plain path, {rep['n_positions']} "
              f"teacher-forced positions: logit_mse {rep['logit_mse']:.3e} "
              f"top1 {rep['top1_agreement']:.4f}, {verdict} decode.int8 "
              f"(cap {rep['policy']['logit_mse']:.0e}, floor "
              f"{rep['policy']['top1_agreement']}) [{smi}]")
        # timing: a verify, the host sync inside the loop, and the
        # single-token steps it competes with
        sync = [0.0]
        fetch = spec._fetch

        def timed_fetch(*a):
            t = time.perf_counter()
            try:
                return fetch(*a)
            finally:
                sync[0] += time.perf_counter() - t
        spec._fetch = timed_fetch
        auto = DecodeEngine(params, cfg, max_seq=SPEC_SEQ, dtype="int8")
        check(auto.decode_kernel_mode == "mega", "int8 'auto' is not mega")
        ids = np.asarray(prompts["random"])[None]
        mega_eager, mega_device = step_ms(auto, ids)
        xla_eager, xla_device = step_ms(plain, ids)
        v_eager, v_device = verify_ms(spec, prompts["random"])
        auto.generate(ids, 8)
        mega_tok = auto.generate(ids, SPEC_NEW).per_token_latency * 1e3
        for kind, p in prompts.items():
            spec.generate(p, 8)                       # warm
            sync[0] = 0.0
            r = spec.generate(p, SPEC_NEW)
            wall = r.decode_seconds * 1e3 / r.verify_steps
            per_tok = r.decode_seconds * 1e3 / (SPEC_NEW - 1)
            print(f"  {family} int8 spec timing, {kind} prompt: "
                  f"{(SPEC_NEW - 1) / r.verify_steps:.2f} tokens a verify, "
                  f"verify wall {wall:.3f} ms (host sync "
                  f"{sync[0] / r.decode_seconds:.1%} of it), "
                  f"{per_tok:.3f} ms a token; one verify {v_eager:.3f} ms "
                  f"eager vs {v_device:.3f} ms device; mega step "
                  f"{mega_eager:.3f} ms eager vs {mega_device:.3f} ms "
                  f"device ({mega_tok:.3f} ms a token in generate); plain "
                  f"int8 step {xla_eager:.3f} ms eager vs {xla_device:.3f} "
                  f"ms device [{smi}]")
        del spec, eng, plain, auto, params
        torch.cuda.empty_cache()
    return out


def spec_server(smi: str) -> dict:
    """``SPEC_DECODE=6`` GPT-2 int8 server (MAX_SEQ=1024): four
    /generate requests (greedy and seeded sampled, twice each) answered,
    the greedy reply equal to an in-process spec engine on the same
    weights, ``spec_decode_stats`` in /healthz, launches exactly what
    its forwards predict. Returns the server's launch counts."""
    import torch

    from llm_sharding_demo_tpu_torch.runtime.spec_decode import (
        SpecDecodeEngine)
    from llm_sharding_demo_tpu_torch.serving import loader
    from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig

    prompt = "the spec server, the spec server, the spec server: "
    greedy = {"prompt": prompt, "max_new_tokens": 24, "mode": "greedy"}
    sample = {"prompt": prompt, "max_new_tokens": 24, "mode": "sample",
              "seed": 99}
    with serving_process("server-spec", MODEL_ID="gpt2",
                         INFERENCE_DTYPE="int8", MAX_SEQ=str(NPOS),
                         SPEC_DECODE=str(SPEC_K)) as (base, health):
        check(health["spec_decode"] == SPEC_K
              and health["decode_kernel"] == "xla"
              and "spec_decode_stats" in health, f"healthz {health}")
        replies = [_http(base + "/generate", b)
                   for b in (greedy, greedy, sample, sample)]
        health = _http(base + "/healthz")
    for r in replies:
        check(isinstance(r.get("generated"), str)
              and r["generated"].startswith(prompt), f"bad reply {r}")
    check(replies[0] == replies[1] and replies[2] == replies[3],
          f"replies do not replay: {replies}")
    st = health["spec_decode_stats"]
    counts = health["kernel_launches"]
    shapes = {tuple(int(v) for v in key.split("x")): n
              for key, n in health["forward_shapes"].items()}
    want = expected_spec_launches(shapes, False)
    check(st["requests"] == 4 and st["verify_steps"] > 0
          and counts == want and counts["quant_linear"] > 0
          and counts["quant_head"] > 0,
          f"spec server: stats {st}, launches {counts}, expected {want} "
          f"from {shapes}")
    cfg = ServingConfig(model_id="gpt2", inference_dtype="int8",
                        max_seq=NPOS)
    config, params = loader.resolve_model(cfg, torch.device("cuda"))
    spec = SpecDecodeEngine(params, config, max_seq=NPOS, dtype="int8",
                            draft_len=SPEC_K)
    tok = ByteTokenizer()
    ref = spec.generate(np.asarray(tok.encode(prompt)), 24)
    check(replies[0]["generated"] == tok.decode(
        [int(t) for t in ref.row_tokens(0)]),
          "spec server greedy reply differs from the in-process spec engine")
    print(f"  GPT-2 int8 SPEC_DECODE={SPEC_K} server: 4 /generate answered "
          f"(greedy and seeded replays equal, greedy equal to the "
          f"in-process spec engine); spec_decode_stats {st}; forwards "
          f"{health['forward_shapes']}; launches {counts} (as predicted) "
          f"[{smi}]")
    del spec, params
    torch.cuda.empty_cache()
    return counts


def spec_phase(smi: str) -> dict:
    """Speculative decoding (module docstring, phase 10). Returns the
    launch counts of the spec paths."""
    t0 = time.perf_counter()
    spec_fp32(smi)
    launches = spec_int8(smi)
    launches["GPT-2 int8 SPEC_DECODE=6 server"] = spec_server(smi)
    print(f"  [spec] {time.perf_counter() - t0:.1f} s wall [{smi}]")
    return launches


# -- phase 11: remote dispatch ----------------------------------------------

REMOTE_PROMPT = "Hi"   # short: shard B answers the logits of every position
REMOTE_NEW = 16


def _post(url: str, body: dict, headers=None, timeout: float = 300.0):
    """``(status, body, headers)`` of one POST; an error status is
    returned, not raised."""
    import urllib.error

    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read()), dict(e.headers)


def relay_reference(params, config, prompt_ids, seed: int):
    """What the three-role topology must answer, computed here with the
    shards' own functions on the same weights: per token, stage A and
    stage B (``stage_apply``, the whole sequence re-forwarded) with the
    hidden states handed over as a fresh float32 tensor, as they arrive
    from JSON. Returns the greedy ids with each step's last-position
    logits, the seeded sample ids (one ``default_rng(seed)`` draw a token
    from ``sampler_pmf``, the coordinator's contract), the last greedy
    hop's JSON messages (A's request, A's reply, B's reply) and the JSON
    bytes of a token's four messages (A's request and reply, B's request
    and reply) at the first and the last token."""
    import torch

    from llm_sharding_demo_tpu_torch.parallel import partition as P_
    from llm_sharding_demo_tpu_torch.runtime.engine import (SamplingConfig,
                                                            sampler_pmf)

    specs = P_.make_stage_specs(config.n_layer, [1])
    stages = [P_.extract_stage_params(params, s) for s in specs]

    def hops(ids):
        """The two hops of one token: A's request and reply as JSON
        values, and B's logits."""
        with torch.inference_mode():
            x = torch.tensor([ids], dtype=torch.int64, device="cuda")
            hidden, _ = P_.stage_apply(stages[0], specs[0], config, x)
            hidden = hidden.float().cpu().tolist()
            logits, _ = P_.stage_apply(
                stages[1], specs[1], config,
                torch.tensor(hidden, dtype=torch.float32, device="cuda"))
        return {"input_ids": list(ids)}, {"hidden_states": hidden}, logits

    sampling = SamplingConfig(mode="sample")
    rng = np.random.default_rng(seed)
    greedy, sample, steps, hop_bytes = (list(prompt_ids), list(prompt_ids),
                                        [], [])
    for step in range(REMOTE_NEW):
        a_req, a_rep, logits = hops(greedy)
        # float32 -> double is exact: the values the coordinator parses
        last = logits[0, -1].cpu().double().numpy()
        steps.append(last)
        greedy.append(int(np.argmax(last)))
        if step in (0, REMOTE_NEW - 1):
            msgs = (a_req, a_rep, {"logits": logits.cpu().tolist()})
            h = len(json.dumps(a_rep))
            hop_bytes.append((len(json.dumps(a_req)), h, h,
                              len(json.dumps(msgs[2]))))
        logits = hops(sample)[2][0, -1].cpu().double()
        probs, top = sampler_pmf(logits, sampling)
        probs = probs.numpy().astype(np.float64)
        sample.append(int(rng.choice(top.numpy(), p=probs / probs.sum())))
    return greedy, steps, sample, msgs, hop_bytes


def remote_phase(smi: str) -> dict:
    """``DISPATCH=remote`` (module docstring, phase 11). Returns each
    process's launch counts."""
    import torch

    from llm_sharding_demo_tpu_torch.parallel.pipeline import PipelineRunner
    from llm_sharding_demo_tpu_torch.serving import loader
    from llm_sharding_demo_tpu_torch.serving.app import create_app
    from llm_sharding_demo_tpu_torch.serving.http import TestClient
    from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig

    t0 = time.perf_counter()
    # the servers' weights (seed 0) in this process: the relay's exact
    # streams, and the local fp32 path's
    config, params = loader.resolve_model(ServingConfig(model_id="gpt2"),
                                          torch.device("cuda"))
    tok = ByteTokenizer()
    prompt_ids = tok.encode(REMOTE_PROMPT)
    n = len(prompt_ids)
    seed = 4321
    g_ids, steps, s_ids, last_hop, hop_bytes = relay_reference(
        params, config, prompt_ids, seed)
    l_ids = [int(t) for t in PipelineRunner(
        params, config, [1], max_seq=NPOS).generate(
        np.asarray(prompt_ids), REMOTE_NEW).row_tokens(0)]
    local = TestClient(create_app(
        ServingConfig(model_id="gpt2", max_seq=NPOS), model=(config, params),
        tokenizer=tok))
    greedy = {"prompt": REMOTE_PROMPT, "max_new_tokens": REMOTE_NEW,
              "mode": "greedy"}
    local_reply = local.post("/generate", json=greedy).json()
    check(local_reply["generated"] == tok.decode(l_ids),
          "the local fp32 server's reply differs from its runner's stream")
    del local
    t_ref = time.perf_counter() - t0

    pa, pb = _free_port(), _free_port()
    shard = {"MODEL_ID": "gpt2", "SPLIT_AT": "1"}
    sample = dict(greedy, mode="sample", seed=seed)
    with serving_processes(
            ("remote-shard-a", dict(shard, SHARD_ROLE="a",
                                    SHARD_PORT=str(pa))),
            ("remote-shard-b", dict(shard, SHARD_ROLE="b",
                                    SHARD_PORT=str(pb))),
            ("remote-coordinator", dict(
                shard, DISPATCH="remote",
                SHARD_A_SERVICE=f"127.0.0.1:{pa}",
                SHARD_B_SERVICE=f"127.0.0.1:{pb}")),
    ) as [(a_url, a_health, _), (b_url, b_health, stop_b),
          (base, health, _)]:
        t_up = time.perf_counter() - t0 - t_ref
        for role, h in (("a", a_health), ("b", b_health)):
            check(h["role"] == role and h["device"].startswith("cuda"),
                  f"shard {role} healthz {h}")
        check(health["dispatch"] == "remote"
              and health["decode_kernel"] is None
              and health["forward_shapes"] == {},
              f"the remote coordinator must hold no engine: {health}")
        # the first greedy request alone (the relay's ms a token), then
        # its replay and the two seeded ones at once
        bodies = (greedy, greedy, sample, sample)

        def ask(i):
            t = time.perf_counter()
            status, reply, hdrs = _post(base + "/generate", bodies[i],
                                        {"X-Request-ID": f"smoke-{i}"})
            check(status == 200 and hdrs.get("X-Request-ID") == f"smoke-{i}",
                  f"remote reply {status} {reply} {hdrs}")
            return reply, time.perf_counter() - t

        out = [ask(0)] + _threads(lambda i: ask(i + 1), 3)
        replies = [r for r, _ in out]
        ms_tok = out[0][1] * 1e3 / REMOTE_NEW
        # the last greedy token's two hops, straight to the shards: the
        # JSON each answers is exactly what its function gives here
        hidden = _http(a_url + "/forward", last_hop[0])
        check(hidden == last_hop[1], "shard a's /forward differs from "
                                     "stage_apply run here")
        check(_http(b_url + "/forward_b", hidden) == last_hop[2],
              "shard b's /forward_b differs from stage_apply run here")
        counts = {role: _http(url + "/healthz")["kernel_launches"]
                  for role, url in (("shard a", a_url), ("shard b", b_url),
                                    ("coordinator", base))}
        # shard b goes down: 3 failed attempts (a typed 502 naming it),
        # then the fifth consecutive failure opens its breaker (503 +
        # Retry-After); a 1 ms budget is spent on the first hop
        stop_b()
        failures = []
        for i, (hdr, want_status, want_error) in enumerate((
                ({}, 502, "upstream_failure"), ({}, 503, "circuit_open"),
                ({"X-Deadline-Ms": "1"}, 503, "deadline_exceeded"))):
            rid = f"smoke-fail-{i}"
            status, body, hdrs = _post(base + "/generate",
                                       dict(greedy, max_new_tokens=2),
                                       dict(hdr, **{"X-Request-ID": rid}))
            check(status == want_status and body.get("error") == want_error
                  and hdrs.get("X-Request-ID") == rid
                  and (status != 503 or int(hdrs["Retry-After"]) >= 1)
                  and (status != 502 or body.get("shard") == "b"),
                  f"with shard b down: {status} {body} {hdrs}, expected "
                  f"{want_status} {want_error}")
            failures.append(f"{status} {body['error']}"
                            + (f" (shard {body['shard']})" if status == 502
                               else f", Retry-After {hdrs['Retry-After']}"))
    for where, c in counts.items():
        check(all(v == 0 for v in c.values()),
              f"the fp32 remote path launched kernels on {where}: {c}")
    check(replies[0] == replies[1] and replies[2] == replies[3],
          f"remote replies do not replay: {replies}")
    check(replies[0]["generated"] == tok.decode(g_ids),
          "remote greedy reply differs from the shards' functions run here")
    check(replies[2]["generated"] == tok.decode(s_ids),
          "remote seeded reply differs from the seed contract run here")
    same = g_ids == l_ids
    if not same:
        # the local path decodes on its KV cache, another GEMM shape than
        # the relay's re-forward: it may part from it only at a near tie
        t = next(i for i in range(n, n + REMOTE_NEW) if g_ids[i] != l_ids[i])
        top2 = np.sort(steps[t - n])[-2:]
        gap = float(top2[1] - top2[0])
        bar = 2 * (1e-5 + 1e-5 * float(np.abs(steps[t - n]).max()))
        print(f"  the relay's greedy stream parts from the local fp32 "
              f"path at new token {t - n}: its top-2 gap {gap:.3e}, near-tie "
              f"bar {bar:.3e} [{smi}]")
        check(gap <= bar, "the remote greedy stream parts from the local "
                          "fp32 path away from a near tie")
    print(f"  three-role GPT-2 124M fp32 (SPLIT_AT=1; shards on the card, "
          f"up in {t_up:.1f} s): greedy x2 equal to the shards' functions "
          f"run here, token for token"
          f"{' and equal to the local fp32 server' if same else ''}; seeded "
          f"sample x2 equal to the seed contract; both shards' JSON equal "
          f"to stage_apply here; launches 0 on all three processes")
    print(f"  relay ms a token: {ms_tok:.1f} (one greedy request alone, "
          f"{REMOTE_NEW} tokens from a {n}-token prompt; the other three "
          f"at once took {max(w for _, w in out[1:]):.1f} s); JSON bytes "
          f"a hop (A request, A reply, B request, B reply) at the first "
          f"token {hop_bytes[0]} and the last {hop_bytes[1]} [{smi}]")
    print(f"  shard b down: {'; '.join(failures)}; X-Request-ID echoed on "
          f"every reply [{smi}]")
    print(f"  [remote] {time.perf_counter() - t0:.1f} s wall [{smi}]")
    del params
    torch.cuda.empty_cache()
    return counts


# -- phase 12: checkpoints ----------------------------------------------------

def ckpt_room(directory: str, need: int) -> None:
    """Fail clearly where ``directory``'s file system lacks room for a
    ``need``-byte checkpoint (a quarter to spare)."""
    import shutil

    free = shutil.disk_usage(directory).free
    check(free > need * 1.25,
          f"{directory} has {free} bytes free; the checkpoint needs about "
          f"{need}")


def save_timed(directory: str, params, config):
    """``checkpoint.save`` -> (bytes written, seconds)."""
    from llm_sharding_demo_tpu_torch.utils import checkpoint

    t0 = time.perf_counter()
    checkpoint.save(directory, params, config)
    secs = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(d, f))
                 for d, _, files in os.walk(directory) for f in files)
    return nbytes, secs


def files_read(log_path: str):
    """The files a shard's stage restore read, from its log."""
    with open(log_path) as f:
        for line in f:
            if " read files " in line:
                return json.loads(line.split(" read files ", 1)[1])
    return None


def ckpt_phase(smi: str) -> dict:
    """``CHECKPOINT_DIR`` (module docstring, phase 12). Returns the
    coordinator's launch counts."""
    import shutil
    import tempfile

    import torch

    from llm_sharding_demo_tpu_torch.parallel import partition as P_
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.serving import loader
    from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig

    t0 = time.perf_counter()
    config, params = loader.resolve_model(ServingConfig(model_id="gpt2"),
                                          torch.device("cuda"))
    tmp = tempfile.mkdtemp(prefix="smoke-ckpt-")
    try:
        ckpt_room(tmp, weight_bytes(params))
        nbytes, secs = save_timed(tmp, params, config)
        print(f"  checkpoint.save of GPT-2 124M fp32 (seed 0): {nbytes} bytes "
              f"in {secs:.2f} s ({nbytes / secs / 1e9:.2f} GB/s) [{smi}]")
        tok = ByteTokenizer()
        prompt = "The checkpoint serves: "
        eng = DecodeEngine(params, config, max_seq=NPOS, dtype="int8",
                           boundaries=[1])
        check(eng.decode_kernel_mode == "mega",
              f"the int8 engine resolved to {eng.decode_kernel_mode}")
        want = tok.decode([int(t) for t in eng.generate(
            np.asarray(tok.encode(prompt)), 24).row_tokens(0)])
        del eng
        spec = P_.make_stage_specs(L, [1])[0]
        ids = tok.encode(prompt)
        with torch.inference_mode():
            hidden, _ = P_.stage_apply(
                P_.extract_stage_params(params, spec), spec, config,
                torch.tensor([ids], device="cuda"))
        want_hidden = hidden.float().cpu().tolist()
        del params, hidden
        torch.cuda.empty_cache()
        ckpt = {"CHECKPOINT_DIR": tmp, "MODEL_ID": "gpt2"}
        with serving_processes(
                ("ckpt-coordinator", dict(ckpt, INFERENCE_DTYPE="int8",
                                          MAX_SEQ=str(NPOS))),
                ("ckpt-shard-a", dict(ckpt, SHARD_ROLE="a")),
        ) as [(base, health, _), (a_url, a_health, _)]:
            check(health["decode_kernel"] == "mega" and health["n_stages"] == 2
                  and a_health["role"] == "a", f"healthz {health} {a_health}")
            got = _http(base + "/generate", {"prompt": prompt,
                                             "max_new_tokens": 24,
                                             "mode": "greedy"})
            got_hidden = _http(a_url + "/forward", {"input_ids": ids})
            health = _http(base + "/healthz")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(got["generated"] == want,
          "the CHECKPOINT_DIR int8 coordinator's greedy stream differs from "
          "the in-process int8 engine on the seeded weights")
    check(got_hidden["hidden_states"] == want_hidden,
          "shard a's /forward differs from stage_apply run here")
    read = files_read(os.path.join(LOG_DIR, "ckpt-shard-a.log"))
    check(read == ["params/blocks/0.pt", "params/wte.pt", "params/wpe.pt"],
          f"shard a read {read}")
    counts = health["kernel_launches"]
    want_counts = expected_launches(health["forward_shapes"], False, 2)
    check(counts == want_counts, f"coordinator launches {counts}, expected "
                                 f"{want_counts}")
    print(f"  CHECKPOINT_DIR int8 coordinator (mega): greedy 24 tokens equal "
          f"to the in-process int8 engine on the seeded weights; launches "
          f"{counts}; shard a: /forward bit-equal to stage_apply, read "
          f"{read}")
    print(f"  [ckpt] {time.perf_counter() - t0:.1f} s wall [{smi}]")
    return {"coordinator": counts}


# -- phase 13: the MoE family ------------------------------------------------

# the JAX package's MoE geometry (bench.py): GPT-2 124M's attention with 8
# experts a block, the top 2 taken
MOE_CFG = dict(vocab_size=V, n_positions=NPOS, n_embd=D, n_layer=L,
               n_head=H, n_experts=8, expert_top_k=2, capacity_factor=1.25)
MOE_WAVE = 8
MOE_WAVE_TOKENS = 64
MOE_TRAIN = (2, 256)     # batch, tokens of the f32 train steps


def expected_moe_launches(shapes: dict) -> dict:
    """The launches an int8 MoE "layer" engine's cached forwards must show
    (``{(B, T) or "BxT": forwards}``): decode attention on every layer of
    a single-token step; at <= 16 rows in all, the int8 linear at c_attn
    and c_proj of every layer (the router's 8 outputs and the experts
    take the plain matmul) and the int8 tied head once."""
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.ops.quant import MAX_KERNEL_ROWS

    want = {k.name: 0 for k in cuda_build.KERNELS}
    for key, n in shapes.items():
        b, t = ((int(v) for v in key.split("x")) if isinstance(key, str)
                else key)
        if t == 1:
            want["decode_attention"] += L * n
        if b * t <= MAX_KERNEL_ROWS:
            want["quant_linear"] += 2 * L * n
            want["quant_head"] += n
    return want


# Routing flips. Router logits are bf16 on the int8 paths, and the
# kernels round earlier activations apart from the plain path, so a token
# whose k-th and (k+1)-th router logits sit close may choose otherwise on
# the two paths. Such a flip is held to two bars: its gap (absolute, in
# router logits, as the recording path saw it) at most MOE_NEAR_TIE, and
# the flipped tokens at most MOE_FLIP_SHARE of all token routings of a
# run. On an H100 80GB HBM3 (700 W) the three held runs flip 0.52-0.66%
# of their token routings (5 of 756, 29 of 5628, 43 of 7920), at gaps of
# at most 2.54e-2; 2^-5 is 4 bf16 ulps of a logit in [1, 2) and 16 of
# one in [0.25, 0.5). Of the planted faults (MOE_FAULT_NOISE) at B=1,
# the wrong c_attn scale tile flips 2.51% and router noise of 2^-6 RMS
# 3.17% (the share bar catches both); noise of 2^-4 flips 8.60%, 23
# tokens past the gap bar (largest gap 0.127); noise of 2^-8, about a
# bf16 rounding, flips 1.98% and passes.
MOE_NEAR_TIE = 2.0 ** -5
MOE_FLIP_SHARE = 0.02
# planted faults on the int8 kernel path (moe_fault): gaussian noise on
# the router's input at these RMS fractions of the input's RMS, and the
# c_attn kernel's first 128-column tile scaled with its neighbour's
# scales (a wrong scale index)
MOE_FAULT_NOISE = (2.0 ** -8, 2.0 ** -6, 2.0 ** -4)


@contextlib.contextmanager
def routing_tape(tape: list, replay: bool = False):
    """Record each ``moe._topk_gates`` call's gates, choices and valid
    tokens on ``tape``, or, with ``replay``, make each call take the
    recorded choices in order (the weights from its own gates):
    teacher-forced routing, so that two paths' logits differ by their
    numerics alone. A replaying call's own choices are compared with the
    recorded ones at the valid tokens; yields the list of flips ``(call,
    tokens flipped, largest recorded logit gap among them)``."""
    import torch

    from llm_sharding_demo_tpu_torch.models import moe

    real = moe._topk_gates
    flips, pos = [], [0]

    def record(gates, e, k, token_valid=None):
        out = real(gates, e, k, token_valid)
        tape.append((gates.detach().clone(), [i.clone() for i in out[0]],
                     None if token_valid is None else token_valid.clone()))
        return out

    def forced(gates, e, k, token_valid=None):
        want_gates, want, _ = tape[pos[0]]
        own = real(gates, e, k, token_valid)[0]
        differ = choices_differ(own, want, token_valid)
        if differ is not None:
            # the recorded path's logit gap between its k-th and (k+1)-th
            # choice, at each flipped token
            logits = want_gates.clamp_min(1e-30).log()
            top = logits.topk(k + 1, dim=-1).values
            gap = (top[..., k - 1] - top[..., k])[differ]
            flips.append((pos[0], int(differ.sum()), float(gap.max())))
        pos[0] += 1
        sel_gates, idxs, onehots, weights = gates, [], [], []
        for idx in want:
            oh = moe._one_hot(idx, e, gates.dtype)
            if token_valid is not None:
                oh = oh * token_valid[..., None].to(gates.dtype)
            idxs.append(idx)
            onehots.append(oh)
            weights.append((sel_gates * oh).sum(-1))
            sel_gates = sel_gates * (1.0 - oh)
        w = torch.stack(weights)
        w = w / torch.clamp(w.sum(0, keepdim=True), min=1e-9)
        return idxs, onehots, w

    moe._topk_gates = forced if replay else record
    try:
        yield flips
    finally:
        moe._topk_gates = real


def choices_differ(own, want, token_valid=None):
    """A ``[B, S]`` mask of the valid tokens whose choice sets differ, or
    None."""
    import torch

    a = torch.sort(torch.stack(own), dim=0).values
    b = torch.sort(torch.stack(want), dim=0).values
    mask = (a != b).any(0)
    if token_valid is not None:
        mask = mask & token_valid
    return mask if bool(mask.any()) else None


def routed_tokens(tape: list) -> int:
    """Token routings on ``tape``: its valid tokens, summed over calls."""
    return sum(g.shape[0] * g.shape[1] if v is None else int(v.sum())
               for g, _, v in tape)


def flip_reading(flips: list, tape: list) -> dict:
    """The flips of a replay against its tape, under both bars."""
    tokens = sum(f[1] for f in flips)
    share = tokens / routed_tokens(tape)
    wide = [f for f in flips if f[2] > MOE_NEAR_TIE]
    return {"calls": len(flips), "tokens": tokens, "share": share,
            "largest_gap": max((f[2] for f in flips), default=0.0),
            "past_bar": sum(f[1] for f in wide),
            "held": not wide and share <= MOE_FLIP_SHARE}


def flip_text(r: dict) -> str:
    return (f"{r['tokens']} flipped tokens in {r['calls']} routings "
            f"(share {r['share']:.4%}, bar {MOE_FLIP_SHARE:.0%}), largest "
            f"gap {r['largest_gap']:.3e}, {r['past_bar']} past "
            f"{MOE_NEAR_TIE:.3e}")


@contextlib.contextmanager
def moe_fault(kind: str, cfg, level: float = 0.0):
    """A planted fault on the int8 kernel path: ``"router"`` adds seeded
    gaussian noise at ``level`` times the input's RMS to the router's
    input; ``"c_attn"`` scales the c_attn kernel's first 128 output
    columns by the next 128 columns' scales over their own."""
    import torch

    from llm_sharding_demo_tpu_torch.models import gpt2, moe
    from llm_sharding_demo_tpu_torch.ops.quant import is_quantized

    mod = moe if kind == "router" else gpt2
    real = mod.linear
    gen = torch.Generator(device="cuda").manual_seed(5)

    def noisy(x, kernel, bias=None, kernels=False):
        xf = x.float()
        rms = xf.pow(2).mean(-1, keepdim=True).sqrt()
        noise = torch.randn(x.shape, generator=gen, device=x.device)
        return real((xf + level * rms * noise).to(x.dtype), kernel, bias,
                    kernels)

    def wrong_scale(x, kernel, bias=None, kernels=False):
        y = real(x, kernel, None, kernels)
        if kernels and is_quantized(kernel) and y.shape[-1] == 3 * cfg.n_embd:
            s = kernel.scale.float()
            y = y.clone()
            y[..., :128] = (y[..., :128].float() * (s[128:256] / s[:128])
                            ).to(y.dtype)
        return y if bias is None else y + bias

    mod.linear = noisy if kind == "router" else wrong_scale
    try:
        yield
    finally:
        mod.linear = real


def write_id_tokenizer(directory: str, vocab_size: int) -> None:
    """Byte-level BPE assets under ``<directory>/tokenizer`` in which
    every id decodes to a string of its own: ids 0-255 are the bytes, id
    i >= 256 is ``<i>``, and there are no merges, so text encodes to
    byte ids. A served reply then names its token ids (the byte
    tokenizer prints every id past 255 as the same mark)."""
    from llm_sharding_demo_tpu_torch.serving.tokenizer import (
        TOKENIZER_SUBDIR, _bytes_to_unicode)

    enc = _bytes_to_unicode()
    vocab = {enc[b]: b for b in range(256)}
    vocab.update({"".join(enc[c] for c in f"<{i}>".encode()): i
                  for i in range(256, vocab_size)})
    out = os.path.join(directory, TOKENIZER_SUBDIR)
    os.makedirs(out)
    with open(os.path.join(out, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    with open(os.path.join(out, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")


def moe_step_bytes(qparams, cfg) -> int:
    """Bytes a batch-1 routed int8 decode step must stream: every layer's
    attention, router and k of the E experts, and the head table."""
    blocks = qparams.get("stacked_blocks", qparams["blocks"])
    k_of_e = cfg.expert_top_k / cfg.n_experts
    return int(weight_bytes({n: blocks[n] for n in ("ln_1", "attn", "ln_2")})
               + weight_bytes(blocks["moe"]["router"])
               + k_of_e * weight_bytes(blocks["moe"]["experts"])
               + weight_bytes(qparams["wte"]) + weight_bytes(qparams["ln_f"]))


def moe_phase(smi: str) -> dict:
    """GPT-2-MoE from a checkpoint (module docstring, phase 13). Returns
    the launch counts of the int8 engine run and of the batched server."""
    import shutil
    import tempfile

    import torch

    from llm_sharding_demo_tpu_torch.models import moe
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.serving.app import create_app
    from llm_sharding_demo_tpu_torch.serving.tokenizer import (
        BPETokenizer, get_tokenizer)
    from llm_sharding_demo_tpu_torch.training import train
    from llm_sharding_demo_tpu_torch.utils import checkpoint, graftnum
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig

    t0 = time.perf_counter()
    misses = []     # the flip bars and the wave, held at the phase's end
    cfg = moe.MoEConfig(**MOE_CFG)
    params = moe.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    n_params = weight_bytes(params) // 4    # fp32
    tmp = tempfile.mkdtemp(prefix="smoke-moe-")
    try:
        ckpt_room(tmp, weight_bytes(params))
        nbytes, secs = save_timed(tmp, params, cfg)
        write_id_tokenizer(tmp, V)
        del params
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        lcfg, params = checkpoint.load(tmp)
        t_load = time.perf_counter() - t1
        check(lcfg == cfg, f"checkpoint config {lcfg}")
        tok = get_tokenizer("gpt2-moe", checkpoint_dir=tmp)
        check(isinstance(tok, BPETokenizer), f"checkpoint tokenizer {tok}")
        print(f"  GPT-2-MoE ({n_params} parameters) fp32 checkpoint: "
              f"{nbytes} bytes saved in {secs:.2f} s, loaded in "
              f"{t_load:.2f} s [{smi}]")
        eng = DecodeEngine(params, cfg, max_seq=NPOS, dtype="int8")
        plain = DecodeEngine(params, cfg, max_seq=NPOS, dtype="int8",
                             decode_kernel="xla")
        check(eng.decode_kernel_mode == "layer",
              f"int8 MoE 'auto' resolved to {eng.decode_kernel_mode}")
        bound = moe_step_bytes(eng.params, cfg) / HBM_BYTES_PER_S * 1e3
        rng = np.random.default_rng(17)
        runs = {}
        for batch in (1, 8):
            prompts = [rng.integers(0, V, 16 if batch == 1 else int(n)
                                    ).tolist()
                       for n in rng.integers(8, 17, batch)]
            forced = rng.integers(0, V, (batch, 48)).tolist()
            # the plain path's routing, recorded, then replayed on the
            # kernel path: the logits then differ by numerics alone, and
            # the choices the kernel path makes itself (the path as
            # served) are held to the flip bars
            tape = []
            with routing_tape(tape):
                lp = tf_rows(plain, prompts, forced)
            cuda_build.reset_launch_counts()
            eng._forward_shapes.clear()
            with routing_tape(tape, replay=True) as flips:
                lk = tf_rows(eng, prompts, forced)
            counts = cuda_build.launch_counts()
            want = expected_moe_launches(eng.forward_shapes())
            check(counts == want, f"MoE int8 B={batch} launches {counts}, "
                                  f"expected {want}")
            check(bool(torch.isfinite(lk).all())
                  and tuple(lk.shape) == (batch, 48, V),
                  f"MoE B={batch}: logits {tuple(lk.shape)} not finite")
            rep = graftnum.compare("decode.int8", lk.reshape(-1, V),
                                   lp.reshape(-1, V))
            fr = flip_reading(flips, tape)
            if not fr["held"]:
                misses.append(f"B={batch} flips: {flip_text(fr)}")
            runs[batch] = counts
            # unforced, both paths route themselves: printed, not held
            lu = tf_rows(eng, prompts, forced)
            mse = float(((lu - lp) ** 2).mean())
            top1 = float((lu.argmax(-1) == lp.argmax(-1)).float().mean())
            print(f"  MoE int8 'layer' vs the int8 plain path, B={batch} "
                  f"({'routed' if batch * 2 <= 8 else 'dense dispatch'}), "
                  f"{rep['n_positions']} teacher-forced positions, the plain "
                  f"path's routing replayed ({len(tape)} routings, "
                  f"{routed_tokens(tape)} tokens): logit_mse="
                  f"{rep['logit_mse']:.3e} (cap "
                  f"{rep['policy']['logit_mse']:.0e}) top1_agreement="
                  f"{rep['top1_agreement']:.4f}; the kernel path's own "
                  f"choices: {flip_text(fr)}; unforced logit_mse {mse:.3e} "
                  f"top1 {top1:.4f}; launches {counts} [{smi}]")
            if batch == 1:
                # planted faults on the kernel path, replayed against the
                # same tape: each should cross a bar
                faults = [("router", lv) for lv in MOE_FAULT_NOISE]
                faults.append(("c_attn", 0.0))
                for kind, lv in faults:
                    with moe_fault(kind, cfg, lv), routing_tape(
                            tape, replay=True) as ff:
                        lf = tf_rows(eng, prompts, forced)
                    fr = flip_reading(ff, tape)
                    fmse = float(((lf - lp) ** 2).mean(-1).mean())
                    caught = (not fr["held"]
                              or fmse > rep["policy"]["logit_mse"])
                    if fr["held"] and (kind == "c_attn"
                                       or lv == MOE_FAULT_NOISE[-1]):
                        misses.append(f"the planted {kind} fault ({lv}) "
                                      "crosses no flip bar")
                    print(f"  planted fault {kind}"
                          + (f" noise {lv:.3e}" if kind == "router" else
                             " wrong scale tile")
                          + f", B=1 replayed: {flip_text(fr)}; logit_mse "
                          f"{fmse:.3e}; caught {caught} [{smi}]")
        # the wave the admission server gets below, run here as its
        # batcher runs it (one round: prompts right-aligned to its
        # 16-token bucket, 64 steps) on the kernel engine; rows do not
        # interact, so their order in the round does not matter
        wave = [f"Wave request {i}: " + "x" * i for i in range(MOE_WAVE)]
        wave_ids = [tok.encode(w) for w in wave]
        s_max = -(-max(map(len, wave_ids)) // 16) * 16
        ids = np.zeros((MOE_WAVE, s_max), dtype=np.int64)
        pad = np.array([s_max - len(w) for w in wave_ids], dtype=np.int32)
        for i, w in enumerate(wave_ids):
            ids[i, pad[i]:] = w
        served = eng.generate(ids, MOE_WAVE_TOKENS, pad=pad).tokens[:, s_max:]
        wave_text = [tok.decode(w + served[i].tolist())
                     for i, w in enumerate(wave_ids)]
        # those tokens teacher-forced: the kernel path's own argmax at
        # every step, and within decode.int8 of the plain path replaying
        # its routing
        tape = []
        with routing_tape(tape):
            lkw = tf_padded(eng, ids, pad, served.tolist())
        top = lkw.topk(2, dim=-1).values
        own = lkw.argmax(-1).cpu().numpy() == served
        with routing_tape(tape, replay=True) as wflips:
            lpw = tf_padded(plain, ids, pad, served.tolist())
        wrep = graftnum.compare("decode.int8", lkw.reshape(-1, V),
                                lpw.reshape(-1, V))
        fr = flip_reading(wflips, tape)
        if not own.all():
            gaps = (top[..., 0] - top[..., 1]).cpu().numpy()[~own]
            misses.append(f"wave: {int((~own).sum())} served tokens are not "
                          f"the teacher-forced argmax (top-2 gaps {gaps})")
        if not fr["held"]:
            misses.append(f"wave flips (plain vs kernel routing): "
                          f"{flip_text(fr)}")
        print(f"  the wave's round in process ({MOE_WAVE} x "
              f"{MOE_WAVE_TOKENS} greedy tokens after {s_max}-column "
              f"prompts): {int(own.sum())} of {own.size} tokens are the "
              f"teacher-forced argmax; vs the int8 plain path on the "
              f"kernel path's routing logit_mse={wrep['logit_mse']:.3e} "
              f"top1_agreement={wrep['top1_agreement']:.4f}; the plain "
              f"path's own choices: {flip_text(fr)} [{smi}]")
        del lkw, lpw, top
        for batch in (1, 8):
            ids = rng.integers(0, V, (batch, 32))
            times = {}
            for mode, e in (("layer", eng), ("xla", plain)):
                e.generate(ids, 8)   # warm-up
                r = e.generate(ids, 33)
                eager, device = step_ms(e, ids)
                times[mode] = (r.per_token_latency * 1e3, eager, device)
            print(f"  MoE int8 decode B={batch}, 33 new tokens after 32: "
                  + "; ".join(
                      f"{mode} {t:.3f} ms/token, one step {e:.3f} ms eager "
                      f"vs {d:.3f} ms device (busy {d / e:.1%})"
                      for mode, (t, e, d) in times.items())
                  + (f"; the B=1 step's bytes bound {bound:.4f} ms"
                     if batch == 1 else "") + f" [{smi}]")
        del eng, plain
        torch.cuda.empty_cache()
        # the servers on the checkpoint, and the fp32 stream in process
        prompt = "Experts route: "
        ref = DecodeEngine(params, cfg, max_seq=NPOS, dtype="float32")
        want = tok.decode([int(t) for t in ref.generate(
            np.asarray(tok.encode(prompt)), 24).row_tokens(0)])
        del ref
        torch.cuda.empty_cache()
        ckpt = {"CHECKPOINT_DIR": tmp, "MODEL_ID": "gpt2-moe",
                "MAX_SEQ": str(NPOS)}
        with serving_processes(
                ("moe-fp32", ckpt),
                # a wait long enough that the wave's 8 requests meet in
                # one round (it starts once 8 are in)
                ("moe-int8-admission", dict(
                    ckpt, INFERENCE_DTYPE="int8", MAX_BATCH=str(MOE_WAVE),
                    BATCH_MODE="admission", BATCH_WAIT_MS="2000")),
        ) as [(f_url, f_health, _), (b_url, b_health, _)]:
            check(f_health["decode_kernel"] == "xla"
                  and f_health["n_stages"] == 1
                  and b_health["decode_kernel"] == "layer"
                  and b_health["n_stages"] == 1,
                  f"healthz {f_health} {b_health}")
            got = _http(f_url + "/generate", {"prompt": prompt,
                                              "max_new_tokens": 24,
                                              "mode": "greedy"})
            _http(b_url + "/generate", {"prompt": wave[0],
                                        "max_new_tokens": 8,
                                        "mode": "greedy"})   # warm-up
            tw = time.perf_counter()
            replies = _threads(lambda i: _http(b_url + "/generate", {
                "prompt": wave[i], "max_new_tokens": MOE_WAVE_TOKENS,
                "mode": "greedy"}), MOE_WAVE)
            wall = time.perf_counter() - tw
            health = _http(b_url + "/healthz")
        check(got["generated"] == want,
              "the fp32 CHECKPOINT_DIR MoE server's greedy stream differs "
              "from the in-process fp32 engine's")
        same = [r["generated"] == w for r, w in zip(replies, wave_text)]
        if not all(same):
            misses.append(f"wave replies equal to the in-process round: "
                          f"{same}; server forwards "
                          f"{health['forward_shapes']}")
        server_counts = health["kernel_launches"]
        want = expected_moe_launches(health["forward_shapes"])
        check(server_counts == want, f"MoE int8 server launches "
                                     f"{server_counts}, expected {want}")
        print(f"  fp32 CHECKPOINT_DIR MoE server: greedy 24 tokens equal to "
              f"the in-process fp32 engine; int8 MAX_BATCH={MOE_WAVE} "
              f"admission server ('layer'): {sum(same)} of {MOE_WAVE} "
              f"replies equal, token for token, to the round in process; "
              f"a wave of {MOE_WAVE} x {MOE_WAVE_TOKENS} tokens in "
              f"{wall:.2f} s = {MOE_WAVE * MOE_WAVE_TOKENS / wall:.1f} "
              f"tokens/s, forwards {health['forward_shapes']}, launches "
              f"{server_counts} [{smi}]")
        try:
            create_app(ServingConfig(model_id="moe", max_batch=8,
                                     batch_mode="iter", max_seq=NPOS),
                       model=(cfg, params), tokenizer=tok)
            check(False, "BATCH_MODE=iter with MoE started")
        except ValueError as e:
            check("window-independent" in str(e), f"iter refusal: {e}")
        # three f32 train steps at full width
        step = train.MoETrainStep(cfg, train.adamw(1e-3), device="cuda")
        p, s = step.init(params)
        del params
        ids = rng.integers(0, V, MOE_TRAIN)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times = [], []
        for _ in range(3):
            ts = time.perf_counter()
            p, s, loss = step(p, s, ids)
            losses.append(float(loss))
            times.append((time.perf_counter() - ts) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        check(all(np.isfinite(losses)) and losses[2] < losses[0],
              f"MoE train losses {losses}")
        print(f"  MoETrainStep f32, B={MOE_TRAIN[0]} x {MOE_TRAIN[1]} tokens: "
              f"losses {[round(x, 4) for x in losses]}, step ms "
              f"{[round(x, 1) for x in times]}, peak memory {peak} bytes "
              f"[{smi}]")
        del p, s, step
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"  [moe] {time.perf_counter() - t0:.1f} s wall [{smi}]")
    check(not misses, "MoE: " + "; ".join(misses))
    return {"int8 engine B=1": runs[1], "int8 engine B=8": runs[8],
            "int8 admission server": server_counts}


# -- phase 14: observability -------------------------------------------------

OBS_NEW = 64          # new tokens of the solo and overhead requests
OBS_TURNS = 50        # overhead turns of each kind
# the overhead bars, medians on / off of the obs int8 server at batch 1
# (set from the card readings in PERF.md §6): ms a token of a request's
# work, which a 50 us time.sleep in every grafttime.emit must cross; ms a
# request outside its prefill and decode, which a 50 us busy wait there
# must cross
OBS_WALL_BAR = 1.15
OBS_HOST_BAR = 1.27
OBS_HOST_BLOCKS = 24  # the tiered server's host tier: a 128-token entry
                      # (8 blocks) demotes, a 512-token one (32) is evicted


class SlowTokenizer:
    """The server's tokenizer, slowed on demand: with ``delay`` set an
    encode takes that long, so an X-Deadline-Ms of 1 is spent before any
    runner sees the request (the refusal path of the deadline tests)."""

    def __init__(self, tok):
        self.tok = tok
        self.delay = 0.0

    def encode(self, text):
        if self.delay:
            time.sleep(self.delay)
        return self.tok.encode(text)

    def __getattr__(self, name):
        return getattr(self.tok, name)


@contextlib.contextmanager
def inprocess_server(cfg, tokenizer=None, recorder=None):
    """``create_app`` on the card behind ``serve(block=False)`` on a free
    port in this process; yields the base url, and shuts the listener
    down on the way out."""
    from llm_sharding_demo_tpu_torch.serving.app import create_app
    from llm_sharding_demo_tpu_torch.serving.http import serve

    app = create_app(cfg, tokenizer=tokenizer, device="cuda",
                     recorder=recorder)
    server = serve(app, host="127.0.0.1", port=0, block=False)
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}"
    finally:
        server.shutdown()
        server.server_close()


def _get_text(url: str) -> str:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def parse_prometheus(text: str) -> dict:
    """Prometheus text -> ``{(name, labels without le): value}`` (a
    histogram's buckets collapse to their largest, the +Inf one); fails
    on a line that does not parse."""
    line_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    label_re = re.compile(r'([a-zA-Z_]+)="((?:[^"\\]|\\.)*)"')
    out = {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            check(len(line.split()) == 4, f"bad TYPE line {line!r}")
            continue
        m = line_re.match(line)
        check(m is not None, f"/metrics line does not parse: {line!r}")
        labels = tuple(sorted((k, v) for k, v in label_re.findall(
            m.group(3) or "") if k != "le"))
        key = (m.group(1), labels)
        out[key] = max(out.get(key, float("-inf")), float(m.group(4)))
    return out


def _series(metrics: dict, name: str) -> float:
    """The sum of a parsed series over its label sets."""
    return sum(v for (n, _), v in metrics.items() if n == name)


def obs_int8(smi: str) -> dict:
    """The int8 GPT-2 admission server with the prefix store (MAX_BATCH=8
    PREFIX_CACHE=8, the mega decode) in this process: solo requests, a
    wave of 8, two requests on one system prompt, a burst whose
    X-Deadline-Ms is spent; then each /metrics, /debug/* and /healthz
    check (module docstring, phase 14) and the overhead turns. Returns
    the script's launch counts."""
    import torch
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                            eos_chunks)
    from llm_sharding_demo_tpu_torch.serving import loader
    from llm_sharding_demo_tpu_torch.serving.tokenizer import get_tokenizer
    from llm_sharding_demo_tpu_torch.utils import (graftscope, grafttime,
                                                   metrics, tracing)
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig

    cfg = ServingConfig(model_id="gpt2", inference_dtype="int8",
                        max_seq=NPOS, max_batch=8, batch_mode="admission",
                        batch_wait_ms=100.0, prefix_cache=8)
    metrics.REGISTRY.restore_state(({}, {}, {}))
    grafttime.clear()
    grafttime.clear_blackbox()
    graftscope.clear()
    gc.collect()
    tok = SlowTokenizer(get_tokenizer(cfg.model_id))
    rng = np.random.default_rng(43)

    def text(n):
        return "".join(chr(int(c)) for c in rng.integers(97, 123, n))

    recorder = tracing.FlightRecorder(capacity=256)
    with inprocess_server(cfg, tokenizer=tok, recorder=recorder) as base:
        health = _http(base + "/healthz")
        check(health["decode_kernel"] == "mega"
              and health["device"].startswith("cuda"), f"healthz {health}")
        check(_http(base + "/debug/trend")["alerts"] == [],
              "a trend alert before any request")
        cuda_build.reset_launch_counts()
        h0 = _http(base + "/healthz")
        answered, sent = [], []

        def generate(body, rid, headers=None):
            status, out, hdrs = _post(base + "/generate", body,
                                      {"X-Request-ID": rid,
                                       **(headers or {})})
            check(hdrs.get("X-Request-ID") == rid, f"{rid}: id not echoed")
            sent.append(rid)
            if status == 200:
                answered.append((rid, body["max_new_tokens"]))
            return status, out

        solo = [text(32) for _ in range(3)]
        for i, p in enumerate(solo):
            status, out = generate({"prompt": p, "mode": "greedy",
                                    "max_new_tokens": OBS_NEW}, f"solo-{i}")
            check(status == 200, f"solo-{i}: {status} {out}")
        torch.cuda.synchronize()
        prof = _http(base + f"/debug/profile?n={graftscope.RING_CAPACITY}")
        # the solo requests' decode segments: keys (rows, steps)
        solo_segs = [(ast.literal_eval(r["key"])[1], r["ms"], r["stream_ms"])
                     for r in prof["dispatch"]["engine._decode_seg"]["ring"]
                     if ast.literal_eval(r["key"])[0] == 1]
        seg_steps = eos_chunks(OBS_NEW - 1)
        check([n for n, _, _ in solo_segs] == seg_steps * 3
              and all(isinstance(v, float) and v > 0
                      for _, _, v in solo_segs),
              f"batch-1 decode segments (steps, host ms, stream ms): "
              f"{solo_segs}")
        bodies = [{"prompt": text(24 + 3 * i), "mode": "greedy",
                   "max_new_tokens": 24} for i in range(8)]
        res = _threads(lambda i: generate(bodies[i], f"wave-{i}"), 8)
        check(all(s == 200 for s, _ in res), f"wave: {res}")
        system = "You answer briefly and exactly. " + text(200)
        for i, q in enumerate(("What is a shard?", "Why so few?")):
            status, out = generate({"prompt": system + " " + q,
                                    "mode": "greedy", "max_new_tokens": 24},
                                   f"prefix-{i}")
            check(status == 200, f"prefix-{i}: {status} {out}")
        tok.delay = 0.005
        burst = _threads(lambda i: generate(
            {"prompt": text(16), "mode": "greedy", "max_new_tokens": 24},
            f"burst-{i}", {"X-Deadline-Ms": "1"}), 4)
        tok.delay = 0.0
        misses = sum(s == 503 and o.get("error") == "deadline_exceeded"
                     for s, o in burst)
        check(misses == 4, f"the 1 ms burst: {burst}")
        h1 = _http(base + "/healthz")
        torch.cuda.synchronize()

        # /metrics
        m = parse_prometheus(_get_text(base + "/metrics"))
        n_ok = len(answered)
        checks = {
            "generate_requests_total": (_series(m, "generate_requests_total"),
                                        n_ok),
            "generated_tokens_total": (_series(m, "generated_tokens_total"),
                                       sum(n for _, n in answered)),
            "deadline_misses_total": (_series(m, "deadline_misses_total"),
                                      misses),
            "ttft_seconds_count": (_series(m, "ttft_seconds_count"), n_ok),
            "tpot_seconds_count": (_series(m, "tpot_seconds_count"), n_ok),
        }
        for name, (got, want) in checks.items():
            check(got == want, f"/metrics {name} {got}, expected {want}")
        print(f"  obs /metrics: {len(m)} series parse as Prometheus text; "
              + ", ".join(f"{k} {int(g)} = {int(w)}"
                          for k, (g, w) in checks.items()) + f" [{smi}]")

        # /debug/requests
        reqs = _http(base + "/debug/requests?n=256")["requests"]
        check(sorted(t["request_id"] for t in reqs) == sorted(sent),
              "/debug/requests does not hold every request")
        for t in reqs:
            def walk(spans, rid=t["request_id"], wall=t["duration_ms"]):
                for s in spans:
                    check(s["start_ms"] >= -1e-3 and s["start_ms"]
                          + s["duration_ms"] <= wall + 1e-3,
                          f"{rid}: span {s['name']} outside the request")
                    walk(s.get("spans", []))
            walk(t["spans"])
        errs = _http(base + "/debug/requests?n=256&errors=1")["requests"]
        check(sorted(t["request_id"] for t in errs)
              == sorted(f"burst-{i}" for i in range(4)),
              f"?errors=1 holds {[t['request_id'] for t in errs]}")
        rounds = {}
        for t in reqs:
            for s in t["spans"]:
                if s["name"] == "decode":
                    # a batch's decode span is shared by its rows' traces
                    lab = s["labels"]
                    rounds[(s["duration_ms"], lab["steps"],
                            lab["batch"])] = lab["steps"] - 1
        launches = {k: h1["kernel_launches"][k] - h0["kernel_launches"][k]
                    for k in h1["kernel_launches"]}
        shapes = {k: v - h0["forward_shapes"].get(k, 0)
                  for k, v in h1["forward_shapes"].items()
                  if v != h0["forward_shapes"].get(k, 0)}
        want = expected_launches(shapes, False, 2)
        check(launches == want, f"obs server launches {launches}, "
                                f"expected {want} from {shapes}")
        print(f"  obs /debug/requests: {len(reqs)} traces, every span "
              f"inside its request; ?errors=1 = the burst's 4; "
              f"decode_layers launched {launches['decode_layers']} times "
              f"(healthz delta) beside {sum(rounds.values())} decode steps "
              f"in {len(rounds)} decode spans of the traces (2 stages: "
              f"{2 * sum(rounds.values())}); launches {launches} [{smi}]")

        # /debug/profile after the final synchronize
        prof = _http(base + f"/debug/profile?n={graftscope.RING_CAPACITY}")
        for scope, d in prof["dispatch"].items():
            check(d["stream"]["pending"] == 0,
                  f"{scope}: {d['stream']['pending']} event pairs pending "
                  "after the synchronize")
            check(all(r["ms"] > 0 for r in d["ring"]),
                  f"{scope}: a host window of 0")
            check(all(r["stream_ms"] > 0 for r in d["ring"]
                      if r["stream_ms"] is not None),
                  f"{scope}: a stream window of 0")
        # the device's own step at the same shape: one decode step of an
        # engine like the server's, replayed from a CUDA graph
        config, params, _ = loader.resolve_for_role(cfg, torch.device("cuda"))
        eng = DecodeEngine(params, config, max_seq=NPOS,
                           boundaries=list(cfg.boundaries), dtype="int8",
                           device="cuda")
        ids = np.asarray([tok.encode(solo[0])], dtype=np.int64)
        eager_ms, device_ms = step_ms(eng, ids)
        del eng, params
        # a step's windows: its segment's over the segment's steps
        steps = sum(n for n, _, _ in solo_segs)
        host_step = sum(h for _, h, _ in solo_segs) / steps
        mean_stream = sum(v for _, _, v in solo_segs) / steps
        check(mean_stream >= 0.9 * device_ms,
              f"batch-1 decode step: mean stream window {mean_stream:.4f} "
              f"ms < 0.9 x the graph-replay device step {device_ms:.4f} ms")
        print(f"  obs /debug/profile: {len(prof['dispatch'])} scopes, no "
              f"event pair pending, every window > 0; batch-1 decode step "
              f"(engine._decode_seg, {len(solo_segs)} segments of "
              f"{seg_steps} steps): host window {host_step:.4f} ms, stream "
              f"window {mean_stream:.4f} ms, a segment's over its steps, "
              f"beside the graph-replay device step {device_ms:.4f} ms "
              f"(eager {eager_ms:.4f}) [{smi}]")

        # /debug/memory
        mem = _http(base + "/debug/memory")
        check(mem["conserved"], "/debug/memory is not conserved")
        card = "cuda:0"
        alloc = mem["allocator"][card]
        held = sum(mem["components"].get(c, {}).get("devices", {})
                   .get(card, 0) for c in ("engine_cache", "prefix_store"))
        check(held <= alloc["memory_allocated"],
              f"ledger {held} > memory_allocated {alloc}")
        print(f"  obs /debug/memory: conserved; on {card} the ledger holds "
              f"{held} bytes of engine_cache + prefix_store "
              f"({mem['devices'].get(card, 0)} with the weights) <= "
              f"torch.cuda.memory_allocated {alloc['memory_allocated']} "
              f"(max {alloc['max_memory_allocated']}) [{smi}]")

        # /debug/trend
        first = _http(base + "/debug/trend")
        second = _http(base + "/debug/trend")
        trips = [a["watch"] for a in first["alerts"]]
        check(trips == ["slo_deadline_burn"], f"trend alerts {trips}")
        check(second["alerts"] == first["alerts"]
              and second["watches"]["slo_deadline_burn"]["latched"],
              "a second scrape raised another alert")
        hz = _http(base + "/healthz")
        check(hz["trend"]["latched"] == ["slo_deadline_burn"],
              f"/healthz trend {hz['trend']}")
        print(f"  obs /debug/trend: slo_deadline_burn tripped once (burn "
              f"{first['alerts'][0]['value']} x the budget), latched on "
              f"the second scrape and in /healthz; black-box dumps "
              f"{[d['reason'] for d in grafttime.blackbox_dumps()]} "
              f"[{smi}]")

        obs_overhead(base, solo[0], smi)
    return launches


def obs_overhead(base: str, prompt: str, smi: str) -> None:
    """The recorders' cost on the obs int8 server at ``base`` (this
    process, after the script and, in a whole run, every other phase):
    greedy batch-1 requests of ``OBS_NEW`` tokens on ``prompt`` in turns
    of four kinds, the order rotating each turn: GRAFTTIME, GRAFTSCOPE
    and GRAFTMEM on; off; on with a 50 us busy wait planted in every
    timeline event; on with a 50 us ``time.sleep`` planted there. Each
    request is read three ways: ms a token of its work (its trace's wall
    less its queue wait, the admission round's wait for peers, over its
    new tokens), its TPOT (a reading), and the ms of its work outside
    its prefill and decode spans, where the serving layer's own host
    work and about 12 of its 21 timeline events lie. The median of each
    kind over off's is held to a bar: work to ``OBS_WALL_BAR``, which the
    sleep must cross, the outside window to ``OBS_HOST_BAR``, which the
    busy wait must cross; on stays under both. (The busy wait adds ~1 ms
    to a request, ~2% of its ms a token: inside the noise of the work
    medians on the card's shared host.)"""
    from llm_sharding_demo_tpu_torch.utils import (graftmem, graftscope,
                                                   grafttime)

    toggles = (grafttime.set_enabled, graftscope.set_enabled,
               graftmem.set_enabled)
    emit = grafttime.BUS.emit

    def busy(*a, **k):
        t_end = time.perf_counter() + 50e-6
        while time.perf_counter() < t_end:
            pass
        emit(*a, **k)

    def sleeping(*a, **k):
        time.sleep(50e-6)
        emit(*a, **k)

    emits = {"on": emit, "off": emit, "busy": busy, "sleep": sleeping}
    body = {"prompt": prompt, "mode": "greedy",
            "max_new_tokens": OBS_NEW}

    def reading(mode: str) -> dict:
        """One request's ms a token of its work (wall less queue wait,
        over its new tokens), its TPOT (decode span over the steps after
        the first token), and the ms of its work outside its prefill and
        decode spans (the serving layer's own: HTTP, tokenizer, trace,
        metrics)."""
        prev = [f(mode != "off") for f in toggles]
        grafttime.BUS.emit = emits[mode]
        try:
            status, out, _ = _post(base + "/generate", body)
        finally:
            grafttime.BUS.emit = emit
            for f, p in zip(toggles, prev):
                f(p)
        check(status == 200, f"overhead turn ({mode}): {status} {out}")
        trace = _http(base + "/debug/requests?n=1")["requests"][0]
        span = {sp["name"]: sp["duration_ms"] for sp in trace["spans"]}
        steps = [sp for sp in trace["spans"]
                 if sp["name"] == "decode"][0]["labels"]["steps"]
        work = trace["duration_ms"] - span["queue_wait"]
        return {"work": work / OBS_NEW,
                "tpot": span["decode"] / (steps - 1),
                "outside": work - span["prefill"] - span["decode"]}

    modes = tuple(emits)
    measures = ("work", "tpot", "outside")
    got = {k: {m: [] for m in modes} for k in measures}
    for m in modes:
        reading(m)                            # warm
    for turn in range(OBS_TURNS):
        k = turn % len(modes)
        for m in modes[k:] + modes[:k]:
            for key, v in reading(m).items():
                got[key][m].append(v)
    med = {k: {m: statistics.median(v) for m, v in got[k].items()}
           for k in measures}
    ratio = {k: {m: med[k][m] / med[k]["off"] for m in modes}
             for k in measures}
    for k in measures:
        print(f"  obs overhead {k}: medians " + ", ".join(
            f"{m} {med[k][m]:.4f} ({ratio[k][m]:.4f})" for m in modes)
            + f" [{smi}]")
        for m in modes if k != "tpot" else ():
            print(f"  obs overhead readings {k} {m}: "
                  f"{[round(x, 4) for x in got[k][m]]}")
    for k, bar, fault in (("work", OBS_WALL_BAR, "sleep"),
                          ("outside", OBS_HOST_BAR, "busy")):
        r = ratio[k]
        check(r["on"] <= bar, f"recorders cost {r['on']:.4f}x in {k}, over "
                              f"the bar {bar}")
        check(r[fault] > bar, f"the planted {fault} fault ({r[fault]:.4f}x "
                              f"in {k}) does not cross the bar {bar}")


def obs_tier(smi: str) -> None:
    """The tiered fp32 GPT-2 iter server in this process (MAX_BATCH=4
    KV_POOL_BLOCKS=256 PREFIX_CACHE=8, a host tier of
    ``OBS_HOST_BLOCKS``): eight system prompts of 512 and 128 tokens in
    turn, cycled twice, a wave of four on each (a lead, three joiners
    through the store), the timeline read after each wave through its
    cursor. The
    stream carries admissions, spans, evictions, demotions and
    promotions, as many as the pool and tier count; its Chrome export
    validates; the ledger holds the pool planes at their nbytes on the
    card and the host tier's bytes on the host."""
    from llm_sharding_demo_tpu_torch.utils import grafttime
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig

    cfg = ServingConfig(model_id="gpt2", inference_dtype="float32",
                        max_seq=NPOS, max_batch=4, batch_mode="iter",
                        batch_wait_ms=5.0, kv_block_size=PAGED_BS,
                        kv_pool_blocks=TIER_BLOCKS, prefix_cache=8,
                        kv_host_blocks=OBS_HOST_BLOCKS)
    rng = np.random.default_rng(47)

    def text(n):
        return "".join(chr(int(c)) for c in rng.integers(97, 123, n))

    systems = [f"System {i}: " + text((512 if i % 2 == 0 else 128) - 10)
               for i in range(8)]
    grafttime.clear()
    events, cursor = [], 0
    t0 = time.perf_counter()
    with inprocess_server(cfg) as base:
        for w in range(16):
            s = systems[w % 8]
            bodies = [{"prompt": s + text(48 if j == 0 else 24),
                       "mode": "greedy",
                       "max_new_tokens": 96 if j == 0 else 24}
                      for j in range(4)]
            res = _threads(lambda i: _post(base + "/generate", bodies[i]),
                           4, [0.0, 0.1, 0.1, 0.1])
            check(all(r[0] == 200 for r in res), f"tier wave {w}: {res}")
            tl = _http(base + f"/debug/timeline?since_seq={cursor}")
            new = tl["events"]
            if tl["cursor"] > cursor:
                check(new and min(e["seq"] for e in new) == cursor + 1,
                      f"wave {w}: events dropped between reads")
            events.extend(new)
            cursor = tl["cursor"]
        deadline = time.monotonic() + 10
        while True:
            h = _http(base + "/healthz")
            ps = h["kv_pool_stats"]
            if ps["blocks_in_use"] == ps["blocks_evictable"]:
                break
            check(time.monotonic() < deadline, f"rows left in the pool {ps}")
            time.sleep(0.05)
        mem = _http(base + "/debug/memory")
    kinds = collections.Counter(e["kind"] for e in events)
    tier = ps["tier"]
    for kind, want in (("tier_demote", tier["demotions"]),
                       ("tier_promote", tier["promotions"]),
                       ("eviction", ps["evictions"])):
        check(kinds[kind] == want > 0,
              f"{kind}: {kinds[kind]} events, the pool counts {want}")
    for kind in ("admission", "span_open", "span_close"):
        check(kinds[kind] > 0, f"no {kind} event")
    problems = grafttime.validate_chrome(grafttime.export_chrome(events))
    check(problems == [], f"export_chrome: {problems[:3]}")
    # [L, N + 1, 2, H, block, head_dim] f32; component totals are the
    # process's, so the pool is read by its own holding
    planes = L * (TIER_BLOCKS + 1) * 2 * H * PAGED_BS * HD * 4
    codes = [h for h in mem["holdings"] if h["component"] == "pool_codes"
             and h["owner"] == "KVBlockPool" and h["bytes"] == planes]
    check(mem["pool"]["pool_bytes"] == planes and codes
          and codes[0]["devices"] == {"cuda:0": planes},
          f"pool_codes {codes}, pool {mem['pool']}, the planes hold "
          f"{planes} bytes")
    spill = mem["components"].get("host_spill", {"bytes": 0, "devices": {}})
    check(set(spill["devices"]) <= {"cpu"}, f"host_spill on {spill}")
    check(mem["conserved"], "/debug/memory is not conserved")
    print(f"  obs tiered fp32 iter server, 16 waves of 4 on 512/128-token "
          f"system prompts, host tier {OBS_HOST_BLOCKS} blocks: "
          f"{len(events)} events read through the cursor, {dict(kinds)}; "
          f"tier {tier}; evictions {ps['evictions']}; the Chrome export "
          f"validates; pool_codes {planes} bytes on cuda:0 = the planes; "
          f"host_spill {spill['devices']}; "
          f"{time.perf_counter() - t0:.1f} s with startup [{smi}]")


def obs_phase(smi: str) -> dict:
    """Observability (module docstring, phase 14). Returns the launch
    counts of the int8 server's script."""
    t0 = time.perf_counter()
    launches = {"GPT-2 int8 obs server": obs_int8(smi)}
    obs_tier(smi)
    print(f"  [obs] {time.perf_counter() - t0:.1f} s wall [{smi}]")
    return launches


# -- fleet ---------------------------------------------------------------------

FLEET_CHUNK = 16      # PREFIX_CHUNK of every replica and the router's key width
FLEET_N = 12          # arrivals of each serial profile
FLEET_OPEN_N = 16     # arrivals of the open-loop run
FLEET_PROFILES = ("bursty_chat", "long_context")


def reply_ids(text: str) -> list:
    return [int(x) for x in re.findall(r"<(\d+)>", text)]


def fleet_shapes(fleet) -> dict:
    """``{"BxT": forwards}`` summed over the fleet's replicas, from each
    one's /healthz ``forward_shapes``."""
    total = collections.Counter()
    for r in fleet.topology.replicas:
        total.update(r.client.get("/healthz").json()["forward_shapes"])
    return dict(total)


def shapes_delta(after: dict, before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def fleet_drive(client, recorder) -> dict:
    """Each of ``FLEET_PROFILES`` driven serially (``FLEET_N`` arrivals of
    seed 6) at ``client``: ``{profile: load report}``."""
    from llm_sharding_demo_tpu_torch import loadgen

    return {name: loadgen.run_load(client, loadgen.profile(name), seed=6,
                                   n=FLEET_N, mode="serial",
                                   recorder=recorder)
            for name in FLEET_PROFILES}


def fleet_tree(fleet, rid: str) -> str:
    """A request's stitched span tree at the router, as nested names."""
    tree = next(t for t in fleet.client.get("/debug/requests?n=64")
                .json()["requests"] if t["request_id"] == rid)

    def names(spans):
        return ", ".join(
            s["name"] + (f" [{names(s['spans'])}]" if s.get("spans") else "")
            for s in spans)
    return names(tree["spans"])


def fleet_phase(smi: str) -> dict:
    """The fleet (module docstring, phase 15). Returns the int8 fleet's
    launch counts."""
    import threading

    import torch

    from llm_sharding_demo_tpu_torch import loadgen
    from llm_sharding_demo_tpu_torch.fleet import build_fleet, build_single
    from llm_sharding_demo_tpu_torch.models import gpt2
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.runtime import kv_pool
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.tools.plan_drive import IdTokenizer
    from llm_sharding_demo_tpu_torch.utils import graftnum

    t_phase = time.perf_counter()
    cfg = gpt2.CONFIGS["gpt2"]
    params = gpt2.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(0))
    tok = IdTokenizer()
    kw = dict(max_seq=NPOS, chunk=FLEET_CHUNK, model=(cfg, params),
              device="cuda", tokenizer=tok)

    # (a) fp32: the fleet byte-equal to the single replica, no kernel
    fleet = build_fleet(n_decode=2, n_prefill=1, **kw)
    single = build_single(**kw)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    rf = fleet_drive(fleet.client, fleet.recorder)
    t1 = time.perf_counter()
    rs = fleet_drive(*single[:2])
    walls = (t1 - t0, time.perf_counter() - t1)
    counts = cuda_build.launch_counts()
    check(not any(counts.values()), f"fp32 fleet launched kernels: {counts}")
    rows = [(name, of, os_) for name in FLEET_PROFILES
            for of, os_ in zip(rf[name]["outcomes"], rs[name]["outcomes"])]
    for name, of, os_ in rows:
        check(of.status == 200 and os_.status == 200,
              f"fp32 {name} {of.k}: {of.status} {of.code} / {os_.status} "
              f"{os_.code}")
        check(of.generated == os_.generated,
              f"fp32 {name} request {of.k}: the fleet's reply differs from "
              "the single replica's")
    new = sum(of.new_tokens for _, of, _ in rows)
    drives = ", ".join(f"{FLEET_N} {n}" for n in FLEET_PROFILES)
    print(f"  fp32 fleet (router, 1 prefill + 2 decode replicas, one pool "
          f"of {fleet.pool.allocator.stats().blocks_total} blocks, chunk "
          f"{FLEET_CHUNK}): {len(rows)} serial replies ({drives}) "
          f"byte-equal to the single replica, {new} new tokens, "
          f"{walls[0]:.2f} s wall (single replica {walls[1]:.2f} s); affinity "
          f"{fleet.app.router.affinity_stats()}, registry entries "
          f"{fleet.pool.allocator.prefix_len()}; no kernel launched [{smi}]")
    del fleet, single
    gc.collect()
    torch.cuda.empty_cache()

    # (b) int8 on the kernels: launches predicted from the forwards, each
    # reply held against the int8 single replica
    os.environ["GRAFTSAN"] = "1"
    try:
        fleet = build_fleet(n_decode=2, n_prefill=1,
                            inference_dtype="int8", **kw)
    finally:
        os.environ.pop("GRAFTSAN")
    check(fleet.pool.allocator.sanitize, "the int8 fleet's pool sanitizes")
    single = build_single(inference_dtype="int8", **kw)
    modes = {r.client.get("/healthz").json()["decode_kernel"]
             for r in fleet.topology.replicas}
    check(modes == {"xla"}, f"paged int8 replicas run {modes}")
    shapes0 = fleet_shapes(fleet)
    cuda_build.reset_launch_counts()
    t0 = time.perf_counter()
    rf = fleet_drive(fleet.client, fleet.recorder)
    wall = time.perf_counter() - t0
    counts = cuda_build.launch_counts()
    shapes = shapes_delta(fleet_shapes(fleet), shapes0)
    want = expected_spec_launches(
        {tuple(int(v) for v in k.split("x")): n for k, n in shapes.items()},
        False)
    check(counts == want, f"int8 fleet: launches {counts}, predicted {want} "
                          f"from the forwards {shapes}")
    check(counts["quant_linear"] > 0 and counts["quant_head"] > 0,
          f"int8 fleet: {counts}")
    launches = {"int8 fleet, serial": counts}
    n_fwd = sum(shapes.values())
    print(f"  int8 fleet serial ({wall:.2f} s wall, {wall / n_fwd * 1e3:.2f} "
          f"ms a forward): forwards {shapes}; "
          f"launches {counts} = the forwards' prediction (the int8 linear "
          f"at 4 x {L} projections and the tied head once a forward of "
          f"<= 16 rows; paged replicas run no decode-attention or "
          f"whole-stack kernel) [{smi}]")
    t0 = time.perf_counter()
    rs = fleet_drive(*single[:2])
    single_wall = time.perf_counter() - t0
    kern = DecodeEngine(params, cfg, max_seq=NPOS, dtype="int8",
                        decode_kernel="xla", matmul_kernels=True,
                        device="cuda")
    plain = DecodeEngine(params, cfg, max_seq=NPOS, dtype="int8",
                         decode_kernel="xla", device="cuda")
    equal = held = 0
    worst = 0.0
    for name in FLEET_PROFILES:
        prof = loadgen.profile(name)
        arrivals = loadgen.schedule(prof, 6, FLEET_N)
        for a, of, os_ in zip(arrivals, rf[name]["outcomes"],
                              rs[name]["outcomes"]):
            check(of.status == 200 and os_.status == 200,
                  f"int8 {name} {a.k}: {of.status} {of.code} / "
                  f"{os_.status} {os_.code}")
            if of.generated == os_.generated:
                equal += 1
                continue
            prompt = tok.encode(a.prompt)
            forced = reply_ids(of.generated)[len(prompt):]
            lk = teacher_forced_logits(kern, prompt, forced)
            lp = teacher_forced_logits(plain, prompt, forced)
            check(bool(torch.isfinite(lk).all()), "int8: non-finite logits")
            rep = graftnum.compare("decode.int8", lk, lp)
            worst = max(worst, rep["logit_mse"])
            held += 1
    first = loadgen.schedule(loadgen.profile(FLEET_PROFILES[0]), 6, 1)[0]
    eager, device = step_ms(kern, np.asarray([tok.encode(first.prompt)]))
    del kern, plain
    print(f"  a paged int8 replica's decode step (its engine alone, after "
          f"a {len(tok.encode(first.prompt))}-token prompt): eager "
          f"{eager:.3f} ms, device {fmt_ms(device)} ms (CUDA-graph replay),"
          f" busy {device / eager:.1%} [{smi}]")
    print(f"  int8 fleet replies against the int8 single replica ("
          f"{single_wall:.2f} s wall for the same drive): {equal} byte-equal, "
          f"{held} held teacher-forced within decode.int8 (worst logit_mse "
          f"{worst:.3e}) [{smi}]")

    # (c) open loop at twice the profile's rate on the same fleet
    prof = loadgen.profile("bursty_chat")
    polls, stop = [], threading.Event()

    def watch():
        d0 = fleet.topology.by_name("decode0").client
        while not stop.is_set():
            polls.append(d0.get("/healthz").json()["kv_pool_stats"])
            time.sleep(0.02)

    stats0 = fleet.app.router.affinity_stats()
    shapes0 = fleet_shapes(fleet)
    watcher = threading.Thread(target=watch, daemon=True)
    cuda_build.reset_launch_counts()
    watcher.start()
    try:
        rep = loadgen.run_load(fleet.client, prof, seed=3, n=FLEET_OPEN_N,
                               rate_scale=2.0, mode="open",
                               recorder=fleet.recorder)
    finally:
        stop.set()
        watcher.join(timeout=30)
    counts = cuda_build.launch_counts()
    shapes = shapes_delta(fleet_shapes(fleet), shapes0)
    want = expected_spec_launches(
        {tuple(int(v) for v in k.split("x")): n for k, n in shapes.items()},
        False)
    check(counts == want, f"int8 open loop: launches {counts}, predicted "
                          f"{want} from {shapes}")
    launches["int8 fleet, open loop"] = counts
    stats1 = fleet.app.router.affinity_stats()
    delta = {k: stats1[k] - stats0[k] for k in stats1}
    by_status = collections.Counter(o.status for o in rep["outcomes"])
    check(set(by_status) <= {200, 429, 503},
          f"open loop: untyped outcomes {dict(by_status)}")
    check(all(o.code for o in rep["outcomes"] if o.status != 200),
          "open loop: an untyped shed")
    check(polls and all(p["blocks_in_use"] + p["blocks_free"]
                        == p["blocks_total"] for p in polls),
          "open loop: pool conservation broke at /healthz")
    st = fleet.pool.allocator.stats()
    check(st.blocks_in_use + st.blocks_free == st.blocks_total,
          "open loop: pool conservation broke after the run")
    kv_pool.graftsan_sweep(timeout=10.0)
    check(fleet.pool.allocator.prefix_len() > 0 and stats1["hits"] > 0,
          f"open loop: no affinity ({stats1}, "
          f"{fleet.pool.allocator.prefix_len()} entries)")
    rid = next(o.request_id for o in rep["outcomes"] if o.status == 200)
    print(f"  int8 fleet open loop ({FLEET_OPEN_N} bursty_chat arrivals at "
          f"rate_scale 2, {rep['wall_s']} s wall): outcomes "
          f"{dict(sorted(by_status.items()))} (every non-200 typed: "
          f"{sorted({o.code for o in rep['outcomes'] if o.status != 200})}); "
          f"affinity hits {delta['hits']}, fallbacks {delta['fallbacks']}, "
          f"sheds {delta['sheds']}; prefix_len() "
          f"{fleet.pool.allocator.prefix_len()}; pool conserved at "
          f"{len(polls)} /healthz polls during the run and after it, "
          f"GRAFTSAN refs balanced; {rep['throughput_tokens_per_sec']} "
          f"tokens/s, p50 e2e {rep['p50_e2e_ms']} ms, p99 {rep['p99_e2e_ms']}"
          f" ms; launches {counts} = the forwards' prediction [{smi}]")
    print(f"  stitched /debug/requests tree of {rid}: "
          f"{fleet_tree(fleet, rid)} [{smi}]")
    del fleet, single
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  [fleet] {time.perf_counter() - t_phase:.1f} s wall [{smi}]")
    return launches


# -- plan ----------------------------------------------------------------------

PLAN_FAULT_ENV = {"GRAFTFAULT": "1", "GRAFTFAULT_SEED": "5",
                  "GRAFTFAULT_RATE": "0.2"}


def plan_hold(got: list, want: list, what: str, engines, tok,
              ks=None) -> tuple:
    """``(equal, held, worst logit_mse)``: each reply of ``got`` (arrivals
    ``ks``, default all) a 200 byte-equal to ``want``'s, or held
    teacher-forced within ``decode.int8`` of the int8 plain path (a row's
    numbers differ with the forward's shape, so a greedy row may part at
    a near tie)."""
    import torch

    from llm_sharding_demo_tpu_torch import loadgen
    from llm_sharding_demo_tpu_torch.tools.plan_drive import PLAN_N, PLAN_SEED
    from llm_sharding_demo_tpu_torch.utils import graftnum

    arrivals = loadgen.schedule(loadgen.profile("agentic"), PLAN_SEED, PLAN_N)
    if ks is not None:
        arrivals = [arrivals[k] for k in ks]
    equal = held = 0
    worst = 0.0
    for a, (st, text), (st2, text2) in zip(arrivals, got, want):
        check(st == 200 and st2 == 200, f"{what} {a.k}: {st} / {st2}")
        if text == text2:
            equal += 1
            continue
        kern, plain = engines()
        prompt = tok.encode(a.prompt)
        forced = reply_ids(text)[len(prompt):]
        lk = teacher_forced_logits(kern, prompt, forced)
        lp = teacher_forced_logits(plain, prompt, forced)
        check(bool(torch.isfinite(lk).all()), f"{what}: non-finite logits")
        worst = max(worst, graftnum.compare("decode.int8", lk, lp)["logit_mse"])
        held += 1
    return equal, held, worst


def plan_phase(smi: str) -> dict:
    """Continuous planning (module docstring, phase 16). Returns the
    continuous server's launch counts."""
    import torch

    from llm_sharding_demo_tpu_torch.models import gpt2
    from llm_sharding_demo_tpu_torch.ops import cuda_build
    from llm_sharding_demo_tpu_torch.runtime import kv_pool
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.tools.plan_drive import (
        MIX, PLAN_N, PLAN_RATE, IdTokenizer, environ, expected_launches,
        plan_traffic, replies)
    from llm_sharding_demo_tpu_torch.tools import plan_drive
    from llm_sharding_demo_tpu_torch.utils import graftfault, graftsched

    def plan_app(model, tok, **env):
        return plan_drive.plan_app(model, tok, "cuda", **env)

    def plan_run(client, recorder, mode, rate=1.0):
        try:
            return plan_drive.plan_run(client, recorder, mode, rate)
        except AssertionError as e:
            raise SmokeError(f"plan {mode} run: {e}") from e

    t_phase = time.perf_counter()
    cfg = gpt2.CONFIGS["gpt2"]
    params = gpt2.init_params(cfg, torch.Generator(device="cuda")
                              .manual_seed(0))
    tok = IdTokenizer()
    model = (cfg, params)
    made = {}

    def engines():
        if not made:
            kw = dict(max_seq=NPOS, dtype="int8", decode_kernel="xla",
                      device="cuda")
            made["kern"] = DecodeEngine(params, cfg, matmul_kernels=True, **kw)
            made["plain"] = DecodeEngine(params, cfg, **kw)
        return made["kern"], made["plain"]

    # (a) the continuous server: serial, the open burst, serial; the mix
    # again; every admission's host cost through the switcher timed
    client, recorder, reg = plan_app(model, tok)
    sw = client.app.plan_switcher
    check(sw is not None and sw.health_view()["active"] == "solo",
          "the continuous server starts on the solo plan")
    eng = sw.plans["solo"].engine
    check(sw.plans["batched"].engine is eng and eng.decode_kernel_mode == "xla",
          "both plans share the paged int8 engine (matmul kernels)")
    admit_us = []
    admit = sw.admit

    def timed_admit(prompt_len, max_new):
        t0 = time.perf_counter()
        out = admit(prompt_len, max_new)
        admit_us.append((time.perf_counter() - t0) * 1e6)
        return out

    sw.admit = timed_admit
    shapes0 = dict(eng.forward_shapes())
    cuda_build.reset_launch_counts()
    reports, first = [], None
    for _ in range(2):
        for mode, rate in MIX:
            reports.append(plan_run(client, recorder, mode, rate))
        if first is None:
            first = dict(eng.forward_shapes())
    counts = cuda_build.launch_counts()
    shapes = dict(eng.forward_shapes())
    delta = shapes_delta(shapes, shapes0)
    want = expected_launches(delta, L)
    check(counts == want, f"plan: launches {counts}, predicted {want} from "
                          f"the forwards {delta}")
    check(counts["quant_linear"] > 0 and counts["quant_head"] > 0,
          f"plan: the int8 kernels never ran: {counts}")
    flips = [(e["from"], e["to"]) for e in sw.events() if e["switched"]]
    check(("solo", "batched") in flips and ("batched", "solo") in flips,
          f"plan: no switch each way: {flips}")
    outside = sw.uncertified_shapes(shapes)
    check(not outside, f"plan: forward shapes outside the certified set: "
                       f"{outside}")
    replay_new = sorted(k for k in shapes if k not in first)
    check(all(b > 1 for b, _ in replay_new),
          f"plan: the replay added single-row shapes {replay_new}")
    runs = [replies(r) for r in reports]
    for i, r in enumerate(runs):
        check(all(st == 200 for st, _ in r),
              f"plan run {i}: outcomes {[st for st, _ in r]}")
    h = client.get("/healthz").json()
    check(h["auto_plan"] == sw.health_view()
          and h["auto_plan"]["switches"] == len(flips),
          f"plan: /healthz auto_plan {h['auto_plan']}")
    kv_pool.graftsan_sweep(timeout=10.0)
    phase_rows = [f"{mode} {rep['throughput_tokens_per_sec']} tokens/s, "
                  f"p50 e2e {rep['p50_e2e_ms']} ms"
                  for (mode, _), rep in zip(MIX * 2, reports)]
    n_fwd = sum(delta.values())
    cert = {lb: row["shape_total"] for lb, row in sw.certified.items()}
    print(f"  continuous int8 server (AUTO_PLAN_TRAFFIC={plan_traffic()}): "
          f"6 agentic runs of {PLAN_N} (serial, open at {PLAN_RATE:g}x, "
          f"serial; twice): {'; '.join(phase_rows)} [{smi}]")
    print(f"  switches {flips} (events {len(sw.events())}, wave "
          f"{sw.wave}); forwards {delta} ({n_fwd}); launches {counts} = the "
          f"forwards' prediction; every shape inside the certified set "
          f"(certified shapes {cert}); the replay's new shapes "
          f"{replay_new or 'none'}; switcher host cost a admission: median "
          f"{statistics.median(admit_us):.1f} us, max {max(admit_us):.1f} us "
          f"over {len(admit_us)} [{smi}]")
    launches = {"continuous server, 6 runs": counts}

    # replies: across the runs, and against each static plan
    eq = [plan_hold(r, runs[0], f"plan run {i}", engines, tok)
          for i, r in enumerate(runs[1:], 1)]
    statics = {}
    for label, env in (("solo paged, MAX_BATCH=1",
                        {"AUTO_PLAN_CONTINUOUS": None, "MAX_BATCH": "1",
                         "BATCH_MODE": "admission"}),
                       ("pooled iter, MAX_BATCH=8",
                        {"AUTO_PLAN_CONTINUOUS": None})):
        c2, r2, _ = plan_app(model, tok, **env)
        check(c2.app.plan_switcher is None, f"{label} is static")
        statics[label] = plan_hold(replies(plan_run(c2, r2, "serial")),
                                   runs[0], label, engines, tok)
        del c2, r2
    print(f"  replies (equal, held teacher-forced, worst logit_mse): runs "
          f"2-6 against run 1 {eq}; static plans against run 1 {statics} "
          f"[{smi}]")

    # (b) the same burst under GRAFTSCHED=trace: lock contention
    graftsched.clear()
    c3, r3, _ = plan_app(model, tok, GRAFTSCHED="trace")
    plan_run(c3, r3, "serial")
    burst = plan_run(c3, r3, "open", PLAN_RATE)
    check(graftsched.findings() == [],
          f"GRAFTSCHED findings: {[f.format() for f in graftsched.findings()]}")
    check(c3.app.plan_switcher.health_view()["active"] == "batched",
          "the traced burst switched to the batched plan")
    cont = graftsched.contention()
    top = sorted(cont.items(), key=lambda kv: -kv[1]["wait_seconds"])
    print(f"  GRAFTSCHED=trace, serial then the open burst ("
          f"{burst['throughput_tokens_per_sec']} tokens/s, p50 e2e "
          f"{burst['p50_e2e_ms']} ms): per lock (wait s, acquisitions, "
          f"contended > 1 ms): " + "; ".join(
              f"{name} {c['wait_seconds']} / {c['acquisitions']} / "
              f"{c['contended']}" for name, c in top) + f" [{smi}]")
    del c3, r3
    graftsched.clear()

    # (c) a serial pass with the env fault plan armed, on the pooled iter
    # plan (every one of its sites: admission load, block grants, decode
    # segments)
    c4, r4, _ = plan_app(model, tok, AUTO_PLAN_CONTINUOUS=None)
    with environ(PLAN_FAULT_ENV):
        graftfault.reset()
        try:
            faulted = replies(plan_run(c4, r4, "serial"))
            injections = collections.Counter(
                (i.site, i.kind) for i in graftfault.plan().injections)
        finally:
            graftfault.reset()
    check(injections, "the env fault plan fired nothing")
    check(all(st in (200, 429, 503) for st, _ in faulted),
          f"faulted pass: untyped outcomes {[st for st, _ in faulted]}")
    ok = [k for k, (st, _) in enumerate(faulted) if st == 200]
    f_eq = plan_hold([faulted[k] for k in ok], [runs[0][k] for k in ok],
                     "faulted pass", engines, tok, ks=ok)
    print(f"  GRAFTFAULT=1 seed {PLAN_FAULT_ENV['GRAFTFAULT_SEED']} rate "
          f"{PLAN_FAULT_ENV['GRAFTFAULT_RATE']}, serial on the pooled iter "
          f"plan: injections by (site, kind) {dict(sorted(injections.items()))}"
          f"; outcomes {collections.Counter(st for st, _ in faulted)}; the "
          f"200 replies against the unfaulted run (equal, held, worst) "
          f"{f_eq} [{smi}]")
    del client, recorder, c4, r4, made
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  [plan] {time.perf_counter() - t_phase:.1f} s wall [{smi}]")
    return launches


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


FLASH_TMA_KERNELS = ("fwd_bf16", "dq_bf16", "dkv_bf16")  # wgmma, TMA rings


def flash_sass(lib_path: str) -> dict:
    """``{kernel: counts}`` of HGMMA (wgmma), UTMALDG (TMA loads) and LDG
    (thread loads from global memory) in the SASS of each bf16 flash
    kernel of ``FLASH_TMA_KERNELS`` (the forward, dQ, dK/dV) in the built
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
    parser.add_argument("--phases",
                        default="kernels,flash,engine,server,batch,train,"
                                "paged,prefix,spec,remote,ckpt,moe,obs,fleet,"
                                "plan",
                        help="comma-separated subset of kernels,flash,engine,"
                             "server,batch,train,paged,prefix,spec,remote,"
                             "ckpt,moe,obs,fleet,plan")
    args = parser.parse_args()
    phases = set(args.phases.split(","))

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
            "dq_bf16": flash_lib.load().flash_dq_smem_bytes(),
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
    batch_launches = {}
    if "batch" in phases:
        print("[batch] batched serving and chunked prefill: the batchers "
              "and chunked prefill in process, batched int8 servers")
        batch_launches = batch_phase(smi)
    if "train" in phases:
        print("[train] llama-124m train steps, flash kernels vs plain "
              "attention")
        counts = train_phase()
        for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            launches[kernel] = counts[kernel]
    if "paged" in phases:
        print("[paged] paged KV: the movers, PagedKVRunner, quantized "
              "pools, the pooled iter server")
        paged_phase(smi)
    prefix_launches = {}
    if "prefix" in phases:
        print("[prefix] the prefix cache and the host tier: fp32 and int8 "
              "streams through the store, time to first token, the tier's "
              "moves, the tiered iter server, an int8 prefix server")
        prefix_launches = prefix_phase(smi)
    spec_launches = {}
    if "spec" in phases:
        print("[spec] speculative decoding: fp32 streams against the plain "
              "engine, int8 verify windows on the int8 kernels, timing, a "
              "SPEC_DECODE server")
        spec_launches = spec_phase(smi)
    remote_launches = {}
    if "remote" in phases:
        print("[remote] DISPATCH=remote: two GPT-2 shards on the card and a "
              "coordinator relaying /forward -> /forward_b, then shard b "
              "down")
        remote_launches = remote_phase(smi)
    ckpt_launches = {}
    if "ckpt" in phases:
        print("[ckpt] CHECKPOINT_DIR: GPT-2 124M saved, an int8 coordinator "
              "and shard a serving it")
        ckpt_launches = ckpt_phase(smi)
    moe_launches = {}
    if "moe" in phases:
        print("[moe] GPT-2-MoE from a checkpoint: int8 'layer' vs plain, "
              "timing, fp32 and batched int8 servers, train steps")
        moe_launches = moe_phase(smi)
    obs_launches = {}
    if "obs" in phases:
        print("[obs] observability: /metrics and /debug/* of an int8 server "
              "(CUDA-event scopes on the mega decode, the ledger beside the "
              "allocator, a tripped burn watch, the recorders' overhead) "
              "and of a tiered fp32 iter server (the timeline's tier "
              "events)")
        obs_launches = obs_phase(smi)
    fleet_launches = {}
    if "fleet" in phases:
        print("[fleet] the replica fleet: a router, one prefill and two "
              "decode replicas over one pool; fp32 byte-equal to the single "
              "replica, int8 on the int8 kernels, an open-loop run")
        fleet_launches = fleet_phase(smi)
    plan_launches = {}
    if "plan" in phases:
        print("[plan] continuous planning: an int8 AUTO_PLAN_CONTINUOUS "
              "server switching between the solo paged and pooled iter "
              "plans under agentic bursts, the static plans, lock "
              "contention under GRAFTSCHED=trace, a GRAFTFAULT pass")
        plan_launches = plan_phase(smi)

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
            "batch_launches": {where: c[k.name]
                               for where, c in batch_launches.items()},
            "prefix_launches": {where: c[k.name]
                                for where, c in prefix_launches.items()},
            "spec_launches": {where: c[k.name]
                              for where, c in spec_launches.items()},
            "remote_launches": {where: c[k.name]
                                for where, c in remote_launches.items()},
            "ckpt_launches": {where: c[k.name]
                              for where, c in ckpt_launches.items()},
            "moe_launches": {where: c[k.name]
                             for where, c in moe_launches.items()},
            "obs_launches": {where: c[k.name]
                             for where, c in obs_launches.items()},
            "fleet_launches": {where: c[k.name]
                               for where, c in fleet_launches.items()},
            "plan_launches": {where: c[k.name]
                              for where, c in plan_launches.items()},
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
