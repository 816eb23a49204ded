"""Where a llama-124m train step's device time goes.

Runs ``LlamaTrainStep(llama-124m, adamw(1e-3), remat=True)`` on bf16
parameters with seeded random weights and ids ``[4, 2049]`` (S=2048, the
flash kernels' training shape), once with ``attention_impl="pallas"``
and once with "xla", and for each: two warm-up steps, the host time of
``--steps`` steps, then one step under ``torch.profiler`` (CPU and CUDA
activities). It prints each path's step time, the device time the trace
holds for one step and their ratio (the device's busy share), and the
kernels with the most device time, grouped by name.

    python -m llm_sharding_demo_tpu_torch.tools.train_profile

Needs a CUDA card and nvcc; the last line is a JSON object of the
readings.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np


def profile(impl: str, steps: int, top: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from ..models import gpt2, llama
    from ..training import train

    cfg = dataclasses.replace(llama.CONFIGS["llama-124m"],
                              attention_impl=impl)
    params = llama.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(5))
    step = train.LlamaTrainStep(cfg, train.adamw(1e-3), remat=True)
    p, state = step.init(gpt2.map_params(lambda x: x.to(torch.bfloat16),
                                         params))
    del params
    ids = step.shard_batch(np.random.default_rng(11).integers(
        0, cfg.vocab_size, (4, 2049)))
    for _ in range(2):
        p, state, loss = step(p, state, ids)
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        p, state, loss = step(p, state, ids)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        p, state, loss = step(p, state, ids)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] = (kernels.get(evt.name, 0.0)
                                 + evt.time_range.elapsed_us() / 1e3)
    device_ms = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    step_ms = statistics.median(times)
    print(f"attention_impl={impl!r}: step {step_ms:.1f} ms (median of "
          f"{steps}; the traced step {traced_ms:.1f} ms), device time in "
          f"the trace {device_ms:.1f} ms (busy {device_ms / step_ms:.1%} "
          f"of the median step)")
    for name, ms in ranked:
        print(f"  {ms:8.2f} ms  {ms / device_ms:6.1%}  {name[:110]}")
    return {"impl": impl, "step_ms": step_ms, "traced_step_ms": traced_ms,
            "device_ms": device_ms,
            "top": [{"name": n, "ms": ms} for n, ms in ranked]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--top", type=int, default=14)
    args = parser.parse_args()
    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    rows = [profile(impl, args.steps, args.top) for impl in ("pallas", "xla")]
    print(json.dumps({"device": smi, "paths": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
