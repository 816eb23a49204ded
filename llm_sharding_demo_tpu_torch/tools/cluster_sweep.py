"""Device time of the decode-attention kernel at each cluster size.

The kernel (``csrc/decode_attention.cu``) splits each (row, kv head)'s
cached positions over a cluster of C CTAs; ``ops/decode_attention.py``
``cluster_plan`` picks C. This tool launches the kernel through its
``Kernel`` entry with C forced to each of 1, 2, 3, 4, 6, 8, 12 and 16,
bf16, at llama-124m's and GPT-2's decode shapes (12 query heads over 4
or 12 kv heads, head dim 64), and prints the device time per launch of
each (launches captured in a CUDA graph and replayed, CUDA events;
inputs rotated over more than the 50 MB L2), beside the plan's C.

    python -m llm_sharding_demo_tpu_torch.tools.cluster_sweep

Needs a CUDA card and nvcc; the last line is a JSON object of the
readings.
"""

from __future__ import annotations

import json
import statistics
import subprocess

# (rows, kv heads, cached positions, cache slots)
CASES = ((1, 4, 3000, 4096), (1, 4, 4095, 4096), (1, 4, 255, 4096),
         (1, 12, 255, 1024), (8, 4, 3000, 4096), (16, 12, 1000, 1024),
         (8, 12, 255, 1024))
CLUSTERS = (1, 2, 3, 4, 6, 8, 12, 16)
LAYERS, HEADS, HD = 12, 12, 64


def device_ms(calls, reps: int = 7) -> float:
    """Median device ms per call of ``calls`` captured in one CUDA graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def main() -> int:
    import torch

    from ..ops import cuda_build as cb
    from ..ops import decode_attention as DA

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rows = []
    for B, hkv, off, slots in CASES:
        cache_bytes = LAYERS * B * hkv * slots * 2 * HD * 2
        n = max(1, min(64, -(-(160 << 20) // cache_bytes)))
        sets = [(rn(B, HEADS, 1, HD), rn(B, hkv, 1, HD), rn(B, hkv, 1, HD),
                 rn(LAYERS, B, hkv, slots, 2 * HD),
                 torch.empty(B, HEADS, 1, HD, dtype=torch.bfloat16,
                             device=dev)) for _ in range(n)]
        times = {}
        for c in CLUSTERS:
            if c > max(1, off):
                continue

            def call(s, li, c=c):
                cb.DECODE_ATTENTION.launch(
                    dev, s[0].data_ptr(), s[1].data_ptr(), s[2].data_ptr(),
                    s[3].data_ptr(), None, s[4].data_ptr(), 1, B, hkv,
                    HEADS // hkv, HD, slots, li, off, c, DA._q_scale(HD),
                    torch.cuda.current_stream().cuda_stream)
            times[c] = device_ms([lambda s=s, li=i % LAYERS: call(s, li)
                                  for i, s in enumerate(sets)])
        plan = DA.cluster_plan(off, B, hkv)[0]
        print(f"B={B} Hkv={hkv} offset={off} (plan C={plan}): " + " ".join(
            f"C={c} {ms * 1e3:.2f} us" for c, ms in times.items()),
            flush=True)
        rows.append(dict(B=B, Hkv=hkv, offset=off, plan=plan,
                         us={c: ms * 1e3 for c, ms in times.items()}))
        del sets
        torch.cuda.empty_cache()
    print(json.dumps({"device": smi, "cases": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
