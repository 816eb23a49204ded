"""Device time of the int8 kernels, alone or in turns with another tree.

Times ``quant_linear`` (``csrc/quant.cu``) at the projection shapes the
served models give it, at one row and, for llama's untied head and
GPT-2's c_fc, at 8 and 16 rows, and ``quant_head`` at GPT-2's tied head
(the 51200 x 768 table) at 1, 8 and 16 rows, each beside the bf16
matmul on the dequantised weights (the yardstick; the port never calls
it) and the card's bound for the same work (bytes over 3.35 TB/s or
operations over 989 TFLOP/s, the larger). Each time is the median
device ms per call of calls captured in one CUDA graph and replayed
between CUDA events, the inputs rotated over more than the 50 MB L2 so
the weights stream from memory.

    python -m llm_sharding_demo_tpu_torch.tools.linear_turns
    python -m llm_sharding_demo_tpu_torch.tools.linear_turns --turns DIR

``--turns DIR`` times the package of another checkout (``DIR``, e.g. a
parent commit unpacked with ``git archive`` into a gitignored
directory), this checkout's, this checkout's again and ``DIR``'s again,
each in its own process on the same card, and prints each shape's four
readings side by side. Needs a CUDA card and nvcc; the last line is a
JSON object of the readings.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# (rows, d, n): llama's untied head, GPT-2's c_fc, c_attn, llama's
# gate/up, the 768-wide q/o/attention c_proj, GPT-2's mlp c_proj,
# llama's down and k/v
SHAPES = ((1, 768, 32000), (8, 768, 32000), (16, 768, 32000),
          (1, 768, 3072), (8, 768, 3072), (16, 768, 3072), (1, 768, 2304),
          (1, 768, 2048), (1, 768, 768), (1, 3072, 768), (1, 2048, 768),
          (1, 768, 256))
# (rows, V_pad, d): GPT-2's tied head, its 50257 rows padded to 51200
HEAD_SHAPES = ((1, 51200, 768), (8, 51200, 768), (16, 51200, 768))
HBM_BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12


def device_ms(calls, reps: int = 7, rounds: int = 4) -> float:
    """Median device ms per call of ``rounds`` passes over ``calls``
    captured in one CUDA graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(rounds):
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
        times.append(start.elapsed_time(end) / (rounds * len(calls)))
    return statistics.median(times)


def time_tree(tree: str) -> dict:
    """Every shape of ``SHAPES`` timed on the package of checkout
    ``tree``."""
    sys.path.insert(0, tree)
    import torch

    from llm_sharding_demo_tpu_torch.ops import quant as Q
    if not os.path.abspath(Q.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {Q.__file__}, not {tree}'s package")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    plan = getattr(Q, "linear_plan", None)
    out = []
    for rows, d, n in SHAPES:
        sets = []
        for _ in range(max(1, min(64, -(-(160 << 20) // (d * n))))):
            qt = Q.quantize_array(
                torch.randn(d, n, generator=g, device=dev) * 0.02)
            sets.append((torch.randn(rows, d, generator=g, device=dev)
                         .to(torch.bfloat16), qt.q, qt.scale,
                         Q.dequantize_array(qt, torch.bfloat16)))
        nbytes = rows * d * 2 + d * n + n * 2 + rows * n * 2
        row = dict(rows=rows, d=d, n=n,
                   ms=device_ms([lambda s=s: Q.quant_linear(s[0], s[1], s[2])
                                 for s in sets]),
                   matmul_ms=device_ms([lambda s=s: torch.matmul(s[0], s[3])
                                        for s in sets]),
                   bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                2 * rows * d * n / BF16_OPS_PER_S) * 1e3)
        if plan is not None:
            bn, split = plan(rows, d, n)
            row.update(bn=bn, split=split, ctas=n // bn * split)
        out.append(row)
        print(f"{rows:2d} x {d}->{n}: kernel {row['ms']:.4f} ms, bf16 "
              f"matmul {row['matmul_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms"
              + (f"; bn={row['bn']} split={row['split']} CTAs={row['ctas']}"
                 if plan is not None else ""), flush=True)
        del sets
        torch.cuda.empty_cache()
    head_plan = getattr(Q, "head_plan", None)
    for rows, v, d in HEAD_SHAPES:
        sets = []
        for _ in range(max(1, min(64, -(-(160 << 20) // (v * d))))):
            q = torch.randint(-127, 128, (v, d), generator=g, device=dev,
                              dtype=torch.int8)
            sets.append((torch.randn(rows, d, generator=g, device=dev)
                         .to(torch.bfloat16), q, q.to(torch.bfloat16)))
        nbytes = rows * d * 2 + v * d + rows * v * 4
        row = dict(kernel="quant_head", rows=rows, d=d, n=v,
                   ms=device_ms([lambda s=s: Q.quant_head(s[0], s[1])
                                 for s in sets]),
                   matmul_ms=device_ms([lambda s=s: torch.matmul(s[0],
                                                                 s[2].t())
                                        for s in sets]),
                   bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                2 * rows * d * v / BF16_OPS_PER_S) * 1e3)
        if head_plan is not None:
            row["ctas"], row["span"] = head_plan(rows, v, d)
        out.append(row)
        print(f"{rows:2d} x head {v}x{d}: kernel {row['ms']:.4f} ms, bf16 "
              f"matmul {row['matmul_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms"
              + (f"; CTAs={row['ctas']} span={row['span']}"
                 if head_plan is not None else ""), flush=True)
        del sets
        torch.cuda.empty_cache()
    return dict(tree=tree, shapes=out)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def run_turns(script: str, other: str) -> list:
    """``script --tree T`` for T in ``other``, this checkout, this
    checkout, ``other``, each in a process of its own; the JSON object
    each prints last."""
    runs = []
    for i, tree in enumerate((other, HERE, HERE, other)):
        print(f"-- turn {i + 1}: {tree}", flush=True)
        proc = subprocess.run([sys.executable, script, "--tree", tree],
                              cwd=tree, capture_output=True, text=True,
                              timeout=900)
        print(proc.stdout, proc.stderr[-3000:], flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"turn {i + 1} ({tree}) exit {proc.returncode}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    return runs


def turns(other: str) -> dict:
    """``other``, this checkout, this checkout, ``other``: each timed in a
    process of its own."""
    runs = run_turns(os.path.abspath(__file__), other)
    print("rows x d->n: other / this / this / other ms; bf16 matmul; bound; "
          "this plan")
    for k, row in enumerate(runs[1]["shapes"]):
        times = " / ".join(f"{r['shapes'][k]['ms']:.4f}" for r in runs)
        head = row.get("kernel") == "quant_head"
        print(f"{row['rows']:2d} x "
              + (f"head {row['n']}x{row['d']}" if head
                 else f"{row['d']}->{row['n']}")
              + f": {times}; {row['matmul_ms']:.4f}; {row['bound_ms']:.4f}; "
              + (f"CTAs={row.get('ctas')} span={row.get('span')}" if head
                 else f"bn={row.get('bn')} split={row.get('split')} "
                      f"CTAs={row.get('ctas')}"))
    return dict(turns=[r["tree"] for r in runs], runs=runs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", metavar="DIR",
                        help="time DIR's package in turns with this one")
    parser.add_argument("--tree", default=HERE, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    device = smi()
    print(device)
    result = (turns(os.path.abspath(args.turns)) if args.turns
              else time_tree(os.path.abspath(args.tree)))
    print(json.dumps(dict(result, device=device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
