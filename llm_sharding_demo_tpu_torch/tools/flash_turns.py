"""Device time of the bf16 flash kernels, alone or in turns with another tree.

Times ``flash_bwd_dkv``, ``flash_bwd_dq`` and ``flash_fwd``
(``csrc/flash_attention.cu``) at llama-124m's training shape (bf16,
B=4, 12 heads, S=2048, head dim 64, causal), each beside the card's
bound for the same work (``chip_smoke.flash_bounds``), and SDPA's
backward (dq, dk and dv in one call; the yardstick of the two backward
kernels, which the port never calls), timed as ``chip_smoke.py`` times
it (``sdpa_backward_ms``). Each kernel time is the median device ms per
call of calls captured in one CUDA graph and replayed between CUDA
events (``chip_smoke.time_ms``), the inputs rotated over more than the
50 MB L2.

    python -m llm_sharding_demo_tpu_torch.tools.flash_turns
    python -m llm_sharding_demo_tpu_torch.tools.flash_turns --turns DIR

``--turns DIR`` times the package of another checkout (``DIR``, e.g. a
parent commit unpacked with ``git archive`` into a gitignored
directory), this checkout's, this checkout's again and ``DIR``'s again,
each in its own process on the same card, and prints each kernel's four
readings side by side. Needs a CUDA card and nvcc; the last line is a
JSON object of the readings.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
B, S = 4, 2048
KERNELS = ("flash_bwd_dkv", "flash_bwd_dq", "flash_fwd")


def smoke():
    """This checkout's ``chip_smoke.py`` as a module (its timing, bounds
    and SDPA yardstick), loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def time_tree(tree: str) -> dict:
    """The three kernels of checkout ``tree`` and SDPA's backward, timed
    at the training shape."""
    sm = smoke()
    sys.path.insert(0, tree)
    import torch

    from llm_sharding_demo_tpu_torch.ops import flash_attention as FA
    if not os.path.abspath(FA.__file__).startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {FA.__file__}, not {tree}'s package")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2048)
    sets = []
    for _ in range(sm.copies_for(4 * B * sm.H * S * sm.HD * 2)):
        q, k, v, do = (torch.randn(B, sm.H, S, sm.HD, generator=g,
                                   device=dev).to(torch.bfloat16)
                       for _ in range(4))
        out, lse = FA.flash_forward(q, k, v)
        sets.append((q, k, v, do, lse, FA.flash_delta(out, do)))
    calls = {
        "flash_bwd_dkv": [lambda s=s: FA.flash_bwd_dkv(*s) for s in sets],
        "flash_bwd_dq": [lambda s=s: FA.flash_bwd_dq(*s) for s in sets],
        "flash_fwd": [lambda s=s: FA.flash_forward(*s[:3]) for s in sets],
    }
    bounds = sm.flash_bounds(B, S, torch.bfloat16)
    rows = {}
    for name in KERNELS:
        ms = sm.time_ms(calls[name])[0]
        rows[name] = dict(ms=ms, bound_ms=bounds[name]["bound_ms"],
                          tflops=bounds[name]["flop"] / ms / 1e9)
        print(f"{name}: {ms:.4f} ms ({rows[name]['tflops']:.0f} TFLOP/s), "
              f"bound {rows[name]['bound_ms']:.4f} ms", flush=True)
    sdpa, (lo, hi) = sm.sdpa_backward_ms(sets)
    print(f"SDPA backward: {sdpa:.4f} ms (replays {lo:.4f}-{hi:.4f})",
          flush=True)
    result = dict(tree=tree, kernels=rows, sdpa_backward_ms=sdpa,
                  sdpa_backward_range=[lo, hi])
    plan = getattr(FA, "dkv_plan", None)
    if plan is not None:
        ctas = plan(B * sm.H, S, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        loads = [sum(FA.dkv_tile_cost(S, kt) for kt, _ in c) for c in ctas]
        result["dkv_plan"] = dict(ctas=len(ctas), q_tiles_min=min(loads),
                                  q_tiles_max=max(loads))
        print(f"dK/dV plan: {len(ctas)} CTAs, {min(loads)}-{max(loads)} "
              f"q tiles a CTA", flush=True)
    return result


def turns(other: str) -> dict:
    """``other``, this checkout, this checkout, ``other``: each timed in a
    process of its own."""
    # imported here: a turn runs this file as a script, with no package on
    # its path until time_tree puts the tree's there
    from llm_sharding_demo_tpu_torch.tools.linear_turns import run_turns
    runs = run_turns(os.path.abspath(__file__), other)
    print("kernel: other / this / this / other ms; bound ms")
    for name in KERNELS:
        times = " / ".join(f"{r['kernels'][name]['ms']:.4f}" for r in runs)
        print(f"{name}: {times}; {runs[1]['kernels'][name]['bound_ms']:.4f}")
    print("SDPA backward: " + " / ".join(
        f"{r['sdpa_backward_ms']:.4f}" for r in runs))
    return dict(turns=[r["tree"] for r in runs], runs=runs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--turns", metavar="DIR",
                        help="time DIR's package in turns with this one")
    parser.add_argument("--tree", default=HERE, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    device = smoke().nvidia_smi_line()
    print(device)
    result = (turns(os.path.abspath(args.turns)) if args.turns
              else time_tree(os.path.abspath(args.tree)))
    print(json.dumps(dict(result, device=device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
