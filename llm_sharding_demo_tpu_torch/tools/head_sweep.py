"""Device time of the int8 head kernel's variants: grid, ring, warps, sums.

Builds copies of ``csrc/quant.cu`` with one setting of the head kernel
(``quant_head_kernel``) changed by a text edit, and times each beside the
shipped one at GPT-2's tied head (the 51200 x 768 table) at 1, 8 and 16
rows: one CTA an SM instead of ``head_plan``'s two, 16 or 48 ring stages
instead of 32, 4 consumer warps instead of 8, three CTAs an SM with 4
warps and 16 stages, and each mma from a zero C added into the running
sum instead of the chain of accumulating mmas. Each variant is first
held against ``head_plain`` (atol 1e-3, rtol 1e-5), then timed in a
process of its own (a kernel fault ends only that variant), in the order
there and back, each time the median device ms per call of calls
replayed from a CUDA graph over inputs rotated past the 50 MB L2.

    python -m llm_sharding_demo_tpu_torch.tools.head_sweep

Needs a CUDA card and nvcc; the last line is a JSON object of the
readings.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from llm_sharding_demo_tpu_torch.ops import cuda_build as cb
from llm_sharding_demo_tpu_torch.tools.linear_turns import device_ms, smi

V_PAD, D = 51200, 768
STAGES = "constexpr int kHeadStages = 32;"
WARPS = "constexpr int kHeadWarps = 8; "
BOUNDS = "__launch_bounds__(kHeadThreads, 2)"
CHAIN = ("          mma(acc[nt], a0, a1, a2, a3, xb[nt][2 * j], "
         "xb[nt][2 * j + 1]);")
ZERO_C = """        {
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          mma(p, a0, a1, a2, a3, xb[nt][2 * j], xb[nt][2 * j + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] += p[e];
        }"""
# name: (CTAs an SM, source edits)
VARIANTS = {
    "shipped": (2, []),
    "1 CTA an SM": (1, [(BOUNDS, BOUNDS.replace("2)", "1)"))]),
    "16 stages": (2, [(STAGES, STAGES.replace("32", "16"))]),
    "48 stages": (2, [(STAGES, STAGES.replace("32", "48"))]),
    "4 warps": (2, [(WARPS, WARPS.replace("8", "4"))]),
    "3 CTAs an SM, 4 warps, 16 stages": (
        3, [(BOUNDS, BOUNDS.replace("2)", "3)")),
            (WARPS, WARPS.replace("8", "4")),
            (STAGES, STAGES.replace("32", "16"))]),
    "zero-C sums": (2, [(CHAIN, ZERO_C)]),
}


def library(name: str) -> cb.KernelLibrary:
    """The quant library of variant ``name``, its source written under
    ``build/head_sweep/``."""
    src = open(cb.QUANT_LIB.source).read()
    for old, new in VARIANTS[name][1]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not once in quant.cu")
        src = src.replace(old, new)
    d = os.path.join(os.path.dirname(cb.BUILD_DIR), "head_sweep",
                     str(list(VARIANTS).index(name)))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "quant.cu")
    with open(path, "w") as f:
        f.write(src)
    return cb.KernelLibrary(path, cb.QUANT_LIB.functions,
                            cb.QUANT_LIB.error_fn)


def registers(lib: cb.KernelLibrary) -> dict:
    """``{n8 tiles of activation rows: registers}`` of the head kernel."""
    out, tiles = {}, None
    for line in lib.build_log.splitlines():
        if "Function properties for" in line:
            name = line.split()[-1]
            tiles = (int(name.split("quant_head_kernelILi")[1].split("E")[0])
                     if "quant_head_kernelILi" in name else None)
        elif tiles is not None and "Used" in line and "registers" in line:
            out[tiles] = int(line.split("Used")[1].split()[0])
            tiles = None
    return out


def time_variant(name: str) -> dict:
    """Check variant ``name`` against ``head_plain``, then time it at rows
    1, 8 and 16."""
    import torch

    from llm_sharding_demo_tpu_torch.ops import quant as Q
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cb.QUANT_HEAD.library = library(name)
    Q.HEAD_CTAS_PER_SM = VARIANTS[name][0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    table = Q.quantize_params(
        {"wte": torch.randn(50257, D, generator=g, device=dev) * 0.02})["wte"]
    for rows in (1, 16):
        x = torch.randn(rows, D, generator=g, device=dev).to(torch.bfloat16)
        got, want = Q.quant_head(x, table.q), Q.head_plain(x, table.q)
        if not torch.allclose(got, want, atol=1e-3, rtol=1e-5):
            raise SystemExit(f"{name} rows={rows}: max err "
                             f"{(got - want).abs().max().item()}")
    del table
    out = {"ctas": Q.head_plan(1, V_PAD, D)[0]}
    for rows in (1, 8, 16):
        sets = []
        for _ in range(max(1, -(-(160 << 20) // (V_PAD * D)))):
            q = torch.randint(-127, 128, (V_PAD, D), generator=g, device=dev,
                              dtype=torch.int8)
            sets.append((torch.randn(rows, D, generator=g, device=dev)
                         .to(torch.bfloat16), q))
        out[rows] = device_ms([lambda s=s: Q.quant_head(s[0], s[1])
                               for s in sets])
        del sets
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.variant:
        print(json.dumps(time_variant(args.variant)))
        return 0
    device = smi()
    print(device)
    libs = {name: library(name) for name in VARIANTS}
    procs = {name: lib.start_build() for name, lib in libs.items()}
    for name, lib in libs.items():
        lib.finish_build(procs[name])
        print(f"{name}: registers a thread (n8 tiles: registers) "
              f"{registers(lib)}", flush=True)
    readings = {name: [] for name in VARIANTS}
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        proc = subprocess.run([sys.executable, "-m", __spec__.name,
                               "--variant", name], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode != 0:
            print(f"{name}: failed: {proc.stderr[-1500:]}", flush=True)
            readings[name].append(None)
            continue
        readings[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{name}: {readings[name][-1]}", flush=True)
    print("variant: rows 1 / 8 / 16 device ms, there and back")
    for name, runs in readings.items():
        print(f"{name} (CTAs {VARIANTS[name][0] * 132}): " + "; ".join(
            "failed" if r is None else
            " / ".join(f"{r[str(k)]:.4f}" for k in (1, 8, 16))
            for r in runs))
    print(json.dumps(dict(device=device, readings=readings)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
