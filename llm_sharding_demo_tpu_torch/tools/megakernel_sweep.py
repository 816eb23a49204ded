"""Phase clock of the whole-stack decode kernels' variants: ring, refill, sums.

Builds copies of ``csrc/decode_layer.cu`` with one setting of the weight
path changed by a text edit (or the weight ring's stage count capped in
``stage_plan``), and measures each beside the shipped one with
``megakernel_phases``'s clock: 2 or 3 ring stages instead of
``stage_plan``'s 3-5, every thread prefetching the layer's later weights
into L2 at the end of attention (the kernel before the ring), each
slice's stages refilled after the task's last barrier
instead of before its warps' sums are added, the shuffle sums of a row
group's absent rows kept, and each norm's normalizing pass run by the
whole block (a thread a few columns of every row) instead of by each
row's statistics warp. Each variant is first held against the
plain version (``graftnum.compare_stack``, GPT-2 int8, B=1), then
measured in a process of its own (a kernel fault ends only that
variant), in the order there and back: the device time per launch and
the four weight phases' work, at the ``CASES`` below.

    python -m llm_sharding_demo_tpu_torch.tools.megakernel_sweep

Needs a CUDA card and nvcc; the last line is a JSON object of the
readings.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

from llm_sharding_demo_tpu_torch.ops import cuda_build as cb
from llm_sharding_demo_tpu_torch.tools import megakernel_phases as MP

# (family, weights, layers, batch rows, cached positions)
CASES = (("gpt2", "int8", 12, 1, 255), ("llama", "int8", 12, 1, 255),
         ("llama", "int8", 12, 8, 255), ("llama", "int8", 12, 1, 3000),
         ("gpt2", "bf16", 12, 1, 255))
MERGE_FN = "// folds the softmax state (m, l, a) into the running one"
SYNC_ATT = "    phase_sync(grid, l, 1);"
# every thread prefetches the layer's later weights and the next layer's
# q/k/v into L2 at the end of ATT (what the kernel did before the ring)
PREFETCH_FN = """
__device__ __forceinline__ void prefetch_l2(const void* p, size_t bytes,
                                            size_t tid, size_t threads) {
  const char* c = static_cast<const char*>(p);
  for (size_t o = tid * 128; o < bytes; o += threads * 128)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(c + o));
}

"""
PREFETCH_CALLS = """    {
      auto mat = [&](int i, int rows, int cols, int layer) {
        return static_cast<const W*>(p.w[i]) + (size_t)layer * rows * cols;
      };
      // the layer's later weights and the next layer's q/k/v, into L2
      const size_t wsz = sizeof(W);
      prefetch_l2(mat(iWo, D, D, l), (size_t)D * D * wsz, gtid, gthreads);
      if (kLlama) {
        prefetch_l2(mat(10, D, I, l), (size_t)D * I * wsz, gtid, gthreads);
        prefetch_l2(mat(12, D, I, l), (size_t)D * I * wsz, gtid, gthreads);
        prefetch_l2(mat(14, I, D, l), (size_t)I * D * wsz, gtid, gthreads);
        if (l + 1 < p.L) {
          prefetch_l2(mat(1, D, D, l + 1), (size_t)D * D * wsz, gtid, gthreads);
          prefetch_l2(mat(3, D, kvw, l + 1), (size_t)D * kvw * wsz, gtid,
                      gthreads);
          prefetch_l2(mat(5, D, kvw, l + 1), (size_t)D * kvw * wsz, gtid,
                      gthreads);
        }
      } else {
        prefetch_l2(mat(10, D, 4 * D, l), (size_t)4 * D * D * wsz, gtid,
                    gthreads);
        prefetch_l2(mat(13, 4 * D, D, l), (size_t)4 * D * D * wsz, gtid,
                    gthreads);
        if (l + 1 < p.L)
          prefetch_l2(mat(2, D, 3 * D, l + 1), (size_t)3 * D * D * wsz, gtid,
                      gthreads);
      }
    }
"""
EARLY = "    if (r0 + kRowGroup >= B) ring_release<W>(p, ring, boxes);\n"
TASK_END = """        part[(size_t)(r0 + r) * ldp + pcol0 + c] = s;
      }
    }
    __syncthreads();
  }
}"""
SKIP = """      if (r0 + r < B) {
#pragma unroll
        for (int j = 0; j < kCpt; ++j) {
          float v = acc[r][j];"""
# the norm's normalizing pass by the whole block (each thread a few
# columns of every row, their scale and bias loaded once) instead of by
# the statistics' warp of each row
BLOCK_NORM = [
    ("  const int warp = threadIdx.x >> 5;\n  for (int r = warp; r < B; "
     "r += kWarps) {\n    bf16* x = xs + (size_t)r * D;\n    if (kRms) {",
     "  const int warp = threadIdx.x >> 5;\n  __shared__ float2 stats[kMaxB];"
     "\n  for (int r = warp; r < B; r += kWarps) {\n    bf16* x = xs + "
     "(size_t)r * D;\n    if (kRms) {"),
    ("      const float inv = rsqrtf(warp_sum(sq) / D + eps);\n      for (int "
     "c = lane; c < D; c += 32)\n        x[c] = __float2bfloat16_rn(rnd(ld(x"
     ", c) * inv) * ld(s, c));\n",
     "      const float inv = rsqrtf(warp_sum(sq) / D + eps);\n      if (lane "
     "== 0) stats[r] = make_float2(0.f, inv);\n"),
    ("      const float inv = rsqrtf(warp_sum(sq) / D + eps);\n      for (int "
     "c = lane; c < D; c += 32)\n        x[c] = __float2bfloat16_rn((ld(x, c)"
     " - mean) * inv * ld(s, c) +\n                                   ld(b, c)"
     ");\n    }\n  }\n  __syncthreads();\n}",
     "      const float inv = rsqrtf(warp_sum(sq) / D + eps);\n      if (lane "
     "== 0) stats[r] = make_float2(mean, inv);\n    }\n  }\n  "
     "__syncthreads();\n  for (int c = threadIdx.x; c < D; c += kThreads) {"
     "\n    const float sc = ld(s, c);\n    const float bi = kRms ? 0.f : "
     "ld(b, c);\n    for (int r = 0; r < B; ++r) {\n      bf16* x = xs + "
     "(size_t)r * D + c;\n      const float2 st = stats[r];\n      *x = kRms "
     "? __float2bfloat16_rn(rnd(ld(x, 0) * st.y) * sc)\n                : "
     "__float2bfloat16_rn((ld(x, 0) - st.x) * st.y * sc + bi);\n    }\n  }"
     "\n  __syncthreads();\n}"),
]
# name: (ring stages at most, or None for stage_plan's; source edits)
VARIANTS = {
    "shipped": (None, []),
    "2 stages": (2, []),
    "3 stages": (3, []),
    "L2 prefetch during attention": (None, [
        (MERGE_FN, PREFETCH_FN + MERGE_FN),
        (SYNC_ATT, PREFETCH_CALLS + SYNC_ATT)]),
    "refill at the task's end": (None, [
        (EARLY, ""),
        (TASK_END, TASK_END[:-1] + "  ring_release<W>(p, ring, boxes);\n}")]),
    "absent rows' sums kept": (None, [(SKIP, SKIP.replace(
        "if (r0 + r < B) {", "{"))]),
    "norm pass by the whole block": (None, BLOCK_NORM),
}


def libraries(name: str):
    """The ordinary and phase-clock libraries of variant ``name``, its
    source written under ``build/megakernel_sweep/``."""
    src = open(cb.DECODE_LAYER_LIB.source).read()
    for old, new in VARIANTS[name][1]:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not once in "
                             "decode_layer.cu")
        src = src.replace(old, new)
    d = os.path.join(os.path.dirname(cb.BUILD_DIR), "megakernel_sweep",
                     str(list(VARIANTS).index(name)))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "decode_layer.cu")
    with open(path, "w") as f:
        f.write(src)
    functions = dict(cb.DECODE_LAYER_LIB.functions)
    return (cb.KernelLibrary(path, functions, cb.DECODE_LAYER_LIB.error_fn),
            cb.KernelLibrary(path, dict(
                functions, decode_layers_phase_clock=(ctypes.c_void_p,)),
                cb.DECODE_LAYER_LIB.error_fn,
                defines=("DECODE_LAYERS_PHASE_CLOCK",)))


def measure_variant(name: str) -> dict:
    """Check variant ``name`` against the plain version, then measure it
    at every case."""
    import torch

    from llm_sharding_demo_tpu_torch.ops.rope import rope_angles
    from llm_sharding_demo_tpu_torch.utils import graftnum
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    tree = MP.Tree(MP.__file__.rsplit(os.sep, 3)[0])
    tree.libs = libraries(name)
    tree.clock = tree.libs[1]
    if VARIANTS[name][0] is not None:
        tree.DL.MAX_STAGES = VARIANTS[name][0]
    for fam in (MP.Family("gpt2"), MP.Family("llama")):
        fam.kernel(tree).library = tree.libs[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stamps = (ctypes.c_ulonglong * (1 + 2 * MP.CLOCK_LAYERS
                                    * MP.CLOCK_PHASES))()
    out = {}
    for family, regime, n_layer, B, off in CASES:
        fam = MP.Family(family)
        sets = MP.make_sets(torch, fam, g, regime, n_layer, B)
        cos, sin = rope_angles(torch.full((B,), off, device=dev),
                               fam.cfg.head_dim)
        key = f"{family} {regime} {n_layer} layers B={B} offset={off}"
        if not out:
            blocks, h, kv = sets[0]
            got, _ = fam.call(tree, blocks, h, kv.clone(), off, cos, sin)
            plain = (tree.DL.decode_layers_llama_plain if fam.is_llama
                     else tree.DL.decode_layers_plain)
            if fam.is_llama:
                want, _ = plain(blocks, h, kv.clone(), off, cos, sin,
                                n_head=fam.cfg.n_head, eps=fam.eps)
            else:
                want, _ = plain(blocks, h, kv.clone(), off,
                                n_head=fam.cfg.n_head, eps=fam.eps)
            graftnum.compare_stack(got, want, h)
        row = MP.measure(torch, tree, fam, sets, off, cos, sin, 10, stamps)
        fam.kernel(tree).library = tree.libs[0]
        out[key] = dict(device_us=row["device_us"],
                        weight_phases_us=row["weight_phases_us"],
                        work_us=row["work_us"],
                        plan=tree.plan(regime, B, fam.cfg, fam.is_llama))
        del sets
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variant", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.variant:
        print(json.dumps(measure_variant(args.variant)))
        return 0
    device = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(device)
    # variants with the same source share one library
    libs = {lib.path: lib for name in VARIANTS for lib in libraries(name)}
    for lib, proc in [(lib, lib.start_build()) for lib in libs.values()]:
        lib.finish_build(proc)
    for name in VARIANTS:
        lib = libs[libraries(name)[0].path]
        print(f"{name}: " + "; ".join(
            line.strip() for line in lib.build_log.splitlines()
            if "spill" in line or "Used" in line), flush=True)
    readings = {name: [] for name in VARIANTS}
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        proc = subprocess.run([sys.executable, "-m", __spec__.name,
                               "--variant", name], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            print(f"{name}: failed: {proc.stderr[-1500:]}", flush=True)
            readings[name].append(None)
            continue
        readings[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(f"{name}: {readings[name][-1]}", flush=True)
    print("variant: device us per launch / weight phases' work us, there "
          "and back, at " + "; ".join(
              f"{f} {w} B={b} offset={o}" for f, w, _, b, o in CASES))
    for name, runs in readings.items():
        print(f"{name}: " + " || ".join(
            "failed" if r is None else "; ".join(
                f"{v['device_us']:.1f} / {v['weight_phases_us']:.1f}"
                for v in r.values()) for r in runs))
    print(json.dumps(dict(device=device, readings=readings)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
