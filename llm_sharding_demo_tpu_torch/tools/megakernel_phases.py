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
the same inputs in the same run), and each case's weight-ring plan
(``stage_plan``: stages, stage bytes, dynamic shared memory).

    python -m llm_sharding_demo_tpu_torch.tools.megakernel_phases
    python -m llm_sharding_demo_tpu_torch.tools.megakernel_phases --family llama
    python -m llm_sharding_demo_tpu_torch.tools.megakernel_phases --turns DIR

``--turns DIR`` loads the package of another checkout (``DIR``, e.g. a
parent commit unpacked with ``git archive`` into a gitignored directory)
beside this one, in one process, builds both trees' ``decode_layer.cu``,
and for both families at the ``TURNS_CASES`` (int8 12 layers at B=1 and
8, llama also at 3000 cached positions, bf16 B=1, the served 11- and
1-layer stages) measures ``DIR``'s kernel, this checkout's, this
checkout's again and ``DIR``'s again on the same inputs, printing each
tree's phase clock; it also checks that the two trees' outputs and
written cache rows are bit-identical on the same inputs (odd rows masked
over part of their cached positions), and exits non-zero if they are
not. Needs a CUDA card and nvcc; the last line is a JSON object of the
readings.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import json
import os
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
TURNS_CASES = {
    "gpt2": (("int8", 12, 1, 255), ("int8", 12, 8, 255),
             ("bf16", 12, 1, 255), ("int8", 11, 1, 255), ("int8", 1, 1, 255)),
    "llama": (("int8", 12, 1, 255), ("int8", 12, 8, 255),
              ("int8", 12, 1, 3000), ("bf16", 12, 1, 255),
              ("int8", 11, 1, 255), ("int8", 1, 1, 255)),
}
PKG = "llm_sharding_demo_tpu_torch"


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


class Tree:
    """One checkout's whole-stack kernels: its ``ops.decode_layer``,
    ``ops.quant`` and ``ops.cuda_build`` modules (another checkout's
    package loaded under an alias, so both live in one process), its
    ordinary library and its phase-clock build of ``decode_layer.cu``."""

    def __init__(self, root: str, alias: str = PKG):
        if alias != PKG:
            pkg = os.path.join(root, PKG)
            spec = importlib.util.spec_from_file_location(
                alias, os.path.join(pkg, "__init__.py"),
                submodule_search_locations=[pkg])
            mod = importlib.util.module_from_spec(spec)
            sys.modules[alias] = mod
            spec.loader.exec_module(mod)
        self.root = root
        self.DL = importlib.import_module(f"{alias}.ops.decode_layer")
        self.Q = importlib.import_module(f"{alias}.ops.quant")
        self.cb = cb = importlib.import_module(f"{alias}.ops.cuda_build")
        if not os.path.abspath(self.DL.__file__).startswith(
                os.path.abspath(root)):
            raise SystemExit(f"imported {self.DL.__file__}, not {root}'s "
                             "package")
        self.clock = cb.KernelLibrary(
            "decode_layer.cu",
            dict(cb.DECODE_LAYER_LIB.functions,
                 decode_layers_phase_clock=(ctypes.c_void_p,)),
            cb.DECODE_LAYER_LIB.error_fn,
            defines=("DECODE_LAYERS_PHASE_CLOCK",))
        self.libs = (cb.DECODE_LAYER_LIB, self.clock)

    def blocks(self, tree):
        """A block tree of this package's parameter types (its own
        ``QuantizedTensor``) over the same tensors."""
        if isinstance(tree, dict):
            return {k: self.blocks(v) for k, v in tree.items()}
        if type(tree).__name__ == "QuantizedTensor":
            return self.Q.QuantizedTensor(tree.q, tree.scale, tree.rows)
        return tree

    def plan(self, regime, B, cfg, is_llama):
        """This tree's weight-ring plan, or None before the ring."""
        if not hasattr(self.DL, "stage_plan"):
            return None
        kvw = (cfg.n_kv_head if is_llama else cfg.n_head) * cfg.head_dim
        inter = cfg.intermediate_size if is_llama else 4 * cfg.n_embd
        return self.DL.stage_plan(regime == "int8", B, cfg.n_embd, kvw,
                                  inter, is_llama)


def build(trees) -> None:
    """Every library of every tree, one nvcc each, all started together."""
    pending = [(lib, lib.start_build()) for t in trees for lib in t.libs]
    for lib, proc in pending:
        lib.finish_build(proc)


class Family:
    """A family's model, its full-width configuration and a way to call
    either tree's kernel on one input set."""

    def __init__(self, family: str):
        from ..models import gpt2, llama
        self.name = family
        self.is_llama = family == "llama"
        self.model = llama if self.is_llama else gpt2
        self.cfg = (llama.CONFIGS["llama-124m"] if self.is_llama
                    else gpt2.CONFIGS["gpt2"])
        self.n_kv = self.cfg.n_kv_head if self.is_llama else self.cfg.n_head
        self.eps = (self.cfg.rms_norm_eps if self.is_llama
                    else self.cfg.layer_norm_epsilon)

    def call(self, tree: Tree, blocks, h, kv, off, cos, sin, vf=None):
        DL, cfg = tree.DL, self.cfg
        if self.is_llama:
            return DL.decode_layers_llama(blocks, h, kv, off, cos, sin, vf,
                                          n_head=cfg.n_head, eps=self.eps)
        return DL.decode_layers(blocks, h, kv, off, vf, n_head=cfg.n_head,
                                eps=self.eps)

    def kernel(self, tree: Tree):
        cb = tree.cb
        return cb.DECODE_LAYERS_LLAMA if self.is_llama else cb.DECODE_LAYERS


def make_sets(torch, fam: Family, g, regime, n_layer, B):
    """Input sets (blocks, h, cache) of this package's types, as many as
    exceed 160 MB together (at most 24), so the weights stream from
    memory."""
    from ..models import gpt2
    from ..ops import quant as Q
    dev = torch.device("cuda")
    cfg = fam.cfg
    sets, per_set = [], 0
    while not sets or (len(sets) * per_set < 160 << 20 and len(sets) < 24):
        blocks = fam.model.init_params(cfg, g)["blocks"]
        blocks = gpt2.map_params(lambda x: x[:n_layer], blocks)
        if regime == "int8":
            blocks = Q.quantize_params({"blocks": blocks})["blocks"]
        else:
            blocks = gpt2.map_params(lambda x: x.to(torch.bfloat16), blocks)
        per_set = sum(t.numel() * t.element_size() for t in _tensors(blocks))
        sets.append((blocks, torch.randn(
            B, 1, cfg.n_embd, generator=g, device=dev).to(torch.bfloat16),
            torch.randn(n_layer, B, fam.n_kv, cfg.n_positions, 128,
                        generator=g, device=dev).to(torch.bfloat16)))
    return sets


def measure(torch, tree: Tree, fam: Family, sets, off, cos, sin, reps,
            stamps) -> dict:
    """One tree's device time per launch (ordinary and clock builds) and
    its phase clock on the sets."""
    n_layer = sets[0][2].shape[0]
    blocks = [tree.blocks(s[0]) for s in sets]
    kernel = fam.kernel(tree)

    def launch(i):
        s = sets[i % len(sets)]
        fam.call(tree, blocks[i % len(sets)], s[1], s[2], off, cos, sin)

    us = {}
    works, barriers, totals = [], [], []
    so = tree.clock.load()
    for lib in tree.libs:
        kernel.library = lib
        try:
            us[lib is tree.clock] = graph_us(torch, launch, reps)
            if lib is tree.clock:
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
            kernel.library = tree.cb.DECODE_LAYER_LIB
    work = [statistics.median(w[k] for w in works) / 1e3
            for k in range(len(PHASES))]
    barrier = [statistics.median(b[k] for b in barriers) / 1e3
               for k in range(len(PHASES))]
    n_barriers = 7 * n_layer - 1
    return dict(tree=tree.root, device_us=us[False],
                clock_build_device_us=us[True],
                clock_total_us=statistics.median(totals) / 1e3,
                work_us=dict(zip(PHASES, work)),
                barrier_us=dict(zip(PHASES, barrier)),
                weight_phases_us=sum(work[PHASES.index(p)]
                                     for p in ("QKV", "OUT", "FC", "PROJ")),
                us_per_barrier=sum(barrier) / n_barriers)


def describe(row: dict) -> str:
    return (f"device {row['device_us']:.1f} us per launch (clock build "
            f"{row['clock_build_device_us']:.1f} us, its clock "
            f"{row['clock_total_us']:.1f} us); over the layers, work / "
            f"barrier us: " + ", ".join(
                f"{p} {row['work_us'][p]:.1f}/{row['barrier_us'][p]:.1f}"
                for p in PHASES)
            + f"; weight phases {row['weight_phases_us']:.1f}; all work "
            f"{sum(row['work_us'].values()):.1f}, all barriers "
            f"{sum(row['barrier_us'].values()):.1f} "
            f"({row['us_per_barrier']:.2f} each)")


def same_bits(torch, trees, fam: Family, sets, off) -> bool:
    """Whether every tree gives the same bits (output and cache) on the
    first set, odd rows masked over half or all of their cached
    positions, each row's rotary angles at its own position."""
    from ..ops.rope import rope_angles
    blocks, h, kv = sets[0]
    B = h.shape[0]
    vf = torch.tensor([off * (b % 4 + 1) // 4 if b % 2 else 0
                       for b in range(B)], dtype=torch.int32, device=h.device)
    cos, sin = rope_angles(torch.clamp(off - vf.long(), min=0),
                           fam.cfg.head_dim)
    got = []
    for tree in trees:
        cache = kv.clone()
        out, _ = fam.call(tree, tree.blocks(blocks), h, cache, off, cos, sin,
                          vf)
        got.append((out.view(torch.int16), cache.view(torch.int16)))
    torch.cuda.synchronize()
    return all(torch.equal(a, got[0][0]) and torch.equal(c, got[0][1])
               for a, c in got[1:])


def run_cases(torch, trees, order, family, cases, reps) -> list:
    """Each case of ``family``: its sets, then a measurement of each tree
    of ``order`` (indices into ``trees``), printed; with two trees, also
    whether their bits agree."""
    from ..ops.rope import rope_angles
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    fam = Family(family)
    stamps = (ctypes.c_ulonglong * (1 + 2 * CLOCK_LAYERS * CLOCK_PHASES))()
    rows = []
    for regime, n_layer, B, off in cases:
        sets = make_sets(torch, fam, g, regime, n_layer, B)
        cos, sin = rope_angles(torch.full((B,), off, device=dev),
                               fam.cfg.head_dim)
        what = f"{family} {regime} {n_layer} layers B={B} offset={off}"
        row = dict(family=family, weights=regime, layers=n_layer, B=B,
                   offset=off, plan=trees[-1].plan(regime, B, fam.cfg,
                                                   fam.is_llama))
        print(f"{what}: plan (stages, stage bytes, shared memory) "
              f"{row['plan']}", flush=True)
        runs = []
        for i in order:
            r = measure(torch, trees[i], fam, sets, off, cos, sin, reps,
                        stamps)
            runs.append(r)
            print(f"  {trees[i].root}: {describe(r)}", flush=True)
        if len(trees) > 1:
            row["bit_identical"] = same_bits(torch, trees, fam, sets, off)
            print(f"  outputs and cache rows bit-identical across the trees: "
                  f"{row['bit_identical']}", flush=True)
            row["runs"] = runs
        else:
            row.update(runs[0])
        rows.append(row)
        del sets
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--family", choices=sorted(CASES), default="gpt2")
    parser.add_argument("--turns", metavar="DIR",
                        help="measure DIR's kernels in turns with this "
                             "checkout's (both families)")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    trees = [Tree(here)]
    if args.turns:
        trees.insert(0, Tree(os.path.abspath(args.turns), "turns_other"))
    build(trees)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    if args.turns:
        print(f"turns: {trees[0].root}, this checkout, this checkout, "
              f"{trees[0].root}")
        rows = []
        for family in sorted(TURNS_CASES):
            rows += run_cases(torch, trees, (0, 1, 1, 0), family,
                              TURNS_CASES[family], args.reps)
        print("weight phases' work us (QKV + OUT + FC + PROJ), other / "
              "this / this / other; device us per launch, the same order:")
        for r in rows:
            print(f"  {r['family']} {r['weights']} {r['layers']} layers "
                  f"B={r['B']} offset={r['offset']}: " + " / ".join(
                      f"{x['weight_phases_us']:.1f}" for x in r["runs"])
                  + "; " + " / ".join(f"{x['device_us']:.1f}"
                                      for x in r["runs"])
                  + f"; bit-identical {r['bit_identical']}")
        ok = all(r["bit_identical"] for r in rows)
        print(json.dumps({"device": smi, "reps": args.reps,
                          "turns": [trees[i].root for i in (0, 1, 1, 0)],
                          "bit_identical": ok, "cases": rows}))
        return 0 if ok else 1
    rows = run_cases(torch, trees, (0,), args.family, CASES[args.family],
                     args.reps)
    print(json.dumps({"device": smi, "reps": args.reps, "cases": rows}))
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
