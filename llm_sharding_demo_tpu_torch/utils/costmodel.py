"""The cost model and the static planner behind ``AUTO_PLAN``.

Counterpart of ``tools/graftcheck/costmodel.py``, over the port's own
engines and ranks. It traces nothing: every term is byte arithmetic on
shapes (the family's ``init_params`` under ``FakeTensorMode``, the
port's layout tables, its cache and pool geometry) or a closed form.

What continuous planning (``utils.graftwatch``) reads:

- ``ICI_BYTE_WEIGHT``, the a-priori cost of one interconnect byte
  against one streamed HBM byte, and ``PAGED_SEG_STEPS``, the iteration
  batcher's segment width (a paged row pays one gather and one scatter
  of its cache a segment);
- the traffic mix: ``TrafficRow``, ``DEFAULT_TRAFFIC`` and
  ``parse_traffic`` (``"16/32x8,64/16"``: 8 concurrent 16-token prompts
  decoding 32, and one 64-token prompt decoding 16);
- ``param_bytes``: the bytes of a family's f32 ``init_params`` tree. The
  JAX package measures the same tree through ``jax.eval_shape``; here the
  port's own ``init_params`` runs under ``FakeTensorMode``, which builds
  shapes and allocates nothing. Both packages score plans with the same
  parameter bytes, whatever dtype the server runs;
- ``kv_cache_bytes``: the ``[L, B, Hkv, max_seq, hd]`` k/v pair of a
  contiguous cache, 4 bytes an element, and ``kv_pool_bytes``, the paged
  pool's one buffer (``ops.paged_attention.pool_shape``, trash block
  included);
- ``CalibrationError`` and ``calibrate``: the interconnect weight a
  bench journal's ``ici_byte_weight_calibration`` row measured (None for
  an absent or skipped row, a typed error for a malformed one).

The static planner (``plan``, ``plan_for_serving``): enumerate the
serving candidates a mesh admits (``Candidate``: topology single, pp,
tp, ep or kvp x batch mode x width x pool geometry), gate each
(``gate_candidate``: the app's composition guards with the JAX
package's messages, then the port's own contracts: the stage split of
``parallel.partition``, the split dims of ``parallel.spmd``'s layout
tables, the paged movers' shapes on meta tensors), score the survivors
(``score_candidate``: weight bytes a device over the effective batch, a
row's KV bytes, the paged gather/scatter a segment, and
``ICI_BYTE_WEIGHT`` x the interconnect bytes a token) and rank them. A
candidate that fails a gate is a rejected row with findings, never a
missing row; one over the device's memory is an infeasible row.

Interconnect bytes a decoded token, closed forms in f32 activations
(each the JAX package's traced schedule; ``comm_bytes_per_token``):

- pp over ``n`` stages: ``4BD (n - 1)(n + 2)``: a tick a stage, each
  handing ``[B, 1, D]`` along the ``n - 1`` ring pairs, then one
  all-reduce of the output, ``2 x 4BD x (n - 1)``;
- tp over ``n`` ranks: two all-reduces of ``[B, 1, D]`` a block (after
  the row-parallel attention and MLP products), ``2 x 4BD x (n - 1)``
  each;
- ep over ``n`` ranks: two all-to-alls a block of the dispatched rows
  ``[n, (E / n) x B x C, D]`` (C the expert capacity of one token), each
  moving its operand ``x (n - 1)``;
- kvp over ``n`` ranks: one all-gather a block of the partial softmax,
  ``o [B, Hq, hd]`` and ``lse [B, Hq]``, ``x n x (n - 1)``.

Where the JAX package counts jitted programs a row compiles, a row here
carries the cached forward shapes ``(batch, tokens)`` it runs
(``forward_shapes``, ``shape_total``, ``shapes_exact``), what
``DecodeEngine.forward_shapes()`` observes: exact for an admission row
(the traffic's calls replayed on the engine) and the solo paged runner,
a static bound for iteration rows (``graftwatch.batched_shapes``) and an
estimate for pp and kvp rows. The memory budget is the serving device's
own (``device_memory_bytes``: the card's total memory, the host's
physical memory on the CPU) unless the caller names one.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

# relative cost of one interconnect byte against one streamed HBM byte
ICI_BYTE_WEIGHT = 4.0
# the iteration batcher's segment width: a paged row pays one gather and
# one scatter of its cache a segment
PAGED_SEG_STEPS = 32


@dataclasses.dataclass(frozen=True)
class TrafficRow:
    """One request class: ``count`` concurrent requests of ``prompt_len``
    prompt tokens decoding ``max_new``."""

    prompt_len: int
    max_new: int
    count: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_TRAFFIC: Tuple[TrafficRow, ...] = (TrafficRow(16, 32, 1),)


def parse_traffic(spec: str) -> Tuple[TrafficRow, ...]:
    """``"16/32x8,64/16"`` -> the rows it names. Elements are
    ``prompt/new[xcount]``, comma-separated."""
    rows: List[TrafficRow] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        shape, _, cnt = part.partition("x")
        p, sep, n = shape.partition("/")
        try:
            row = TrafficRow(int(p), int(n) if sep else 0,
                             int(cnt) if cnt else 1)
        except ValueError as e:
            raise ValueError(
                f"bad traffic element {part!r}: want prompt/new[xcount], "
                f"e.g. 16/32x8") from e
        if row.prompt_len < 1 or row.max_new < 1 or row.count < 1:
            raise ValueError(
                f"bad traffic element {part!r}: prompt/new/count must "
                "all be >= 1")
        rows.append(row)
    if not rows:
        raise ValueError(f"traffic spec {spec!r} names no request shapes")
    return tuple(rows)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@functools.lru_cache(maxsize=64)
def param_bytes(config) -> int:
    """Bytes of the family's f32 ``init_params`` tree, from its shapes
    alone (``FakeTensorMode``: no storage is allocated)."""
    with _fake_mode():
        return sum(t.numel() * t.element_size()
                   for t in _leaves(_fake_params(config)))


def kv_cache_bytes(config, batch: int, max_seq: int,
                   dtype_bytes: int = 4) -> int:
    """A contiguous cache's ``[L, B, Hkv, max_seq, hd]`` k/v pair."""
    heads = getattr(config, "n_kv_head", config.n_head)
    return (2 * config.n_layer * batch * heads * max_seq
            * config.head_dim * dtype_bytes)


def kv_pool_bytes(config, num_blocks: int, block_size: int,
                  dtype_bytes: int = 4) -> int:
    """The paged pool's one buffer, ``ops.paged_attention.pool_shape``
    (the trash block included)."""
    from ..ops.paged_attention import pool_shape
    heads = getattr(config, "n_kv_head", config.n_head)
    return math.prod(pool_shape(config.n_layer, num_blocks, heads,
                                block_size, config.head_dim)) * dtype_bytes


class CalibrationError(ValueError):
    """A calibration row is present in the journal but unparsable. A
    skipped row (off the card, say) calibrates nothing and is no error;
    a malformed one must not fall back to the a-priori weight in
    silence."""


def config_row(journal, name: str) -> Optional[dict]:
    """The config row ``name`` of a bench journal: a raw payload, one
    wrapped under ``parsed``, or the row itself."""
    doc = journal
    if isinstance(doc, dict) and "parsed" in doc:
        doc = doc.get("parsed")
    if not isinstance(doc, dict):
        return None
    if doc.get("name") == name:
        return doc
    for cfg in doc.get("configs") or ():
        if isinstance(cfg, dict) and cfg.get("name") == name:
            return cfg
    return None


def calibrate(journal) -> Optional[float]:
    """The interconnect byte weight a journal's
    ``ici_byte_weight_calibration`` row measured: the weight it was
    measured against (``ici_byte_weight``, the a-priori one when the row
    omits it) times ``measured_over_modeled``. None when the row is
    absent, skipped or errored; ``CalibrationError`` when it is present
    but malformed."""
    row = config_row(journal, "ici_byte_weight_calibration")
    if row is None or row.get("skipped") or row.get("error"):
        return None
    ratio = row.get("measured_over_modeled")
    if not isinstance(ratio, (int, float)) or isinstance(ratio, bool) \
            or ratio <= 0:
        raise CalibrationError(
            "ici_byte_weight_calibration row is present but its "
            f"measured_over_modeled={ratio!r} is not a positive number "
            "— refusing to fall back silently on a malformed row "
            "(skipped rows calibrate nothing; malformed rows fail "
            "loudly)")
    base = row.get("ici_byte_weight")
    if base is None:
        base = ICI_BYTE_WEIGHT        # older rows omit the base weight
    elif not isinstance(base, (int, float)) or isinstance(base, bool) \
            or base <= 0:
        raise CalibrationError(
            "ici_byte_weight_calibration row is present but its "
            f"ici_byte_weight={base!r} is not a positive number — "
            "the row does not say what weight it was measured against")
    return float(base) * float(ratio)


# -- the static planner --------------------------------------------------------

_APP_PATH = "llm_sharding_demo_tpu_torch/serving/app.py"

# the config fields each mesh axis must divide, by family: the divisor
# fields of the JAX package's SHARDING_DESCRIPTORs (kvp None: the family
# declares none, so pool-plane sharding is unreviewable for it)
_DIVISORS = {
    "gpt2": {"tp": ("n_head",), "ep": (), "kvp": ("n_head",)},
    "llama": {"tp": ("n_head", "n_kv_head"), "ep": (),
              "kvp": ("n_kv_head",)},
    "moe": {"tp": ("n_head",), "ep": ("n_experts",), "kvp": None},
}


def concurrency(traffic: Sequence[TrafficRow]) -> int:
    return sum(r.count for r in traffic)


def device_memory_bytes(device=None) -> int:
    """The serving device's memory: a card's total memory, the host's
    physical memory for the CPU."""
    import torch

    from .device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


@dataclasses.dataclass(frozen=True)
class Finding:
    """Why a gate rejected a candidate (the JAX package's finding
    record: rule, file, line, scope, message)."""

    rule: str
    path: str
    line: int
    scope: str
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One serving configuration the planner scores — exactly the knobs
    ``utils.config.ServingConfig`` exposes, so a chosen candidate maps
    1:1 onto env vars / an AUTO_PLAN override."""

    topology: str = "single"          # single | pp | tp | ep | kvp | kvp-tp
    boundaries: Tuple[int, ...] = ()  # pp stage split (interior bounds)
    batch_mode: str = "admission"
    max_batch: int = 1
    kv_pool_blocks: int = 0
    kv_block_size: int = 16

    @property
    def n_stages(self) -> int:
        return len(self.boundaries) + 1 if self.topology == "pp" else 1

    def label(self) -> str:
        parts = [self.topology]
        if self.topology == "pp":
            parts.append("b" + "+".join(str(b) for b in self.boundaries))
        parts.append(self.batch_mode)
        parts.append(f"mb{self.max_batch}")
        if self.kv_pool_blocks:
            parts.append(f"kv{self.kv_pool_blocks}x{self.kv_block_size}")
        return "/".join(parts)

    def serving_env(self) -> Dict[str, str]:
        """The env-var view of this candidate (the planner quickstart's
        copy-paste output; AUTO_PLAN applies the same mapping
        in-process)."""
        env = {
            "BATCH_MODE": self.batch_mode,
            "MAX_BATCH": str(self.max_batch),
            "PP_DECODE": "1" if self.topology == "pp" else "0",
            "TP_DECODE": "1" if self.topology in ("tp", "kvp-tp") else "0",
            "EP_DECODE": "1" if self.topology == "ep" else "0",
            "KVP_DECODE": "1" if self.topology in ("kvp", "kvp-tp")
                          else "0",
            "KV_POOL_BLOCKS": str(self.kv_pool_blocks),
            "KV_BLOCK_SIZE": str(self.kv_block_size),
        }
        if self.topology == "pp":
            env["BOUNDARIES"] = ",".join(str(b) for b in self.boundaries)
        return env


def enumerate_candidates(config, mesh_axes: Dict[str, int], max_seq: int,
                         max_batch_cap: int = 8, kv_pool_blocks: int = 0,
                         kv_block_size: int = 16,
                         include_unsharded: bool = True) -> List[Candidate]:
    """Every topology the mesh and the family admit x batch modes x
    widths x pool geometries. Legality is ``gate_candidate``'s: an
    illegal combination is a rejected row, never a missing one.
    ``include_unsharded=False`` drops the single rows (``plan_for_serving``
    scores them once, on the pass without a mesh). kvp rows (the pool's
    kv-head plane sharded) exist only with a pool, at ``MAX_BATCH=1``
    admission; the port serves no kvp topology, and the rows keep the
    JAX payload's shape."""
    del max_seq
    from ..models import is_stage_partitionable
    from ..parallel import partition as Pt

    moe = hasattr(config, "n_experts")
    topos: List[Tuple[str, Tuple[int, ...]]] = (
        [("single", ())] if include_unsharded else [])
    if mesh_axes.get("pp", 0) > 1 and is_stage_partitionable(config) \
            and mesh_axes["pp"] <= config.n_layer:
        topos.append(("pp", tuple(Pt.balanced_boundaries(
            config.n_layer, mesh_axes["pp"]))))
    if mesh_axes.get("tp", 0) > 1 and not moe:
        topos.append(("tp", ()))
    if mesh_axes.get("ep", 0) > 1 and moe:
        topos.append(("ep", ()))

    widths = sorted({1, max(1, max_batch_cap)})
    out: List[Candidate] = []
    for topo, bounds in topos:
        for mb in widths:
            out.append(Candidate(topo, bounds, "admission", mb))
            if mb > 1 and topo == "single":
                out.append(Candidate(topo, bounds, "iter", mb))
            if kv_pool_blocks and topo == "single":
                mode = "iter" if mb > 1 else "admission"
                out.append(Candidate(topo, bounds, mode, mb,
                                     kv_pool_blocks, kv_block_size))
    if mesh_axes.get("kvp", 0) > 1 and kv_pool_blocks:
        out.append(Candidate("kvp", (), "admission", 1,
                             kv_pool_blocks, kv_block_size))
        if mesh_axes.get("tp", 0) > 1 and not moe:
            out.append(Candidate("kvp-tp", (), "admission", 1,
                                 kv_pool_blocks, kv_block_size))
    return out


def _family(config) -> str:
    from ..models import family_module
    return family_module(config).__name__.rsplit(".", 1)[-1]


def _fake_params(config):
    """The family's f32 parameter tree as fake tensors (shapes only);
    call inside ``FakeTensorMode``."""
    import torch

    from ..models import family_module
    return family_module(config).init_params(
        config, torch.Generator().manual_seed(0))


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode()


def layout_table(config, mesh_axes: Dict[str, int]):
    """The port's layout table for the family (``parallel.spmd``) over
    the mesh axes of more than one rank."""
    import types

    from ..parallel import spmd
    names = tuple(a for a, n in mesh_axes.items() if n > 1)
    mesh = types.SimpleNamespace(mesh_dim_names=names)
    table = {"gpt2": spmd.param_pspecs, "llama": spmd.llama_param_pspecs,
             "moe": spmd.moe_param_pspecs}[_family(config)]
    return table(mesh)


def _split_leaves(config, mesh_axes: Dict[str, int]):
    """``(path, shape, itemsize, [(dim, axis, parts)])`` of every leaf
    under the family's layout table."""
    from ..parallel.spmd import Fused
    specs = layout_table(config, mesh_axes)
    out = []

    def walk(tree, spec, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, spec[k], f"{path}.{k}" if path else k)
            return
        splits = [(d, e.axis if isinstance(e, Fused) else e,
                   e.parts if isinstance(e, Fused) else 1)
                  for d, e in enumerate(spec) if e is not None]
        out.append((path, tuple(tree.shape), tree.element_size(),
                    len(spec), splits))

    with _fake_mode():
        walk(_fake_params(config), specs, "")
    return out


def _layout_findings(config, mesh_axes: Dict[str, int],
                     where: str) -> List[Finding]:
    """Every split dim of the layout table divides into its parts x the
    axis's ranks (``spmd.slice_dim``'s rule)."""
    findings = []
    for path, shape, _, rank, splits in _split_leaves(config, mesh_axes):
        if rank and rank != len(shape):
            findings.append(Finding(
                "layout", "llm_sharding_demo_tpu_torch/parallel/spmd.py", 1,
                where, f"{path}: spec of {rank} entries for a "
                       f"{len(shape)}-d leaf of shape {shape}"))
            continue
        for dim, axis, parts in splits:
            n = mesh_axes.get(axis, 1)
            if shape[dim] % (parts * n):
                findings.append(Finding(
                    "layout", "llm_sharding_demo_tpu_torch/parallel/spmd.py",
                    1, where, f"{path}: dim {dim} of size {shape[dim]} does "
                              f"not split into {parts} x {n} equal parts "
                              f"over {axis!r}"))
    return findings


def _stage_findings(config, boundaries: Sequence[int],
                    where: str) -> List[Finding]:
    """The stage split's contracts: ``make_stage_specs`` (every stage
    non-empty, in order) and ``validate_specs``, and the hand-off pairs a
    partial bijection along the stages."""
    from ..parallel import partition as Pt
    from ..parallel.ppdecode import stage_ring_permutation
    path = "llm_sharding_demo_tpu_torch/parallel/partition.py"
    try:
        specs = Pt.make_stage_specs(config.n_layer, boundaries)
        Pt.validate_specs(specs, config.n_layer)
    except ValueError as e:
        return [Finding("stage-contract", path, 1, where, str(e))]
    pairs = stage_ring_permutation(len(specs))
    srcs, dsts = [a for a, _ in pairs], [b for _, b in pairs]
    if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
            or not all(0 <= x < len(specs) for x in srcs + dsts)):
        return [Finding("stage-contract",
                        "llm_sharding_demo_tpu_torch/parallel/ppdecode.py",
                        1, where, f"hand-off pairs {pairs} are not a "
                                  f"partial bijection of {len(specs)} stages")]
    return []


def _paged_findings(config, num_blocks: int, block_size: int, max_seq: int,
                    batches: Sequence[int], where: str) -> List[Finding]:
    """A trimmed copy of the JAX verifier's paged contracts, run on meta
    tensors: the pool is ``pool_shape``; a row's table covers exactly
    ``max_seq``; ``gather_kv`` gives the engine's cache shape and
    ``scatter_kv`` takes it back into the pool's shape."""
    import numpy as np
    import torch

    from ..ops import paged_attention as PA
    path = "llm_sharding_demo_tpu_torch/ops/paged_attention.py"
    heads = getattr(config, "n_kv_head", config.n_head)
    try:
        nbm = PA.blocks_per_row(max_seq, block_size)
    except ValueError as e:
        return [Finding("paged-contract", path, 1, where,
                        f"rejected geometry: {e}")]
    shape = PA.pool_shape(config.n_layer, num_blocks, heads, block_size,
                          config.head_dim)
    findings = []
    if shape[1:] != (num_blocks + 1, 2, heads, block_size, config.head_dim):
        findings.append(Finding(
            "paged-contract", path, 1, where,
            f"pool shape {shape} breaks the per-layer [num_blocks+1, 2, "
            "n_kv_head, block_size, head_dim] contract"))
    pool = torch.empty(shape, device="meta")
    for b in batches:
        tables = np.zeros((b, nbm), dtype=np.int32)
        k, v = PA.gather_kv(pool, tables)
        want = (config.n_layer, b, heads, max_seq, config.head_dim)
        for name, side in (("k", k), ("v", v)):
            if tuple(side.shape) != want:
                findings.append(Finding(
                    "paged-contract", path, 1, where,
                    f"gather_kv {name} shape {tuple(side.shape)} != engine "
                    f"cache shape {want} at B={b}"))
        back = PA.scatter_kv(torch.empty(shape, device="meta"), k, v, tables)
        if tuple(back.shape) != tuple(shape):
            findings.append(Finding(
                "paged-contract", path, 1, where,
                f"scatter(gather(pool)) shape {tuple(back.shape)} does not "
                f"round-trip the pool shape at B={b}"))
    return findings


def gate_candidate(config, cand: Candidate, mesh_axes: Dict[str, int],
                   max_seq: int) -> List[Finding]:
    """The app's composition guards, with the JAX package's messages,
    then the port's own contracts (the stage split, the layout tables'
    split dims, the paged movers' shapes). Non-empty = rejected, never
    scored."""
    from ..models import is_window_independent
    where = cand.label()
    findings: List[Finding] = []

    def guard(ok: bool, msg: str):
        if not ok:
            findings.append(Finding("plan-gate", _APP_PATH, 1, where, msg))

    guard(cand.batch_mode != "iter" or cand.max_batch > 1,
          "BATCH_MODE=iter requires MAX_BATCH > 1")
    if cand.batch_mode == "iter" or cand.kv_pool_blocks:
        guard(is_window_independent(config),
              f"{type(config).__name__} is window-dependent (capacity "
              "routing); iter scheduling / paged KV serve dense families")
    if cand.kv_pool_blocks:
        guard(cand.topology in ("single", "kvp", "kvp-tp"),
              "KV_POOL_BLOCKS drives the paged engine's storage (single "
              "or kvp-sharded pool planes); PP/EP/TP_DECODE keep "
              "contiguous caches")
        guard(cand.max_batch == 1 or cand.batch_mode == "iter",
              "KV_POOL_BLOCKS batches through BATCH_MODE=iter")
        guard(max_seq % cand.kv_block_size == 0,
              f"MAX_SEQ={max_seq} must be a multiple of KV_BLOCK_SIZE="
              f"{cand.kv_block_size}")
    if cand.batch_mode == "iter":
        guard(cand.topology == "single",
              "BATCH_MODE=iter drives the single-device engine's segment "
              "loop; PP/EP/TP_DECODE use BATCH_MODE=admission")
    desc = _DIVISORS[_family(config)]
    if cand.topology in ("tp", "kvp-tp"):
        tp = mesh_axes.get("tp", 1)
        for field in desc["tp"]:
            v = getattr(config, field)
            guard(v % tp == 0,
                  f"TP_DECODE: {field}={v} not divisible by the "
                  f"{tp}-device tp axis (attention shards whole heads)")
    if cand.topology == "ep":
        ep = mesh_axes.get("ep", 1)
        for field in desc["ep"]:
            v = getattr(config, field)
            guard(v % ep == 0,
                  f"EP_DECODE: {field}={v} not divisible by the "
                  f"{ep}-device ep axis")
    if cand.topology in ("kvp", "kvp-tp"):
        kvp = mesh_axes.get("kvp", 1)
        guard(cand.kv_pool_blocks > 0,
              "KVP_DECODE shards the paged pool's kv-head plane; it "
              "requires KV_POOL_BLOCKS")
        if desc["kvp"] is None:
            guard(False,
                  f"KVP_DECODE: {type(config).__name__}'s family "
                  "declares no kvp_divisors in its SHARDING_DESCRIPTOR "
                  "— the pool-plane sharding is unreviewable")
        else:
            for field in desc["kvp"]:
                v = getattr(config, field)
                guard(v % kvp == 0,
                      f"KVP_DECODE: {field}={v} not divisible by the "
                      f"{kvp}-device kvp axis (pool planes shard whole "
                      "kv heads)")
    if findings:
        return findings

    if cand.topology == "pp":
        findings.extend(_stage_findings(config, cand.boundaries, where))
    if cand.topology in ("tp", "ep", "kvp-tp"):
        findings.extend(_layout_findings(config, mesh_axes, where))
    if cand.kv_pool_blocks:
        findings.extend(_paged_findings(
            config, cand.kv_pool_blocks, cand.kv_block_size, max_seq,
            (1, cand.max_batch), where))
    return findings


# -- scoring -------------------------------------------------------------------


def stage_param_bytes(config, boundaries: Sequence[int]) -> List[int]:
    """Each pipeline stage's parameter bytes, from the port's own
    ``partition_params`` over the f32 tree (the last GPT-2 stage holds
    the tied head's ``wte`` again)."""
    from ..parallel import partition as Pt
    specs = Pt.make_stage_specs(config.n_layer, boundaries)
    with _fake_mode():
        stages = Pt.partition_params(_fake_params(config), specs)
        return [sum(t.numel() * t.element_size() for t in _leaves(s))
                for s in stages]


def sharded_param_bytes(config, mesh_axes: Dict[str, int]) -> int:
    """One rank's parameter bytes under the family's layout table: a leaf
    split over axes holds 1 / (their ranks) of its bytes."""
    total = 0
    for _, shape, itemsize, _, splits in _split_leaves(config, mesh_axes):
        shards = math.prod(mesh_axes.get(axis, 1) for _, axis, _ in splits)
        total += math.ceil(math.prod(shape) * itemsize / shards)
    return total


def pp_decode_comm_bytes(config, n_stages: int, batch: int = 1) -> int:
    """A decoded token over ``n_stages`` stages: ``n_stages`` ticks each
    handing the f32 ``[B, 1, D]`` activation along the ``n_stages - 1``
    ring pairs, then one all-reduce of the output."""
    h = 4 * batch * config.n_embd
    return n_stages * (n_stages - 1) * h + 2 * h * (n_stages - 1)


def tp_decode_comm_bytes(config, batch: int, tp: int) -> int:
    """A decoded token over ``tp`` ranks: per block, one all-reduce of
    the f32 ``[B, 1, D]`` activation after the row-parallel attention
    product and one after the MLP's, ``2 x bytes x (tp - 1)`` each."""
    h = 4 * batch * config.n_embd
    return config.n_layer * 2 * (2 * h * (tp - 1))


def ep_decode_comm_bytes(config, batch: int, ep: int) -> int:
    """A decoded token over ``ep`` ranks: per block, the dispatch and the
    combine all-to-all of the dispatched rows, a rank's operand ``[ep,
    (E / ep) x B x C, D]`` f32 (C: one token's expert capacity), each
    moving its operand ``x (ep - 1)``."""
    from ..models.moe import expert_capacity
    rows = max(1, (config.n_experts // ep) * batch
               * expert_capacity(config, 1))
    operand = ep * rows * config.n_embd * 4
    return config.n_layer * 2 * operand * (ep - 1)


def kvp_decode_comm_bytes(config, batch: int, kvp: int) -> int:
    """A decoded token with the pool's kv heads over ``kvp`` ranks: per
    block, an all-gather of the partial softmax (``o [B, Hq, hd]`` and
    ``lse [B, Hq]``, f32), ``bytes x kvp x (kvp - 1)``."""
    part = 4 * batch * config.n_head * (config.head_dim + 1)
    return config.n_layer * part * kvp * (kvp - 1)


def peak_activation_bytes(config, batch: int, max_seq: int) -> int:
    """The largest live set of one decode step's forward: the f32
    residual stream ``[B, 1, D]`` beside the largest tensor made from it
    (the head's logits ``[B, 1, V]``, the plain path's attention scores
    ``[B, H, 1, max_seq]``, the MLP's hidden ``[B, 1, F]``, MoE's
    dispatched hidden ``[E, B x C, F]``). The cache is written in place
    and is not part of it. The JAX package counts its traced step's
    largest intermediate instead, the whole cache rewritten (about
    ``kv_cache_bytes(config, B, max_seq)``); the term decides only
    whether a row fits."""
    d = config.n_embd
    hidden = getattr(config, "intermediate_size", 4 * d)
    widths = [config.vocab_size, config.n_head * max_seq, hidden, 3 * d]
    if hasattr(config, "n_experts"):
        from ..models.moe import expert_capacity
        widths.append(config.n_experts * expert_capacity(config, 1) * hidden)
    return 4 * batch * (d + max(widths))


def traffic_calls(traffic: Sequence[TrafficRow], max_batch: int,
                  ) -> List[Tuple[int, int, int]]:
    """The traffic as the admission batcher's rounds ``(rows, prompt_len,
    max_new)``: full ``max_batch``-wide rounds, then the remainder, a
    request class at a time."""
    calls = []
    for row in traffic:
        left = row.count
        while left > 0:
            b = min(left, max_batch)
            left -= b
            calls.append((b, row.prompt_len, row.max_new))
    return calls


def row_shapes(cand: Candidate, max_seq: int, traffic: Sequence[TrafficRow],
               prompt_bucket: int = 16) -> Tuple[set, bool]:
    """``(forward shapes, exact)`` a row runs under the traffic: an
    iteration row the pooled batcher's bound (``graftwatch.batched_shapes``,
    a bound); the solo paged runner each prompt's prefill and its
    single-token steps (``graftwatch.solo_shapes``, exact on one device);
    an admission row each round's prefill ``(b, p)`` and, past its
    first token, its steps ``(b, 1)`` (exact but for pp, an estimate)."""
    from . import graftwatch
    if cand.batch_mode == "iter":
        return graftwatch.batched_shapes(traffic, max_seq, cand.max_batch,
                                         prompt_bucket), False
    if cand.kv_pool_blocks:
        return graftwatch.solo_shapes(traffic), cand.topology == "single"
    shapes = set()
    for b, p, n in traffic_calls(traffic, cand.max_batch):
        shapes.add((b, p))
        if n > 1:
            shapes.add((b, 1))
    return shapes, cand.topology != "pp"


@dataclasses.dataclass
class PlanRow:
    candidate: Candidate
    ok: bool
    findings: List[Finding] = dataclasses.field(default_factory=list)
    comm_bytes_per_token: int = 0
    param_bytes_per_device: int = 0
    kv_bytes_per_device: int = 0
    act_bytes: int = 0
    hbm_bytes_per_device: int = 0
    forward_shapes: List[str] = dataclasses.field(default_factory=list)
    shapes_exact: bool = False
    cost_per_token: float = float("inf")
    note: str = ""

    @property
    def shape_total(self) -> int:
        return len(self.forward_shapes)

    def sort_key(self):
        c = self.candidate
        simplicity = (c.kv_pool_blocks > 0, c.batch_mode != "admission",
                      c.max_batch, c.n_stages, c.topology)
        return (not self.ok, self.cost_per_token, self.shape_total,
                self.hbm_bytes_per_device, simplicity)

    def to_dict(self) -> dict:
        return {
            "config": dataclasses.asdict(self.candidate),
            "label": self.candidate.label(),
            "ok": self.ok,
            "cost_per_token": (None if math.isinf(self.cost_per_token)
                               else round(self.cost_per_token, 1)),
            "comm_bytes_per_token": self.comm_bytes_per_token,
            "param_bytes_per_device": self.param_bytes_per_device,
            "kv_bytes_per_device": self.kv_bytes_per_device,
            "peak_activation_bytes": self.act_bytes,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "forward_shapes": list(self.forward_shapes),
            "shape_total": self.shape_total,
            "shapes_exact": self.shapes_exact,
            "serving_env": self.candidate.serving_env(),
            "note": self.note,
            "findings": [f.to_dict() for f in self.findings],
        }


def score_candidate(config, cand: Candidate, mesh_axes: Dict[str, int],
                    max_seq: int, traffic: Sequence[TrafficRow],
                    budget_bytes: int, budget_gb: float,
                    ici_byte_weight: Optional[float] = None) -> PlanRow:
    """Price one gated candidate (the module docstring's cost terms).
    Over ``budget_bytes`` (``budget_gb`` GiB, as the note says) a row is
    infeasible and is not ranked."""
    from . import graftwatch
    row = PlanRow(candidate=cand, ok=True)
    eff_batch = max(1, min(cand.max_batch, concurrency(traffic)))

    if cand.topology in ("tp", "ep", "kvp-tp"):
        row.param_bytes_per_device = sharded_param_bytes(config, mesh_axes)
    elif cand.topology == "pp":
        row.param_bytes_per_device = max(
            stage_param_bytes(config, cand.boundaries))
    else:
        row.param_bytes_per_device = param_bytes(config)

    if cand.kv_pool_blocks:
        pool = kv_pool_bytes(config, cand.kv_pool_blocks, cand.kv_block_size)
        kv_row = kv_cache_bytes(config, 1, max_seq)
        if cand.topology in ("kvp", "kvp-tp"):
            # the divisor gate proved Hkv % kvp == 0: both divide exactly
            kvp = mesh_axes.get("kvp", 1)
            pool //= kvp
            kv_row //= kvp
        row.kv_bytes_per_device = pool
    else:
        kv_all = kv_cache_bytes(config, eff_batch, max_seq)
        if cand.topology == "pp":
            # a stage holds only its own blocks' cache
            per = max(b - a for a, b in zip(
                (0,) + cand.boundaries, cand.boundaries + (config.n_layer,)))
            kv_all = kv_all * per // config.n_layer
        elif cand.topology == "tp":
            tp = mesh_axes.get("tp", 1)
            if getattr(config, "n_kv_head", config.n_head) % tp == 0:
                kv_all //= tp
        row.kv_bytes_per_device = kv_all
        kv_row = kv_all // eff_batch

    if cand.topology == "pp":
        row.comm_bytes_per_token = pp_decode_comm_bytes(
            config, cand.n_stages, eff_batch)
    elif cand.topology == "tp":
        row.comm_bytes_per_token = tp_decode_comm_bytes(
            config, eff_batch, mesh_axes["tp"])
    elif cand.topology == "ep":
        row.comm_bytes_per_token = ep_decode_comm_bytes(
            config, eff_batch, mesh_axes["ep"])
    elif cand.topology == "kvp":
        row.comm_bytes_per_token = kvp_decode_comm_bytes(
            config, eff_batch, mesh_axes["kvp"])
    elif cand.topology == "kvp-tp":
        row.comm_bytes_per_token = (
            kvp_decode_comm_bytes(config, eff_batch, mesh_axes["kvp"])
            + tp_decode_comm_bytes(config, eff_batch, mesh_axes["tp"]))

    row.act_bytes = peak_activation_bytes(config, eff_batch,
                                          min(max_seq, 128))
    row.hbm_bytes_per_device = (row.param_bytes_per_device
                                + row.kv_bytes_per_device + row.act_bytes)
    if row.hbm_bytes_per_device > budget_bytes:
        row.ok = False
        row.note = (f"infeasible: {row.hbm_bytes_per_device} bytes/device "
                    f"exceeds the {budget_gb} GiB HBM budget")
        return row

    shapes, row.shapes_exact = row_shapes(cand, max_seq, traffic)
    row.forward_shapes = [graftwatch.shape_key(s) for s in sorted(shapes)]
    paged_overhead = (2 * kv_row / PAGED_SEG_STEPS
                      if cand.kv_pool_blocks else 0.0)
    ici_w = (ICI_BYTE_WEIGHT if ici_byte_weight is None
             else float(ici_byte_weight))
    row.cost_per_token = (row.param_bytes_per_device / eff_batch + kv_row
                          + paged_overhead
                          + ici_w * row.comm_bytes_per_token)
    return row


# -- the planner -----------------------------------------------------------------


def plan(config, mesh_axes: Dict[str, int], max_seq: int = 64,
         traffic: Optional[Sequence[TrafficRow]] = None,
         max_batch_cap: int = 8, kv_pool_blocks: int = 0,
         kv_block_size: int = 16, hbm_gb: Optional[float] = None,
         include_unsharded: bool = True,
         ici_byte_weight: Optional[float] = None, device=None) -> dict:
    """Enumerate, gate, score and rank (the JAX planner's payload, with
    forward shapes where it counts programs). ``hbm_gb`` is the memory
    budget a device in GiB; None: ``device``'s own
    (``device_memory_bytes``). ``chosen`` is the first ranked row that
    passed every gate and fits, or None."""
    traffic = tuple(traffic) if traffic else DEFAULT_TRAFFIC
    if hbm_gb is None:
        budget = device_memory_bytes(device)
        hbm_gb = budget / (1 << 30)
    else:
        budget = int(hbm_gb * (1 << 30))
    rows: List[PlanRow] = []
    for cand in enumerate_candidates(config, mesh_axes, max_seq,
                                     max_batch_cap, kv_pool_blocks,
                                     kv_block_size,
                                     include_unsharded=include_unsharded):
        findings = gate_candidate(config, cand, mesh_axes, max_seq)
        if findings:
            rows.append(PlanRow(candidate=cand, ok=False, findings=findings,
                                note="rejected by the planner's gates"))
            continue
        rows.append(score_candidate(config, cand, mesh_axes, max_seq,
                                    traffic, budget, hbm_gb,
                                    ici_byte_weight=ici_byte_weight))
    rows.sort(key=PlanRow.sort_key)
    chosen = next((r for r in rows if r.ok), None)
    return {
        "model": type(config).__name__,
        "mesh": dict(mesh_axes),
        "ici_byte_weight": (ICI_BYTE_WEIGHT if ici_byte_weight is None
                            else float(ici_byte_weight)),
        "ici_byte_weight_source": ("a-priori" if ici_byte_weight is None
                                   else "provided"),
        "max_seq": max_seq,
        "traffic": [r.to_dict() for r in traffic],
        "plan": [r.to_dict() for r in rows],
        "chosen": chosen.to_dict() if chosen is not None else None,
        "rejected": sum(1 for r in rows if not r.ok),
    }


def plan_for_serving(config, n_devices: int, max_seq: int,
                     traffic: Optional[Sequence[TrafficRow]] = None,
                     max_batch_cap: int = 8, kv_pool_blocks: int = 0,
                     kv_block_size: int = 16,
                     hbm_gb: Optional[float] = None, device=None) -> dict:
    """The AUTO_PLAN entry point: every single-axis assignment of the
    ``n_devices`` ranks (unsharded, then tp, ep and pp over all of them)
    planned, merged into one payload whose ``chosen`` row is the best
    (cost, then fewer forward shapes). A pure function of its arguments:
    every rank resolves the same plan."""
    meshes: List[Dict[str, int]] = [{}]
    if n_devices > 1:
        for axis in ("tp", "ep", "pp"):
            meshes.append({axis: n_devices})
    merged: Optional[dict] = None
    all_rows: List[dict] = []
    best: Optional[dict] = None
    for mesh_axes in meshes:
        # the unsharded rows score once, on the pass without a mesh
        payload = plan(config, mesh_axes, max_seq=max_seq, traffic=traffic,
                       max_batch_cap=max_batch_cap,
                       kv_pool_blocks=kv_pool_blocks,
                       kv_block_size=kv_block_size, hbm_gb=hbm_gb,
                       include_unsharded=not mesh_axes, device=device)
        if merged is None:
            merged = payload
        for row in payload["plan"]:
            all_rows.append(dict(row, mesh=dict(mesh_axes)))
        c = payload["chosen"]
        if c is not None:
            c = dict(c, mesh=dict(mesh_axes))
            if best is None or (c["cost_per_token"], c["shape_total"]) < \
                    (best["cost_per_token"], best["shape_total"]):
                best = c
    assert merged is not None
    all_rows.sort(key=lambda r: (not r["ok"],
                                 r["cost_per_token"] is None,
                                 r["cost_per_token"] or 0))
    merged["plan"] = all_rows
    merged["chosen"] = best
    merged["mesh"] = {"devices": n_devices}
    merged["rejected"] = sum(1 for r in all_rows if not r["ok"])
    return merged
