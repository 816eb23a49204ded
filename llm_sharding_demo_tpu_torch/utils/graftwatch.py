"""Continuous planning: the traffic watcher, calibrated cost weights and
the plan switcher behind ``AUTO_PLAN_CONTINUOUS``.

Counterpart of ``llm_sharding_demo_tpu/utils/graftwatch.py``.

``TelemetryWatcher`` folds each admission's ``(prompt_len, max_new,
pending)`` into a bounded window and reduces it to a ``TrafficEstimate``
(medians and the window's largest in-flight count), which does not
depend on the order the observations arrived in. ``signals()`` is the
read-only telemetry view ``/debug/plan`` serves: each signal of
``SIGNALS`` through the metric ``PLAN_SIGNALS`` maps it to.

``fit_cost_weights`` fits, by least squares through the origin, the
seconds one modeled HBM byte costs (and, when a row moves interconnect
bytes, the relative interconnect weight) from a bench journal's
``graftscope_attribution`` rows; it falls back to the journal's
``ici_byte_weight_calibration`` row (``costmodel.calibrate``), and a row
that is present but malformed raises ``costmodel.CalibrationError``.

``build_plan_set`` builds the switchable plans of ``PLAN_SET`` once, at
start-up, over one engine and one block pool: ``solo``, the paged
runner (``PagedKVRunner``), and ``batched``, the iteration batcher over
the pool (``IterBatchingEngine``). ``plan_costs`` prices each from the
cost model's byte terms; ``certify_plan_set`` gives each the set of
cached-forward shapes ``(batch, tokens)`` it runs under the declared
traffic, which ``DecodeEngine.forward_shapes()`` observes: exact for
``solo``, a static bound over the live widths 1..``max_batch`` for
``batched``. (The JAX package counts jitted programs per entry point
through its recompile certifier; eager PyTorch builds no program per
shape, and these shapes are what a CUDA-graph capture of the plans
would have to cover.) The invariant: a switch constructs no runner and
runs no forward shape outside the certified set
(``PlanSwitcher.uncertified_shapes``); a label outside the set raises
``UncertifiedPlanError``.

``PlanSwitcher.admit`` routes each request to the active plan and, every
``wave`` admissions, scores the plans against the watcher's estimate
(``decide_plan``: a pure function of the estimate, the static costs and
the weights, with a hysteresis margin and a switch back to the simpler
plan on an equal score). Each evaluation is journaled (``events``) and
published on the timeline (``plan_eval``, and ``plan_switch`` when the
plan changes); a switch counts ``plan_switches_total{from,to}`` and sets
``auto_plan_active{plan}``. With a trend reducer attached
(``attach_trend``), each wave also sizes the batched plan's wait and
queue limit from the reducer's occupancy estimate
(``grafttrend.SIZING_POLICY``). ``/debug/plan`` serves ``describe``,
``/healthz`` ``auto_plan`` serves ``health_view``.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from . import costmodel, graftsched, graftscope, grafttime

# the signals the watcher reads, and the metric each is computed from
SIGNALS = ("queue_depth", "batch_occupancy", "pool_blocks", "live_rows",
           "breaker_open", "prefix_hits", "prefix_misses",
           "admission_sheds", "affinity_hits", "affinity_fallbacks",
           "replica_sheds")

PLAN_SIGNALS = {
    "queue_depth": "queue_depth",
    "batch_occupancy": "batch_occupancy",
    "pool_blocks": "kv_cache_blocks_in_use",
    "live_rows": "iter_live_rows",
    "breaker_open": "hop_breaker_open",
    "prefix_hits": "prefix_cache_hits_total",
    "prefix_misses": "prefix_cache_misses_total",
    "admission_sheds": "kv_pool_admission_rejections_total",
    "affinity_hits": "fleet_affinity_hits_total",
    "affinity_fallbacks": "fleet_affinity_fallbacks_total",
    "replica_sheds": "fleet_sheds_total",
}

# the switchable plans: every label the switcher can install is one of
# these, built by build_plan_set, priced by plan_costs and certified by
# certify_plan_set
PLAN_SET = ("solo", "batched")


def signal_series(signal: str) -> str:
    """The metric a signal is computed from."""
    try:
        return PLAN_SIGNALS[signal]
    except KeyError:
        raise KeyError(
            f"unknown plan signal {signal!r}; declared: {SIGNALS}"
        ) from None


class UncertifiedPlanError(ValueError):
    """A plan label outside the certified set."""


# -- the windowed traffic estimate -------------------------------------------


@dataclasses.dataclass(frozen=True)
class TrafficEstimate:
    """The window's reductions: medians over its observations and 1 +
    the largest in-flight count seen at an admission (the batch the
    weight stream is shared by). Any order of the same observations
    gives the same estimate."""

    requests: int = 0
    prompt_p50: int = 0
    max_new_p50: int = 0
    concurrency: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _median_int(values: List[int]) -> int:
    if not values:
        return 0
    vs = sorted(values)
    return int(vs[(len(vs) - 1) // 2])


class TelemetryWatcher:
    """The admission window and the telemetry view."""

    def __init__(self, window: int = 16, registry=None):
        if window < 1:
            raise ValueError("window must be >= 1")
        from .metrics import REGISTRY
        self.registry = registry if registry is not None else REGISTRY
        self._lock = graftsched.lock("graftwatch.TelemetryWatcher._lock")
        self._window: deque = deque(maxlen=window)
        self._admitted = 0

    def observe(self, prompt_len: int, max_new: int, pending: int) -> int:
        """Record one admission (``pending``: the requests in flight when
        it came); returns the admissions so far."""
        with self._lock:
            self._window.append((int(prompt_len), int(max_new),
                                 int(pending)))
            self._admitted += 1
            return self._admitted

    def admitted(self) -> int:
        with self._lock:
            return self._admitted

    def estimate(self) -> TrafficEstimate:
        with self._lock:
            rows = list(self._window)
        if not rows:
            return TrafficEstimate()
        return TrafficEstimate(
            requests=len(rows),
            prompt_p50=_median_int([r[0] for r in rows]),
            max_new_p50=_median_int([r[1] for r in rows]),
            concurrency=1 + max(r[2] for r in rows))

    def signals(self) -> dict:
        """Each signal's live reduction: a gauge's occupancy series
        (graftscope's totals by label set), a counter's total over its
        label sets. Read-only: the decision never reads it."""
        from .metrics import METRIC_CATALOG
        series = graftscope.series_totals()
        counters = self.registry.snapshot()["counters"]
        out: Dict[str, dict] = {}
        for signal in SIGNALS:
            name = signal_series(signal)
            if METRIC_CATALOG.get(name) == "gauge":
                rows = {label: dict(tot) for label, tot in series.items()
                        if label == name or label.startswith(name + "{")}
                out[signal] = {"series": name, "kind": "gauge",
                               "points": rows}
            else:
                total = sum(v for (n, _), v in counters.items() if n == name)
                out[signal] = {"series": name, "kind": "counter",
                               "total": total}
        return out


# -- calibrated cost weights -------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CostWeights:
    """The weights plan scoring uses: ``hbm_seconds_per_byte`` turns a
    modeled byte cost into predicted seconds (None until a journal is
    fitted); ``ici_byte_weight`` is the relative interconnect weight
    (None: ``costmodel.ICI_BYTE_WEIGHT``)."""

    hbm_seconds_per_byte: Optional[float] = None
    ici_byte_weight: Optional[float] = None
    per_scope_seconds: Tuple[Tuple[str, float], ...] = ()
    rows_used: int = 0
    source: str = "a-priori"

    @classmethod
    def apriori(cls) -> "CostWeights":
        return cls()

    def to_dict(self) -> dict:
        return {
            "hbm_seconds_per_byte": self.hbm_seconds_per_byte,
            "ici_byte_weight": self.ici_byte_weight,
            "per_scope_seconds": {k: round(v, 6)
                                  for k, v in self.per_scope_seconds},
            "rows_used": self.rows_used,
            "source": self.source,
        }


def _number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def fit_cost_weights(journal) -> CostWeights:
    """Fit the byte weights from a journal's ``graftscope_attribution``
    rows. Each measured workload gives ``measured_s = w_hbm * hbm_bytes
    + w_ici_s * comm_bytes`` (the HBM term is the row's modeled total
    with the a-priori interconnect weighting removed); the least-squares
    fit through the origin gives ``hbm_seconds_per_byte`` and, when a row
    moved interconnect bytes, the relative weight ``w_ici_s / w_hbm``.
    Without such rows the interconnect weight comes from
    ``costmodel.calibrate``. A journal without an attribution row (or
    with a skipped one) gives the a-priori weights; a row present but
    unparsable raises ``costmodel.CalibrationError``."""
    C = costmodel
    row = C.config_row(journal, "graftscope_attribution")
    # a malformed interconnect row fails this fit too
    ici = C.calibrate(journal)
    if row is None or row.get("skipped") or row.get("error"):
        return CostWeights(ici_byte_weight=ici,
                           source="a-priori" if ici is None
                           else "ici-row-only")
    workloads = row.get("workloads")
    if not isinstance(workloads, list):
        raise C.CalibrationError(
            "graftscope_attribution row carries no 'workloads' list — "
            "present but unparsable (malformed journal?)")
    eqs: List[Tuple[float, float, float]] = []   # (hbm, comm, measured)
    scope_secs: Dict[str, float] = {}
    for wl in workloads:
        if not isinstance(wl, dict):
            raise C.CalibrationError(
                f"graftscope_attribution workload row is not an object: "
                f"{wl!r}")
        m = wl.get("measured_decode_seconds_per_token")
        if m is None:
            continue                      # not measured: skipped
        cost = wl.get("modeled_cost_bytes_per_token")
        comm = wl.get("modeled_comm_bytes_per_token", 0)
        if not (_number(m) and _number(cost) and _number(comm)) \
                or m <= 0 or cost <= 0 or comm < 0:
            raise C.CalibrationError(
                "graftscope_attribution workload "
                f"{wl.get('workload')!r}: measured/modeled fields are "
                "present but not positive numbers — refusing to fit "
                "weights from an unparsable row")
        # the modeled total priced comm at the a-priori weight
        hbm = float(cost) - C.ICI_BYTE_WEIGHT * float(comm)
        if hbm <= 0:
            raise C.CalibrationError(
                f"graftscope_attribution workload {wl.get('workload')!r}"
                ": modeled HBM term is non-positive after removing the "
                "ICI weighting — the row's byte split is inconsistent")
        eqs.append((hbm, float(comm), float(m)))
        for name, ep in (wl.get("entry_points") or {}).items():
            secs = (ep or {}).get("seconds_total")
            if _number(secs):
                scope_secs[name] = scope_secs.get(name, 0.0) + float(secs)
    if not eqs:
        return CostWeights(ici_byte_weight=ici,
                           source="ici-row-only" if ici is not None
                           else "a-priori")
    shh = sum(h * h for h, _, _ in eqs)
    shc = sum(h * c for h, c, _ in eqs)
    scc = sum(c * c for _, c, _ in eqs)
    shm = sum(h * m for h, _, m in eqs)
    scm = sum(c * m for _, c, m in eqs)
    det = shh * scc - shc * shc
    if scc > 0 and det > 0:
        w_h = (shm * scc - scm * shc) / det
        w_c = (scm * shh - shm * shc) / det
        if w_h > 0 and w_c > 0:
            ici = w_c / w_h
        else:                 # a degenerate fit: the 1-D projection
            w_h = shm / shh
    else:
        w_h = shm / shh
    return CostWeights(
        hbm_seconds_per_byte=(w_h if w_h > 0 else None),
        ici_byte_weight=ici,
        per_scope_seconds=tuple(sorted(scope_secs.items())),
        rows_used=len(eqs),
        source="graftscope_attribution")


# -- the certified plan set --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """A plan's static cost terms (the cost model's decode cost with
    the traffic-dependent sharing of the weight stream left out)."""

    label: str
    batch_mode: str
    max_batch: int
    param_bytes: int
    kv_bytes_per_row: int
    paged_overhead: float
    comm_bytes: int = 0

    def simplicity(self) -> tuple:
        # the tie-break: admission before iter, narrower before wider
        return (self.batch_mode != "admission", self.max_batch)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def plan_costs(config, max_seq: int, max_batch: int) -> Dict[str, PlanCost]:
    """Each switchable plan's static cost terms from ``costmodel``'s
    byte arithmetic: the f32 parameter bytes, a row's contiguous cache
    and the paged gather and scatter a segment."""
    param_bytes = costmodel.param_bytes(config)
    kv_row = costmodel.kv_cache_bytes(config, 1, max_seq)
    paged_overhead = 2 * kv_row / costmodel.PAGED_SEG_STEPS
    return {
        "solo": PlanCost(label="solo", batch_mode="admission",
                         max_batch=1, param_bytes=param_bytes,
                         kv_bytes_per_row=kv_row,
                         paged_overhead=paged_overhead),
        "batched": PlanCost(label="batched", batch_mode="iter",
                            max_batch=max_batch, param_bytes=param_bytes,
                            kv_bytes_per_row=kv_row,
                            paged_overhead=paged_overhead),
    }


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def solo_shapes(traffic: Sequence[costmodel.TrafficRow]) -> set:
    """The paged runner's forwards: each prompt's prefill ``(1, p)``
    and, when a request decodes past its first token, the single-token
    steps ``(1, 1)``."""
    shapes = set()
    for r in traffic:
        shapes.add((1, r.prompt_len))
        if r.max_new > 1:
            shapes.add((1, 1))
    return shapes


def batched_shapes(traffic: Sequence[costmodel.TrafficRow], max_seq: int,
                   max_batch: int, prompt_bucket: int) -> set:
    """A bound on the pooled iteration batcher's forwards. Its live
    widths are powers of two capped at ``max_batch`` (a seed takes the
    next one that fits, a grow the next one up); it decodes ``(w, 1)``.
    A seed prefills ``(w, s)`` and a join ``(1, s)``, where ``s`` lies
    between a stream's length ``l`` and ``l`` rounded up to
    ``prompt_bucket`` (never past ``max_seq``); a stream is a prompt
    (``l = p``) or a preempted row resumed by recompute (``p < l <
    p + max_new``)."""
    widths = {min(_next_pow2(n), max_batch) for n in range(1, max_batch + 1)}
    tokens = set()
    for r in traffic:
        for length in range(r.prompt_len, r.prompt_len + r.max_new):
            top = min(_round_up(length, prompt_bucket), max_seq)
            tokens.update(range(length, max(top, length) + 1))
    return ({(w, 1) for w in widths}
            | {(w, t) for w in widths for t in tokens})


def shape_key(shape: Tuple[int, int]) -> str:
    """``(batch, tokens)`` as ``/healthz`` ``forward_shapes`` keys it."""
    return f"{shape[0]}x{shape[1]}"


def certify_plan_set(config, max_seq: int, max_batch: int,
                     pool_blocks: int, block_size: int, traffic=None,
                     prompt_bucket: int = 16) -> Dict[str, dict]:
    """Each plan's certified forward shapes under the declared traffic
    (``costmodel.parse_traffic`` syntax or rows; default
    ``DEFAULT_TRAFFIC``): ``forward_shapes`` (sorted "BxT" keys),
    ``shape_total`` and ``shapes_exact`` (True for ``solo``, whose set
    is what the traffic runs; False for ``batched``, a static bound),
    beside the plan's composition (``candidate``). ``config`` names the
    model the plans serve (the shapes do not depend on it)."""
    del config
    if isinstance(traffic, str):
        traffic = costmodel.parse_traffic(traffic)
    traffic = tuple(traffic) if traffic else costmodel.DEFAULT_TRAFFIC
    sets = {"solo": (solo_shapes(traffic), True, "admission", 1),
            "batched": (batched_shapes(traffic, max_seq, max_batch,
                                       prompt_bucket),
                        False, "iter", max_batch)}
    out: Dict[str, dict] = {}
    for label, (shapes, exact, mode, width) in sets.items():
        out[label] = {
            "forward_shapes": [shape_key(s) for s in sorted(shapes)],
            "shape_total": len(shapes),
            "shapes_exact": exact,
            "candidate": {"topology": "single", "batch_mode": mode,
                          "max_batch": width,
                          "kv_pool_blocks": pool_blocks,
                          "kv_block_size": block_size},
        }
    return out


def build_plan_set(engine, pool, config, max_seq: int, max_batch: int,
                   traffic=None, batch_wait_ms: float = 5.0,
                   ) -> Tuple[Dict[str, object], Dict[str, PlanCost],
                              Dict[str, dict]]:
    """The switchable front ends over one engine and one block pool,
    built once: a switch only re-routes admissions between them.
    Returns ``(plans, costs, certified)`` keyed by ``PLAN_SET``."""
    from ..runtime.iterbatch import IterBatchingEngine
    from ..runtime.kv_pool import PagedKVRunner
    plans = {
        "solo": PagedKVRunner(engine, pool),
        "batched": IterBatchingEngine(engine, max_batch=max_batch,
                                      max_wait_ms=batch_wait_ms,
                                      pool=pool),
    }
    costs = plan_costs(config, max_seq, max_batch)
    certified = certify_plan_set(config, max_seq, max_batch,
                                 pool.allocator.num_blocks,
                                 pool.block_size, traffic=traffic,
                                 prompt_bucket=plans["batched"].prompt_bucket)
    return plans, costs, certified


# -- the pure decision -------------------------------------------------------


def score_plans(estimate: TrafficEstimate, costs: Dict[str, PlanCost],
                weights: CostWeights) -> Dict[str, float]:
    """Each plan's modeled decode bytes a token under the estimate: the
    weight stream shared by the batch the plan can form, a row's cache,
    the paged overhead and the weighted interconnect bytes. Pure."""
    ici_w = weights.ici_byte_weight or costmodel.ICI_BYTE_WEIGHT
    out: Dict[str, float] = {}
    for label, pc in costs.items():
        eff = max(1, min(pc.max_batch, estimate.concurrency))
        out[label] = (pc.param_bytes / eff + pc.kv_bytes_per_row
                      + pc.paged_overhead + ici_w * pc.comm_bytes)
    return out


def decide_plan(estimate: TrafficEstimate, costs: Dict[str, PlanCost],
                weights: CostWeights, current: str,
                margin: float = 0.1) -> Tuple[str, Dict[str, float]]:
    """The best-scoring plan (ties to the simpler), installed only past
    the hysteresis ``margin``, or on a score no worse when it is
    simpler (the switch back once traffic drains). Pure: no clock, no
    RNG, no ambient state."""
    scores = score_plans(estimate, costs, weights)
    best = min(costs, key=lambda lb: (scores[lb], costs[lb].simplicity(),
                                      lb))
    return _pick(best, current, scores, costs, margin), scores


def _pick(best: str, current: str, scores: Dict[str, float],
          costs: Dict[str, PlanCost], margin: float) -> str:
    if best == current:
        return current
    cur = scores.get(current)
    if cur is None:
        return best
    if scores[best] < cur * (1.0 - margin):
        return best
    if scores[best] <= cur and costs[best].simplicity() \
            < costs[current].simplicity():
        return best
    return current


# -- the switcher ------------------------------------------------------------


class PlanSwitcher:
    """Routes admissions to the active certified plan and re-evaluates
    every ``wave`` admissions. Every label it can install is checked
    against the certified set when it is built."""

    HISTORY = 128       # the event journal's ring

    def __init__(self, plans: Dict[str, object], costs: Dict[str, PlanCost],
                 certified: Dict[str, dict], watcher: TelemetryWatcher,
                 weights: Optional[CostWeights] = None,
                 initial: Optional[str] = None, wave: int = 8,
                 margin: float = 0.1, registry=None):
        if not plans:
            raise ValueError("empty plan set")
        labels = set(plans)
        if labels != set(costs) or labels != set(certified):
            raise UncertifiedPlanError(
                f"plan set {sorted(labels)} does not match costs "
                f"{sorted(costs)} / certified {sorted(certified)} — "
                "every switchable plan must be priced AND certified")
        for label in labels:
            if label not in PLAN_SET:
                raise UncertifiedPlanError(
                    f"plan label {label!r} is not in the declared "
                    f"PLAN_SET {PLAN_SET}")
        if wave < 1:
            raise ValueError("wave must be >= 1")
        from .metrics import REGISTRY
        self.registry = registry if registry is not None else REGISTRY
        self.plans = dict(plans)
        self.costs = dict(costs)
        self.certified = dict(certified)
        self.watcher = watcher
        self.weights = self._resolved(weights if weights is not None
                                      else CostWeights.apriori())
        self.wave = int(wave)
        self.margin = float(margin)
        self._lock = graftsched.lock("graftwatch.PlanSwitcher._lock")
        # start on the simplest plan: under the single-stream estimate
        # every plan scores the same
        start = initial if initial is not None else min(
            self.costs, key=lambda lb: (self.costs[lb].simplicity(), lb))
        if start not in self.plans:
            raise UncertifiedPlanError(
                f"initial plan {start!r} is not in the certified set "
                f"{sorted(self.plans)}")
        self._active = start
        self._inflight = 0
        self._switches = 0
        self._events: deque = deque(maxlen=self.HISTORY)
        # trend-driven sizing: the base knob values are taken at
        # attach_trend, so a resize is always base x scale
        self._trend = None
        self._sizing_base: Dict[str, tuple] = {}
        self._sizings: deque = deque(maxlen=self.HISTORY)
        self._announce(start)

    @staticmethod
    def _resolved(weights: CostWeights) -> CostWeights:
        if weights.ici_byte_weight:
            return weights
        return dataclasses.replace(
            weights, ici_byte_weight=costmodel.ICI_BYTE_WEIGHT)

    # -- admission routing --

    def peek(self):
        """The active runner, admitting nothing (the 429 gate's read)."""
        with self._lock:
            return self.plans[self._active]

    def admit(self, prompt_len: int, max_new: int):
        """Observe one admission, evaluate at a wave boundary, and
        return ``(runner, label)`` for this request; pair it with
        ``release`` in a ``finally``."""
        with self._lock:
            pending = self._inflight
            self._inflight += 1
        n = self.watcher.observe(prompt_len, max_new, pending)
        if n % self.wave == 0:
            self._evaluate(n)
        with self._lock:
            label = self._active
            return self.plans[label], label

    def release(self) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)

    def _evaluate(self, admitted: int) -> None:
        est = self.watcher.estimate()
        t_ms = round(graftscope.now_ms(), 3)
        switched_from: Optional[str] = None
        wave = admitted // self.wave
        with self._lock:
            # reading the plan and installing the decision is one hold:
            # a peer's wave cannot come between them
            current = self._active
            decision, scores = decide_plan(est, self.costs, self.weights,
                                           current, margin=self.margin)
            if decision not in self.plans:
                raise UncertifiedPlanError(
                    f"switch decision {decision!r} outside the "
                    f"certified set {sorted(self.plans)}")
            if decision != current:
                self._active = decision
                self._switches += 1
                switched_from = current
            self._events.append({
                "wave": wave,
                "admitted": admitted,
                "estimate": est.to_dict(),
                "scores": {lb: round(s, 1) for lb, s in scores.items()},
                "from": current,
                "to": decision,
                "switched": decision != current,
                # wall-clock context: events(strip_time=True) drops it
                "t_ms": t_ms,
            })
            # under the hold, so two racing waves publish in order
            grafttime.emit("plan_eval", to_plan=decision,
                           from_plan=current, wave=wave,
                           switched=switched_from is not None)
            if switched_from is not None:
                grafttime.emit("plan_switch", to_plan=decision,
                               from_plan=switched_from, wave=wave)
        if switched_from is not None:
            self._announce(decision, previous=switched_from)
        self._resize(wave)

    def set_weights(self, weights: CostWeights) -> CostWeights:
        """Install re-fitted weights (``grafttrend.refit``); scoring
        only: no runner and no forward shape depends on them. Returns
        the previous weights."""
        weights = self._resolved(weights)
        with self._lock:
            prev, self.weights = self.weights, weights
        return prev

    # -- trend-driven sizing --

    def attach_trend(self, reducer) -> None:
        """Size the batched plan from ``reducer`` between waves: its
        ``max_wait_s`` and ``queue_limit`` become base x clamp(occupancy
        estimate / max_batch) within ``grafttrend.SIZING_POLICY``'s
        scales. Neither changes a forward shape or an emitted token."""
        self._trend = reducer
        self._sizing_base = {
            label: (runner.max_wait_s, runner.queue_limit, runner.max_batch)
            for label, runner in self.plans.items()
            if hasattr(runner, "max_wait_s")
            and hasattr(runner, "queue_limit")}

    def _resize(self, wave: int) -> None:
        trend = self._trend
        if trend is None or not self._sizing_base:
            return
        from . import grafttrend
        # one registry fold a wave, outside every switcher hold
        trend.poll()
        series, lo, hi = grafttrend.SIZING_POLICY["batch_wait_ms"]
        q_series, q_lo, q_hi = grafttrend.SIZING_POLICY["queue_limit"]
        est = trend.occupancy_estimate(series)
        q_est = est if q_series == series \
            else trend.occupancy_estimate(q_series)
        if est is None and q_est is None:
            return   # silence never resizes
        row = {"wave": wave, "estimate": None if est is None
               else round(est, 3), "knobs": {}}
        for label, (base_wait, base_limit, max_batch) in sorted(
                self._sizing_base.items()):
            runner = self.plans[label]
            if est is not None:
                scale = min(max(est / max(max_batch, 1), lo), hi)
                runner.max_wait_s = base_wait * scale
            if q_est is not None:
                q_scale = min(max(q_est / max(max_batch, 1), q_lo), q_hi)
                runner.queue_limit = max(1, int(round(
                    base_limit * q_scale)))
            row["knobs"][label] = {
                "batch_wait_ms": round(runner.max_wait_s * 1e3, 4),
                "queue_limit": runner.queue_limit}
        with self._lock:
            self._sizings.append(row)

    def sizings(self, n: Optional[int] = None) -> List[dict]:
        """The journaled resizes, oldest first."""
        with self._lock:
            rows = [dict(r) for r in self._sizings]
        return rows if n is None else rows[-n:]

    def _announce(self, label: str, previous: Optional[str] = None):
        # the metrics outside every hold
        reg = self.registry
        if previous is not None:
            reg.inc("plan_switches_total", **{"from": previous,
                                              "to": label})
            reg.gauge("auto_plan_active", 0.0, plan=previous)
            graftscope.sample("auto_plan_active", 0.0, plan=previous)
        reg.gauge("auto_plan_active", 1.0, plan=label)
        graftscope.sample("auto_plan_active", 1.0, plan=label)

    # -- the certified shapes --

    def certified_shapes(self) -> set:
        """The union of the plans' certified forward shapes ("BxT")."""
        return {s for row in self.certified.values()
                for s in row["forward_shapes"]}

    def uncertified_shapes(self, observed) -> List[str]:
        """The observed forward shapes ("BxT" keys or ``(batch,
        tokens)`` pairs, e.g. ``engine.forward_shapes()``) outside every
        plan's certified set: empty while the invariant holds."""
        keys = {k if isinstance(k, str) else shape_key(k) for k in observed}
        return sorted(keys - self.certified_shapes())

    # -- observability --

    def events(self, n: Optional[int] = None,
               strip_time: bool = False) -> List[dict]:
        """The journaled evaluations, oldest first; ``strip_time`` drops
        ``t_ms``."""
        with self._lock:
            rows = list(self._events)
        if n is not None:
            rows = rows[-n:]
        if strip_time:
            rows = [{k: v for k, v in r.items() if k != "t_ms"}
                    for r in rows]
        return rows

    def switch_history(self, n: Optional[int] = None) -> List[dict]:
        return [e for e in self.events(n=None) if e["switched"]][
            -(n or self.HISTORY):]

    def health_view(self) -> dict:
        """The ``/healthz`` ``auto_plan`` block: the live plan."""
        # the watcher's lock outside the switcher's: they never nest
        admitted = self.watcher.admitted()
        with self._lock:
            return {"mode": "continuous", "active": self._active,
                    "switches": self._switches,
                    "admitted": admitted,
                    "wave": self.wave,
                    "plans": sorted(self.plans)}

    def describe(self, n: int = 16) -> dict:
        """The ``/debug/plan`` body: the active plan, each plan's scores
        under the live estimate with its cost terms and certified shapes,
        the weights, the journals and the signal map with its values."""
        est = self.watcher.estimate()
        scores = score_plans(est, self.costs, self.weights)
        with self._lock:
            active = self._active
            switches = self._switches
        rows = []
        for label in sorted(self.plans):
            pc = self.costs[label]
            row = {"label": label, "active": label == active,
                   "batch_mode": pc.batch_mode,
                   "max_batch": pc.max_batch,
                   "cost_terms": pc.to_dict(),
                   "score_bytes_per_token": round(scores[label], 1),
                   "certified": self.certified[label]}
            if self.weights.hbm_seconds_per_byte:
                row["predicted_seconds_per_token"] = round(
                    scores[label] * self.weights.hbm_seconds_per_byte, 8)
            rows.append(row)
        return {
            "mode": "continuous",
            "active": active,
            "switches": switches,
            "wave": self.wave,
            "margin": self.margin,
            "admitted": self.watcher.admitted(),
            "estimate": est.to_dict(),
            "calibrated_weights": self.weights.to_dict(),
            "plans": rows,
            "events": self.events(n=n),
            "sizings": self.sizings(n=n),
            "signals": dict(PLAN_SIGNALS),
            "signal_values": self.watcher.signals(),
        }


# -- queue-depth ordering (the fleet router's prefill fan-out) ---------------


def order_by_queue_depth(candidates: List[str],
                         depth_of: Dict[str, int]) -> List[str]:
    """Replica names by their queue-depth estimate, ascending. The sort
    is stable: callers pass the candidates in their deterministic
    fallback order (the consistent-hash ring walk), so an idle fleet
    keeps the ring's placement while a backed-up replica drops behind
    its peers."""
    return sorted(candidates, key=lambda name: depth_of.get(name, 0))
