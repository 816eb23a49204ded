"""Streaming telemetry reducer and declared burn-rate, drift and level
watches.

Counterpart of ``llm_sharding_demo_tpu/utils/grafttrend.py``.

``TrendReducer`` folds samples into bounded per-series windows of
``(t_ms, value, weight)`` points: through ``observe`` (a pure record,
what seeded tests feed) or ``poll`` (the live tap: the registry's
histogram buckets of the SLO latency series, the deadline-miss and
request counters, and the watched gauges). The reductions (windowed
burn rate, windowed mean, EWMA drift, the p50/p99 sketch) are pure
functions of the samples and the evaluation instant.

``WATCH_POLICY = {watch: (series, window, threshold, severity)}`` is the
JAX package's declared contract, each watch in one of three modes
(``watch_mode``): burn for an SLO source series (trips when the
violating share over the loosest declared error budget passes the
threshold in both a short and a long window), drift for a derived
measured-against-modeled series (EWMA), level for a gauge (windowed
mean). A trip emits ``trend_alert`` on the timeline, increments
``trend_alerts_total{watch,severity}`` and makes a black-box dump; it
latches, so a sustained burn alerts once until the watch evaluates
clean. ``alerts(strip_time=True)`` is a pure function of the samples
and the evaluation instants.

``GET /debug/trend`` serves ``describe`` after a ``poll`` and an
``evaluate`` (``?eval=0`` reads without them); ``/healthz`` serves
``health_view``.

The drift watches (``hbm_params_drift``, ``hbm_kv_drift``,
``cost_weight_drift``) stay declared as the JAX package declares them
and are fed by nothing yet: their series come from ``graftmem.reconcile``
against the cost model's plan rows (``poll(plan_row=)``) and from the
live refit of the cost model's byte weights (``refit``,
``live_attribution_journal``), which wait with ``SIZING_POLICY`` for
ROADMAP Queue 1 item 15c.
"""

from __future__ import annotations

import bisect
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import graftsched, grafttime

SEVERITIES = ("page", "ticket")

# trend inputs computed from producer pairs rather than emitted metrics
DERIVED_SERIES = {
    "graftmem_params_drift":
        "graftmem.reconcile components.params drift — |measured/"
        "predicted - 1| of live ledger param bytes vs the cost model's "
        "aval arithmetic (fed by TrendReducer.poll(plan_row=...))",
    "graftmem_kv_drift":
        "graftmem.reconcile components.kv drift — |measured/predicted "
        "- 1| of live pool/cache bytes vs the planned KV footprint "
        "(fed by TrendReducer.poll(plan_row=...))",
    "costmodel_weight_drift":
        "|fitted ici_byte_weight / a-priori ICI_BYTE_WEIGHT - 1| — how "
        "far the live refit has moved the cost model off its prior "
        "(fed by grafttrend.refit)",
}

# {watch: (series, window, threshold, severity)}: window is (short_ms,
# long_ms) for burn watches, one window_ms otherwise; thresholds are the
# JAX package's, loose against its tiny CPU test model
WATCH_POLICY = {
    "slo_ttft_burn": ("ttft_seconds", (10_000.0, 60_000.0), 2.0, "page"),
    "slo_tpot_burn": ("tpot_seconds", (10_000.0, 60_000.0), 2.0, "page"),
    "slo_e2e_burn": ("generate_request_seconds", (10_000.0, 60_000.0),
                     2.0, "page"),
    "slo_deadline_burn": ("deadline_misses_total", (10_000.0, 60_000.0),
                          2.0, "page"),
    "hbm_params_drift": ("graftmem_params_drift", 60_000.0, 0.10,
                         "ticket"),
    "hbm_kv_drift": ("graftmem_kv_drift", 60_000.0, 0.25, "ticket"),
    "cost_weight_drift": ("costmodel_weight_drift", 300_000.0, 0.50,
                          "ticket"),
    "breaker_stuck_open": ("hop_breaker_open", 30_000.0, 0.5, "page"),
    "queue_depth_surge": ("queue_depth", 30_000.0, 16.0, "ticket"),
}

SAMPLE_CAPACITY = 1024
ALERT_CAPACITY = 128
DRIFT_ALPHA = 0.3


class WatchPolicyError(ValueError):
    """A malformed watch declaration."""


def watch_mode(series: str) -> str:
    """"burn" for an SLO source series, "drift" for a derived series,
    else "level"."""
    from ..loadgen import profiles
    if series in profiles.SLO_SOURCE_METRICS.values():
        return "burn"
    if series in DERIVED_SERIES:
        return "drift"
    return "level"


def slo_budget(series: str) -> Tuple[float, float]:
    """``(target, error budget)`` of an SLO source series: the loosest
    target the profiles declare for it and the matching budget (1 -
    percentile/100, or the declared miss fraction for
    ``deadline_miss``)."""
    from ..loadgen import profiles
    metric = {v: k for k, v in profiles.SLO_SOURCE_METRICS.items()
              }.get(series)
    if metric is None:
        raise WatchPolicyError(
            f"{series!r} is not an SLO source series; burn watches "
            f"cover {sorted(profiles.SLO_SOURCE_METRICS.values())}")
    targets: List[float] = []
    budgets: List[float] = []
    for policy in profiles.SLO_POLICY.values():
        if metric in policy:
            target, pct = policy[metric]
            targets.append(float(target))
            budgets.append(float(target) if pct >= 100
                           else 1.0 - pct / 100.0)
    if not targets:
        raise WatchPolicyError(
            f"no SLO_POLICY profile declares metric {metric!r} — a "
            "burn watch needs a declared budget to burn")
    return max(targets), max(budgets)


def validate_policy(policy: Dict[str, tuple]) -> None:
    """Refuse a malformed watch policy."""
    if not isinstance(policy, dict) or not policy:
        raise WatchPolicyError("WATCH_POLICY must be a non-empty dict "
                               "{watch: (series, window, threshold, "
                               "severity)}")
    for watch, entry in policy.items():
        if not (isinstance(entry, tuple) and len(entry) == 4):
            raise WatchPolicyError(
                f"watch {watch!r}: entry must be a 4-tuple (series, "
                f"window, threshold, severity), got {entry!r}")
        series, window, threshold, severity = entry
        if not isinstance(series, str) or not series:
            raise WatchPolicyError(
                f"watch {watch!r}: series must be a non-empty string")
        if severity not in SEVERITIES:
            raise WatchPolicyError(
                f"watch {watch!r}: severity {severity!r} outside "
                f"{SEVERITIES}")
        if not (isinstance(threshold, (int, float))
                and not isinstance(threshold, bool) and threshold > 0):
            raise WatchPolicyError(
                f"watch {watch!r}: threshold must be a positive number")
        windows = window if isinstance(window, tuple) else (window,)
        if not windows or not all(
                isinstance(w, (int, float)) and not isinstance(w, bool)
                and w > 0 for w in windows):
            raise WatchPolicyError(
                f"watch {watch!r}: window must be a positive ms value "
                "or a (short_ms, long_ms) tuple")
        if watch_mode(series) == "burn":
            if len(windows) != 2 or windows[0] >= windows[1]:
                raise WatchPolicyError(
                    f"watch {watch!r}: burn watches need (short_ms, "
                    f"long_ms) with short < long, got {window!r}")
            slo_budget(series)
        elif len(windows) != 1:
            raise WatchPolicyError(
                f"watch {watch!r}: {watch_mode(series)} watches take a "
                f"single window_ms, got {window!r}")


# -- pure windowed reductions -------------------------------------------------


def _windowed(samples: List[tuple], now_ms: float,
              window_ms: float) -> List[tuple]:
    return [s for s in samples if now_ms - s[0] <= window_ms]


def burn_rate(samples: List[tuple], now_ms: float, window_ms: float,
              budget: float) -> Optional[float]:
    """Violating weight over total weight, over the error budget; None
    for a window without weight."""
    win = _windowed(samples, now_ms, window_ms)
    total = sum(s[2] for s in win)
    if total <= 0:
        return None
    return (sum(s[1] for s in win) / total) / budget


def windowed_mean(samples: List[tuple], now_ms: float,
                  window_ms: float) -> Optional[float]:
    win = _windowed(samples, now_ms, window_ms)
    if not win:
        return None
    return sum(s[1] for s in win) / len(win)


def ewma_drift(samples: List[tuple], now_ms: float, window_ms: float,
               alpha: float = DRIFT_ALPHA) -> Optional[float]:
    """EWMA of the window's values, folded in time order."""
    win = _windowed(samples, now_ms, window_ms)
    if not win:
        return None
    acc = win[0][1]
    for _, value, _ in win[1:]:
        acc = alpha * value + (1.0 - alpha) * acc
    return acc


def percentile_sketch(samples: List[tuple], now_ms: float,
                      window_ms: float) -> dict:
    """Exact p50 and p99 over the bounded window."""
    vals = sorted(s[1] for s in _windowed(samples, now_ms, window_ms))
    if not vals:
        return {"points": 0}
    return {
        "points": len(vals),
        "p50": round(vals[(len(vals) - 1) // 2], 6),
        "p99": round(vals[min(len(vals) - 1, (len(vals) * 99) // 100)], 6),
        "last": round(vals[-1] if len(vals) == 1 else samples[-1][1], 6),
    }


def _append(samples: Dict[str, deque], series: str, point: tuple) -> None:
    ring = samples.get(series)
    if ring is None:
        ring = samples[series] = deque(maxlen=SAMPLE_CAPACITY)
    ring.append(point)


class TrendReducer:
    """The bounded reducer and watch evaluator of one app."""

    def __init__(self, policy: Optional[Dict[str, tuple]] = None,
                 registry=None, blackbox: bool = True,
                 min_weight: float = 4.0, min_points: int = 3):
        from .metrics import REGISTRY
        self.registry = registry if registry is not None else REGISTRY
        self.policy = dict(policy if policy is not None else WATCH_POLICY)
        validate_policy(self.policy)
        self.blackbox = blackbox
        # below these a watch is "insufficient" and never trips: a burn
        # needs this much weight in its short window, drift and level
        # this many points
        self.min_weight = float(min_weight)
        self.min_points = int(min_points)
        self._lock = graftsched.lock("grafttrend.TrendReducer._lock")
        self._samples: Dict[str, deque] = {}
        self._alerts: deque = deque(maxlen=ALERT_CAPACITY)
        self._latched: Dict[str, bool] = {}
        self._evals = 0
        self._cursors: Dict[str, object] = {}

    def observe(self, series: str, value: float, weight: float = 1.0,
                t_ms: Optional[float] = None) -> None:
        """One sample: ``value`` is the violating count of a burn series,
        the drift of a derived one, else the level; ``weight`` the
        denominator of a burn series, else 1; ``t_ms`` defaults to the
        timeline's clock."""
        t = grafttime.now_ms() if t_ms is None else float(t_ms)
        with self._lock:
            _append(self._samples, series, (t, float(value), float(weight)))

    def poll(self, now_ms: Optional[float] = None) -> int:
        """Fold the registry into samples: for each SLO latency series
        the observations since the last poll and those past the loosest
        target (buckets whose lower edge is at or past it); for the
        deadline series the misses and the requests since the last poll;
        each watched gauge's largest label set. The first poll only sets
        the cursors. Returns the samples taken."""
        from .metrics import DEFAULT_BUCKETS, METRIC_CATALOG
        t = grafttime.now_ms() if now_ms is None else float(now_ms)
        watched = {entry[0] for entry in self.policy.values()}
        buckets = self.registry.histogram_buckets()
        snap = self.registry.snapshot()

        def counter_total(name: str) -> float:
            return sum(v for (n, _), v in snap["counters"].items()
                       if n == name)

        cursors: Dict[str, Tuple[float, float]] = {}
        levels: Dict[str, float] = {}
        for series in sorted(watched):
            mode = watch_mode(series)
            if mode == "burn" and METRIC_CATALOG.get(series) == "histogram":
                target, _ = slo_budget(series)
                cut = bisect.bisect_left(DEFAULT_BUCKETS, target) + 1
                total = viol = 0.0
                for key, (counts, _s, _n) in buckets.items():
                    if key == series or key.startswith(series + "{"):
                        total += sum(counts)
                        viol += sum(counts[cut:])
                cursors[series] = (total, viol)
            elif mode == "burn":
                cursors[series] = (counter_total("generate_requests_total"),
                                   counter_total(series))
            elif mode == "level" and METRIC_CATALOG.get(series) == "gauge":
                vals = [v for (n, _), v in snap["gauges"].items()
                        if n == series]
                if vals:
                    levels[series] = max(vals)
        taken = 0
        with self._lock:
            for series, cur in cursors.items():
                prev = self._cursors.get(series)
                self._cursors[series] = cur
                if prev is None:
                    continue
                d_total, d_viol = cur[0] - prev[0], cur[1] - prev[1]
                if d_total <= 0:
                    continue
                _append(self._samples, series,
                        (t, max(d_viol, 0.0), d_total))
                taken += 1
            for series, level in levels.items():
                _append(self._samples, series, (t, level, 1.0))
                taken += 1
        return taken

    def _verdict(self, mode: str, series: str, samples: List[tuple],
                 now: float, window, threshold: float):
        """``(tripped, value, window)``, or None without enough data."""
        if mode == "burn":
            short_ms, long_ms = window
            _, budget = slo_budget(series)
            win = _windowed(samples, now, short_ms)
            if sum(s[2] for s in win) < self.min_weight:
                return None
            short = burn_rate(samples, now, short_ms, budget)
            long = burn_rate(samples, now, long_ms, budget)
            if short is None or long is None:
                return None
            return (short > threshold and long > threshold,
                    min(short, long), window)
        win_ms = window if not isinstance(window, tuple) else window[0]
        if len(_windowed(samples, now, win_ms)) < self.min_points:
            return None
        value = (ewma_drift(samples, now, win_ms) if mode == "drift"
                 else windowed_mean(samples, now, win_ms))
        if value is None:
            return None
        return value > threshold, value, win_ms

    def evaluate(self, now_ms: Optional[float] = None) -> List[dict]:
        """Evaluate every watch; returns the new trips. The alerts'
        emission (event, counter, black-box dump) happens outside the
        lock."""
        now = grafttime.now_ms() if now_ms is None else float(now_ms)
        trips: List[dict] = []
        with self._lock:
            self._evals += 1
            for watch in sorted(self.policy):
                series, window, threshold, severity = self.policy[watch]
                mode = watch_mode(series)
                v = self._verdict(mode, series,
                                  list(self._samples.get(series, ())),
                                  now, window, threshold)
                if v is None or not v[0]:
                    self._latched.pop(watch, None)   # the episode ends
                    continue
                if self._latched.get(watch):
                    continue
                self._latched[watch] = True
                alert = {"watch": watch, "series": series,
                         "severity": severity, "mode": mode,
                         "window_ms": (list(window)
                                       if isinstance(window, tuple)
                                       else window),
                         "value": round(v[1], 6), "threshold": threshold,
                         "t_ms": round(now, 3)}
                self._alerts.append(alert)
                trips.append(alert)
        for alert in trips:
            grafttime.emit("trend_alert", watch=alert["watch"],
                           severity=alert["severity"],
                           series=alert["series"], mode=alert["mode"],
                           value=alert["value"],
                           threshold=alert["threshold"])
            self.registry.inc("trend_alerts_total", watch=alert["watch"],
                              severity=alert["severity"])
            if self.blackbox:
                grafttime.blackbox(f"trend_alert:{alert['watch']}")
        return trips

    def alerts(self, n: Optional[int] = None,
               strip_time: bool = False) -> List[dict]:
        """The alert journal, oldest first; ``strip_time`` drops
        ``t_ms``."""
        with self._lock:
            rows = list(self._alerts)
        if n is not None:
            rows = rows[-n:]
        if strip_time:
            rows = [{k: v for k, v in r.items() if k != "t_ms"}
                    for r in rows]
        return rows

    def describe(self, now_ms: Optional[float] = None) -> dict:
        """The ``/debug/trend`` body: each watch's state, each series'
        windowed reductions, the alert journal and the policy."""
        now = grafttime.now_ms() if now_ms is None else float(now_ms)
        with self._lock:
            samples = {s: list(ring) for s, ring in self._samples.items()}
            latched = dict(self._latched)
            evals = self._evals
            alerts = list(self._alerts)
        watches = {}
        for watch in sorted(self.policy):
            series, window, threshold, severity = self.policy[watch]
            mode = watch_mode(series)
            v = self._verdict(mode, series, samples.get(series, []), now,
                              window, threshold)
            watches[watch] = {
                "series": series, "mode": mode,
                "window_ms": (list(window) if isinstance(window, tuple)
                              else window),
                "threshold": threshold, "severity": severity,
                "state": ("insufficient" if v is None
                          else "tripped" if v[0] else "ok"),
                "value": None if v is None else round(v[1], 6),
                "latched": bool(latched.get(watch))}
        series_view = {}
        for series, pts in sorted(samples.items()):
            spans = [max(w[1]) if isinstance(w[1], tuple) else w[1]
                     for w in self.policy.values() if w[0] == series]
            win_ms = max(spans) if spans else 60_000.0
            win = _windowed(pts, now, win_ms)
            series_view[series] = {
                "points": len(pts), "window_points": len(win),
                "rate_per_s": round(sum(s[2] for s in win)
                                    / (win_ms / 1e3), 6),
                "sketch": percentile_sketch(pts, now, win_ms)}
        return {
            "now_ms": round(now, 3),
            "evaluations": evals,
            "watches": watches,
            "series": series_view,
            "alerts": alerts,
            "refits": [],             # the live refit waits for 15c
            "policy": {w: {"series": e[0],
                           "window_ms": (list(e[1]) if isinstance(e[1], tuple)
                                         else e[1]),
                           "threshold": e[2], "severity": e[3]}
                       for w, e in sorted(self.policy.items())},
            "derived_series": dict(DERIVED_SERIES),
        }

    def health_view(self) -> dict:
        """The ``/healthz`` ``trend`` block."""
        with self._lock:
            return {"watches": len(self.policy),
                    "evaluations": self._evals,
                    "alerts_journaled": len(self._alerts),
                    "latched": sorted(w for w, on in self._latched.items()
                                      if on)}

    def dump_state(self) -> tuple:
        with self._lock:
            return ({s: list(r) for s, r in self._samples.items()},
                    list(self._alerts), dict(self._latched), self._evals,
                    dict(self._cursors))

    def restore_state(self, state: tuple) -> None:
        samples, alerts, latched, evals, cursors = state
        with self._lock:
            self._samples = {s: deque(r, maxlen=SAMPLE_CAPACITY)
                             for s, r in samples.items()}
            self._alerts = deque(alerts, maxlen=ALERT_CAPACITY)
            self._latched = dict(latched)
            self._evals = evals
            self._cursors = dict(cursors)

    def clear(self) -> None:
        with self._lock:
            self._samples = {}
            self._alerts = deque(maxlen=ALERT_CAPACITY)
            self._latched = {}
            self._evals = 0
            self._cursors = {}


REDUCER = TrendReducer()


def dump_state() -> tuple:
    return REDUCER.dump_state()


def restore_state(state: tuple) -> None:
    REDUCER.restore_state(state)


def clear() -> None:
    REDUCER.clear()
