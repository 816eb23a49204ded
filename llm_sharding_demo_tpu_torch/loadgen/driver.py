"""The load driver: seeded open-loop load against an in-process app.

Counterpart of ``llm_sharding_demo_tpu/loadgen/driver.py``. ``run_load``
fires a seeded ``loadgen.schedule`` at the serving surface (a
``serving/http.py`` ``TestClient``: the serving dispatch path, no
sockets; the fleet router's or a replica's) and reduces the outcomes to
two rows:

- the **Pareto point** (offered rate, achieved throughput, tail
  latency) of a ``(profile, rate_scale)``: ``pareto_row``;
- the **SLO attainment** row: each declared ``SLO_POLICY`` metric's
  observed percentile against its target, and **goodput**, the requests
  that completed inside all their budgets, with typed sheds (429, 503)
  counted apart from SLO misses: ``slo_row``.

``mode="open"`` (the default) fires arrival k at its offset on a thread
of its own whatever earlier requests are doing, so queue growth under
overload lands in the tail; ``mode="closed"`` runs ``width`` workers
back to back (it throttles itself at saturation and under-reports p99);
``mode="serial"`` is closed at width 1, the deterministic replay (one
seed, byte-identical replies). Every fired request is an ``arrival``
event on the timeline (``utils.grafttime``).

TTFT and TPOT come from the flight recorder (joined by X-Request-ID);
``occupancy_summary`` reduces graftscope's occupancy series (queue
depth, batch occupancy, pool blocks, breaker state) over the run's
window (``graftscope.now_ms``); ``traffic_mix_row`` joins a list of
runs' demand, goodput and occupancy.
"""

from __future__ import annotations

import dataclasses
import queue as _queuemod
import threading
import time
from typing import Dict, List, Optional

from ..utils import graftscope, grafttime
from .profiles import SLO_POLICY, WorkloadProfile
from .schedule import Arrival, schedule

# graftscope series the occupancy summary reduces (queue, batch, pool
# and breaker: the serving stack's internal state under load)
OCCUPANCY_SERIES = ("queue_depth", "batch_occupancy",
                    "kv_cache_blocks_in_use", "iter_live_rows",
                    "hop_breaker_open")


@dataclasses.dataclass
class Outcome:
    """One request's observed result (client side + trace join)."""

    k: int
    request_id: str
    status: int = 0
    code: str = ""              # typed error code ("" on success)
    latency_s: float = 0.0
    abandoned: bool = False     # scheduled walk-away (short deadline)
    generated: Optional[str] = None
    ttft_s: Optional[float] = None    # joined from the flight recorder
    tpot_s: Optional[float] = None
    new_tokens: int = 0


def _post(client, profile: WorkloadProfile, a: Arrival,
          rid: str) -> Outcome:
    body = {"prompt": a.prompt, "max_new_tokens": a.max_new,
            "mode": a.mode}
    if a.mode == "sample":
        body["seed"] = a.seed
    headers = {"X-Request-ID": rid,
               "X-Workload-Profile": profile.name}
    if a.deadline_ms is not None:
        headers["X-Deadline-Ms"] = str(a.deadline_ms)
    t0 = time.perf_counter()
    out = Outcome(k=a.k, request_id=rid, abandoned=a.abandoned)
    grafttime.emit("arrival", rid=rid, k=a.k, profile=profile.name,
                   sched_t=round(a.t, 6), t=t0)
    try:
        r = client.post("/generate", json=body, headers=headers)
        out.status = r.status_code
        payload = r.json()
        if r.status_code == 200 and "generated" in payload:
            out.generated = payload["generated"]
        else:
            out.code = str(payload.get("error",
                                       payload.get("detail", "")))[:80]
            if out.status == 200:
                # reference-parity 200-with-error bodies (bad request
                # shapes) are driver errors, not serving outcomes
                out.status = 400
    except Exception as e:  # noqa: BLE001 — a dead client IS a result
        out.status = -1
        out.code = f"{type(e).__name__}: {e}"[:80]
    out.latency_s = time.perf_counter() - t0
    return out


def _join_traces(outcomes: List[Outcome], recorder) -> None:
    """Attach ttft/tpot/new_tokens from the flight recorder's traces
    (matched by X-Request-ID; requests that fell off the bounded ring
    simply keep client-side numbers only)."""
    if recorder is None:
        return
    by_id: Dict[str, dict] = {}
    # snapshot is newest-first; walk it oldest-first so a request id
    # reused across runs on one recorder (a sweep of rates) joins the
    # newest trace
    for t in reversed(recorder.snapshot(n=None)):
        by_id[t["request_id"]] = t
    for o in outcomes:
        t = by_id.get(o.request_id)
        if t is None:
            continue
        labels = t.get("labels", {})
        ttft_ms = labels.get("ttft_ms")
        if ttft_ms is not None:
            o.ttft_s = float(ttft_ms) / 1e3
        o.new_tokens = int(labels.get("new_tokens", 0) or 0)
        if o.ttft_s is not None and o.new_tokens > 1:
            decode_s = max(t["duration_ms"] / 1e3 - o.ttft_s, 0.0)
            o.tpot_s = decode_s / (o.new_tokens - 1)


def run_load(client, profile: WorkloadProfile, seed: int, n: int,
             rate_scale: float = 1.0, mode: str = "open",
             width: int = 4, recorder=None,
             join_timeout_s: float = 300.0, trend=None) -> dict:
    """Drive ``n`` scheduled arrivals of ``(seed, profile)`` at the
    app behind ``client`` and return the reduced load report (see
    module docstring). ``recorder`` is the app's FlightRecorder (pass
    the instance handed to ``create_app`` so the TTFT/TPOT join sees
    every request; size it >= n). ``trend`` is an optional
    ``grafttrend.TrendReducer``: the driver polls it once after the
    run drains and evaluates the declared watches, so a load run is one
    trend observation window, and the report gains a ``trend`` block
    naming the watches this run tripped."""
    if mode not in ("open", "closed", "serial"):
        raise ValueError(f"unknown load mode {mode!r}")
    arrivals = schedule(profile, seed, n, rate_scale)
    outcomes: List[Optional[Outcome]] = [None] * n
    rid_of = [f"{profile.name}-{seed}-{a.k:05d}" for a in arrivals]
    horizon_s = arrivals[-1].t if arrivals else 0.0

    occ_since = graftscope.now_ms()   # window THIS run's occupancy
    t0 = time.perf_counter()
    if mode == "open":
        def fire(a: Arrival):
            delay = a.t - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            outcomes[a.k] = _post(client, profile, a, rid_of[a.k])

        threads = [threading.Thread(target=fire, args=(a,), daemon=True)
                   for a in arrivals]
        for t in threads:
            t.start()
        # the join budget starts counting AFTER the schedule horizon —
        # a long low-rate run still has threads sleeping toward their
        # offsets, which is health, not a hang
        deadline = time.monotonic() + horizon_s + join_timeout_s
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.1))
        hung = sum(1 for t in threads if t.is_alive())
        if hung:
            raise TimeoutError(
                f"graftload: {hung}/{n} open-loop requests still in "
                f"flight {join_timeout_s}s past the schedule horizon")
    else:
        # closed loop: workers pull the same request bodies in order,
        # next only after the previous returns (arrival times ignored
        # — that self-throttling is the point of the comparison)
        q: "_queuemod.Queue[Arrival]" = _queuemod.Queue()
        for a in arrivals:
            q.put(a)
        n_workers = 1 if mode == "serial" else max(int(width), 1)

        def drain():
            while True:
                try:
                    a = q.get_nowait()
                except _queuemod.Empty:
                    return
                outcomes[a.k] = _post(client, profile, a, rid_of[a.k])

        if n_workers == 1:
            drain()
        else:
            threads = [threading.Thread(target=drain, daemon=True)
                       for _ in range(n_workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=join_timeout_s)
            if any(t.is_alive() for t in threads):
                raise TimeoutError("graftload: closed-loop workers hung")
    wall = time.perf_counter() - t0

    done: List[Outcome] = [o for o in outcomes if o is not None]
    _join_traces(done, recorder)
    report = summarize(profile, done, wall, seed=seed,
                       rate_scale=rate_scale, mode=mode,
                       width=(1 if mode == "serial" else width),
                       horizon_s=(horizon_s if mode == "open" else None))
    report["occupancy"] = occupancy_summary(since_ms=occ_since)
    if trend is not None:
        trend.poll()
        trips = trend.evaluate()
        report["trend"] = {"alerts_fired": len(trips),
                           "tripped": [a["watch"] for a in trips]}
    return report


# -- reduction ----------------------------------------------------------------


def _pct(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile without numpy (values unsorted ok)."""
    if not values:
        return None
    vs = sorted(values)
    idx = max(int(-(-q / 100.0 * len(vs) // 1)) - 1, 0)
    return vs[min(idx, len(vs) - 1)]


def _metric_values(metric: str, completed: List[Outcome],
                   ) -> List[float]:
    if metric == "e2e":
        return [o.latency_s for o in completed]
    if metric == "ttft":
        return [o.ttft_s for o in completed if o.ttft_s is not None]
    if metric == "tpot":
        return [o.tpot_s for o in completed if o.tpot_s is not None]
    raise KeyError(metric)


def summarize(profile: WorkloadProfile, outcomes: List[Outcome],
              wall_s: float, seed: int = 0, rate_scale: float = 1.0,
              mode: str = "open", width: int = 0,
              horizon_s: Optional[float] = None) -> dict:
    """Outcomes -> the journaled load report: Pareto fields, typed
    shed/miss split, declared-SLO attainment, goodput. ``horizon_s``
    is the SCHEDULE's span (last arrival offset) — the open-loop
    offered rate derives from it, not from completion wall time:
    deriving the Pareto x-axis from how long the system took to drain
    would reintroduce exactly the system-speed coupling open-loop
    generation exists to remove. Closed/serial modes (self-paced by
    construction) pass None and fall back to wall time."""
    policy = SLO_POLICY.get(profile.name, {})
    completed = [o for o in outcomes if o.status == 200]
    shed_429 = [o for o in outcomes if o.status == 429]
    s503 = [o for o in outcomes if o.status == 503]
    # 503s split three ways: deadline_exceeded on accepted work is an
    # SLO MISS; the abandonment profile's scheduled walk-aways are
    # demand that left (neither shed nor miss); everything else
    # (breaker open, park budget, engine fault) is a typed SHED —
    # honest refusal/degradation, never conflated with broken promises.
    # Note the walk-away netting is CLIENT-side knowledge: the
    # server's deadline_misses_total counts every budget death
    # (it cannot see intent), so it reads >= this row's miss count
    # under abandonment traffic — documented at the METRIC_CATALOG
    # entry.
    walked = [o for o in s503 if o.abandoned
              and o.code == "deadline_exceeded"]
    misses = [o for o in s503 if not o.abandoned
              and o.code == "deadline_exceeded"]
    shed_503 = [o for o in s503 if o.code != "deadline_exceeded"]
    errors = [o for o in outcomes
              if o.status not in (200, 429, 503)]
    demanded = max(len(outcomes) - len(walked), 0)

    toks = sum(o.new_tokens for o in completed)
    lat_ms = [o.latency_s * 1e3 for o in completed]

    # declared-SLO attainment, metric by metric
    slo_rows: Dict[str, dict] = {}
    attained_n = 0
    for metric, (target, pct) in sorted(policy.items()):
        if metric == "deadline_miss":
            observed = (len(misses) / demanded) if demanded else 0.0
            ok = observed <= target
            row = {"target": target, "percentile": pct,
                   "observed_miss_fraction": round(observed, 4),
                   "attained": ok}
        else:
            values = _metric_values(metric, completed)
            p = _pct(values, pct)
            ok = p is not None and p <= target
            row = {"target_s": target, "percentile": pct,
                   "observed_s": None if p is None else round(p, 4),
                   "samples": len(values), "attained": ok}
        slo_rows[metric] = row
        attained_n += bool(ok)

    # goodput: completions whose EVERY declared latency budget
    # PROVABLY held — a declared metric with no measured value (the
    # flight-recorder join missed: no recorder, or the rid fell off
    # the bounded ring) counts AGAINST goodput, never silently for it;
    # an unprovable promise must not inflate the gated number
    def in_slo(o: Outcome) -> bool:
        for metric, (target, _pct_) in policy.items():
            if metric == "deadline_miss":
                continue
            if metric == "tpot" and o.new_tokens <= 1:
                continue       # no inter-token interval exists to bind
            v = {"e2e": o.latency_s, "ttft": o.ttft_s,
                 "tpot": o.tpot_s}[metric]
            if v is None or v > target:
                return False
        return True

    good = [o for o in completed if in_slo(o)]
    return {
        "profile": profile.name,
        "seed": seed,
        "mode": mode,
        "width": width,
        "rate_scale": rate_scale,
        "offered": len(outcomes),
        "offered_rps": round(
            len(outcomes) / (horizon_s if horizon_s else wall_s), 3)
        if (horizon_s or wall_s) else 0,
        "wall_s": round(wall_s, 3),
        "completed": len(completed),
        "abandoned": len(walked),
        "shed_429": len(shed_429),
        "shed_503": len(shed_503),
        "deadline_misses": len(misses),
        "errors": len(errors),
        "error_codes": sorted({o.code for o in errors if o.code})[:8],
        "throughput_tokens_per_sec": round(toks / wall_s, 2)
        if wall_s else 0.0,
        "p50_e2e_ms": round(_pct(lat_ms, 50) or 0.0, 1),
        "p99_e2e_ms": round(_pct(lat_ms, 99) or 0.0, 1),
        "p99_ttft_ms": round((_pct(_metric_values("ttft", completed),
                                   99) or 0.0) * 1e3, 1),
        "p99_tpot_ms": round((_pct(_metric_values("tpot", completed),
                                   99) or 0.0) * 1e3, 1),
        "slo": slo_rows,
        "slo_attainment": round(attained_n / len(policy), 4)
        if policy else None,
        "goodput": len(good),
        "goodput_fraction": round(len(good) / demanded, 4)
        if demanded else 0.0,
        "goodput_rps": round(len(good) / wall_s, 3) if wall_s else 0.0,
        "outcomes": outcomes,
    }


def occupancy_summary(n: int = 512,
                      since_ms: Optional[float] = None) -> dict:
    """Reduce the graftscope occupancy series (the same rings
    /debug/profile serves) to per-series {points, max, mean} — queue
    depth, batch occupancy, pool blocks, breaker state. ``since_ms``
    (a ``graftscope.now_ms`` instant) windows the reduction to points
    sampled after it — run_load passes its own start, so sequential
    runs against one app (warmup, a Pareto sweep) don't bleed each
    other's spikes into per-run columns. None = whole ring."""
    series = graftscope.snapshot(n=n).get("series", {})
    out: Dict[str, dict] = {}
    for label, pts in sorted(series.items()):
        if not any(label.startswith(name) for name in OCCUPANCY_SERIES):
            continue
        values = [v for t, v in pts
                  if since_ms is None or t >= since_ms]
        if not values:
            continue
        out[label] = {"points": len(values),
                      "max": round(max(values), 3),
                      "mean": round(sum(values) / len(values), 3)}
    return out


def pareto_row(report: dict) -> dict:
    """The compact Pareto point of a (profile, rate): offered rate ->
    achieved throughput + tails + shed split."""
    keep = ("profile", "rate_scale", "offered", "offered_rps",
            "completed", "abandoned", "shed_429", "shed_503",
            "deadline_misses", "errors", "throughput_tokens_per_sec",
            "p50_e2e_ms", "p99_e2e_ms", "p99_ttft_ms", "p99_tpot_ms",
            "goodput_rps", "goodput_fraction")
    return {k: report[k] for k in keep}


def slo_row(report: dict) -> dict:
    """The compact SLO-attainment row of a profile."""
    keep = ("profile", "rate_scale", "offered", "completed",
            "abandoned", "shed_429", "shed_503", "deadline_misses",
            "slo", "slo_attainment", "goodput", "goodput_fraction",
            "goodput_rps")
    return {k: report[k] for k in keep}


def traffic_mix_row(reports: List[dict]) -> dict:
    """The measured traffic mix: one row a (profile, rate_scale) run
    joining the demand side (offered rate), the value side (goodput
    under the declared SLOs) and the occupancy the mix induced in the
    serving stack (queue depth, batch occupancy, pool blocks: each
    run's own windowed graftscope reduction), the tuple a continuous
    re-planner watches."""
    rows = []
    for rep in reports:
        occ = rep.get("occupancy", {})

        def _mean_of(prefix: str, occ=occ) -> Optional[float]:
            vals = [v["mean"] for k, v in occ.items()
                    if k.startswith(prefix)]
            return (round(sum(vals) / len(vals), 3) if vals else None)

        rows.append({
            "workload": f"{rep['profile']}_x{rep['rate_scale']:g}"
                        .replace(".", "p"),
            "profile": rep["profile"],
            "rate_scale": rep["rate_scale"],
            "offered_rps": rep["offered_rps"],
            "completed": rep["completed"],
            "throughput_tokens_per_sec":
                rep["throughput_tokens_per_sec"],
            "goodput_rps": rep["goodput_rps"],
            "goodput_fraction": rep["goodput_fraction"],
            "shed_429": rep["shed_429"],
            "shed_503": rep["shed_503"],
            "deadline_misses": rep["deadline_misses"],
            "mean_queue_depth": _mean_of("queue_depth"),
            "mean_batch_occupancy": _mean_of("batch_occupancy"),
            "mean_blocks_in_use": _mean_of("kv_cache_blocks_in_use"),
        })
    return {"workloads": rows}
