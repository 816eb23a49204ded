"""The unified causal timeline: one clock, every producer.

Counterpart of ``llm_sharding_demo_tpu/utils/grafttime.py``. Producers
publish typed events onto one bounded bus (``TimelineBus``, the oldest
dropped first) stamped on one monotonic clock, ``perf_counter`` in ms
since the bus epoch:

- request-trace spans (``span_open``/``span_close``, utils.tracing);
- graftscope's instrumented calls (``dispatch_begin``/``dispatch_end``)
  and occupancy samples (``occupancy``);
- graftmem's byte deltas (``mem_alloc``/``mem_free``);
- graftfault's injections and breaker transitions (``fault_inject``,
  ``breaker``), the iteration batcher's ``admission``, ``park``,
  ``preempt`` and ``resume``, the pool's ``eviction``, the host tier's
  ``tier_demote``/``tier_promote``, the trend reducer's
  ``trend_alert``, the plan switcher's ``plan_eval``/``plan_switch``
  (utils.graftwatch) and, with ``GRAFTSCHED`` armed, each traced lock's
  ``lock_acquire`` and ``lock_contend``.

Events join by ``rid`` (the X-Request-ID; a batched phase carries the
``rids`` of all its rows: ``correlate``) and ``replica`` (the serving
app's label, ``use_replica``). ``GET /debug/timeline`` serves the stream
(``debug_timeline_payload``: ``?rid=``, ``?since=``, ``?since_seq=``,
``?kinds=``, ``?n=``); ``export_chrome`` turns it into Chrome-trace JSON
for chrome://tracing or Perfetto and ``validate_chrome`` checks one.
``blackbox`` journals the ring when a request fails typed (a bounded
ring of dumps, and a file each under ``$GRAFTTIME_DIR`` when set).

``EVENT_KINDS`` and ``KIND_FIELDS`` are the JAX package's vocabulary.
``arrival`` comes from the load driver (``loadgen.driver``), once a
fired request, as in the JAX package, where the router emits none
either. ``replay_view`` is the projection two runs of one seeded schedule
must agree on: per-rid streams without the wall-clock fields and the
kinds that observe the schedule itself.

``GRAFTTIME=0`` turns recording off; ``GRAFTTIME_CAP`` sizes the ring.
The bus's lock is a plain ``threading.Lock``.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

EVENT_KINDS = {
    "arrival":        "loadgen fired a scheduled request at the app",
    "span_open":      "a request-trace span opened (tracing)",
    "span_close":     "a request-trace span closed, duration attached",
    "dispatch_begin": "an instrumented jit entry point began dispatch",
    "dispatch_end":   "an instrumented dispatch closed (program key + "
                      "window)",
    "occupancy":      "a live-state gauge sample (graftscope series)",
    "lock_acquire":   "an instrumented lock was acquired (GRAFTSCHED)",
    "lock_contend":   "an instrumented lock acquisition waited >1ms",
    "fault_inject":   "a seeded fault plan fired at a production site",
    "breaker":        "a circuit/park-budget breaker state observation",
    "admission":      "a scheduler admitted a request (seed/join)",
    "eviction":       "the pool LRU-evicted a prefix entry's blocks",
    "park":           "a live row parked (preemption or fault recovery)",
    "preempt":        "pool pressure chose a victim row to park",
    "resume":         "a parked row resumed by recompute",
    "plan_eval":      "graftwatch evaluated the plan set at a wave "
                      "boundary",
    "plan_switch":    "graftwatch installed a different certified plan",
    "mem_alloc":      "a graftmem ledger holding grew (byte delta + "
                      "component total)",
    "mem_free":       "a graftmem ledger holding shrank or retired",
    "trend_alert":    "a declared grafttrend watch tripped (burn/"
                      "drift/level)",
    "tier_demote":    "grafttier spilled a cold prefix entry's blocks "
                      "to the host-RAM tier",
    "tier_promote":   "grafttier promoted a demoted entry's blocks "
                      "back into the device pool",
}

# kind -> the fields an emit site names
KIND_FIELDS = {
    "arrival":        ("rid",),
    "span_open":      ("name",),
    "span_close":     ("name",),
    "dispatch_begin": ("scope", "key"),
    "dispatch_end":   ("scope", "key"),
    "occupancy":      ("name", "value"),
    "lock_acquire":   ("name",),
    "lock_contend":   ("name", "wait_ms"),
    "fault_inject":   ("site", "fault"),
    "breaker":        ("state",),
    "admission":      ("rid",),
    "eviction":       ("blocks",),
    "park":           ("rid", "reason"),
    "preempt":        ("rid",),
    "resume":         ("rid",),
    "plan_eval":      ("to_plan",),
    "plan_switch":    ("to_plan",),
    "mem_alloc":      ("component", "bytes"),
    "mem_free":       ("component", "bytes"),
    "trend_alert":    ("watch", "severity"),
    "tier_demote":    ("blocks",),
    "tier_promote":   ("blocks",),
}

# wall-clock and interleaving fields, and the kinds that observe the
# schedule itself: outside what a seeded replay must reproduce
REPLAY_EXEMPT_FIELDS = ("seq", "ts", "tid", "dur_ms", "wait_ms")
REPLAY_EXEMPT_KINDS = ("lock_acquire", "lock_contend", "occupancy",
                       "mem_alloc", "mem_free")

RING_CAPACITY = 4096
BLACKBOX_CAPACITY = 8

_enabled = [os.environ.get("GRAFTTIME", "1") != "0"]


def enabled() -> bool:
    return _enabled[0]


def set_enabled(value: bool) -> bool:
    """Turn recording on or off; returns the previous setting."""
    prev = _enabled[0]
    _enabled[0] = bool(value)
    return prev


# -- ambient correlation ------------------------------------------------------

_RIDS: "contextvars.ContextVar[Tuple[str, ...]]" = contextvars.ContextVar(
    "grafttime_rids", default=())
_REPLICA: "contextvars.ContextVar[Optional[str]]" = contextvars.ContextVar(
    "grafttime_replica", default=None)


@contextlib.contextmanager
def correlate(rids: Sequence[Optional[str]]):
    """Attach this rid set to every event emitted in the block (a
    scheduler around a batched phase; None entries are dropped)."""
    token = _RIDS.set(tuple(r for r in rids if r))
    try:
        yield
    finally:
        _RIDS.reset(token)


@contextlib.contextmanager
def use_replica(name: Optional[str]):
    """Attach a replica label to every event emitted in the block."""
    token = _REPLICA.set(name)
    try:
        yield
    finally:
        _REPLICA.reset(token)


def set_thread_replica(name: Optional[str]) -> None:
    """Label every event of the current thread: a scheduler's worker
    thread never sees the handler's ``use_replica``."""
    _REPLICA.set(name)


_current_trace = []   # tracing.current_trace, bound at first use


def _ambient_rid() -> Tuple[Optional[str], Optional[Tuple[str, ...]]]:
    """``(rid, rids)``: the ``correlate`` set first, else the ambient
    request trace's id."""
    rids = _RIDS.get()
    if rids:
        return (rids[0], None) if len(rids) == 1 else (None, rids)
    if not _current_trace:
        from . import tracing   # tracing imports this module
        _current_trace.append(tracing.current_trace)
    rid = getattr(_current_trace[0](), "request_id", None)
    return (rid, None) if rid else (None, None)


# -- the bus ------------------------------------------------------------------


class TimelineBus:
    """A bounded ring of typed events on one monotonic clock."""

    def __init__(self, capacity: int = RING_CAPACITY):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._seq = 0
        self.capacity = capacity
        self.t0 = time.perf_counter()
        self.epoch_unix = time.time()

    def to_ms(self, perf_t: float) -> float:
        """A ``perf_counter`` instant on the bus clock."""
        return round((perf_t - self.t0) * 1e3, 3)

    def now_ms(self) -> float:
        return self.to_ms(time.perf_counter())

    def emit(self, kind: str, *, rid=None, key: Optional[str] = None,
             replica: Optional[str] = None, t: Optional[float] = None,
             **fields) -> None:
        """Publish one event. ``rid`` is a string, a sequence of them (a
        batched phase) or None (the ambient correlation); ``t`` dates
        the event at an already measured ``perf_counter`` instant."""
        if not _enabled[0]:
            return
        rids = None
        if rid is None:
            rid, rids = _ambient_rid()
        elif not isinstance(rid, str):
            seq_rids = tuple(r for r in rid if r)
            rid, rids = ((seq_rids[0], None) if len(seq_rids) == 1
                         else (None, seq_rids or None))
        if replica is None:
            replica = _REPLICA.get()
        ev = {"kind": kind,
              "ts": round(((time.perf_counter() if t is None else t)
                           - self.t0) * 1e3, 3),
              "tid": threading.get_ident()}
        if rid is not None:
            ev["rid"] = rid
        if rids:
            ev["rids"] = list(rids)
        if key is not None:
            ev["key"] = key
        if replica is not None:
            ev["replica"] = replica
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)

    def events(self, rid: Optional[str] = None,
               since: Optional[float] = None,
               kinds: Optional[Iterable[str]] = None,
               n: Optional[int] = None,
               since_seq: Optional[int] = None) -> List[dict]:
        """The filtered stream in clock order (``ts``, then ``seq``),
        oldest first: ``rid`` matches ``rid`` or membership in ``rids``;
        ``since`` is an exclusive ``ts`` bound, ``since_seq`` an
        exclusive emission-sequence bound (the incremental cursor: an
        event dated back but emitted late still comes); ``kinds`` keeps
        those kinds; ``n`` keeps the newest n."""
        with self._lock:
            evs = list(self._events)
        evs.sort(key=lambda e: (e["ts"], e["seq"]))
        if rid is not None:
            evs = [e for e in evs
                   if e.get("rid") == rid or rid in e.get("rids", ())]
        if since is not None:
            evs = [e for e in evs if e["ts"] > since]
        if since_seq is not None:
            evs = [e for e in evs if e["seq"] > since_seq]
        if kinds is not None:
            keep = set(kinds)
            evs = [e for e in evs if e["kind"] in keep]
        if n is not None:
            n = int(n)
            evs = evs[-n:] if n > 0 else []
        return [dict(e) for e in evs]

    def snapshot(self, rid: Optional[str] = None,
                 since: Optional[float] = None,
                 kinds: Optional[Iterable[str]] = None,
                 n: Optional[int] = None,
                 since_seq: Optional[int] = None) -> dict:
        """The filtered stream with its clock header; ``cursor`` is the
        newest sequence, to pass back as ``since_seq``; ``dropped``
        counts the events the ring has lost."""
        evs = self.events(rid=rid, since=since, kinds=kinds, n=n,
                          since_seq=since_seq)
        with self._lock:
            emitted = self._seq
            held = len(self._events)
        return {
            "enabled": enabled(),
            "capacity": self.capacity,
            "emitted_total": emitted,
            "cursor": emitted,
            "since_seq": since_seq,
            "dropped": max(emitted - held, 0),
            "clock": {
                "epoch_unix": round(self.epoch_unix, 6),
                "now_ms": self.now_ms(),
                "model": ("perf_counter ms since bus epoch; one shared "
                          "clock in-process, rebase() across processes"),
            },
            "kinds": dict(EVENT_KINDS),
            "events": evs,
        }

    def dump_state(self) -> tuple:
        with self._lock:
            return (list(self._events), self._seq, self.t0,
                    self.epoch_unix)

    def restore_state(self, state: tuple) -> None:
        events, seq, t0, epoch = state
        with self._lock:
            self._events = deque(events, maxlen=self.capacity)
            self._seq = seq
            self.t0 = t0
            self.epoch_unix = epoch

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._seq = 0
            self.t0 = time.perf_counter()
            self.epoch_unix = time.time()


def _env_capacity() -> int:
    try:
        n = int(os.environ.get("GRAFTTIME_CAP", ""))
    except ValueError:
        return RING_CAPACITY
    return n if n >= 1 else RING_CAPACITY


BUS = TimelineBus(_env_capacity())


def emit(kind: str, **kw) -> None:
    BUS.emit(kind, **kw)


def events(**kw) -> List[dict]:
    return BUS.events(**kw)


def snapshot(**kw) -> dict:
    return BUS.snapshot(**kw)


def now_ms() -> float:
    return BUS.now_ms()


def dump_state() -> tuple:
    return BUS.dump_state()


def restore_state(state: tuple) -> None:
    BUS.restore_state(state)


def clear() -> None:
    BUS.clear()


# -- replay projection and rebasing -------------------------------------------


def replay_view(evs: List[dict]) -> Dict[str, List[dict]]:
    """Per-rid streams (a ``rids`` event in each member's), without the
    schedule-observing kinds and the wall-clock fields; events of no
    request are left out."""
    out: Dict[str, List[dict]] = {}
    for e in evs:
        if e["kind"] in REPLAY_EXEMPT_KINDS:
            continue
        targets = [e["rid"]] if "rid" in e else list(e.get("rids", ()))
        if not targets:
            continue
        core = {k: v for k, v in e.items() if k not in REPLAY_EXEMPT_FIELDS}
        for r in targets:
            out.setdefault(r, []).append(core)
    return {r: out[r] for r in sorted(out)}


def rebase(evs: List[dict], offset_ms: float) -> List[dict]:
    """Another process's events shifted onto this clock by the hop's
    start (``ts += offset_ms``)."""
    out = []
    for e in evs:
        e2 = dict(e)
        e2["ts"] = round(e["ts"] + offset_ms, 3)
        out.append(e2)
    return out


# -- Chrome-trace / Perfetto export -------------------------------------------

# windows become complete slices ("X"), occupancy and byte deltas
# counters ("C"), everything else instants ("i")
_WINDOW_KINDS = {"span_close": "span", "dispatch_end": "dispatch"}


def _pid_of(replica: Optional[str], pids: Dict[str, int]) -> int:
    if not replica:
        return 1
    if replica not in pids:
        pids[replica] = 2 + len(pids)
    return pids[replica]


def export_chrome(evs: List[dict], meta: Optional[dict] = None) -> dict:
    """A timeline stream as Chrome-trace JSON (``ts`` in microseconds;
    replicas as pids, emitting threads as tids, correlators in
    ``args``)."""
    trace_events: List[dict] = []
    pids: Dict[str, int] = {}
    for e in evs:
        kind = e["kind"]
        args = {k: v for k, v in e.items()
                if k not in ("kind", "ts", "tid", "seq")}
        pid = _pid_of(e.get("replica"), pids)
        tid = int(e.get("tid", 0)) % 2 ** 31
        ts_us = max(e["ts"], 0.0) * 1e3
        if kind in _WINDOW_KINDS:
            dur_us = max(float(e.get("dur_ms", 0.0)), 0.0) * 1e3
            trace_events.append({
                "name": str(e.get("name") or e.get("scope") or kind),
                "cat": _WINDOW_KINDS[kind], "ph": "X",
                "ts": max(ts_us - dur_us, 0.0), "dur": dur_us,
                "pid": pid, "tid": tid, "args": args})
        elif kind == "occupancy":
            trace_events.append({
                "name": str(e.get("name", "occupancy")),
                "cat": "occupancy", "ph": "C", "ts": ts_us,
                "pid": pid, "tid": tid,
                "args": {"value": float(e.get("value", 0.0))}})
        elif kind in ("mem_alloc", "mem_free"):
            # one counter track a component: its running total, with the
            # signed delta beside it
            trace_events.append({
                "name": f"hbm_bytes:{e.get('component', 'unknown')}",
                "cat": "graftmem", "ph": "C", "ts": ts_us,
                "pid": pid, "tid": tid,
                "args": {"value": float(e.get("total", e.get("bytes", 0))),
                         "delta": (float(e.get("bytes", 0))
                                   * (1 if kind == "mem_alloc" else -1))}})
        else:
            trace_events.append({
                "name": (f"{kind}:{e['name']}" if "name" in e
                         else (f"{kind}:{e['scope']}" if "scope" in e
                               else kind)),
                "cat": kind, "ph": "i", "s": "t", "ts": ts_us,
                "pid": pid, "tid": tid, "args": args})
    return {
        "displayTimeUnit": "ms",
        "traceEvents": trace_events,
        "otherData": {"producer": "grafttime",
                      "kinds": sorted({e["kind"] for e in evs}),
                      **(meta or {})},
    }


_VALID_PH = {"X", "i", "C", "B", "E", "I"}


def validate_chrome(payload: dict) -> List[str]:
    """The structural problems of an export; empty when valid."""
    problems: List[str] = []
    if not isinstance(payload, dict):
        return ["payload is not an object"]
    tes = payload.get("traceEvents")
    if not isinstance(tes, list):
        return ["traceEvents missing or not a list"]
    for i, te in enumerate(tes):
        where = f"traceEvents[{i}]"
        if not isinstance(te, dict):
            problems.append(f"{where}: not an object")
            continue
        if not isinstance(te.get("name"), str) or not te.get("name"):
            problems.append(f"{where}: name must be a non-empty string")
        if te.get("ph") not in _VALID_PH:
            problems.append(f"{where}: ph {te.get('ph')!r} invalid")
        if not isinstance(te.get("ts"), (int, float)) or te["ts"] < 0:
            problems.append(f"{where}: ts must be a number >= 0")
        for fld in ("pid", "tid"):
            if not isinstance(te.get(fld), int):
                problems.append(f"{where}: {fld} must be an int")
        if te.get("ph") == "X" and (
                not isinstance(te.get("dur"), (int, float))
                or te["dur"] < 0):
            problems.append(f"{where}: X event needs dur >= 0")
        if te.get("ph") == "i" and te.get("s") not in ("g", "p", "t"):
            problems.append(f"{where}: instant needs s in g/p/t")
    return problems


# -- the /debug/timeline payload ----------------------------------------------


def debug_timeline_payload(query: dict, serving: dict):
    """The ``GET /debug/timeline`` body under the ``serving`` header, or
    ``(422, detail)`` for a filter that does not parse or a kind outside
    the vocabulary."""
    since = query.get("since")
    if since is not None:
        try:
            since = float(since)
        except ValueError:
            return 422, {"detail": "since must be a number (ms on the "
                                   "bus clock)"}
    since_seq = query.get("since_seq")
    if since_seq is not None:
        try:
            since_seq = int(since_seq)
        except ValueError:
            return 422, {"detail": "since_seq must be an integer "
                                   "(the previous payload's cursor)"}
    kinds = None
    if query.get("kinds"):
        kinds = [k.strip() for k in query["kinds"].split(",") if k.strip()]
        unknown = sorted(set(kinds) - set(EVENT_KINDS))
        if unknown:
            return 422, {"detail": f"unknown kinds {unknown}; "
                         f"vocabulary: {sorted(EVENT_KINDS)}"}
    n = query.get("n")
    if n is not None:
        try:
            n = int(n)
        except ValueError:
            return 422, {"detail": "n must be an integer"}
    return {"serving": serving,
            **BUS.snapshot(rid=query.get("rid") or None, since=since,
                           kinds=kinds, n=n, since_seq=since_seq)}


# -- black-box dumps ----------------------------------------------------------

_DUMPS_LOCK = threading.Lock()
_DUMPS: deque = deque(maxlen=BLACKBOX_CAPACITY)
_DUMP_SEQ = [0]   # file index: never reused when the ring rotates


def blackbox(reason: str, rid: Optional[str] = None) -> dict:
    """Journal the ring as a post-mortem dump, in a bounded in-process
    ring and, when ``$GRAFTTIME_DIR`` names a directory, in
    ``grafttime_blackbox_<n>_<reason>.json`` there (a failed write never
    masks the failure that called for the dump)."""
    dump = {"reason": reason, "rid": rid, "t_wall": time.time(),
            **BUS.snapshot()}
    with _DUMPS_LOCK:
        _DUMPS.append(dump)
        _DUMP_SEQ[0] += 1
        n = _DUMP_SEQ[0]
    out_dir = os.environ.get("GRAFTTIME_DIR", "")
    if out_dir:
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in reason)[:48]
        path = os.path.join(out_dir, f"grafttime_blackbox_{n}_{safe}.json")
        try:
            with open(path, "w", encoding="utf-8") as f:
                json.dump(dump, f, default=str)
        except OSError:
            pass
    return dump


def blackbox_dumps() -> List[dict]:
    with _DUMPS_LOCK:
        return list(_DUMPS)


def clear_blackbox() -> None:
    with _DUMPS_LOCK:
        _DUMPS.clear()
