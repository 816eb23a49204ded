"""Per-call timing rings and occupancy series.

Counterpart of ``llm_sharding_demo_tpu/utils/graftscope.py``:

- ``instrument(fn, scope, key_fn)`` wraps a callable so that each call
  lands in a bounded ring of its scope under a key derived from its
  arguments (``key_fn``, else the tensor shapes): the host window around
  the call (also the ``dispatch_seconds`` histogram) and, for a call on
  CUDA tensors, the stream window between two ``torch.cuda.Event``\\ s
  recorded on the current stream before and after it. The events are
  never waited on: ``snapshot`` resolves the pairs whose end the stream
  has passed and reports the others as pending. While the current
  stream is capturing a CUDA graph no pair is recorded (timing events
  cannot be recorded in a capture);
- ``sample(name, value)`` appends an occupancy point (batch occupancy,
  queue depth, pool blocks, ledger bytes) to a bounded series;
- ``snapshot(n)`` is the ``GET /debug/profile`` body; ``now_ms()`` is
  the instant on its clock.

Each call also emits ``dispatch_begin``/``dispatch_end`` on the timeline
(utils.grafttime), and each sample an ``occupancy`` event.

The event pair is the torch form of the JAX package's sync mode, which
closes each window with ``block_until_ready``: it costs two event
records a call and no sync. ``GRAFTSCOPE=0`` turns recording off.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import graftsched, grafttime
from .metrics import REGISTRY

RING_CAPACITY = 256
SERIES_CAPACITY = 512
# distinct keys a scope tracks; the rest aggregate under _OVERFLOW
KEY_CAPACITY = 512
_OVERFLOW = ("<key-overflow>",)

TRUTH = ("host: the calling thread's wall clock around the call, which "
         "ends once its CUDA work is enqueued (launches are "
         "asynchronous); stream: the time between two CUDA events "
         "recorded on the current stream before and after the call, "
         "resolved when this payload is read and never waited on, so a "
         "pair the stream has not reached yet is pending; the stream "
         "window includes any idle time the host leaves between "
         "launches, so it is not device busy time")

_enabled = [os.environ.get("GRAFTSCOPE", "1") != "0"]


def enabled() -> bool:
    return _enabled[0]


def set_enabled(value: bool) -> bool:
    """Turn recording on or off; returns the previous setting."""
    prev = _enabled[0]
    _enabled[0] = bool(value)
    return prev


def _stream_ms(sample: list):
    """A ring sample's stream window in ms: resolved (and cached) once
    its end event has completed, "pending" before, None without a
    pair."""
    ev = sample[3]
    if ev is None or isinstance(ev, float):
        return ev
    start, end = ev
    if not end.query():
        return "pending"
    sample[3] = float(start.elapsed_time(end))
    return sample[3]


class ScopeState:
    """Per-scope call rings and per-series occupancy points, bounded."""

    def __init__(self):
        self._lock = graftsched.lock("graftscope.ScopeState._lock")
        # scope -> {"samples": deque[[t, key, seconds, events]],
        #           "programs": {key: [calls, seconds]}}
        self._rings: Dict[str, dict] = {}
        # (name, labels) -> deque[(t, value)]
        self._points: Dict[Tuple[str, tuple], deque] = {}
        self.t0 = time.perf_counter()

    def record(self, scope: str, key: tuple, seconds: float,
               events=None) -> None:
        now = time.perf_counter()
        with self._lock:
            ring = self._rings.get(scope)
            if ring is None:
                ring = self._rings[scope] = {
                    "samples": deque(maxlen=RING_CAPACITY), "programs": {}}
            programs = ring["programs"]
            if key not in programs and len(programs) >= KEY_CAPACITY:
                key = _OVERFLOW
            stat = programs.setdefault(key, [0, 0.0])
            stat[0] += 1
            stat[1] += seconds
            ring["samples"].append([now, key, seconds, events])

    def sample(self, name: str, value: float, **labels) -> None:
        now = time.perf_counter()
        skey = (name, tuple(sorted(labels.items())))
        with self._lock:
            pts = self._points.get(skey)
            if pts is None:
                pts = self._points[skey] = deque(maxlen=SERIES_CAPACITY)
            pts.append((now, float(value)))

    def calls(self, scope: str) -> List[Tuple[tuple, float]]:
        """The scope's ``(key, host seconds)`` calls, oldest first."""
        with self._lock:
            ring = self._rings.get(scope)
            return [(s[1], s[2]) for s in ring["samples"]] if ring else []

    def series(self, name: str) -> List[Tuple[float, float, dict]]:
        """Every label set's ``(t, value, labels)`` points of one series,
        in time order."""
        with self._lock:
            pts = [(t, v, dict(labels))
                   for (n, labels), ring in self._points.items()
                   if n == name for t, v in ring]
        return sorted(pts, key=lambda p: p[0])

    def program_keys(self, scope: str) -> Dict[tuple, Tuple[int, float]]:
        """``{key: (calls, host seconds)}`` of one scope."""
        with self._lock:
            ring = self._rings.get(scope)
            if ring is None:
                return {}
            return {k: (v[0], v[1]) for k, v in ring["programs"].items()}

    def scope_seconds(self, scope: str) -> float:
        with self._lock:
            ring = self._rings.get(scope)
            if ring is None:
                return 0.0
            return sum(v[1] for v in ring["programs"].values())

    def _series_totals_locked(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for (name, labels), pts in sorted(self._points.items()):
            vals = [v for _, v in pts]
            out[_label(name, labels)] = {"points": len(vals),
                                         "last": vals[-1],
                                         "max": max(vals),
                                         "min": min(vals)}
        return out

    def series_totals(self) -> Dict[str, dict]:
        """Each series' points, last, max and min over its whole ring."""
        with self._lock:
            return self._series_totals_locked()

    def snapshot(self, n: int = 32) -> dict:
        """The ``/debug/profile`` body: per scope its totals, its hottest
        keys, its stream-window summary over the ring, and the last
        ``n`` calls; per series the last ``n`` points. Times are ms since
        the state's start."""
        n = max(int(n), 0)
        with self._lock:
            dispatch = {}
            for scope in sorted(self._rings):
                ring = self._rings[scope]
                programs = ring["programs"]
                top = sorted(programs.items(), key=lambda kv: kv[1][1],
                             reverse=True)
                samples = list(ring["samples"])
                streams = [_stream_ms(s) for s in samples]
                done = [v for v in streams if isinstance(v, float)]
                entry = {
                    "calls": sum(v[0] for v in programs.values()),
                    "seconds_total": round(
                        sum(v[1] for v in programs.values()), 6),
                    "programs": len(programs),
                    "keys": {repr(k): {"calls": v[0],
                                       "seconds_total": round(v[1], 6)}
                             for k, v in top[:64]},
                    "stream": {
                        "resolved": len(done),
                        "pending": sum(v == "pending" for v in streams),
                        "none": sum(v is None for v in streams),
                        "ms_total": round(sum(done), 4),
                    },
                    "ring": [
                        {"t_ms": round((s[0] - self.t0) * 1e3, 3),
                         "key": repr(s[1]), "ms": round(s[2] * 1e3, 4),
                         "stream_ms": (round(v, 4) if isinstance(v, float)
                                       else v)}
                        for s, v in (list(zip(samples, streams))[-n:]
                                     if n else [])],
                }
                if len(programs) > 64:
                    entry["keys_truncated"] = True
                dispatch[scope] = entry
            series = {
                _label(name, labels): [
                    [round((t - self.t0) * 1e3, 3), v]
                    for t, v in (list(pts)[-n:] if n else [])]
                for (name, labels), pts in sorted(self._points.items())}
            series_totals = self._series_totals_locked()
        return {
            "enabled": enabled(),
            "ring_capacity": RING_CAPACITY,
            "series_capacity": SERIES_CAPACITY,
            "truth": TRUTH,
            "dispatch": dispatch,
            "series": series,
            "series_totals": series_totals,
        }

    def dump_state(self) -> tuple:
        with self._lock:
            rings = {scope: {"samples": [list(s) for s in ring["samples"]],
                             "programs": {k: list(v) for k, v
                                          in ring["programs"].items()}}
                     for scope, ring in self._rings.items()}
            points = {k: list(v) for k, v in self._points.items()}
        return rings, points, self.t0

    def restore_state(self, state: tuple) -> None:
        rings, points, t0 = state
        with self._lock:
            self._rings = {
                scope: {"samples": deque((list(s) for s in ring["samples"]),
                                         maxlen=RING_CAPACITY),
                        "programs": {k: list(v) for k, v
                                     in ring["programs"].items()}}
                for scope, ring in rings.items()}
            self._points = {k: deque(v, maxlen=SERIES_CAPACITY)
                            for k, v in points.items()}
            self.t0 = t0

    def clear(self) -> None:
        with self._lock:
            self._rings = {}
            self._points = {}
            self.t0 = time.perf_counter()


def _label(name: str, labels: tuple) -> str:
    return name + ("{%s}" % ",".join(f"{k}={v}" for k, v in labels)
                   if labels else "")


STATE = ScopeState()


def _default_key(args, kwargs) -> tuple:
    """The tensor operands' shapes and the plain keyword values."""
    parts = []
    for a in args:
        shp = getattr(a, "shape", None)
        if shp is not None:
            parts.append(tuple(shp))
    for k in sorted(kwargs):
        v = kwargs[k]
        parts.append((k, v if isinstance(v, (int, float, str, bool,
                                             type(None))) else repr(v)))
    return tuple(parts)


def _cuda_device(values, depth: int = 2) -> Optional[torch.device]:
    """The device of the first CUDA tensor among ``values`` (and their
    lists, tuples, dicts and dataclasses, ``depth`` levels down), or
    None."""
    for v in values:
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                return v.device
            continue
        if depth == 0:
            continue
        if isinstance(v, dict):
            inner = v.values()
        elif isinstance(v, (list, tuple)):
            inner = v
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            inner = [getattr(v, f.name) for f in dataclasses.fields(v)]
        else:
            continue
        dev = _cuda_device(inner, depth - 1)
        if dev is not None:
            return dev
    return None


class ProfiledFn:
    """A callable timed into its scope's ring on every call (module
    docstring). Other attributes forward to the wrapped callable. On a
    class it wraps a method: an instance's attribute binds it, so the
    instance holds no reference to itself (no cycle to wait for the
    collector)."""

    __slots__ = ("_fn", "_scope", "_key_fn")

    def __init__(self, fn, scope: str, key_fn: Optional[Callable] = None):
        self._fn = fn
        self._scope = scope
        self._key_fn = key_fn

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return ProfiledFn(self._fn.__get__(obj, objtype), self._scope,
                          self._key_fn)

    def __call__(self, *args, **kwargs):
        if not _enabled[0]:
            return self._fn(*args, **kwargs)
        try:
            key = (self._key_fn(*args, **kwargs) if self._key_fn is not None
                   else _default_key(args, kwargs))
        except Exception:  # noqa: BLE001 - a key slip must not cost the call
            key = ("<unkeyed>",)
        krepr = repr(key)
        grafttime.emit("dispatch_begin", scope=self._scope, key=krepr)
        events = None
        dev = _cuda_device(args)
        if dev is None and kwargs:
            dev = _cuda_device(kwargs.values())
        if dev is not None and not torch.cuda.is_current_stream_capturing():
            # an int index: a quarter of the cost of a device
            stream = torch.cuda.current_stream(dev.index)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        seconds = time.perf_counter() - t0
        if events is not None:
            events[1].record(stream)
        REGISTRY.observe("dispatch_seconds", seconds, scope=self._scope)
        STATE.record(self._scope, key, seconds, events)
        grafttime.emit("dispatch_end", scope=self._scope, key=krepr,
                       dur_ms=round(seconds * 1e3, 4))
        return out

    def __getattr__(self, name):
        return getattr(self._fn, name)


def instrument(fn, scope: str,
               key_fn: Optional[Callable] = None) -> ProfiledFn:
    """Wrap ``fn`` for the scope ring; ``key_fn(*args, **kwargs)`` gives
    a call's key (default: the operands' shapes)."""
    return ProfiledFn(fn, scope, key_fn)


def sample(name: str, value: float, **labels) -> None:
    """Append one occupancy point to ``name``'s series (a
    ``METRIC_CATALOG`` gauge) and mirror it onto the timeline."""
    if _enabled[0]:
        STATE.sample(name, value, **labels)
        grafttime.emit("occupancy", name=name, value=float(value), **labels)


def calls(scope: str) -> List[Tuple[tuple, float]]:
    return STATE.calls(scope)


def series(name: str) -> List[Tuple[float, float, dict]]:
    return STATE.series(name)


def now_ms() -> float:
    """The current instant on the snapshot clock (ms since the state's
    start, the clock of ``snapshot``'s ``t_ms`` and series points): a
    caller windows the series to one run with it (the load driver's
    occupancy summary) without touching the rings."""
    return (time.perf_counter() - STATE.t0) * 1e3


def program_keys(scope: str) -> Dict[tuple, Tuple[int, float]]:
    return STATE.program_keys(scope)


def scope_seconds(scope: str) -> float:
    return STATE.scope_seconds(scope)


def series_totals() -> Dict[str, dict]:
    return STATE.series_totals()


def snapshot(n: int = 32) -> dict:
    return STATE.snapshot(n=n)


def dump_state() -> tuple:
    return STATE.dump_state()


def restore_state(state: tuple) -> None:
    STATE.restore_state(state)


def clear() -> None:
    STATE.clear()
