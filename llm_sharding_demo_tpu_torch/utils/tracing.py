"""Request-scoped span trees, the flight recorder and profiler helpers.

Counterpart of ``llm_sharding_demo_tpu/utils/tracing.py``.

Profiler helpers: ``trace(log_dir)`` captures a ``torch.profiler`` trace
(CPU, and CUDA where there is a card) into ``log_dir`` for TensorBoard
or Perfetto; ``annotate(name)`` is a ``record_function`` range inside
one; ``timed(name)`` observes a host-clock window into a histogram.
PyTorch launches CUDA work asynchronously, so by default the window
closes when the work was enqueued; with ``sync=True`` it closes after
synchronizing the devices of the value handed to ``handle.sync(...)``.

Request traces: every ``/generate`` request carries a ``RequestTrace``,
a tree of timed spans (tokenize, queue wait, prefill, decode,
detokenize) with labels. The ambient trace rides a context variable
(``current_trace``, ``use_trace``); runtime modules record through
``span`` and ``record``, which do nothing without one. A batcher runs
many requests' phases on one worker thread: ``fanout`` commits one
measured span to every row's trace. The app derives its TTFT and TPOT
histograms from the tree and keeps the last N traces in the
``FlightRecorder`` that ``GET /debug/requests`` serves
(``debug_requests_payload``). Every span also lands on the timeline
(utils.grafttime: ``span_open`` at entry, ``span_close`` with its
window).

Span times are ``perf_counter`` values; a serialized tree is relative to
its request's start. A batcher's decode spans measure the host's
window: launches queue on the stream, so they include device time only
up to the last sync.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
import uuid
from collections import deque
from typing import Iterator, List, Optional

from . import graftsched, grafttime


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[object]:
    """Capture a ``torch.profiler`` trace (CPU, and CUDA when a card is
    there) into ``log_dir``; yields the profiler."""
    import torch
    from torch import profiler
    acts = [profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(profiler.ProfilerActivity.CUDA)
    with profiler.profile(
            activities=acts,
            on_trace_ready=profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


def annotate(name: str):
    """A named range in profiler traces (``record_function``)."""
    from torch import profiler
    return profiler.record_function(name)


def _sync_devices(value) -> None:
    """Wait for every CUDA device a tensor of ``value`` lies on."""
    import torch
    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)

    walk(value)
    for dev in devices:
        torch.cuda.synchronize(dev)


class _TimedHandle:
    """What ``timed`` yields: ``sync(value)`` opts the value into the
    window's close; ``seconds`` holds the window after the block."""

    __slots__ = ("seconds", "_sync_value", "_armed")

    def __init__(self, armed: bool):
        self._armed = armed
        self._sync_value = None
        self.seconds = 0.0

    def sync(self, value):
        self._sync_value = value
        return value


@contextlib.contextmanager
def timed(name: str, registry=None, sync: bool = False,
          **labels) -> Iterator[_TimedHandle]:
    """A host-clock window observed into the histogram ``name``. With
    ``sync=True`` the window closes after the devices of the value given
    to ``handle.sync`` finish their queued work (only after a body that
    did not raise)."""
    from .metrics import REGISTRY
    reg = registry if registry is not None else REGISTRY
    h = _TimedHandle(bool(sync))
    t0 = time.perf_counter()
    body_ok = False
    try:
        yield h
        body_ok = True
    finally:
        if body_ok and h._armed and h._sync_value is not None:
            _sync_devices(h._sync_value)
        h.seconds = time.perf_counter() - t0
        reg.observe(name, h.seconds, **labels)


# -- request-scoped span trees -----------------------------------------------


def new_request_id() -> str:
    return uuid.uuid4().hex[:12]


class Span:
    """One timed node: name, ``[t0, t1)`` on the ``perf_counter`` clock,
    labels, children."""

    __slots__ = ("name", "t0", "t1", "labels", "children")

    def __init__(self, name: str, t0: float, t1: Optional[float] = None,
                 labels: Optional[dict] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.labels = dict(labels) if labels else {}
        self.children: List["Span"] = []

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    def to_dict(self, origin: float) -> dict:
        d = {"name": self.name,
             "start_ms": round((self.t0 - origin) * 1e3, 3),
             "duration_ms": round(self.duration * 1e3, 3)}
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.children:
            d["spans"] = [c.to_dict(origin) for c in self.children]
        return d


class _TraceSink:
    """Span recording shared by ``RequestTrace`` and ``fanout``. Nesting
    is per thread: a span another thread adds lands at the root."""

    def __init__(self):
        self._lock = graftsched.lock("tracing._TraceSink._lock")
        self._tls = threading.local()
        self.spans: List[Span] = []

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _rid(self):
        """The timeline correlation: the request's id (a fanout gives
        all of its targets')."""
        return getattr(self, "request_id", None)

    def _commit(self, span: Span) -> None:
        stack = self._stack()
        if stack:
            stack[-1].children.append(span)
        else:
            with self._lock:
                self.spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str, **labels) -> Iterator[Span]:
        s = Span(name, time.perf_counter(), labels=labels)
        stack = self._stack()
        stack.append(s)
        grafttime.emit("span_open", name=name, rid=self._rid(), t=s.t0)
        try:
            yield s
        finally:
            s.t1 = time.perf_counter()
            stack.pop()
            self._commit(s)
            grafttime.emit("span_close", name=name, rid=self._rid(),
                           t=s.t1, dur_ms=round(s.duration * 1e3, 3))

    def add_span(self, name: str, t0: float, t1: float, **labels) -> Span:
        """Record an already-timed span (a scheduler times a phase once
        and attaches it to every request that rode it)."""
        s = Span(name, t0, t1, labels=labels)
        self._commit(s)
        grafttime.emit("span_close", name=name, rid=self._rid(), t=t1,
                       dur_ms=round(s.duration * 1e3, 3))
        return s


class RequestTrace(_TraceSink):
    """The span tree of one request, with its id and labels."""

    def __init__(self, request_id: Optional[str] = None, **labels):
        super().__init__()
        self.request_id = request_id or new_request_id()
        self.labels = dict(labels)
        self.t0 = time.perf_counter()
        self.started_unix = time.time()
        self.t1: Optional[float] = None

    def finish(self) -> "RequestTrace":
        if self.t1 is None:
            self.t1 = time.perf_counter()
            # the request's own window closes its timeline stream
            grafttime.emit("span_close", name="request",
                           rid=self.request_id, t=self.t1,
                           dur_ms=round(self.duration * 1e3, 3))
        return self

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None
                else time.perf_counter()) - self.t0

    def find_all(self, name: str) -> List[Span]:
        """Every span named ``name``, depth first."""
        out: List[Span] = []

        def walk(spans):
            for s in spans:
                if s.name == name:
                    out.append(s)
                walk(s.children)
        with self._lock:
            walk(self.spans)
        return out

    def find(self, name: str) -> Optional[Span]:
        found = self.find_all(name)
        return found[0] if found else None

    def graft(self, name: str, payload: Optional[dict], t0: float,
              t1: float, **labels) -> Span:
        """Join another process's serialized trace (its ``to_dict``) as
        a span over ``[t0, t1)`` whose children are its spans, rebased
        onto ``t0``; without a payload, a bare span."""
        hop = Span(name, t0, t1, labels=labels)
        if payload is not None:
            hop.labels.setdefault("replica_request_id",
                                  payload.get("request_id"))
            hop.children = [span_from_dict(c, t0)
                            for c in payload.get("spans", ())]
        self._commit(hop)
        return hop

    def to_dict(self) -> dict:
        with self._lock:
            spans = [s.to_dict(self.t0) for s in self.spans]
        d = {"request_id": self.request_id,
             "started_unix": round(self.started_unix, 3),
             "duration_ms": round(self.duration * 1e3, 3),
             "spans": spans}
        if self.labels:
            d["labels"] = dict(self.labels)
        return d


def span_from_dict(d: dict, base: float) -> Span:
    """A serialized span (``Span.to_dict``) rebuilt on this clock, its
    relative times rebased onto ``base``."""
    t0 = base + d.get("start_ms", 0.0) / 1e3
    s = Span(d.get("name", "?"), t0, t0 + d.get("duration_ms", 0.0) / 1e3,
             labels=d.get("labels"))
    s.children = [span_from_dict(c, base) for c in d.get("spans", ())]
    return s


class _FanoutTrace(_TraceSink):
    """Commits each finished root span to every target trace: how a
    batch scheduler attributes one shared phase to all its rows."""

    def __init__(self, traces: List[RequestTrace]):
        super().__init__()
        self._targets = [t for t in traces if t is not None]

    def _rid(self):
        return tuple(t.request_id for t in self._targets)

    def _commit(self, span: Span) -> None:
        stack = self._stack()
        if stack:
            stack[-1].children.append(span)
            return
        for t in self._targets:
            with t._lock:
                t.spans.append(span)


def fanout(traces: List[Optional[RequestTrace]]) -> _FanoutTrace:
    return _FanoutTrace(traces)


_current: "contextvars.ContextVar[Optional[_TraceSink]]" = \
    contextvars.ContextVar("request_trace", default=None)


def current_trace() -> Optional[_TraceSink]:
    return _current.get()


@contextlib.contextmanager
def use_trace(trace_obj: Optional[_TraceSink]) -> Iterator[None]:
    token = _current.set(trace_obj)
    try:
        yield
    finally:
        _current.reset(token)


@contextlib.contextmanager
def span(name: str, **labels) -> Iterator[Optional[Span]]:
    """A span on the ambient trace; yields None without one."""
    tr = _current.get()
    if tr is None:
        yield None
        return
    with tr.span(name, **labels) as s:
        yield s


def record(name: str, t0: float, t1: float, **labels) -> None:
    """Attach an already-timed span to the ambient trace (a no-op
    without one)."""
    tr = _current.get()
    if tr is not None:
        tr.add_span(name, t0, t1, **labels)


def annotate_span(**labels) -> None:
    """Merge labels into the innermost open span of the ambient trace."""
    tr = _current.get()
    if tr is None:
        return
    stack = tr._stack()
    if stack:
        stack[-1].labels.update(labels)


class FlightRecorder:
    """A bounded ring of the last N finished request traces, served at
    ``GET /debug/requests``."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._lock = graftsched.lock("tracing.FlightRecorder._lock")
        self._traces: "deque[RequestTrace]" = deque(maxlen=capacity)

    def record(self, trace_obj: RequestTrace) -> None:
        trace_obj.finish()
        with self._lock:
            self._traces.append(trace_obj)

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def find(self, request_id: str) -> Optional[dict]:
        """The newest trace of this X-Request-ID as JSON, or None."""
        with self._lock:
            traces = list(self._traces)
        for t in reversed(traces):
            if t.request_id == request_id:
                return t.to_dict()
        return None

    def snapshot(self, n: Optional[int] = None, slowest: bool = False,
                 errors_only: bool = False,
                 profile: Optional[str] = None) -> List[dict]:
        """The newest (or slowest) ``n`` traces as JSON; ``errors_only``
        keeps the error-labelled ones (failed, shed), ``profile`` those
        of one X-Workload-Profile."""
        with self._lock:
            traces = list(self._traces)
        traces.reverse()
        if errors_only:
            traces = [t for t in traces if "error" in t.labels]
        if profile is not None:
            traces = [t for t in traces if t.labels.get("profile") == profile]
        if slowest:
            traces.sort(key=lambda t: t.duration, reverse=True)
        if n is not None:
            traces = traces[:max(n, 0)]
        return [t.to_dict() for t in traces]


def debug_requests_payload(recorder: FlightRecorder, query: dict,
                           serving: dict):
    """The ``GET /debug/requests`` body (``?n``, ``?slowest``,
    ``?errors``, ``?profile``) under the ``serving`` header, or ``(422,
    detail)`` for an ``n`` that does not parse."""
    try:
        n = int(query.get("n", "32"))
    except ValueError:
        return 422, {"detail": "n must be an integer"}
    slowest = query.get("slowest", "").lower() in ("1", "true", "yes")
    errs = query.get("errors", "").lower() in ("1", "true", "yes")
    prof = query.get("profile") or None
    return {
        "serving": serving,
        "capacity": recorder.capacity,
        "recorded": len(recorder),
        "order": "slowest" if slowest else "newest",
        **({"profile": prof} if prof else {}),
        "requests": recorder.snapshot(n=n, slowest=slowest,
                                      errors_only=errs, profile=prof),
    }


RECORDER = FlightRecorder()
