"""Request-scoped span trees.

Trimmed counterpart of ``llm_sharding_demo_tpu/utils/tracing.py``: a
``RequestTrace`` records timed spans; the ambient trace rides a context
variable (``current_trace``, ``use_trace``), so a batcher can carry the
caller's trace across its queue and attribute the phases it runs;
``fanout`` commits one shared phase (a batched prefill or decode) to
every row's trace; ``record`` attaches an already-timed span to the
ambient trace. The flight recorder and ``/debug/requests`` wait for
ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
import uuid
from typing import Iterator, List, Optional

from . import graftsched


def new_request_id() -> str:
    return uuid.uuid4().hex[:12]


class Span:
    """One timed node: name, ``[t0, t1)`` on the ``perf_counter`` clock,
    labels."""

    __slots__ = ("name", "t0", "t1", "labels")

    def __init__(self, name: str, t0: float, t1: float,
                 labels: Optional[dict] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.labels = dict(labels) if labels else {}

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class _TraceSink:
    def __init__(self):
        self._lock = graftsched.lock("tracing._TraceSink._lock")
        self.spans: List[Span] = []

    def _commit(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def add_span(self, name: str, t0: float, t1: float, **labels) -> Span:
        """Record an already-timed span (a scheduler times a phase once
        and attaches it to every request that rode it)."""
        s = Span(name, t0, t1, labels)
        self._commit(s)
        return s


class RequestTrace(_TraceSink):
    """The spans of one request, with its id and labels."""

    def __init__(self, request_id: Optional[str] = None, **labels):
        super().__init__()
        self.request_id = request_id or new_request_id()
        self.labels = dict(labels)
        self.t0 = time.perf_counter()

    def find_all(self, name: str) -> List[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def find(self, name: str) -> Optional[Span]:
        found = self.find_all(name)
        return found[0] if found else None


class _FanoutTrace(_TraceSink):
    """Commits each span to every target trace: how a batch scheduler
    attributes one shared device phase to all the rows riding it."""

    def __init__(self, traces: List[RequestTrace]):
        super().__init__()
        self._targets = [t for t in traces if t is not None]

    def _commit(self, span: Span) -> None:
        for t in self._targets:
            t._commit(span)


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


def record(name: str, t0: float, t1: float, **labels) -> None:
    """Attach an already-timed span to the ambient trace (a no-op
    without one)."""
    tr = _current.get()
    if tr is not None:
        tr.add_span(name, t0, t1, **labels)

