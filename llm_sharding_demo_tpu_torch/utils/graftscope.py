"""Host-clock scopes and occupancy series.

Trimmed counterpart of ``llm_sharding_demo_tpu/utils/graftscope.py``:
``instrument`` wraps a callable so that each call's host-clock seconds
land in a bounded ring keyed by scope and program key, and ``sample``
appends an occupancy point (batch occupancy, queue depth) to a bounded
series. The JAX package wraps ``jax.jit`` entry points; here the callable
is a plain function. CUDA-event timing and the ``/debug/profile`` view
wait for ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from . import graftsched

RING_CAPACITY = 256
SERIES_CAPACITY = 512


class ScopeState:
    """Per-scope rings of ``(key, seconds)`` and per-name series of
    ``(t, value, labels)``, both bounded."""

    def __init__(self):
        self._lock = graftsched.lock("graftscope.ScopeState._lock")
        self._rings: Dict[str, Deque[Tuple[tuple, float]]] = {}
        self._points: Dict[str, Deque[Tuple[float, float, dict]]] = {}

    def record(self, scope: str, key: tuple, seconds: float) -> None:
        with self._lock:
            self._rings.setdefault(
                scope, collections.deque(maxlen=RING_CAPACITY)).append(
                    (key, float(seconds)))

    def sample(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._points.setdefault(
                name, collections.deque(maxlen=SERIES_CAPACITY)).append(
                    (time.perf_counter(), float(value), labels))

    def calls(self, scope: str) -> List[Tuple[tuple, float]]:
        with self._lock:
            return list(self._rings.get(scope, ()))

    def series(self, name: str) -> List[Tuple[float, float, dict]]:
        with self._lock:
            return list(self._points.get(name, ()))


STATE = ScopeState()


class ProfiledFn:
    """A callable whose every call is timed on the host clock into the
    scope ring under ``key_fn(*args)``."""

    __slots__ = ("_fn", "_scope", "_key_fn")

    def __init__(self, fn: Callable, scope: str,
                 key_fn: Optional[Callable] = None):
        self._fn = fn
        self._scope = scope
        self._key_fn = key_fn

    def __call__(self, *args, **kwargs):
        key = self._key_fn(*args, **kwargs) if self._key_fn else ()
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        STATE.record(self._scope, key, time.perf_counter() - t0)
        return out


def instrument(fn: Callable, scope: str,
               key_fn: Optional[Callable] = None) -> ProfiledFn:
    return ProfiledFn(fn, scope, key_fn)


def sample(name: str, value: float, **labels) -> None:
    STATE.sample(name, value, **labels)


def calls(scope: str) -> List[Tuple[tuple, float]]:
    """The scope's recorded ``(key, seconds)`` calls, oldest first."""
    return STATE.calls(scope)


def series(name: str) -> List[Tuple[float, float, dict]]:
    """The named series' ``(t, value, labels)`` points, oldest first."""
    return STATE.series(name)
