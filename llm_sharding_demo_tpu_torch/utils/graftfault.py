"""Seeded fault injection and the degraded-mode error types.

Trimmed counterpart of ``llm_sharding_demo_tpu/utils/graftfault.py``:

- ``inject(site, *kinds)``, the hook a fault boundary calls: ``None``
  unless a ``FaultPlan`` is installed (``install``, or ``use`` for a
  scope); with one, the k-th call at a site maps to an outcome by a hash
  of ``(seed, site, k)``, so a pinned seed replays the same per-site
  sequence;
- the typed faults (``TransientFault``, which the iteration batcher
  absorbs by parking and resuming rows; ``PermanentFault``,
  ``DeadlineExceeded``, ``FaultBudgetError``, each an ``Unavailable``
  that serving answers with a 503);
- ``Deadline``, one monotonic per-request budget.

The port's sites: ``iterbatch.decode_seg`` (``decode_transient``,
``decode_permanent``, ``decode_slow``) before each segment, and
``pool_spike``, a pool that refuses as a full one would, at the paged
pool's grant (``kv_pool.admit_alloc``) and at the two 429 gates
(``iterbatch.admission_load``, ``serving.admission``).

The plan built from ``GRAFTFAULT*`` environment variables and the hop
policy of remote dispatch wait for ROADMAP Queue 1 items 15 and 16.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from . import graftsched


class InjectedFault(RuntimeError):
    """Base of every injected failure."""

    def __init__(self, site: str, kind: str, message: str):
        super().__init__(message)
        self.site = site
        self.kind = kind


class TransientFault(InjectedFault):
    """A failure the degraded path absorbs: the iteration batcher parks
    the live rows and resumes them by recompute."""


class Unavailable(RuntimeError):
    """Typed unavailability: serving answers 503 with ``Retry-After``."""

    code = "unavailable"

    def __init__(self, message: str, retry_after: float = 1.0):
        super().__init__(message)
        self.retry_after = max(float(retry_after), 0.0)


class PermanentFault(InjectedFault, Unavailable):
    """An engine failure the degraded path does not retry."""

    code = "engine_fault"

    def __init__(self, site: str, kind: str, message: str,
                 retry_after: float = 1.0):
        InjectedFault.__init__(self, site, kind, message)
        self.retry_after = max(float(retry_after), 0.0)


class DeadlineExceeded(Unavailable):
    """The request's deadline budget ran out; a live row is cancelled at
    the next segment boundary."""

    code = "deadline_exceeded"


class FaultBudgetError(Unavailable):
    """A row exhausted its transient-fault park budget."""

    code = "fault_budget_exhausted"


class Deadline:
    """One monotonic per-request deadline."""

    __slots__ = ("at",)

    def __init__(self, at: float):
        self.at = float(at)

    @classmethod
    def from_ms(cls, ms: float) -> "Deadline":
        return cls(time.monotonic() + float(ms) / 1e3)

    def remaining(self) -> float:
        return self.at - time.monotonic()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def raise_if_expired(self, what: str = "request") -> None:
        if self.expired():
            raise DeadlineExceeded(
                f"{what}: deadline budget exhausted "
                f"({-self.remaining() * 1e3:.0f}ms past)")


@dataclasses.dataclass(frozen=True)
class Injection:
    """One fired fault: site, kind and the site's call number."""

    site: str
    kind: str
    seq: int


class FaultPlan:
    """Deterministic fault schedule. Whether the n-th call at a site
    fires, and which kind it picks, is a pure function of ``(seed, site,
    n)``. ``sites``/``kinds`` filter where faults may land (None: all);
    ``max_injections`` bounds the total fired."""

    def __init__(self, seed: int = 0, rate: float = 0.1,
                 sites: Optional[Sequence[str]] = None,
                 kinds: Optional[Sequence[str]] = None,
                 max_injections: Optional[int] = None):
        self.seed = int(seed)
        self.rate = float(rate)
        self.sites = None if sites is None else frozenset(sites)
        self.kinds = None if kinds is None else frozenset(kinds)
        self.max_injections = max_injections
        self._lock = graftsched.lock("graftfault.FaultPlan._lock")
        self._counts: Dict[str, int] = {}
        self._log: List[Injection] = []

    def _decide(self, site: str, n: int,
                kinds: Tuple[str, ...]) -> Optional[str]:
        if self.sites is not None and site not in self.sites:
            return None
        allowed = [k for k in kinds if self.kinds is None or k in self.kinds]
        if not allowed:
            return None
        rng = random.Random(f"{self.seed}/{site}/{n}")
        if rng.random() >= self.rate:
            return None
        return allowed[rng.randrange(len(allowed))]

    def fire(self, site: str, kinds: Sequence[str]) -> Optional[str]:
        with self._lock:
            n = self._counts.get(site, 0)
            self._counts[site] = n + 1
            if (self.max_injections is not None
                    and len(self._log) >= self.max_injections):
                return None
            kind = self._decide(site, n, tuple(kinds))
            if kind is not None:
                self._log.append(Injection(site, kind, n))
            return kind

    @property
    def injections(self) -> List[Injection]:
        with self._lock:
            return list(self._log)


_PLAN_LOCK = threading.Lock()
_PLAN: Optional[FaultPlan] = None


def install(p: Optional[FaultPlan]) -> None:
    """Arm (or, with None, disarm) a plan for the whole process."""
    global _PLAN
    with _PLAN_LOCK:
        _PLAN = p


@contextlib.contextmanager
def use(p: FaultPlan):
    """``install`` for the duration of a ``with`` block."""
    install(p)
    try:
        yield p
    finally:
        install(None)


def inject(site: str, *kinds: str) -> Optional[str]:
    """The hook: the injected kind, or None (always None with no plan
    armed)."""
    p = _PLAN
    return None if p is None else p.fire(site, kinds)
