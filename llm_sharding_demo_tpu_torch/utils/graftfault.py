"""Seeded fault injection and the degraded-mode error types.

Trimmed counterpart of ``llm_sharding_demo_tpu/utils/graftfault.py``:

- ``inject(site, *kinds)``, the hook a fault boundary calls: ``None``
  unless a ``FaultPlan`` is installed (``install``, or ``use`` for a
  scope); with one, the k-th call at a site maps to an outcome by a hash
  of ``(seed, site, k)``, so a pinned seed replays the same per-site
  sequence;
- the typed faults (``TransientFault``, which the iteration batcher
  absorbs by parking and resuming rows; ``PermanentFault``,
  ``CircuitOpenError``, ``DeadlineExceeded``, ``FaultBudgetError``, each
  an ``Unavailable`` that serving answers with a 503);
- ``Deadline``, one monotonic per-request budget;
- ``HopPolicy``, the retry, backoff and per-shard circuit-breaker
  discipline of remote dispatch's shard hops.

The port's sites: ``iterbatch.decode_seg`` (``decode_transient``,
``decode_permanent``, ``decode_slow``) before each segment,
``pool_spike``, a pool that refuses as a full one would, at the paged
pool's grant (``kv_pool.admit_alloc``) and at the two 429 gates
(``iterbatch.admission_load``, ``serving.admission``), and
``serving.shard_hop`` (``reset``, ``timeout``, ``http_503``, ``slow``)
inside each hop attempt, before the wire call, and the fleet router's
``router.replica_hop`` (the same kinds) inside each replica hop attempt
(``serving/router.py``). Each fired fault is a
``fault_inject`` event on the timeline (utils.grafttime), each breaker
transition a ``breaker`` event beside its ``hop_breaker_open`` gauge.

The plan built from ``GRAFTFAULT*`` environment variables waits for
ROADMAP Queue 1 item 15c; plans are installed in process.
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


class CircuitOpenError(Unavailable):
    """The shard's breaker is open: the hop was not attempted."""

    code = "circuit_open"


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

    def timeout(self, cap: float) -> float:
        """A per-attempt timeout from the remaining budget: at most
        ``cap``, never below 1 ms (a zero timeout means "none" to
        socket calls)."""
        return max(min(float(cap), self.remaining()), 1e-3)

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
            if kind is None:
                return None
            self._log.append(Injection(site, kind, n))
        # on the timeline, correlated with the ambient request or rows
        from . import grafttime
        grafttime.emit("fault_inject", site=site, fault=kind, seq=n)
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


# -- the hop policy -----------------------------------------------------------


def _sample_breaker(target: str, value: float, registry=None) -> None:
    """One breaker's transition, labelled by its target (1.0 when it
    opens, 0.0 when a probe closes it): the ``hop_breaker_open`` gauge
    (of ``registry``, else the process's), its occupancy point and a
    ``breaker`` event."""
    from . import graftscope, grafttime
    from .metrics import REGISTRY
    (REGISTRY if registry is None else registry).gauge(
        "hop_breaker_open", value, target=target)
    graftscope.sample("hop_breaker_open", value, target=target)
    grafttime.emit("breaker", state="open" if value else "closed",
                   target=target)


@dataclasses.dataclass
class _Breaker:
    """One shard's breaker (every field under ``HopPolicy._lock``)."""

    streak: int = 0            # consecutive failures
    opened_at: Optional[float] = None
    probing: bool = False      # the half-open probe is in flight


class HopPolicy:
    """Retries, backoff and a per-shard circuit breaker for one class of
    cross-process hops (the coordinator's POSTs to its stage shards).

    ``call(fn, shard=..., deadline=...)`` runs ``fn(timeout_s)`` up to
    ``attempts`` times with capped exponential backoff and seeded jitter
    between tries; each attempt's timeout comes from the remaining
    deadline budget, capped at ``timeout_s``. Exceptions in ``fatal``
    propagate at once (a misroute does not heal by repetition).
    ``on_retry(shard, reason)`` fires before each re-attempt;
    ``registry`` takes the ``hop_breaker_open`` gauge (default: the
    process's; the fleet router sets its own on a policy without one).

    The breaker opens after ``breaker_threshold`` consecutive failures;
    calls then fail fast with ``CircuitOpenError`` (``retry_after`` the
    rest of the cooldown). After ``breaker_cooldown_s`` one probe goes
    through (half-open): success closes the breaker, failure reopens it.
    """

    def __init__(self, attempts: int = 3, timeout_s: float = 30.0,
                 base_backoff_s: float = 0.05, max_backoff_s: float = 1.0,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 5.0,
                 jitter_seed: int = 0, fatal: Tuple[type, ...] = (),
                 on_retry=None, sleep=time.sleep, registry=None):
        if attempts < 1:
            raise ValueError("attempts must be >= 1")
        self.attempts = attempts
        self.timeout_s = float(timeout_s)
        self.base_backoff_s = float(base_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.fatal = tuple(fatal)
        self.on_retry = on_retry
        self.registry = registry
        self._sleep = sleep
        self._lock = graftsched.lock("graftfault.HopPolicy._lock")
        self._rng = random.Random(jitter_seed)
        self._breakers: Dict[str, _Breaker] = {}

    def _gate(self, shard: str) -> None:
        """Admission through the breaker: raises ``CircuitOpenError``, or
        claims the half-open probe."""
        now = time.monotonic()
        with self._lock:
            b = self._breakers.setdefault(shard, _Breaker())
            if b.opened_at is None:
                return
            waited = now - b.opened_at
            if waited < self.breaker_cooldown_s:
                raise CircuitOpenError(
                    f"shard {shard!r} circuit open "
                    f"({b.streak} consecutive failures)",
                    retry_after=self.breaker_cooldown_s - waited)
            if b.probing:
                raise CircuitOpenError(
                    f"shard {shard!r} circuit half-open: a probe is "
                    "already in flight",
                    retry_after=self.breaker_cooldown_s)
            b.probing = True   # this call is the probe

    def _note_failure(self, shard: str) -> bool:
        """Count a failed attempt; True when the breaker is now open."""
        now = time.monotonic()
        with self._lock:
            b = self._breakers.setdefault(shard, _Breaker())
            b.streak += 1
            opened = b.probing or b.streak >= self.breaker_threshold
            if opened:
                b.opened_at = now
                b.probing = False
                _sample_breaker(shard, 1.0, self.registry)
        return opened

    def _note_success(self, shard: str) -> None:
        with self._lock:
            b = self._breakers.get(shard)
            was_open = b is not None and b.opened_at is not None
            self._breakers[shard] = _Breaker()
            if was_open:
                _sample_breaker(shard, 0.0, self.registry)

    def _probe_release(self, shard: str) -> None:
        """Drop a probe claim that ended without a verdict (a deadline
        spent before the attempt ran); a stuck claim would keep the
        breaker open for good."""
        with self._lock:
            b = self._breakers.get(shard)
            if b is not None:
                b.probing = False

    def breaker_state(self, shard: str) -> str:
        now = time.monotonic()
        with self._lock:
            b = self._breakers.get(shard)
            if b is None or b.opened_at is None:
                return "closed"
            if b.probing or now - b.opened_at >= self.breaker_cooldown_s:
                return "half-open"
            return "open"

    def _backoff(self, attempt: int) -> float:
        """Capped exponential, times a seeded jitter in [0.5, 1.5)."""
        base = min(self.base_backoff_s * (2 ** (attempt - 1)),
                   self.max_backoff_s)
        with self._lock:
            j = 0.5 + self._rng.random()
        return base * j

    def call(self, fn, *, shard: str,
             deadline: Optional[Deadline] = None):
        """Run ``fn(timeout_s)`` under the policy. Raises the last
        attempt's exception when the attempts are spent,
        ``CircuitOpenError`` when the breaker is or goes open,
        ``DeadlineExceeded`` when the budget ran out."""
        self._gate(shard)
        try:
            return self._call_gated(fn, shard=shard, deadline=deadline)
        except BaseException:
            self._probe_release(shard)
            raise

    def _call_gated(self, fn, *, shard: str,
                    deadline: Optional[Deadline] = None):
        last: Optional[BaseException] = None
        for attempt in range(self.attempts):
            if attempt:
                delay = self._backoff(attempt)
                if deadline is not None and deadline.remaining() <= delay:
                    break   # no budget left to wait out the backoff
                self._sleep(delay)
            if deadline is not None:
                deadline.raise_if_expired(f"hop to shard {shard!r}")
            t = (self.timeout_s if deadline is None
                 else deadline.timeout(self.timeout_s))
            try:
                out = fn(t)
            except self.fatal:
                # a misrouted or erroring shard is an unhealthy shard
                self._note_failure(shard)
                raise
            except Exception as e:  # noqa: BLE001 - retried per policy
                last = e
                if self._note_failure(shard):
                    raise CircuitOpenError(
                        f"shard {shard!r} circuit opened after repeated "
                        f"failures (last: {type(e).__name__}: {e})",
                        retry_after=self.breaker_cooldown_s) from e
                if (self.on_retry is not None
                        and attempt + 1 < self.attempts):
                    self.on_retry(shard, _failure_reason(e))
                continue
            self._note_success(shard)
            return out
        if deadline is not None and deadline.expired():
            raise DeadlineExceeded(
                f"hop to shard {shard!r}: deadline budget exhausted "
                f"after {self.attempts} attempt(s)") from last
        assert last is not None  # attempt 0 always runs
        raise last


def _failure_reason(e: BaseException) -> str:
    """A low-cardinality reason label for the retry counter."""
    name = type(e).__name__.lower()
    if "timeout" in name:
        return "timeout"
    if "connection" in name:
        return "connection"
    if "http" in name:
        return "http_error"
    return "error"
