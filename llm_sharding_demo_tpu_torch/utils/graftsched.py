"""Declared locks and the lock tracer (``GRAFTSCHED``).

Counterpart of ``llm_sharding_demo_tpu/utils/graftsched.py``. The
serving stack is concurrent (HTTP handler threads feed the batchers'
worker threads over shared allocator, prefix-store, metrics and tracing
state), and every declared lock of those modules is built here, by
``lock(name)`` or ``rlock(name)``, under the JAX package's declaration
key (``module.Class.attr``). With ``GRAFTSCHED`` unset that is a plain
``threading.Lock``/``RLock``; armed, every declared lock is a
``TracedLock``, which

- records runtime lock-order pairs (B taken while A is held) and
  reports an inversion once the opposite order is seen, with both call
  sites;
- detects a deadlock by acquisition timeout and reports the wait-for
  chain through the held and waiting maps;
- accounts contention per lock name (``contention()``: wait seconds,
  acquisitions, acquisitions that waited more than 1 ms), and publishes
  each acquisition (``lock_acquire``) and each wait past 1 ms
  (``lock_contend``) on the timeline (``utils.grafttime``);
- yields at acquire and release: seeded jitter (``GRAFTSCHED=1`` with
  ``GRAFTSCHED_SEED``), or a step-mode ``Harness`` that runs one
  registered thread at a time and picks the next with a seeded RNG, so
  a seed replays one interleaving.

The race traps each give one finding with ``file:line`` and the seed:
``Cell`` (a read-modify-write slot whose write traps a lost update),
``trace_admission`` (wraps a ``BlockAllocator``: a grant justified by an
earlier ``can_admit`` that leaves live blocks past the watermark is an
overshoot; the atomic ``admit_alloc`` path is wrapped too and must
never fire) and ``TracedLock``'s timeout (a lock-order deadlock).

The tracer's own state sits under the private ``_STATE`` lock, which is
never traced. ``GRAFTSCHED``: "" or ``0`` off, ``1`` seeded jitter,
``trace`` accounting only (no yields); ``GRAFTSCHED_SEED``: int,
default 0. ``held_locks()`` names the traced locks some thread still
holds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import sys
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Cell", "DeadlockError", "Harness", "SchedFinding", "TracedLock",
    "clear", "contention", "enabled", "findings", "held_locks", "lock",
    "mode", "rlock", "seed", "trace_admission",
]

def mode() -> str:
    """"" (off) | "sched" (seeded jitter yields) | "trace" (accounting
    only). Read at every ``lock()`` construction, so a test can arm the
    harness with ``monkeypatch.setenv`` before building the stack."""
    v = os.environ.get("GRAFTSCHED", "")
    if v in ("", "0"):
        return ""
    return "trace" if v == "trace" else "sched"


def enabled() -> bool:
    return mode() != ""


def seed() -> int:
    try:
        return int(os.environ.get("GRAFTSCHED_SEED", "0"))
    except ValueError:
        return 0


@dataclasses.dataclass(frozen=True)
class SchedFinding:
    """One finding: the rule, the site (file, line, function), the
    message and the schedule seed that reproduces it."""

    rule: str
    path: str
    line: int
    scope: str
    message: str
    seed: Optional[int] = None

    def format(self) -> str:
        tail = f" (seed={self.seed})" if self.seed is not None else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tail}"


class DeadlockError(RuntimeError):
    """An instrumented lock acquisition timed out (lock-order inversion
    deadlock detection). The finding carries the wait-for details."""


# internal bookkeeping lock — plain and NEVER traced (the apparatus must
# not schedule itself)
_STATE = threading.Lock()
_FINDINGS: List[SchedFinding] = []
_PAIRS: Dict[Tuple[str, str], str] = {}      # (outer, inner) -> site
_REPORTED: set = set()
_WAIT: Dict[str, List[float]] = {}           # name -> [wait_s, acqs, contended]
_WAITING: Dict[int, "TracedLock"] = {}       # tid -> lock being acquired
_LOCKS: "weakref.WeakSet[TracedLock]" = weakref.WeakSet()
_TLS = threading.local()
_ACTIVE: Optional["Harness"] = None          # ambient step/jitter harness
_RNG = random.Random(seed())                 # env-mode jitter RNG


def _call_site(skip_file: str = __file__) -> str:
    """``file.py:line (func)`` of the nearest frame outside this module
    — the provenance unit every finding carries (same helper shape as
    the graftsan sanitizer's)."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == skip_file:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return (f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
            f"({f.f_code.co_name})")


def _site_parts(skip_file: str = __file__) -> Tuple[str, int, str]:
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == skip_file:
        f = f.f_back
    if f is None:
        return "<unknown>", 0, "<unknown>"
    return (os.path.basename(f.f_code.co_filename), f.f_lineno,
            f.f_code.co_name)


def _emit(rule: str, message: str, *, seed_val: Optional[int] = None,
          site: Optional[Tuple[str, int, str]] = None) -> SchedFinding:
    path, line, scope = site if site is not None else _site_parts()
    f = SchedFinding(rule, path, line, scope, message, seed_val)
    h = _ACTIVE
    if h is not None:
        h.findings.append(f)
    else:
        with _STATE:
            _FINDINGS.append(f)
    return f


def findings() -> List[SchedFinding]:
    """Global (env-armed) findings; a step-mode Harness collects its own
    on ``harness.findings`` instead."""
    with _STATE:
        return list(_FINDINGS)


def clear() -> None:
    """Reset global findings + order pairs + contention accounting, and
    re-seed the env-mode jitter RNG from the current GRAFTSCHED_SEED
    (so an armed run that clears at its start replays its schedule)."""
    global _RNG
    with _STATE:
        _FINDINGS.clear()
        _PAIRS.clear()
        _REPORTED.clear()
        _WAIT.clear()
        _RNG = random.Random(seed())


def contention() -> Dict[str, dict]:
    """Per-lock-name contention totals from every traced acquisition:
    ``{name: {wait_seconds, acquisitions, contended}}``."""
    with _STATE:
        return {name: {"wait_seconds": round(w[0], 6),
                       "acquisitions": int(w[1]),
                       "contended": int(w[2])}
                for name, w in sorted(_WAIT.items())}


def held_locks() -> List[str]:
    """Names of instrumented locks some thread still holds (a held
    lock after a run means a code path unwound without releasing)."""
    out = []
    for lk in list(_LOCKS):
        with _STATE:
            holders = sum(lk._owners.values())
        if holders:
            out.append(f"{lk.name} (held {holders}x)")
    return sorted(out)


def _held_stack() -> List["TracedLock"]:
    st = getattr(_TLS, "held", None)
    if st is None:
        st = _TLS.held = []
    return st


def _yield_point(tag: str) -> None:
    h = _ACTIVE
    if h is not None:
        h.point(tag)
        return
    if mode() == "sched":
        with _STATE:
            r = _RNG.random()
            d = _RNG.random()
        if r < 0.1:
            time.sleep(d * 5e-4)


class TracedLock:
    """Drop-in ``threading.Lock``/``RLock`` that records order pairs,
    detects deadlock by timeout, accounts contention, and yields to the
    ambient schedule at acquire/release."""

    def __init__(self, name: str, reentrant: bool = False,
                 timeout: float = 15.0,
                 seed_val: Optional[int] = None):
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self.name = name
        self.reentrant = reentrant
        self._timeout = timeout
        self._seed = seed() if seed_val is None else seed_val
        self._owners: Dict[int, int] = {}    # tid -> recursion depth
        _LOCKS.add(self)

    # -- order pairs ---------------------------------------------------------

    def _note_pair(self, outer: "TracedLock", site: str) -> None:
        if outer.name == self.name and outer is not self:
            return  # same-name different-instance nesting: not an order
        pair = (outer.name, self.name)
        rev = (self.name, outer.name)
        with _STATE:
            if pair not in _PAIRS:
                _PAIRS[pair] = site
            rev_site = _PAIRS.get(rev)
            key = frozenset(pair)
            if (rev_site is not None and pair != rev
                    and key not in _REPORTED):
                _REPORTED.add(key)
                report = True
            else:
                report = False
        if report:
            _emit("lock-order",
                  f"runtime lock-order inversion: {self.name!r} acquired "
                  f"while holding {outer.name!r} at {site}, but the "
                  f"opposite order was taken at {rev_site}",
                  seed_val=self._seed)

    # -- acquire/release -----------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        tid = threading.get_ident()
        held = _held_stack()
        reenter = self.reentrant and self._owners.get(tid, 0) > 0
        site = _call_site()
        if not reenter:
            _yield_point(f"acquire:{self.name}")
            for h in held:
                if h is not self:
                    self._note_pair(h, site)
        budget = timeout if timeout != -1 else self._timeout
        t0 = time.perf_counter()
        if not blocking:
            ok = self._inner.acquire(False)
        else:
            ok = self._inner.acquire(True, 0.002)
            if not ok:
                # contended: free the step-mode token while we block so
                # the holder can be scheduled to release
                harness = _ACTIVE
                if harness is not None:
                    harness._block_begin()
                with _STATE:
                    _WAITING[tid] = self
                try:
                    ok = self._inner.acquire(True, budget)
                finally:
                    with _STATE:
                        _WAITING.pop(tid, None)
                    if harness is not None:
                        harness._block_end()
        wait = time.perf_counter() - t0
        with _STATE:
            w = _WAIT.setdefault(self.name, [0.0, 0, 0])
            w[0] += wait
            w[1] += 1
            if wait > 1e-3:
                w[2] += 1
        if ok:
            # lazy import: the bus must stay constructible before this
            # module finishes bootstrapping (and never instruments it).
            # Both kinds observe the schedule, so grafttime's replay_view
            # leaves them out; the bus's own lock is a plain one, so this
            # emission cannot recurse
            from . import grafttime
            wait_ms = round(wait * 1e3, 3)
            grafttime.emit("lock_acquire", name=self.name,
                           wait_ms=wait_ms)
            if wait > 1e-3:
                grafttime.emit("lock_contend", name=self.name,
                               wait_ms=wait_ms)
        if not ok and blocking:
            self._report_deadlock(budget, site)
            raise DeadlockError(
                f"acquisition of {self.name!r} timed out after "
                f"{budget:.2f}s (see the lock-order finding)")
        if ok:
            with _STATE:
                self._owners[tid] = self._owners.get(tid, 0) + 1
            held.append(self)
        return ok

    def _report_deadlock(self, budget: float, site: str) -> None:
        with _STATE:
            holders = {t: d for t, d in self._owners.items() if d}
            # wait-for walk: who holds me -> what are THEY waiting on
            cycle = [self.name]
            cur = self
            for _ in range(8):
                owner = next((t for t, d in cur._owners.items() if d),
                             None)
                if owner is None:
                    break
                nxt = _WAITING.get(owner)
                if nxt is None:
                    break
                cycle.append(nxt.name)
                if nxt is self:
                    break
                cur = nxt
            key = ("deadlock", frozenset(cycle))
            if key in _REPORTED:
                return
            _REPORTED.add(key)
        held_names = [h.name for h in _held_stack()]
        _emit("lock-order",
              f"deadlock (acquisition timeout {budget:.2f}s): waiting "
              f"for {self.name!r} while holding {held_names}; wait-for "
              f"chain {' -> '.join(cycle)}; holders: "
              f"{len(holders)} thread(s)",
              seed_val=self._seed)

    def release(self) -> None:
        tid = threading.get_ident()
        with _STATE:
            d = self._owners.get(tid, 0)
            if d <= 1:
                self._owners.pop(tid, None)
            else:
                self._owners[tid] = d - 1
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._inner.release()
        _yield_point(f"release:{self.name}")

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def lock(name: str, timeout: float = 15.0):
    """A declared lock: plain ``threading.Lock`` when GRAFTSCHED is off
    (zero overhead on the production path), a :class:`TracedLock`
    otherwise. ``name`` is the reporting/contention key — use the
    ``module.Class.attr`` form the declarations reference."""
    if not enabled():
        return threading.Lock()
    return TracedLock(name, reentrant=False, timeout=timeout)


def rlock(name: str, timeout: float = 15.0):
    """Reentrant form of :func:`lock`."""
    if not enabled():
        return threading.RLock()
    return TracedLock(name, reentrant=True, timeout=timeout)


# -- step-mode harness --------------------------------------------------------


class Harness:
    """Seeded cooperative scheduler for 2-4 real threads.

    ``step=True`` serializes registered threads: exactly one runs at a
    time, and at every yield point the next runnable thread is picked
    with the seeded RNG — the same seed replays the same interleaving
    (threads are identified by registration order, never by OS ids).
    ``step=False`` is the jitter mode the integration tests use: seeded
    sleeps at yield points perturb the schedule replayably.

    Findings raised by traps while the harness is ambient land on
    ``self.findings`` (not the process-global list), so fixture runs
    cannot pollute the suite-level accounting.
    """

    def __init__(self, seed: int = 0, step: bool = True,
                 jitter: float = 0.1, lock_timeout: float = 2.0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.step = step
        self.jitter = jitter
        self.lock_timeout = lock_timeout
        self.findings: List[SchedFinding] = []
        self._cv = threading.Condition()
        self._state: Dict[int, str] = {}     # tid -> state
        self._index: Dict[int, int] = {}     # tid -> registration order
        self._current: Optional[int] = None
        self._abort = False
        self._errors: List[BaseException] = []

    def lock(self, name: str, reentrant: bool = False) -> TracedLock:
        return TracedLock(name, reentrant=reentrant,
                          timeout=self.lock_timeout, seed_val=self.seed)

    @contextlib.contextmanager
    def use(self):
        global _ACTIVE
        prev = _ACTIVE
        _ACTIVE = self
        try:
            yield self
        finally:
            _ACTIVE = prev

    # -- yield points --------------------------------------------------------

    def point(self, tag: str = "") -> None:
        tid = threading.get_ident()
        if not self.step:
            with self._cv:
                r = self.rng.random()
                d = self.rng.random()
            if r < self.jitter:
                time.sleep(d * 5e-4)
            return
        if tid not in self._state:
            return  # unregistered thread (e.g. the driving test)
        with self._cv:
            self._state[tid] = "parked"
            if self._current == tid:
                self._current = None
            self._cv.notify_all()
            while self._current != tid:
                if self._abort:
                    raise RuntimeError("graftsched harness aborted")
                self._cv.wait(0.02)
            self._state[tid] = "running"

    def _block_begin(self) -> None:
        tid = threading.get_ident()
        if not self.step or tid not in self._state:
            return
        with self._cv:
            self._state[tid] = "blocked"
            if self._current == tid:
                self._current = None
            self._cv.notify_all()

    def _block_end(self) -> None:
        tid = threading.get_ident()
        if not self.step or tid not in self._state:
            return
        self.point("unblocked")

    # -- driving -------------------------------------------------------------

    def _entry(self, i: int, fn: Callable[[], None]) -> None:
        # SELF-registration, before any user code: registering from
        # run() after start() would let a fast thread sail past its
        # first yield point unscheduled (the whole fixture would run
        # serially and the race never manifests)
        tid = threading.get_ident()
        with self._cv:
            self._state[tid] = "new"
            self._index[tid] = i
            self._cv.notify_all()
        try:
            self.point("start")
            fn()
        except DeadlockError:
            pass  # the finding IS the signal; the thread unwinds
        except BaseException as e:  # noqa: BLE001 — surfaced by run()
            with self._cv:
                self._errors.append(e)
        finally:
            with self._cv:
                self._state[tid] = "done"
                if self._current == tid:
                    self._current = None
                self._cv.notify_all()

    def run(self, fns: Sequence[Callable[[], None]],
            timeout: float = 30.0) -> None:
        """Drive ``fns`` (one thread each) to completion under the
        seeded schedule. Raises the first non-deadlock thread error;
        deadlocks surface as findings, not exceptions."""
        threads = []
        for i, fn in enumerate(fns):
            t = threading.Thread(target=self._entry, args=(i, fn),
                                 daemon=True,
                                 name=f"graftsched-{self.seed}-{i}")
            threads.append(t)
        for t in threads:
            t.start()
        deadline = time.monotonic() + timeout
        with self._cv:
            while len(self._state) < len(fns):
                self._cv.wait(0.02)
                if time.monotonic() > deadline:
                    raise TimeoutError("harness threads never registered")
            while any(s != "done" for s in self._state.values()):
                if time.monotonic() > deadline:
                    self._abort = True
                    self._cv.notify_all()
                    raise TimeoutError(
                        f"harness run exceeded {timeout}s: states "
                        f"{dict(self._state)}")
                if self.step and self._current is None:
                    runnable = sorted(
                        (tid for tid, s in self._state.items()
                         if s in ("parked", "new")),
                        key=lambda tid: self._index[tid])
                    if runnable:
                        self._current = self.rng.choice(runnable)
                        self._cv.notify_all()
                self._cv.wait(0.02)
        for t in threads:
            t.join(timeout=5.0)
        if self._errors:
            raise self._errors[0]


# -- race traps ---------------------------------------------------------------


class Cell:
    """Instrumented guarded-state stand-in: a read-modify-write slot
    whose ``set`` traps LOST UPDATES (the value being written was
    computed from a read another thread's write has since invalidated
    — the unguarded-gauge bug shape). Reads and writes are yield
    points, so the harness can interleave two incrementers exactly at
    the hazard."""

    def __init__(self, value=0, name: str = "cell"):
        self.name = name
        self._value = value
        self._version = 0
        self._tls = threading.local()

    def get(self):
        with _STATE:
            v, ver = self._value, self._version
        self._tls.read_version = ver
        _yield_point(f"{self.name}:read")
        return v

    def set(self, value) -> None:
        _yield_point(f"{self.name}:write")
        site = _site_parts()
        h = _ACTIVE
        with _STATE:
            read_ver = getattr(self._tls, "read_version", None)
            lost = read_ver is not None and read_ver != self._version
            self._version += 1
            self._value = value
        self._tls.read_version = None
        if lost:
            _emit("lost-update",
                  f"lost update on {self.name!r}: this write was "
                  "computed from a read another thread's write "
                  "invalidated — the intervening update is silently "
                  "overwritten (guard the read-modify-write with one "
                  "lock hold)",
                  seed_val=h.seed if h is not None else seed(),
                  site=site)

    @property
    def value(self):
        with _STATE:
            return self._value


def trace_admission(alloc) -> None:
    """Arm the check-then-act admission trap on a real
    ``BlockAllocator`` instance: a grant whose justification was an
    earlier ``can_admit`` — with live blocks past the watermark by the
    time the grant lands — is an ATOMIC-CHECK-ACT overshoot finding
    (the 429 admission shape ``admit_alloc`` exists to close). The
    atomic ``admit_alloc`` path is wrapped too and must never fire."""
    orig_can = alloc.can_admit
    orig_alloc = alloc.alloc
    orig_admit = alloc.admit_alloc
    checked = threading.local()

    def _limit() -> float:
        return alloc.watermark * alloc.num_blocks

    def _live() -> int:
        with alloc._lock:
            return len(alloc._ref) - alloc._evictable_blocks_locked()

    def can_admit(n: int) -> bool:
        ok = orig_can(n)
        if ok:
            checked.site = _site_parts()
        _yield_point("admission:checked")
        return ok

    def alloc_fn(n: int):
        out = orig_alloc(n)
        site = getattr(checked, "site", None)
        checked.site = None
        if site is not None and _live() > _limit():
            h = _ACTIVE
            _emit("atomic-check-act",
                  f"watermark admission overshoot: can_admit said yes, "
                  f"but by this grant live blocks exceed the watermark "
                  f"({_live()} > {_limit():g}) — the check and the "
                  "grant ran under separate lock holds "
                  "(BlockAllocator.admit_alloc is the atomic form)",
                  seed_val=h.seed if h is not None else seed(),
                  site=site)
        return out

    def admit_alloc(n: int):
        out = orig_admit(n)
        if out is not None and _live() > _limit():
            h = _ACTIVE
            _emit("atomic-check-act",
                  "admit_alloc overshot its own watermark — the atomic "
                  "admission path broke its contract",
                  seed_val=h.seed if h is not None else seed())
        _yield_point("admission:atomic")
        return out

    alloc.can_admit = can_admit
    alloc.alloc = alloc_fn
    alloc.admit_alloc = admit_alloc
