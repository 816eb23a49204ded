"""graftshard: the live placement auditor (dynamic half).

Counterpart of ``llm_sharding_demo_tpu/utils/graftshard.py``. The JAX
auditor reads each registered buffer's ``.sharding``; a rank here holds
plain local tensors, so the mesh decoders record where each tensor they
place came from (``place``: the mesh axis, the dim it is split along,
the global shape, this rank's share), and the auditor holds every
holding the memory ledger registers (``graftmem.track`` /
``graftmem.update``, the one moment the value itself is in hand) to the
owning module's declared ``PLACEMENT_CONTRACT``:

- a holding declared ``"replicated"`` must have its global shape on this
  rank, and no leaf split over any axis;
- a holding declared over an axis must have, along each leaf's recorded
  split dim, the share the placement gave this rank (global / axis size
  for an even split), and the recorded axis must be the declared one.

A tensor with no placement record (a single-device engine's) satisfies
every declaration. Armed by ``GRAFTSHARD=1`` (off by default: one env
check per ledger registration, and ``place`` records nothing). A
violation at ``track``/``update`` raises :class:`GraftshardError` with
holding/component/declaration-site provenance; :func:`audit` re-walks
every still-live tracked value and returns the violations, and
``/healthz`` serves :func:`status`.

``tools/graftcheck``'s static half, which verifies traced JAX programs,
has no counterpart in the port.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

# THE mesh-axis vocabulary (the JAX package's, pinned equal by the tests)
MESH_AXES = ("pp", "tp", "ep", "kvp", "dp", "sp")

REPLICATED = "replicated"


class GraftshardError(AssertionError):
    """A live tensor's placement disagrees with its module's declared
    PLACEMENT_CONTRACT: an invariant violation, not an environmental
    failure, so a test cannot catch it by accident."""

    def __init__(self, message: str, owner: str = "", holding: str = "",
                 component: str = "", expected: str = "",
                 found: Tuple[str, ...] = (), where: str = ""):
        super().__init__(message)
        self.owner = owner
        self.holding = holding
        self.component = component
        self.expected = expected
        self.found = tuple(found)
        self.where = where


def enabled() -> bool:
    return os.environ.get("GRAFTSHARD", "0") == "1"


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one local tensor came from: ``splits`` is ``((dim, axis,
    share), ...)``, this rank's ``share`` of the global size along each
    split dim; no splits means replicated."""

    global_shape: Tuple[int, ...]
    splits: Tuple[Tuple[int, str, int], ...] = ()


class _Auditor:
    """The registry + counters behind the module-level API: handle ->
    declaration row plus a weak ref to the live value, and the placement
    records of live tensors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._registry: Dict[int, Tuple[str, str, str, str, str]] = {}
        self._live: Dict[int, List["weakref.ref"]] = {}
        self._placed: Dict[int, Tuple["weakref.ref", Placement]] = {}
        self._stats = {"checks": 0, "violations": 0}

    def place(self, t: torch.Tensor, placement: Placement) -> None:
        key = id(t)
        # the callback runs while the tensor is freed, before its id can
        # name another tensor; it takes no lock (a collection can fire it
        # on a thread that holds this one)
        ref = weakref.ref(t, lambda _r: self._placed.pop(key, None))
        with self._lock:
            self._placed[key] = (ref, placement)

    def placement(self, t: torch.Tensor) -> Optional[Placement]:
        with self._lock:
            entry = self._placed.get(id(t))
        if entry is None or entry[0]() is not t:
            return None
        return entry[1]

    def register(self, handle: int, row: Tuple[str, str, str, str, str],
                 value: Any) -> None:
        # weak refs to the holding's tensors (a parameter dict itself
        # takes none): the audit re-walks those still alive
        refs = [weakref.ref(t) for t in _tensors(value)]
        with self._lock:
            self._registry[handle] = row
            self._live[handle] = refs

    def row(self, handle: int) -> Optional[Tuple[str, str, str, str, str]]:
        with self._lock:
            return self._registry.get(handle)

    def rebind(self, handle: int, value: Any) -> None:
        refs = [weakref.ref(t) for t in _tensors(value)]
        with self._lock:
            if handle in self._registry:
                self._live[handle] = refs

    def drop(self, handle: int) -> None:
        with self._lock:
            self._registry.pop(handle, None)
            self._live.pop(handle, None)

    def live_rows(self):
        with self._lock:
            return [(h, self._registry[h], self._live[h])
                    for h in sorted(self._registry) if h in self._live]

    def count(self, checks: int = 0, violations: int = 0) -> None:
        with self._lock:
            self._stats["checks"] += checks
            self._stats["violations"] += violations

    def stats(self) -> dict:
        with self._lock:
            return {"checks": self._stats["checks"],
                    "violations": self._stats["violations"],
                    "tracked": len(self._registry)}

    def clear(self) -> None:
        with self._lock:
            self._registry.clear()
            self._live.clear()
            self._stats = {"checks": 0, "violations": 0}


STATE = _Auditor()


def place(t: torch.Tensor, global_shape: Sequence[int],
          splits: Sequence[Tuple[int, str, int]] = ()) -> torch.Tensor:
    """Record where ``t`` came from (see :class:`Placement`); returns
    ``t``. Records nothing unless armed."""
    if enabled():
        STATE.place(t, Placement(tuple(int(x) for x in global_shape),
                                 tuple((int(d), a, int(n))
                                       for d, a, n in splits)))
    return t


def replicate(tree: Any) -> Any:
    """Record every tensor of ``tree`` as replicated at its own shape."""
    if enabled():
        for t in _tensors(tree):
            place(t, t.shape)
    return tree


def _tensors(value: Any):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            yield from _tensors(getattr(value, f.name))


def _contract_of(module_name: str) -> Optional[dict]:
    mod = sys.modules.get(module_name)
    contract = getattr(mod, "PLACEMENT_CONTRACT", None)
    return contract if isinstance(contract, dict) else None


def _decl_site(module_name: str) -> str:
    """``file:line`` of the owning module's PLACEMENT_CONTRACT — the
    provenance every violation points back at."""
    mod = sys.modules.get(module_name)
    path = getattr(mod, "__file__", None)
    if not path:
        return module_name
    try:
        with open(path, encoding="utf-8") as f:
            for i, text in enumerate(f, 1):
                if text.startswith("PLACEMENT_CONTRACT"):
                    return f"{path}:{i}"
    except OSError:
        pass
    return path


def _findings(expected: str, value: Any) -> Tuple[List[str], List[str]]:
    """(problems, axes found) of one holding against its declaration."""
    problems: List[str] = []
    axes = set()
    for t in _tensors(value):
        p = STATE.placement(t)
        if p is None:
            continue  # single-device tensors satisfy every declaration
        local = tuple(t.shape)
        split_axes = {a for _, a, _ in p.splits}
        axes |= split_axes
        if expected == REPLICATED:
            if split_axes:
                problems.append(
                    f"declared \"replicated\" but the live buffer is "
                    f"placed over mesh axes {sorted(split_axes)}")
            elif local != p.global_shape:
                problems.append(
                    f"declared \"replicated\" but this rank holds "
                    f"{list(local)} of global {list(p.global_shape)}")
            continue
        stray = split_axes - {expected}
        if stray:
            problems.append(
                f"declared placement over {expected!r} but the live "
                f"buffer also names {sorted(stray)}")
        for dim, axis, share in p.splits:
            if axis == expected and local[dim] != share:
                problems.append(
                    f"declared placement over {expected!r} but dim {dim} "
                    f"holds {local[dim]} of global {p.global_shape[dim]} "
                    f"(this rank's share is {share})")
    return problems, sorted(axes)


def _check(module_name: str, owner_type: str, holding: str,
           component: str, expected: str, value: Any) -> None:
    problems, axes = _findings(expected, value)
    STATE.count(checks=1)
    if not problems:
        return
    STATE.count(violations=1)
    where = _decl_site(module_name)
    raise GraftshardError(
        f"graftshard: {owner_type}.{holding} (component {component!r}) "
        f"{problems[0]} — contract at {where}",
        owner=owner_type, holding=holding, component=component,
        expected=expected, found=tuple(axes), where=where)


def observe_track(owner: Any, holding: str, component: str, value: Any,
                  handle: int) -> None:
    """graftmem.track's hook: register + check one new holding. A
    module with no PLACEMENT_CONTRACT, or a contract not declaring
    this holding, audits nothing."""
    if not enabled():
        return
    module_name = type(owner).__module__
    contract = _contract_of(module_name)
    if contract is None:
        return
    expected = contract.get(f"holding:{holding}")
    if not isinstance(expected, str):
        return
    row = (module_name, type(owner).__name__, holding, component,
           expected)
    STATE.register(handle, row, value)
    _check(*row, value)


def observe_update(handle: int, value: Any) -> None:
    """graftmem.update's hook: re-check a re-bound holding."""
    if not enabled():
        return
    row = STATE.row(handle)
    if row is None:
        return
    STATE.rebind(handle, value)
    _check(*row, value)


def observe_release(handle: int) -> None:
    STATE.drop(handle)


def audit() -> List[dict]:
    """Re-walk every still-live tracked holding against its declared
    contract; one row per VIOLATION (empty = the whole ledger is where
    it was declared to be). Never raises."""
    out: List[dict] = []
    for _handle, row, refs in STATE.live_rows():
        module_name, owner_type, holding, component, expected = row
        value = [t for t in (r() for r in refs) if t is not None]
        if not value:
            continue
        problems, axes = _findings(expected, value)
        STATE.count(checks=1)
        if not problems:
            continue
        STATE.count(violations=1)
        out.append({
            "owner": owner_type, "holding": holding,
            "component": component, "expected": expected,
            "found": axes, "problem": problems[0],
            "where": _decl_site(module_name),
        })
    return out


def status() -> dict:
    """The /healthz view: armed or not, cumulative check/violation
    counters, and how many live holdings are under audit."""
    return {"enabled": enabled(), **STATE.stats()}


def clear() -> None:
    """Test hook: drop the registry and counters."""
    STATE.clear()
