"""The device-memory ledger of long-lived holdings.

Trimmed counterpart of ``llm_sharding_demo_tpu/utils/graftmem.py``:
``track`` registers one holding (a batch's KV cache, a pool's planes, a
stored prefix, a demoted host entry) under a component and returns a
handle, ``update`` re-measures it after a rebind (a batch
that grew), ``release`` drops it. Bytes are the sum of ``nbytes`` over
the tensors the holding reaches (through lists, tuples, dicts and
dataclasses such as ``KVCache``), never shape arithmetic. The owner is
held weakly: a collected owner's entries release themselves.
Reconciliation against a plan, peaks and the ``/debug/memory`` view wait
for ROADMAP Queue 1 item 15 (with bytes from the CUDA allocator).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Dict

import torch

from . import graftsched

# a batch's contiguous KV cache; the paged pool's block storage (full
# precision or codes) and its scales; the prefix store's cache copies;
# the host tier's demoted blocks (host memory, not the device's)
MEMORY_COMPONENTS = frozenset({"engine_cache", "pool_codes", "pool_scales",
                               "prefix_store", "host_spill"})


def measure(value: Any) -> int:
    """Live bytes of the tensors ``value`` reaches."""
    if isinstance(value, torch.Tensor):
        return value.nelement() * value.element_size()
    if isinstance(value, dict):
        return sum(measure(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return sum(measure(v) for v in value)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return sum(measure(getattr(value, f.name))
                   for f in dataclasses.fields(value))
    return 0


class MemoryLedger:
    """Handle-keyed entries plus running per-component totals."""

    def __init__(self):
        self._lock = graftsched.lock("graftmem.MemoryLedger._lock")
        self._entries: Dict[int, dict] = {}
        self._totals: Dict[str, int] = {}
        self._next = 1

    def track(self, owner: Any, holding: str, component: str,
              value: Any) -> int:
        if component not in MEMORY_COMPONENTS:
            raise ValueError(f"component {component!r} outside "
                             f"{sorted(MEMORY_COMPONENTS)}")
        nbytes = measure(value)
        with self._lock:
            handle = self._next
            self._next += 1
            self._entries[handle] = {"owner_id": id(owner),
                                     "holding": holding,
                                     "component": component,
                                     "bytes": nbytes}
            self._totals[component] = self._totals.get(component, 0) + nbytes
        weakref.finalize(owner, self.release, handle)
        return handle

    def update(self, handle: int, value: Any) -> None:
        nbytes = measure(value)
        with self._lock:
            e = self._entries.get(handle)
            if e is not None:
                self._totals[e["component"]] += nbytes - e["bytes"]
                e["bytes"] = nbytes

    def release(self, handle: int) -> None:
        with self._lock:
            e = self._entries.pop(handle, None)
            if e is not None:
                self._totals[e["component"]] -= e["bytes"]

    def component_bytes(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._totals)

    def holding_bytes(self, owner: Any, holding: str) -> int:
        """Live bytes of one owner's named holding, summed over its
        entries."""
        oid = id(owner)
        with self._lock:
            return sum(e["bytes"] for e in self._entries.values()
                       if e["owner_id"] == oid and e["holding"] == holding)


STATE = MemoryLedger()


def track(owner: Any, holding: str, component: str, value: Any) -> int:
    return STATE.track(owner, holding, component, value)


def update(handle: int, value: Any) -> None:
    STATE.update(handle, value)


def release(handle: int) -> None:
    STATE.release(handle)


def component_bytes() -> Dict[str, int]:
    return STATE.component_bytes()


def holding_bytes(owner: Any, holding: str) -> int:
    return STATE.holding_bytes(owner, holding)
