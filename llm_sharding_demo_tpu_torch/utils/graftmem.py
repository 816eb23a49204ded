"""The memory ledger of long-lived holdings.

Counterpart of ``llm_sharding_demo_tpu/utils/graftmem.py``: ``track``
registers one holding (an engine's weights, a batch's KV cache, a pool's
planes, a stored prefix, a demoted host entry) under a component and
returns a handle; ``update`` re-measures it after a rebind (a batch that
grew); ``release`` drops it. Bytes are measured from the tensors the
holding reaches (through lists, tuples, dicts and dataclasses such as
``KVCache``), never from shape arithmetic: each distinct storage once,
its ``nbytes``, attributed to its tensor's ``device``. The owner is held
weakly: a collected owner's entries release themselves at the ledger's
next call (the finalizer only queues the handle, so a collection that
runs while a lock of this package is held takes no lock). ``release``
detaches its holding's finalizer, so an owner that lives as long as the
server (an engine, the prefix store, the host tier) keeps no finalizer
per holding it once had.

Every change sets the ``hbm_bytes{component}`` gauge, samples it into
graftscope's series and emits a ``mem_alloc``/``mem_free`` event on the
timeline. ``snapshot()`` is the ``GET /debug/memory`` body: per
component its live bytes, entries and peak; per device the ledger's
bytes; the hottest holdings (``HOLDINGS_CAPACITY``); and the
conservation verdict, the entry table against the running totals, which
``/healthz`` turns into a 500 when they part. Beside the ledger it
reports the CUDA allocator's ``memory_allocated`` and
``max_memory_allocated`` for each card a holding lies on: the ledger
counts registered holdings, the allocator every tensor (activations,
workspaces, the allocator's rounding).

``reconcile(plan_row)`` holds the ledger against a cost-model plan row
(a dict with ``param_bytes_per_device``, ``kv_bytes_per_device`` and
optionally ``hbm_bytes_per_device`` and ``label``): the measured
``params`` bytes, and the pool's planes (else the contiguous caches),
against the predicted, as ratios and drifts (``|ratio - 1|``); the trend
reducer's ``poll(plan_row=)`` feeds the drifts to its watches. The cost
model predicts f32 bytes, so an int8 engine or a quantized pool drifts
below its prediction by design.

``GRAFTMEM=0`` turns recording off (``track`` returns the null handle
0).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import weakref
from typing import Any, Dict, List, Tuple

import torch

from . import graftsched, grafttime

MEMORY_COMPONENTS = {
    "params":       "an engine's weights as its forwards read them",
    "pool_codes":   "the paged pool's block planes (full precision or "
                    "codes)",
    "pool_scales":  "a quantized pool's per-block scales",
    "engine_cache": "contiguous KV caches: a generate call's, a batch's",
    "prefix_store": "the prefix store's cache copies (without a pool)",
    "host_spill":   "the host tier's demoted blocks (host memory)",
}

HOLDINGS_CAPACITY = 64

TRUTH = ("ledger: the nbytes of each distinct storage the REGISTERED "
         "holdings reach, by the tensor's device; transient activations, "
         "workspaces and the allocator's rounding are not ledger "
         "entries. allocator: torch.cuda.memory_allocated and "
         "max_memory_allocated of each card a holding lies on, which "
         "count every tensor")

_enabled = [os.environ.get("GRAFTMEM", "1") != "0"]


def enabled() -> bool:
    return _enabled[0]


def set_enabled(value: bool) -> bool:
    """Turn recording on or off; returns the previous setting."""
    prev = _enabled[0]
    _enabled[0] = bool(value)
    return prev


def measure_devices(value: Any) -> Tuple[int, Dict[str, int]]:
    """``(bytes, {device: bytes})`` of the distinct storages the tensors
    of ``value`` lie in."""
    seen = set()
    devices: Dict[str, int] = {}

    def walk(v):
        if isinstance(v, torch.Tensor):
            st = v.untyped_storage()
            key = (st.data_ptr(), v.device)
            if key in seen:
                return
            seen.add(key)
            dev = str(v.device)
            devices[dev] = devices.get(dev, 0) + st.nbytes()
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            for f in dataclasses.fields(v):
                walk(getattr(v, f.name))

    walk(value)
    return sum(devices.values()), devices


def measure(value: Any) -> int:
    """Live bytes of the storages ``value`` reaches."""
    return measure_devices(value)[0]


def allocator_bytes(devices) -> Dict[str, dict]:
    """The CUDA allocator's live and peak bytes on each of ``devices``
    that is a card."""
    out = {}
    for dev in sorted(devices):
        if dev.startswith("cuda"):
            d = torch.device(dev)
            out[dev] = {"memory_allocated": torch.cuda.memory_allocated(d),
                        "max_memory_allocated":
                            torch.cuda.max_memory_allocated(d)}
    return out


class MemoryLedger:
    """Handle-keyed entries, and running per-component and grand totals
    kept apart from them (the conservation check compares the two)."""

    def __init__(self):
        self._lock = graftsched.lock("graftmem.MemoryLedger._lock")
        self._entries: Dict[int, dict] = {}
        self._component_totals: Dict[str, int] = {}
        self._total = 0
        # component -> [peak bytes, t_ms]; "" keys the grand total
        self._peaks: Dict[str, list] = {}
        self._next_handle = 1
        self.t0 = time.perf_counter()
        # handles of collected owners, released at the next call
        self._collected: collections.deque = collections.deque()
        # handle -> the weakref.finalize of its owner, detached on release
        self._finalizers: Dict[int, weakref.finalize] = {}

    def _drain(self) -> None:
        while self._collected:
            self.release(self._collected.popleft())

    def _emit(self, component: str, delta: int, comp_total: int,
              total: int) -> None:
        # outside the ledger's lock
        from . import graftscope
        from .metrics import REGISTRY
        if delta >= 0:
            grafttime.emit("mem_alloc", component=component,
                           bytes=int(delta), total=int(comp_total))
        else:
            grafttime.emit("mem_free", component=component,
                           bytes=-int(delta), total=int(comp_total))
        graftscope.sample("hbm_bytes", float(comp_total), component=component)
        REGISTRY.gauge("hbm_bytes", float(comp_total), component=component)
        REGISTRY.gauge("hbm_bytes", float(total), component="total")

    def _note_peaks_locked(self, component: str, comp_total: int,
                           total: int) -> None:
        now = round((time.perf_counter() - self.t0) * 1e3, 3)
        for c, v in ((component, comp_total), ("", total)):
            peak = self._peaks.get(c)
            if peak is None or v > peak[0]:
                self._peaks[c] = [v, now]

    def track(self, owner: Any, holding: str, component: str,
              value: Any) -> int:
        self._drain()
        if not _enabled[0]:
            return 0
        if component not in MEMORY_COMPONENTS:
            raise ValueError(f"component {component!r} outside "
                             f"{sorted(MEMORY_COMPONENTS)}")
        nbytes, devices = measure_devices(value)
        with self._lock:
            handle = self._next_handle
            self._next_handle += 1
            self._entries[handle] = {"owner_id": id(owner),
                                     "owner": type(owner).__name__,
                                     "holding": holding,
                                     "component": component,
                                     "bytes": nbytes, "devices": devices}
            comp_total = self._component_totals.get(component, 0) + nbytes
            self._component_totals[component] = comp_total
            self._total += nbytes
            total = self._total
            self._note_peaks_locked(component, comp_total, total)
        self._finalizers[handle] = weakref.finalize(
            owner, self._collected.append, handle)
        self._emit(component, nbytes, comp_total, total)
        return handle

    def update(self, handle: int, value: Any) -> None:
        self._drain()
        if not _enabled[0] or not handle:
            return
        nbytes, devices = measure_devices(value)
        with self._lock:
            e = self._entries.get(handle)
            if e is None:
                return
            delta = nbytes - e["bytes"]
            e["bytes"] = nbytes
            e["devices"] = devices
            component = e["component"]
            comp_total = self._component_totals.get(component, 0) + delta
            self._component_totals[component] = comp_total
            self._total += delta
            total = self._total
            self._note_peaks_locked(component, comp_total, total)
        if delta:
            self._emit(component, delta, comp_total, total)

    def release(self, handle: int) -> None:
        """Drop one holding (idempotent: the owner's finalizer and an
        explicit release may both come)."""
        if not handle:
            return
        fin = self._finalizers.pop(handle, None)
        if fin is not None:
            fin.detach()
        with self._lock:
            e = self._entries.pop(handle, None)
            if e is None:
                return
            nbytes, component = e["bytes"], e["component"]
            comp_total = self._component_totals.get(component, 0) - nbytes
            self._component_totals[component] = comp_total
            self._total -= nbytes
            total = self._total
        if nbytes:
            self._emit(component, -nbytes, comp_total, total)

    def component_bytes(self) -> Dict[str, int]:
        """Per-component live bytes (the running totals; a component
        once held stays, at 0 when empty)."""
        self._drain()
        with self._lock:
            return dict(self._component_totals)

    def total_bytes(self) -> int:
        self._drain()
        with self._lock:
            return self._total

    def reconcile(self, plan_row) -> dict:
        """The ledger against a plan row's predicted bytes (module
        docstring): ``{plan, components: {params, kv}, total, ledger}``,
        each comparison ``{measured_bytes, predicted_bytes}`` with
        ``ratio`` and ``drift`` when a prediction is given, and
        ``max_component_drift`` over the components that have one."""
        row = (plan_row.to_dict() if hasattr(plan_row, "to_dict")
               else dict(plan_row))
        comp = self.component_bytes()
        measured_pool = (comp.get("pool_codes", 0)
                         + comp.get("pool_scales", 0))

        def _cmp(measured: int, predicted) -> dict:
            predicted = int(predicted or 0)
            out = {"measured_bytes": measured, "predicted_bytes": predicted}
            if predicted > 0:
                ratio = measured / predicted
                out["ratio"] = round(ratio, 6)
                out["drift"] = round(abs(ratio - 1.0), 6)
            return out

        components = {
            "params": _cmp(comp.get("params", 0),
                           row.get("param_bytes_per_device")),
            "kv": _cmp(measured_pool or comp.get("engine_cache", 0),
                       row.get("kv_bytes_per_device")),
        }
        out = {
            "plan": row.get("label"),
            "components": components,
            "total": _cmp(self.total_bytes(),
                          row.get("hbm_bytes_per_device")),
            "ledger": comp,
        }
        drifts = [c["drift"] for c in components.values() if "drift" in c]
        if drifts:
            out["max_component_drift"] = max(drifts)
        return out

    def holding_bytes(self, owner: Any, holding: str) -> int:
        """Live bytes of one owner's named holding, summed over its
        entries."""
        self._drain()
        oid = id(owner)
        with self._lock:
            return sum(e["bytes"] for e in self._entries.values()
                       if e["owner_id"] == oid and e["holding"] == holding)

    def snapshot(self) -> dict:
        """The ``/debug/memory`` body (module docstring)."""
        self._drain()
        with self._lock:
            derived: Dict[str, int] = {}
            devices: Dict[str, int] = {}
            by_component_device: Dict[str, Dict[str, int]] = {}
            holdings: List[dict] = []
            for e in self._entries.values():
                c = e["component"]
                derived[c] = derived.get(c, 0) + e["bytes"]
                for dev, b in e["devices"].items():
                    devices[dev] = devices.get(dev, 0) + b
                    cd = by_component_device.setdefault(c, {})
                    cd[dev] = cd.get(dev, 0) + b
                holdings.append({"component": c, "holding": e["holding"],
                                 "owner": e["owner"], "bytes": e["bytes"],
                                 "devices": dict(e["devices"])})
            running = {c: b for c, b in self._component_totals.items()
                       if b or derived.get(c)}
            total = self._total
            entries_n = len(self._entries)
            peaks = {(c or "total"): {"bytes": p[0], "t_ms": p[1]}
                     for c, p in self._peaks.items()}
        conserved = derived == running and sum(running.values()) == total
        holdings.sort(key=lambda h: h["bytes"], reverse=True)
        components = {
            c: {"bytes": running.get(c, 0),
                "entries": sum(1 for h in holdings if h["component"] == c),
                "peak_bytes": peaks.get(c, {}).get("bytes", 0),
                "devices": by_component_device.get(c, {})}
            for c in sorted(set(running) | set(derived))}
        out = {
            "enabled": enabled(),
            "truth": TRUTH,
            "components": components,
            "total_bytes": total,
            "peak_bytes": peaks.get("total", {}).get("bytes", 0),
            "peaks": peaks,
            "devices": devices,
            "allocator": allocator_bytes(devices),
            "entries": entries_n,
            "holdings": holdings[:HOLDINGS_CAPACITY],
            "conserved": conserved,
        }
        if len(holdings) > HOLDINGS_CAPACITY:
            out["holdings_truncated"] = True
        return out

    def dump_state(self) -> tuple:
        with self._lock:
            return (dict(self._entries), dict(self._component_totals),
                    self._total, {k: list(v) for k, v in self._peaks.items()},
                    self._next_handle, self.t0)

    def restore_state(self, state: tuple) -> None:
        entries, totals, total, peaks, next_handle, t0 = state
        with self._lock:
            self._entries = dict(entries)
            self._component_totals = dict(totals)
            self._total = total
            self._peaks = {k: list(v) for k, v in peaks.items()}
            # never rewound: a finalizer of an entry dropped here may
            # still release its handle, which must not name a new entry
            self._next_handle = max(self._next_handle, next_handle)
            self.t0 = t0

    def clear(self) -> None:
        with self._lock:
            self._entries = {}
            self._component_totals = {}
            self._total = 0
            self._peaks = {}
            self.t0 = time.perf_counter()


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


def total_bytes() -> int:
    return STATE.total_bytes()


def reconcile(plan_row) -> dict:
    return STATE.reconcile(plan_row)


def snapshot() -> dict:
    return STATE.snapshot()


def dump_state() -> tuple:
    return STATE.dump_state()


def restore_state(state: tuple) -> None:
    STATE.restore_state(state)


def clear() -> None:
    STATE.clear()
