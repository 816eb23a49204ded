"""The host-memory KV spill tier below the device pool.

Counterpart of ``llm_sharding_demo_tpu/runtime/kv_tier.py``. Without a
tier, a cold prefix entry of the pool's content-keyed registry
(``runtime.kv_pool``) is evicted and re-prefilled on its next hit; the
tier turns that into a ladder:

- **demote** (``HostKVTier.demote_lru``): when an allocation would evict
  a prefix entry (``BlockAllocator._demote_pressure``) or the prefix
  store's capacity trim fires (``PrefixCachingEngine``), the entry's
  blocks are copied to host memory as raw planes (a quantized pool's
  codes and scales, never dequantized) and the entry moves down a tier
  under its own content key;
- **promote** (``HostKVTier.promote``): a hit on a demoted key (the
  prefix store's ``_lookup``) allocates fresh device blocks, copies the
  host planes back and re-registers the entry under the same key, so a
  promoted entry decodes byte-identically to one never demoted;
- **LRU to oblivion**: the host budget (``KV_HOST_BLOCKS``) is a hard
  bound; a new demotion discards the tier's own LRU entries, and an
  entry larger than the whole budget is evicted as before (typed, never
  an error).

Host memory: on a CUDA pool the planes land in pinned CPU tensors; a CPU
pool's spill is plain CPU tensors. ``KVBlockPool.spill_blocks`` copies
synchronously, so an entry's tensors are complete before the tier holds
them, and ``fill_blocks`` returns once they are on the device.

Conservation per tier, checked at every move when the allocator
sanitizes (``GRAFTSAN=1``) and on demand (``graftsan_check``, the
``/healthz`` read): host blocks in use equal the sum over entries,
entries equal demotions - promotions - discards, occupancy stays within
the budget; a violation raises ``GraftsanError`` with the numbers. Each
entry's bytes are a ``host_spill`` holding in ``utils.graftmem``,
measured from its tensors, released at promote or discard.

Locks: the tier's ``_lock`` is a leaf, never held across allocator or
device work. A demotion goes lease (allocator) -> spill (device) -> pop
(allocator) -> install (tier); a promote pops the host entry first, so
the allocation it makes may demote other entries without deadlock. The
moves are counted in ``stats()`` and ``REGISTRY`` and land on the
timeline (utils.grafttime) as ``tier_demote`` and ``tier_promote``,
emitted outside the tier's lock.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from ..utils import graftmem, graftsched, grafttime
from ..utils.metrics import REGISTRY
from .kv_pool import GraftsanError, PoolExhausted


@dataclasses.dataclass
class _HostEntry:
    """One demoted prefix entry: its blocks' raw planes (codes, and
    scales for a quantized pool), the device blocks they stand for, and
    the graftmem handle measuring them."""
    codes: torch.Tensor
    scales: Optional[torch.Tensor]
    n_blocks: int
    mem_handle: int


class HostKVTier:
    """Bounded host store of demoted prefix entries in LRU order
    (insertion order; promotes pop). Attach below a ``KVBlockPool`` with
    ``pool.attach_tier(tier)``."""

    def __init__(self, host_blocks: int):
        if host_blocks < 1:
            raise ValueError(
                f"host_blocks={host_blocks} must be >= 1 (a zero-block "
                "tier is 'no tier' — leave it unattached instead)")
        self.host_blocks = host_blocks
        self._lock = graftsched.rlock("kv_tier.HostKVTier._lock")
        self._entries: "OrderedDict[bytes, _HostEntry]" = OrderedDict()
        self._blocks_in_use = 0
        self.demotions = 0
        self.promotions = 0
        self.discards = 0
        self._promote_ms = 0.0

    def _check_locked(self, boundary: str) -> None:
        """Per-tier conservation at a boundary; raises with the
        numbers."""
        held = sum(e.n_blocks for e in self._entries.values())
        if held != self._blocks_in_use:
            raise GraftsanError(
                f"[tier:{boundary}] host-block conservation broken: "
                f"{held} blocks held by entries != {self._blocks_in_use} "
                "in use")
        moved = self.demotions - self.promotions - self.discards
        if len(self._entries) != moved:
            raise GraftsanError(
                f"[tier:{boundary}] entry conservation broken: "
                f"{len(self._entries)} entries != {self.demotions} "
                f"demotions - {self.promotions} promotions - "
                f"{self.discards} discards")
        if self._blocks_in_use > self.host_blocks:
            raise GraftsanError(
                f"[tier:{boundary}] budget broken: {self._blocks_in_use}"
                f" blocks in use > {self.host_blocks} budget")

    def demote_lru(self, pool) -> bool:
        """Move the pool's LRU prefix entry down to this tier. True when
        an entry moved (its device blocks freed); False when there is
        none, it exceeds the whole host budget (the caller evicts), or it
        changed under the lease (the stale copy is dropped)."""
        alloc = pool.allocator
        lease = alloc.lease_lru_prefix()
        if lease is None:
            return False
        key, ids = lease
        n = len(ids)
        if n > self.host_blocks:
            alloc.free(ids)
            return False
        codes, scales = pool.spill_blocks(ids)
        if not alloc.demote_pop_prefix(key, ids):
            alloc.free(ids)
            return False
        alloc.free(ids)
        handle = graftmem.track(self, "_entries", "host_spill",
                                (codes, scales))
        dropped: List[_HostEntry] = []
        with self._lock:
            prior = self._entries.pop(key, None)
            if prior is not None:
                # the same content demoted twice: the newer bytes replace
                # the stale copy, which leaves as a discard
                self._blocks_in_use -= prior.n_blocks
                self.discards += 1
                dropped.append(prior)
            while (self._blocks_in_use + n > self.host_blocks
                   and self._entries):
                _, old = self._entries.popitem(last=False)
                self._blocks_in_use -= old.n_blocks
                self.discards += 1
                dropped.append(old)
            self._entries[key] = _HostEntry(codes, scales, n, handle)
            self._blocks_in_use += n
            self.demotions += 1
            in_use = self._blocks_in_use
            n_entries = len(self._entries)
            if alloc.sanitize:
                self._check_locked("demote")
        for old in dropped:
            graftmem.release(old.mem_handle)
        REGISTRY.inc("tier_demotions_total")
        grafttime.emit("tier_demote", blocks=n, host_blocks=in_use,
                       host_entries=n_entries)
        return True

    def has(self, key: bytes) -> bool:
        """Is ``key`` demoted here? (No LRU effect.)"""
        with self._lock:
            return key in self._entries

    def promote(self, pool, key: bytes) -> Optional[Tuple[int, ...]]:
        """Bring a demoted entry back into the pool under the same key.
        Returns its block ids with one caller ref per block (the
        ``lookup_prefix`` contract: release with ``free``), or None when
        ``key`` is not here or the pool cannot host it now (the entry
        stays demoted, at the warm end of the LRU)."""
        alloc = pool.allocator
        if alloc.has_prefix(key):
            # already resident (a concurrent promote or re-prefill won):
            # the host copy is redundant
            with self._lock:
                entry = self._entries.pop(key, None)
                if entry is not None:
                    self._blocks_in_use -= entry.n_blocks
                    self.discards += 1
                    if alloc.sanitize:
                        self._check_locked("promote_redundant")
            if entry is not None:
                graftmem.release(entry.mem_handle)
            return alloc.lookup_prefix(key)
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._blocks_in_use -= entry.n_blocks
        if entry is None:
            return None
        t0 = time.perf_counter()
        try:
            ids = alloc.alloc(entry.n_blocks)
        except PoolExhausted:
            with self._lock:
                self._entries[key] = entry
                self._entries.move_to_end(key, last=False)
                self._blocks_in_use += entry.n_blocks
                if alloc.sanitize:
                    self._check_locked("promote_refused")
            return None
        pool.fill_blocks(ids, entry.codes, entry.scales)
        alloc.register_prefix(key, ids)
        dur_ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.promotions += 1
            self._promote_ms += dur_ms
            in_use = self._blocks_in_use
            if alloc.sanitize:
                self._check_locked("promote")
        graftmem.release(entry.mem_handle)
        REGISTRY.inc("tier_promotions_total")
        grafttime.emit("tier_promote", blocks=entry.n_blocks,
                       host_blocks=in_use, dur_ms=round(dur_ms, 3))
        return tuple(ids)

    def note_gauges(self, component: str = "pool") -> None:
        with self._lock:
            in_use = self._blocks_in_use
        REGISTRY.gauge("kv_host_blocks_in_use", in_use, component=component)
        REGISTRY.gauge("kv_host_blocks_total", self.host_blocks,
                       component=component)

    def graftsan_check(self, boundary: str = "explicit") -> None:
        """The per-tier conservation check on demand."""
        with self._lock:
            self._check_locked(boundary)

    def stats(self) -> Dict[str, object]:
        """The tier block of ``KVBlockPool.stats`` (``/healthz``
        ``kv_pool_stats``): occupancy in device blocks, the movement
        ledger, and the host bytes measured from the held tensors."""
        with self._lock:
            out = {
                "host_blocks_total": self.host_blocks,
                "host_blocks_in_use": self._blocks_in_use,
                "host_entries": len(self._entries),
                "demotions": self.demotions,
                "promotions": self.promotions,
                "discards": self.discards,
                "promote_ms_total": round(self._promote_ms, 3),
            }
        out["host_bytes"] = graftmem.holding_bytes(self, "_entries")
        return out
