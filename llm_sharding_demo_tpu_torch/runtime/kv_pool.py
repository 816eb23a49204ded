"""Paged KV-cache memory: the block pool, its allocator and the paged
runner.

Counterpart of ``llm_sharding_demo_tpu/runtime/kv_pool.py``:

- ``BlockAllocator``: host-side accounting, no tensors. Ref-counted
  blocks, all-or-nothing ``alloc``, watermark admission (``can_admit``,
  and ``admit_alloc``, which checks and grants under one lock hold), a
  content-keyed prefix registry whose entries share blocks and are
  evicted least recently used first, and the ``GRAFTSAN`` sanitizer
  (double free, leak at teardown, use-after-free, copy-on-write
  violation, refcount drift; every report carries the grant and free
  sites).
- ``KVBlockPool``: the device pool (``ops.paged_attention.pool_shape``,
  or int8/fp8 codes plus scales with ``block_dtype``,
  ``ops.kv_quant``), its allocator and its movers. Every device write
  holds ``_dev_lock``: the pool is written in place, and several front
  ends may share one pool.
- ``PagedKVRunner``: solo or ragged ``generate`` on the pool over an
  unmodified ``DecodeEngine``. It prefills with the engine, scatters the
  state into blocks, then gathers each decode segment's rows into a
  contiguous cache, runs the engine's own ``_decode_seg`` on it and
  scatters it back. The model code is the contiguous path's, so an fp32
  paged stream equals the contiguous engine's byte for byte. With a
  pool-backed prefix store (``prefix=``) a solo prompt prefills through
  the store and references the entry's full blocks in its own table; the
  frontier block is copied on write.
- The host spill tier (``runtime.kv_tier``) hangs below the pool
  (``attach_tier``): the allocator demotes its LRU prefix entry there
  before an allocation would evict it (``_demote_pressure``,
  ``lease_lru_prefix``, ``demote_pop_prefix``), and the raw planes move
  through ``spill_blocks`` and ``fill_blocks``.

The reference's pools compile their movers with ``jax.jit`` and certify
their program counts (``note_compiles``, the recompile certificate);
PyTorch runs the movers eagerly, so neither has a counterpart here.

Block lifecycle::

    free -> allocated (ref=1, private)
         -> shared    (ref>1: live table refs and/or prefix entries)
         -> evictable (ref held only by prefix entries, LRU-ordered)
         -> free      (last ref dropped / entry evicted)

Writers never mutate a shared block: extension into a shared block goes
through ``cow_copy`` (allocate, copy, retarget the table entry, deref the
original).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import kv_quant as KVQ
from ..ops import paged_attention as PA
from ..ops.attention import KVCache
from ..utils import (graftfault, graftmem, graftsched, graftscope,
                     grafttime, tracing)
from ..utils.device import DeviceLike, resolve_device
from ..utils.graftnum import regime_of
from ..utils.metrics import DEFAULT_KV_BLOCK_SIZE, REGISTRY
from .engine import (DecodeEngine, GenerateResult, Generators,
                     SamplingConfig, _sync, eos_chunks, prepare_generate,
                     select_token)

# gauge/stats label of a full-precision pool's blocks
_REGIME_LABELS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def bytes_per_block(n_layer: int, n_kv_head: int, block_size: int,
                    head_dim: int, dtype: torch.dtype = torch.float32,
                    block_dtype: Optional[str] = None) -> int:
    """Device bytes one physical block costs, scales included: quantized
    blocks pay ``2 * n_kv_head`` f32 scales a layer beside their codes."""
    slots = n_layer * 2 * n_kv_head * block_size * head_dim
    if block_dtype is None:
        return slots * dtype.itemsize
    return (slots * KVQ.STORAGE_DTYPES[block_dtype].itemsize
            + n_layer * 2 * n_kv_head * torch.float32.itemsize)


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """fp8 codes as their bytes: index_select and index_copy_ take no
    fp8 tensors; every other storage dtype as it is."""
    if t.dtype in (torch.int8, torch.float32, torch.bfloat16):
        return t
    return t.view(torch.uint8)


class PoolExhausted(RuntimeError):
    """No allocation possible even after evicting every zero-ref prefix
    entry. Schedulers catch this and preempt; serving turns sustained
    exhaustion into 429."""


class GraftsanError(RuntimeError, ValueError):
    """A memory-safety violation caught by the sanitizer (``GRAFTSAN=1``
    or ``sanitize=True``): double free, use-after-free gather or scatter,
    copy-on-write write to a shared block, refcount drift, or a leak at
    teardown. Messages carry the block id and the call sites of the
    grants and frees involved. Also a ``ValueError``: it upgrades the
    allocator's plain double-free ``ValueError``."""


def _graftsan_enabled() -> bool:
    return os.environ.get("GRAFTSAN", "") not in ("", "0")


def _call_site(skip_file: str = __file__) -> str:
    """``file.py:line (func)`` of the nearest caller frame outside this
    module: the provenance the sanitizer records per grant and free."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == skip_file:
        f = f.f_back
    if f is None:
        return "<unknown>"
    return (f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
            f"({f.f_code.co_name})")


# live sanitizing allocators, for teardown sweeps
_SAN_ALLOCATORS: "weakref.WeakSet[BlockAllocator]" = weakref.WeakSet()


def graftsan_sweep(timeout: float = 2.0) -> None:
    """Assert every live sanitizing allocator is quiesced (no caller refs
    left); raises ``GraftsanError`` listing each leaked block with its
    grant sites."""
    for alloc in list(_SAN_ALLOCATORS):
        alloc.graftsan_assert_quiesced(timeout=timeout)


@dataclasses.dataclass(frozen=True)
class PoolStats:
    blocks_total: int
    blocks_free: int
    blocks_in_use: int      # any ref (live rows and/or prefix entries)
    blocks_evictable: int   # in_use blocks whose refs are ALL prefix refs
    prefix_entries: int
    evictions: int
    cow_copies: int

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class BlockAllocator:
    """Host-side ref-counted block accounting (no tensors), so every
    policy is testable without a pool.

    ``watermark`` bounds ADMISSION, not allocation: ``can_admit(n)``
    refuses while ``n`` would push referenced blocks past ``watermark *
    num_blocks``, keeping the rest as growth headroom for admitted rows.
    ``alloc`` itself may use the reserve.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 watermark: float = 0.9,
                 sanitize: Optional[bool] = None):
        if num_blocks < 1:
            raise ValueError(f"num_blocks={num_blocks} must be >= 1")
        if block_size < 1:
            raise ValueError(f"block_size={block_size} must be >= 1")
        if not 0.0 < watermark <= 1.0:
            raise ValueError(f"watermark={watermark} must be in (0, 1]")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.watermark = watermark
        self._lock = graftsched.rlock("kv_pool.BlockAllocator._lock")
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        # content key -> block ids; insertion order is the LRU order
        # (lookups move_to_end). Each entry holds one ref per id, counted
        # apart in _prefix_ref so that "evictable" is decidable.
        self._prefix: "OrderedDict[bytes, Tuple[int, ...]]" = OrderedDict()
        self._prefix_ref: Dict[int, int] = {}
        self.evictions = 0
        self.cow_copies = 0
        # sanitizer: per-block grant sites, the last freeing site,
        # conservation checks at every boundary, and the free hook the
        # owning pool wires to poison freed blocks
        self.sanitize = (_graftsan_enabled() if sanitize is None
                         else sanitize)
        self._san_owner: Dict[int, List[str]] = {}   # grant sites, LIFO
        self._san_freed: Dict[int, str] = {}         # last freeing site
        self._san_grants = 0
        self._san_drops = 0
        self._on_free: Optional[Callable[[List[int]], None]] = None
        # the host tier's demotion hook (``KVBlockPool.attach_tier``),
        # called outside ``_lock`` before an allocation would evict: True
        # when it moved one entry down a tier; None means no tier
        self._tier_demote: Optional[Callable[[], bool]] = None
        if self.sanitize:
            _SAN_ALLOCATORS.add(self)

    # -- sanitizer bookkeeping (all under self._lock) ------------------------

    def _san_grant_locked(self, b: int, site: str) -> None:
        self._san_grants += 1
        self._san_owner.setdefault(b, []).append(site)
        self._san_freed.pop(b, None)

    def _san_drop_locked(self, b: int, site: str,
                         fully_freed: bool) -> None:
        self._san_drops += 1
        owners = self._san_owner.get(b)
        if owners:
            owners.pop()
        if fully_freed:
            self._san_owner.pop(b, None)
            self._san_freed[b] = site

    def _san_check_locked(self, boundary: str) -> None:
        """Conservation at a boundary: free + referenced == total, grants
        - drops == live refs, prefix refs within total refs."""
        free_n, ref_n = len(self._free), len(self._ref)
        if free_n + ref_n != self.num_blocks:
            raise GraftsanError(
                f"[{boundary}] block conservation broken: {free_n} free "
                f"+ {ref_n} referenced != {self.num_blocks} total")
        live = sum(self._ref.values())
        if self._san_grants - self._san_drops != live:
            raise GraftsanError(
                f"[{boundary}] refcount conservation broken: "
                f"{self._san_grants} grants - {self._san_drops} drops "
                f"!= {live} live refs")
        for b, pr in self._prefix_ref.items():
            if pr > self._ref.get(b, 0):
                raise GraftsanError(
                    f"[{boundary}] block {b} holds {pr} prefix refs but "
                    f"only {self._ref.get(b, 0)} total refs")

    def freed_provenance(self, block: int) -> Optional[str]:
        """The site that last freed ``block`` (sanitizer mode), if it is
        free because of an explicit free or eviction."""
        with self._lock:
            return self._san_freed.get(block)

    def graftsan_report(self) -> List[dict]:
        """Leaks: blocks whose refcount exceeds their prefix-entry refs,
        each with its live grant sites."""
        with self._lock:
            out = []
            for b in sorted(self._ref):
                extra = self._ref[b] - self._prefix_ref.get(b, 0)
                if extra > 0:
                    out.append({
                        "block": b,
                        "leaked_refs": extra,
                        "prefix_refs": self._prefix_ref.get(b, 0),
                        "grant_sites": list(self._san_owner.get(b, [])),
                    })
            return out

    def graftsan_assert_quiesced(self, timeout: float = 2.0) -> None:
        """Poll until no caller refs remain beyond prefix entries (a
        release can trail a delivery by a scheduler beat), then raise
        ``GraftsanError`` with provenance if leaks persist."""
        deadline = time.monotonic() + timeout
        leaks = self.graftsan_report()
        while leaks and time.monotonic() < deadline:
            time.sleep(0.01)
            leaks = self.graftsan_report()
        if leaks:
            lines = "; ".join(
                f"block {r['block']}: {r['leaked_refs']} leaked ref(s), "
                f"granted at {r['grant_sites']}" for r in leaks)
            raise GraftsanError(
                f"pool teardown leak: {len(leaks)} block(s) still hold "
                f"caller refs — {lines}")
        with self._lock:
            if self.sanitize:
                self._san_check_locked("teardown")

    # -- sizing --------------------------------------------------------------

    def blocks_for(self, n_slots: int) -> int:
        return max(0, -(-n_slots // self.block_size))

    # -- allocation ----------------------------------------------------------

    def _evictable_blocks_locked(self) -> int:
        return sum(1 for b, r in self._ref.items()
                   if r > 0 and r == self._prefix_ref.get(b, 0))

    def available(self) -> int:
        """Blocks obtainable now: free plus freeable by eviction."""
        with self._lock:
            return len(self._free) + self._evictable_blocks_locked()

    def _can_admit_locked(self, n_blocks: int) -> bool:
        """The admission predicate (availability and watermark), shared by
        ``can_admit`` and ``admit_alloc`` so that the two never drift."""
        if n_blocks > len(self._free) + self._evictable_blocks_locked():
            return False
        live = len(self._ref) - self._evictable_blocks_locked()
        return live + n_blocks <= self.watermark * self.num_blocks

    def can_admit(self, n_blocks: int) -> bool:
        """Would granting ``n_blocks`` keep referenced blocks within the
        watermark (after evicting prefix entries as needed)? Advisory:
        grants go through ``admit_alloc``."""
        with self._lock:
            if self.sanitize:
                self._san_check_locked("admission")
            return self._can_admit_locked(n_blocks)

    def _notify_freed(self, freed: List[int]) -> None:
        """Fire the poison hook for fully freed blocks, outside
        ``self._lock`` (the pool's writer takes ``_dev_lock``; the lock
        order is ``_dev_lock`` before ``_lock``)."""
        if freed and self._on_free is not None:
            self._on_free(freed)

    def _alloc_locked(self, n: int, site: str) -> Tuple[List[int],
                                                        List[int]]:
        """Grant ``n`` blocks at ref=1, evicting LRU prefix entries as
        needed -> (granted, freed by eviction and not re-taken)."""
        evict_freed: List[int] = []
        while len(self._free) < n and self._prefix:
            evict_freed.extend(self._evict_lru_locked())
        if len(self._free) < n:
            raise PoolExhausted(
                f"need {n} blocks, {len(self._free)} free and no "
                f"evictable prefix entries ({len(self._ref)} blocks "
                "referenced)")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        if self.sanitize:
            for b in out:
                self._san_grant_locked(b, site)
            self._san_check_locked("alloc")
        return out, [b for b in evict_freed if b not in self._ref]

    def _demote_pressure(self, n: int) -> None:
        """While granting ``n`` would force an LRU eviction and a tier is
        attached, ask it to demote the LRU prefix entry instead. Runs
        outside ``_lock`` (a demotion reads the device under the pool's
        ``_dev_lock``); ``_alloc_locked``'s eviction stays the fallback
        when the tier refuses. Each demotion removes one entry, so the
        loop ends."""
        hook = self._tier_demote
        if hook is None:
            return
        while True:
            with self._lock:
                pressed = len(self._free) < n and bool(self._prefix)
            if not pressed or not hook():
                return

    def alloc(self, n: int) -> List[int]:
        """Allocate ``n`` blocks at ref=1, demoting (with a tier) or
        evicting zero-ref prefix entries as needed. Raises
        ``PoolExhausted`` without taking any block when ``n`` cannot be
        satisfied."""
        if n == 0:
            return []
        self._demote_pressure(n)
        with self._lock:
            site = _call_site() if self.sanitize else ""
            out, evict_freed = self._alloc_locked(n, site)
        self._notify_freed(evict_freed)
        return out

    def admit_alloc(self, n: int) -> Optional[List[int]]:
        """Watermark admission and grant under one lock hold, so that no
        other pool user slips between the check and the grant. Returns
        the granted ids, or None when the watermark (or availability)
        refuses: the caller defers."""
        if n == 0:
            return []
        # a seeded pool-exhaustion spike refuses as a full pool would
        if graftfault.inject("kv_pool.admit_alloc", "pool_spike"):
            return None
        self._demote_pressure(n)
        evict_freed: List[int] = []
        with self._lock:
            if self.sanitize:
                self._san_check_locked("admission")
            if not self._can_admit_locked(n):
                return None
            site = _call_site() if self.sanitize else ""
            out, evict_freed = self._alloc_locked(n, site)
        self._notify_freed(evict_freed)
        return out

    def note_cow(self) -> None:
        """Count one copy-on-write block copy."""
        with self._lock:
            self.cow_copies += 1

    def ref(self, ids) -> None:
        with self._lock:
            site = _call_site() if self.sanitize else ""
            for b in ids:
                if b not in self._ref:
                    raise ValueError(f"ref of unallocated block {b}")
                self._ref[b] += 1
                if self.sanitize:
                    self._san_grant_locked(b, site)
            if self.sanitize:
                self._san_check_locked("ref")

    def free(self, ids) -> None:
        """Drop one ref per id; zero-ref blocks return to the free list.
        A double free raises (``GraftsanError`` with the earlier freeing
        site under the sanitizer)."""
        freed: List[int] = []
        with self._lock:
            site = _call_site() if self.sanitize else ""
            for b in ids:
                r = self._ref.get(b)
                if r is None:
                    if self.sanitize:
                        prior = self._san_freed.get(b)
                        raise GraftsanError(
                            f"double-free of block {b} at {site}: "
                            + (f"previously freed at {prior}" if prior
                               else "block was never allocated"))
                    raise ValueError(f"free of unallocated block {b}")
                if r == 1:
                    del self._ref[b]
                    self._free.append(b)
                    freed.append(b)
                    if self.sanitize:
                        self._san_drop_locked(b, site, fully_freed=True)
                else:
                    self._ref[b] = r - 1
                    if self.sanitize:
                        self._san_drop_locked(b, site, fully_freed=False)
            if self.sanitize:
                self._san_check_locked("free")
        self._notify_freed(freed)

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref.get(block, 0)

    # -- prefix registry -----------------------------------------------------

    def register_prefix(self, key: bytes, ids) -> None:
        """Register ``ids`` as the cached state for content ``key``. The
        entry takes its own ref on every block; re-registering a key only
        refreshes its recency."""
        with self._lock:
            if key in self._prefix:
                self._prefix.move_to_end(key)
                return
            ids = tuple(ids)
            site = f"prefix:{_call_site()}" if self.sanitize else ""
            for b in ids:
                if b not in self._ref:
                    raise ValueError(
                        f"register_prefix of unallocated block {b}")
                self._ref[b] += 1
                self._prefix_ref[b] = self._prefix_ref.get(b, 0) + 1
                if self.sanitize:
                    self._san_grant_locked(b, site)
            self._prefix[key] = ids
            if self.sanitize:
                self._san_check_locked("register_prefix")

    def lookup_prefix(self, key: bytes) -> Optional[Tuple[int, ...]]:
        """Hit -> the entry's block ids with one caller ref added per
        block (release with ``free``); miss -> None. Hits refresh
        recency."""
        with self._lock:
            ids = self._prefix.get(key)
            if ids is None:
                return None
            self._prefix.move_to_end(key)
            site = _call_site() if self.sanitize else ""
            for b in ids:
                self._ref[b] += 1
                if self.sanitize:
                    self._san_grant_locked(b, site)
            if self.sanitize:
                self._san_check_locked("lookup_prefix")
            return ids

    def has_prefix(self, key: bytes) -> bool:
        with self._lock:
            return key in self._prefix

    def drop_prefix(self, key: bytes) -> bool:
        freed: List[int] = []
        with self._lock:
            ids = self._prefix.pop(key, None)
            if ids is None:
                return False
            freed = self._deref_prefix_locked(ids)
            if self.sanitize:
                self._san_check_locked("drop_prefix")
        self._notify_freed(freed)
        return True

    def prefix_len(self) -> int:
        with self._lock:
            return len(self._prefix)

    # -- host-tier demotion (runtime/kv_tier.py) -----------------------------

    def lease_lru_prefix(self) -> Optional[Tuple[bytes, Tuple[int, ...]]]:
        """The LRU prefix entry with one caller ref per block, recency
        untouched: the tier's demote lease. The refs keep the blocks
        alive and immutable while the tier copies them out of the lock;
        release with ``free`` after ``demote_pop_prefix``. None when the
        registry is empty."""
        with self._lock:
            if not self._prefix:
                return None
            key = next(iter(self._prefix))
            ids = self._prefix[key]
            site = f"tier:{_call_site()}" if self.sanitize else ""
            for b in ids:
                self._ref[b] += 1
                if self.sanitize:
                    self._san_grant_locked(b, site)
            if self.sanitize:
                self._san_check_locked("tier_lease")
            return key, ids

    def demote_pop_prefix(self, key: bytes, expect_ids) -> bool:
        """Drop the entry for ``key`` as a demotion (the tier holds its
        bytes now): not an eviction, so ``evictions`` does not count it.
        False, touching nothing, when the entry vanished or was
        re-registered with other blocks since the lease."""
        expect = tuple(expect_ids)
        freed: List[int] = []
        with self._lock:
            if self._prefix.get(key) != expect:
                return False
            del self._prefix[key]
            freed = self._deref_prefix_locked(expect)
            if self.sanitize:
                self._san_check_locked("tier_demote")
        self._notify_freed(freed)
        return True

    def _deref_prefix_locked(self, ids) -> List[int]:
        freed: List[int] = []
        site = _call_site() if self.sanitize else ""
        for b in ids:
            self._prefix_ref[b] -= 1
            if self._prefix_ref[b] == 0:
                del self._prefix_ref[b]
            if self._ref[b] == 1:
                del self._ref[b]
                self._free.append(b)
                freed.append(b)
                if self.sanitize:
                    self._san_drop_locked(b, site, fully_freed=True)
            else:
                self._ref[b] -= 1
                if self.sanitize:
                    self._san_drop_locked(b, site, fully_freed=False)
        return freed

    def _evict_lru_locked(self) -> List[int]:
        key, ids = self._prefix.popitem(last=False)
        freed = self._deref_prefix_locked(ids)
        self.evictions += 1
        REGISTRY.inc("kv_pool_evictions_total")
        grafttime.emit("eviction", blocks=len(ids), freed=len(freed),
                       prefix_entries=len(self._prefix))
        if self.sanitize:
            self._san_check_locked("eviction")
        return freed

    def evict_lru(self) -> None:
        freed: List[int] = []
        with self._lock:
            if self._prefix:
                freed = self._evict_lru_locked()
        self._notify_freed(freed)

    # -- stats ---------------------------------------------------------------

    def stats(self) -> PoolStats:
        with self._lock:
            ev = self._evictable_blocks_locked()
            return PoolStats(
                blocks_total=self.num_blocks,
                blocks_free=len(self._free),
                blocks_in_use=len(self._ref),
                blocks_evictable=ev,
                prefix_entries=len(self._prefix),
                evictions=self.evictions,
                cow_copies=self.cow_copies)


class KVBlockPool:
    """The device block pool, its allocator and its movers.

    Full precision: ``data`` is one ``[L, num_blocks+1, 2, Hkv, bs, hd]``
    tensor in the engine's dtype (index ``num_blocks`` is the trash
    block). Quantized (``block_dtype`` "int8" or "fp8"): ``data`` holds
    the codes and ``scales`` ``[L, num_blocks+1, 2, Hkv]`` f32; a scatter
    quantizes, a gather dequantizes into ``dtype``. Both start as zeros:
    a masked slot gets softmax weight exactly 0, but a NaN in a trash
    block would still reach the value product as ``0 * NaN``. Every
    device write holds ``_dev_lock``.
    """

    def __init__(self, n_layer: int, num_blocks: int, n_kv_head: int,
                 block_size: int, head_dim: int, max_seq: int,
                 dtype: torch.dtype = torch.float32, watermark: float = 0.9,
                 sanitize: Optional[bool] = None,
                 block_dtype: Optional[str] = None,
                 device: DeviceLike = None):
        self.nbm = PA.blocks_per_row(max_seq, block_size)
        if num_blocks < self.nbm:
            raise ValueError(
                f"num_blocks={num_blocks} cannot hold even one full "
                f"row ({self.nbm} blocks at max_seq={max_seq}, "
                f"block_size={block_size}) — nothing could ever decode "
                "to budget")
        self.block_size = block_size
        self.max_seq = max_seq
        self.trash = num_blocks
        self.dtype = dtype
        self.device = resolve_device(device)
        # the knob through the regime vocabulary (a typo fails there),
        # then full-precision spellings refused: such a pool already
        # stores blocks in the engine dtype
        self.block_dtype: Optional[str] = None
        if block_dtype:
            regime = regime_of(block_dtype)
            if regime not in KVQ.STORAGE_DTYPES:
                raise ValueError(
                    f"block_dtype={block_dtype!r} is the full-precision "
                    f"regime {regime!r} — the pool already stores blocks "
                    "in the engine dtype there; quantized storage takes "
                    f"one of {sorted(KVQ.STORAGE_DTYPES)}")
            if regime == "fp8" and not KVQ.fp8_supported():
                raise ValueError(
                    "block_dtype='fp8' requires float8_e4m3fn support "
                    "(ops.kv_quant.fp8_supported() is False) — use "
                    "'int8' here")
            self.block_dtype = regime
        self.block_regime = self.block_dtype or _REGIME_LABELS.get(
            dtype, str(dtype).replace("torch.", ""))
        self.allocator = BlockAllocator(num_blocks, block_size,
                                        watermark=watermark,
                                        sanitize=sanitize)
        shape = PA.pool_shape(n_layer, num_blocks, n_kv_head, block_size,
                              head_dim)
        if self.block_dtype is not None:
            self.data = torch.zeros(
                shape, dtype=KVQ.STORAGE_DTYPES[self.block_dtype],
                device=self.device)
            self.scales = torch.zeros(
                KVQ.scales_shape(n_layer, num_blocks, n_kv_head),
                dtype=torch.float32, device=self.device)
            self._scatter_fn = {"int8": KVQ.scatter_kv_int8,
                                "fp8": KVQ.scatter_kv_fp8}[self.block_dtype]
        else:
            self.data = torch.zeros(shape, dtype=dtype, device=self.device)
            self.scales = None
        # the host spill tier below this pool (``attach_tier``); None:
        # cold prefix entries are evicted
        self.tier = None
        self._bytes_per_block = bytes_per_block(
            n_layer, n_kv_head, block_size, head_dim, dtype,
            self.block_dtype)
        self._dev_lock = graftsched.rlock("kv_pool.KVBlockPool._dev_lock")
        graftmem.track(self, "data", "pool_codes", self.data)
        if self.scales is not None:
            graftmem.track(self, "scales", "pool_scales", self.scales)
        if self.allocator.sanitize:
            self.allocator._on_free = self._graftsan_poison

    # -- movers (the caller holds _dev_lock) ---------------------------------

    def _gather_impl(self, tables):
        if self.block_dtype is not None:
            return KVQ.gather_kv_q(self.data, self.scales, tables, self.dtype)
        return PA.gather_kv(self.data, tables)

    def _scatter_impl(self, k, v, tables) -> None:
        if self.block_dtype is not None:
            self._scatter_fn(self.data, self.scales, k, v, tables)
        else:
            PA.scatter_kv(self.data, k, v, tables)

    # the movers timed into their graftscope rings by table shape
    _gather_timed = graftscope.instrument(
        _gather_impl, "kv_pool._gather",
        key_fn=lambda tables: tuple(np.asarray(tables).shape))
    _scatter_timed = graftscope.instrument(
        _scatter_impl, "kv_pool._scatter",
        key_fn=lambda k, v, tables: tuple(np.asarray(tables).shape))

    def _copy(self, src, dst) -> None:
        if self.block_dtype is not None:
            KVQ.copy_blocks_q(self.data, self.scales, src, dst)
        else:
            PA.copy_blocks(self.data, src, dst)

    # -- graftsan (GRAFTSAN=1) -----------------------------------------------

    def _graftsan_poison(self, ids: List[int]) -> None:
        """``BlockAllocator._on_free`` hook: overwrite each fully freed
        block with the trash block (codes and scale alike). The trap
        itself is the host-side table check in every mover."""
        with self._dev_lock:
            for b in ids:
                if self.allocator.refcount(b) > 0:
                    continue  # re-allocated between free and poison
                self._copy([self.trash], [b])

    def _graftsan_check_tables(self, tables, op: str,
                               write: bool = False) -> None:
        """Use-after-free trap: every id a mover touches is the trash
        block or a live allocation; a write also traps on a shared block
        (refcount > 1: ``cow_copy`` first)."""
        alloc = self.allocator
        for b in {int(x) for x in np.asarray(tables).reshape(-1)}:
            if b == self.trash:
                continue
            if not 0 <= b < alloc.num_blocks:
                raise GraftsanError(
                    f"{op} touches out-of-range block id {b} "
                    f"(pool has {alloc.num_blocks} blocks)")
            refs = alloc.refcount(b)
            if refs == 0:
                site = alloc.freed_provenance(b)
                raise GraftsanError(
                    f"use-after-free: {op} touches poisoned block {b}"
                    + (f", freed at {site}" if site
                       else ", which was never allocated"))
            if write and refs > 1:
                with alloc._lock:
                    sites = list(alloc._san_owner.get(b, []))
                raise GraftsanError(
                    f"CoW violation: {op} writes shared block {b} "
                    f"(refcount {refs}, granted at {sites}) without a "
                    "private copy — shared blocks are immutable; "
                    "cow_copy before the first write")

    @classmethod
    def for_engine(cls, engine: DecodeEngine, num_blocks: int,
                   block_size: int = DEFAULT_KV_BLOCK_SIZE,
                   watermark: float = 0.9,
                   sanitize: Optional[bool] = None,
                   block_dtype: Optional[str] = None,
                   device: DeviceLike = None) -> "KVBlockPool":
        """A pool matching an engine's cache geometry, on the engine's
        device (the engine as ``check_engine`` takes it)."""
        cls.check_engine(engine)
        dev = engine.device if device is None else torch.device(device)
        if dev != engine.device:
            raise ValueError(
                f"pool device {dev} differs from the engine's "
                f"{engine.device}: gathered views feed the engine's own "
                "decode, on its device")
        cfg = engine.config
        heads = getattr(cfg, "n_kv_head", cfg.n_head)
        return cls(cfg.n_layer, num_blocks, heads, block_size,
                   cfg.head_dim, engine._cache_seq, dtype=engine.dtype,
                   watermark=watermark, sanitize=sanitize,
                   block_dtype=block_dtype, device=dev)

    @staticmethod
    def check_engine(engine: DecodeEngine) -> None:
        """Refuse an engine the paged path cannot drive. It runs the
        engine's own decode on gathered views, so the engine must keep
        the plain single-device layout: no decode kernel (fused in-place
        cache), no stages, no chunked prefill."""
        if engine.decode_kernel is not None:
            raise NotImplementedError(
                "KV pool paging drives the XLA cache layout; the Pallas "
                "decode kernel owns its fused in-place cache "
                "(decode_kernel='xla' composes)")
        if engine.specs is not None:
            raise NotImplementedError(
                "KV pool paging covers the unstaged engine; staged "
                "per-stage cache lists are not paged")
        if engine.prefill_chunk:
            raise NotImplementedError(
                "KV pool paging prefills monolithically (one scatter per "
                "admission); build the engine without prefill_chunk")

    # -- device ops (all under _dev_lock) ------------------------------------

    def gather(self, tables: np.ndarray, length: int) -> KVCache:
        """A contiguous working cache for the tabled rows (fresh tensors,
        which the engine's decode writes in place); ``length`` is the
        logical depth the caller tracks."""
        with self._dev_lock:
            if self.allocator.sanitize:
                self._graftsan_check_tables(tables, "gather")
            k, v = self._gather_timed(tables)
        return KVCache(k=k, v=v, length=int(length))

    def scatter(self, cache: KVCache, tables: np.ndarray) -> None:
        with self._dev_lock:
            if self.allocator.sanitize:
                self._graftsan_check_tables(tables, "scatter", write=True)
            self._scatter_timed(cache.k, cache.v, tables)

    def scatter_columns(self, cache: KVCache, tables: np.ndarray,
                        nb_lo: int) -> None:
        """Scatter only table columns ``[nb_lo, NBm)`` of a full-width
        cache: a privately owned tail behind a shared (immutable)
        prefix."""
        bs = self.block_size
        sub = KVCache(k=cache.k[..., nb_lo * bs:, :],
                      v=cache.v[..., nb_lo * bs:, :], length=cache.length)
        self.scatter(sub, np.asarray(tables)[:, nb_lo:])

    def scatter_row(self, cache: KVCache, table_row: np.ndarray,
                    roll: int) -> None:
        """Merge one solo-prefilled row (content at ``[sp - plen, sp)``)
        into its blocks at logical ``[d - plen, d)`` (``roll = d - sp``;
        what wraps around lands in masked pad slots)."""
        k = torch.roll(cache.k, roll, dims=-2)
        v = torch.roll(cache.v, roll, dims=-2)
        with self._dev_lock:
            if self.allocator.sanitize:
                self._graftsan_check_tables(table_row, "scatter_row",
                                            write=True)
            self._scatter_impl(k, v, np.asarray(table_row)[None])

    def attach_tier(self, tier) -> None:
        """Wire a host tier (``runtime.kv_tier.HostKVTier``) below this
        pool: allocation pressure demotes cold prefix entries into it
        instead of evicting them, and the prefix store promotes them
        back on a hit."""
        self.tier = tier
        # weakly: a cycle through the allocator would keep a dropped pool
        # (and its ledger holdings) alive until a collection
        pool = weakref.ref(self)
        self.allocator._tier_demote = lambda: tier.demote_lru(pool())

    def spill_blocks(self, ids) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
        """Host copies of the raw planes of blocks ``ids``: codes ``[L,
        n, 2, Hkv, bs, hd]`` in the storage dtype, plus the ``[L, n, 2,
        Hkv]`` f32 scales of a quantized pool (None at full precision).
        Codes spill as codes, never dequantized, so a round trip is bit
        exact. The copy into host memory (pinned when the pool is on
        CUDA) is synchronous: the tensors are complete on return."""
        idx = torch.as_tensor(np.asarray(ids, dtype=np.int64),
                              device=self.device)
        pin = self.device.type == "cuda"
        with self._dev_lock:
            if self.allocator.sanitize:
                self._graftsan_check_tables(np.asarray(ids), "spill_blocks")
            planes = [self.data] + ([self.scales]
                                    if self.scales is not None else [])
            out = []
            for plane in planes:
                picked = _bytes_of(plane).index_select(1, idx)
                host = torch.empty(picked.shape, dtype=picked.dtype,
                                   pin_memory=pin)
                host.copy_(picked)
                out.append(host.view(plane.dtype))
        return out[0], (out[1] if len(out) > 1 else None)

    def fill_blocks(self, ids, codes: torch.Tensor,
                    scales: Optional[torch.Tensor] = None) -> None:
        """Write spilled raw blocks back into freshly allocated ``ids``
        (the tier's promote): the same plane slots a scatter fills, byte
        for byte what ``spill_blocks`` captured. The targets must be
        privately owned (GRAFTSAN traps a shared one)."""
        idx = torch.as_tensor(np.asarray(ids, dtype=np.int64),
                              device=self.device)
        with self._dev_lock:
            if self.allocator.sanitize:
                self._graftsan_check_tables(np.asarray(ids), "fill_blocks",
                                            write=True)
            _bytes_of(self.data).index_copy_(1, idx, _bytes_of(
                codes.to(self.device, self.data.dtype)))
            if self.scales is not None:
                self.scales.index_copy_(1, idx, scales.to(
                    self.device, self.scales.dtype))

    def cow_copy(self, src: int) -> int:
        """Copy-on-write: allocate a private block, copy ``src`` into it,
        return the new id. The caller retargets its table entry and drops
        its own ref on ``src``."""
        if self.allocator.sanitize:
            self._graftsan_check_tables(np.asarray([src]), "cow_copy")
        dst = self.allocator.alloc(1)[0]
        with self._dev_lock:
            self._copy([src], [dst])
        self.allocator.note_cow()
        REGISTRY.inc("kv_pool_cow_copies_total")
        return dst

    # -- observability -------------------------------------------------------

    def note_gauges(self, component: str = "pool") -> None:
        st = self.allocator.stats()
        in_use = st.blocks_in_use - st.blocks_evictable
        labels = dict(component=component, block_dtype=self.block_regime)
        REGISTRY.gauge("kv_cache_blocks_in_use", in_use, **labels)
        REGISTRY.gauge("kv_cache_blocks_total", st.blocks_total, **labels)
        REGISTRY.gauge("kv_pool_bytes_per_block", self._bytes_per_block,
                       **labels)
        graftscope.sample("kv_cache_blocks_in_use", in_use, **labels)
        if self.tier is not None:
            self.tier.note_gauges(component=component)

    def stats(self) -> dict:
        out = {**self.allocator.stats().as_dict(),
               "block_size": self.block_size,
               "blocks_per_row": self.nbm,
               "block_dtype": self.block_regime,
               "bytes_per_block": self._bytes_per_block,
               "graftsan": self.allocator.sanitize}
        if self.tier is not None:
            out["tier"] = self.tier.stats()
        return out


class PagedKVRunner:
    """Solo or ragged paged ``generate``: the engine's own forwards on
    pool-backed storage, with ``DecodeEngine.generate``'s calling
    convention. An fp32 stream equals the contiguous engine's byte for
    byte; a quantized pool's within ``kv.int8`` / ``kv.fp8``.

    With ``prefix`` (a pool-backed ``PrefixCachingEngine`` over the same
    engine and pool) a solo prompt prefills only what the store lacks
    and shares the store's full blocks in its own table; only the
    partly filled frontier block is copied on write.
    """

    def __init__(self, engine: DecodeEngine, pool: KVBlockPool,
                 prefix=None):
        if pool.max_seq != engine._cache_seq:
            raise ValueError(
                f"pool rows span {pool.max_seq} slots, engine cache is "
                f"{engine._cache_seq} — gathered views must match the "
                "compiled programs' cache width exactly")
        if engine.prefill_chunk:
            raise NotImplementedError(
                "PagedKVRunner prefills monolithically (one scatter per "
                "admission); build the engine without prefill_chunk")
        if prefix is not None:
            if prefix.plain is not engine:
                raise ValueError("prefix must wrap the same DecodeEngine")
            if getattr(prefix, "_pool", None) is not pool:
                raise ValueError(
                    "prefix store must be backed by the same pool "
                    "(pass pool= to PrefixCachingEngine) — block "
                    "sharing is the point")
        self.engine = engine
        self.pool = pool
        self.prefix = prefix
        # one generation at a time: the allocator's alloc/free pairs of
        # two generates must not interleave
        self._gen_lock = graftsched.lock("kv_pool.PagedKVRunner._gen_lock")

    @torch.inference_mode()
    def generate(self, prompt_ids, max_new_tokens: int,
                 sampling: SamplingConfig = SamplingConfig(),
                 generator: Generators = None,
                 pad: Optional[np.ndarray] = None,
                 eos_id: Optional[int] = None) -> GenerateResult:
        eng = self.engine
        ids, batch, prompt_len, pad = prepare_generate(
            prompt_ids, max_new_tokens, eng.max_seq, sampling, generator,
            pad=pad)
        alloc = self.pool.allocator
        with self._gen_lock:
            t0 = time.perf_counter()
            pad_t = eng._pad(pad)
            last, tables, owned, shared = self._prefill_tables(
                ids, batch, prompt_len, max_new_tokens, pad, pad_t)
            try:
                token = select_token(last, sampling, generator)
                _sync(eng.device)
                t1 = time.perf_counter()
                tracing.record("prefill", t0, t1, batch=batch,
                               prompt_len=prompt_len, paged=True)
                self.pool.note_gauges(component="paged")
                # columns below every row's shared prefix hold registry
                # blocks, which are immutable: each segment scatters the
                # owned tail only
                nb_lo = min(len(s) for s in shared)
                return self._decode(ids, pad, pad_t, token, tables,
                                    max_new_tokens, sampling, generator,
                                    prompt_len, t1 - t0, eos_id, nb_lo)
            finally:
                for row_ids in owned + shared:
                    alloc.free(row_ids)
                self.pool.note_gauges(component="paged")

    def _prefill_tables(self, ids, batch, prompt_len, max_new, pad, pad_t):
        """Prefill (through the prefix store for a solo unpadded prompt,
        when one is attached), allocate each row's blocks, scatter the
        state. Returns ``(last logits [B, V], tables [B, NBm], owned ids
        per row, shared ids per row)``; a row's table entries past its
        blocks are trash."""
        eng, pool = self.engine, self.pool
        alloc = pool.allocator
        bs = pool.block_size
        need = alloc.blocks_for(prompt_len + max_new)
        tables = np.full((batch, pool.nbm), pool.trash, dtype=np.int32)
        owned: List[List[int]] = []
        shared: List[List[int]] = []
        frontier: List[int] = []
        try:
            if self.prefix is not None and batch == 1 and not pad.any():
                last, cache, keep_ids, hit_depth = \
                    self.prefix.prefill_shared(ids[0])
                # full blocks stay shared; the partly filled frontier
                # block is copied on write (this row writes into it)
                n_full = hit_depth // bs
                row_shared = list(keep_ids[:n_full])
                shared.append(row_shared)
                row_owned: List[int] = []
                owned.append(row_owned)
                frontier = list(keep_ids[n_full:])
                while frontier:
                    row_owned.append(pool.cow_copy(frontier[0]))
                    alloc.free([frontier.pop(0)])
                row_owned.extend(alloc.alloc(need - n_full - len(row_owned)))
                tables[0, :n_full] = row_shared
                tables[0, n_full:need] = row_owned
                # only the owned tail: the shared blocks hold these bytes
                pool.scatter_columns(cache, tables, n_full)
            else:
                logits, cache = eng._prefill(eng._ids(ids), pad_t)
                last = logits[:, -1]
                for b in range(batch):
                    row = alloc.alloc(need)
                    tables[b, :need] = row
                    owned.append(row)
                    shared.append([])
                pool.scatter(cache, tables)
        except BaseException:
            # all-or-nothing: a failure mid-placement returns every ref
            # taken so far
            for row_ids in owned + shared:
                alloc.free(row_ids)
            alloc.free(frontier)
            raise
        return last, tables, owned, shared

    def _decode(self, ids, pad, pad_t, token, tables, max_new_tokens,
                sampling, generator, prompt_len, prefill_seconds,
                eos_id, nb_lo: int = 0) -> GenerateResult:
        """``DecodeEngine.generate``'s decode loop, each EOS-check chunk
        one segment: gather, the engine's ``_decode_seg``, scatter of the
        table columns from ``nb_lo`` on."""
        eng = self.engine
        t1 = time.perf_counter()
        parts = [token[:, None]]
        depth = prompt_len
        done = None if eos_id is None else (token == eos_id)
        if done is None or not bool(done.all()):
            for take in eos_chunks(max_new_tokens - 1):
                working = self.pool.gather(tables, depth)
                out, working = eng._decode_seg(token, working, pad_t, take,
                                               sampling, generator)
                self.pool.scatter_columns(working, tables, nb_lo)
                token = out[:, -1]
                parts.append(out)
                depth += take
                if done is not None:
                    done |= (out == eos_id).any(dim=1)
                    if bool(done.all()):
                        break
        new = torch.cat(parts, dim=1).cpu().numpy().copy()
        t2 = time.perf_counter()
        tracing.record("decode", t1, t2, batch=new.shape[0],
                       steps=new.shape[1], paged=True,
                       blocks_held=int((tables != self.pool.trash).sum()))
        return GenerateResult(tokens=np.concatenate([ids, new], axis=1),
                              prompt_len=prompt_len,
                              prefill_seconds=prefill_seconds,
                              decode_seconds=t2 - t1,
                              new_tokens=new.shape[1],
                              decode_steps=new.shape[1] - 1,
                              pad=pad if pad.any() else None)
