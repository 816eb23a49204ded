"""Prefix caching: cross-request KV reuse for shared prompt prefixes.

Counterpart of ``llm_sharding_demo_tpu/runtime/prefix_cache.py``. The
store keeps KV states at chunk boundaries and, on a prefix hit, prefills
only the suffix:

- **Right-aligned chunking.** The prompt is split from the LEFT edge into
  ``chunk``-wide pieces plus a ragged tail, at true positions with no
  pad, so a prefix's KV state is the same whatever follows it. Entries
  are keyed by the int32 bytes of the first ``m`` chunks (the JAX
  package's key, byte for byte) in LRU order; a lookup walks from the
  deepest candidate prefix to the shallowest and extends the deepest
  stored state chunk by chunk (``_prefill_walk``).
- **Copies.** The port's caches are written in place (``ops.attention``),
  so a stored entry must never be the cache a walk extends: ``_insert``
  stores a clone, and a hit extends a clone of the entry. Every cache
  form the engine makes is covered: the plain ``KVCache``, the fused
  kernel-mode cache (``[L, 1, Hkv, cache_seq, 2*hd]`` with an empty
  ``v``) and the staged engine's list of per-stage caches.
- **Pool mode** (``pool=``, a ``runtime.kv_pool.KVBlockPool``): entries
  are ref-counted block ids in the allocator's content-keyed registry.
  Entries that extend each other share their common blocks, eviction is
  the allocator's LRU, an attached host tier (``runtime.kv_tier``)
  demotes the LRU entry before eviction and promotes it back on a hit,
  and ``PagedKVRunner`` references entry blocks zero-copy
  (``prefill_shared``). A hit gathers the entry into a fresh cache.

A hit replays the cold path's forwards on the same state, so greedy
streams are byte-identical with the cache on or off. Single-stream
(``generate`` takes batch 1); the batchers compose through
``prefill_state``. Two locks: ``_lock`` serializes device work, and
``_store_lock`` guards only the store and its counters, so ``stats()``
(the ``/healthz`` read) never waits behind a generation. With a
speculative engine (``spec=``, a ``SpecDecodeEngine`` over the same
engine) a request it admits (``spec.eligible``) decodes through
``spec.run_loop`` off the walk's cache; the others decode plain.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from ..models import is_window_independent
from ..ops.attention import KVCache
from ..utils import graftmem, graftsched, graftscope, tracing
from ..utils.metrics import REGISTRY
from .engine import (DecodeEngine, GenerateResult, Generators,
                     SamplingConfig, _sync, prepare_generate, select_token)

def clone_cache(cache):
    """An independent copy of an engine cache (plain, fused or a staged
    list): what the store keeps, and what a hit extends."""
    if isinstance(cache, list):
        return [clone_cache(c) for c in cache]
    return KVCache(k=cache.k.clone(), v=cache.v.clone(), length=cache.length)


def _extend_scope_key(cache, ids):
    return tuple(ids.shape)


class PrefixCachingEngine:
    """Wraps a ``DecodeEngine`` with a chunk-aligned KV prefix cache.

    ``capacity`` bounds resident entries (each a full-width cache copy in
    the engine dtype, or a set of pool blocks); ``chunk`` is the
    alignment width: prefixes are cached at multiples of it.
    """

    def __init__(self, engine: DecodeEngine, capacity: int = 4,
                 chunk: int = 64, spec=None, pool=None):
        if not is_window_independent(engine.config):
            raise NotImplementedError(
                "prefix caching replays the prompt in chunk windows; MoE "
                "capacity-factor routing is window-dependent, so the "
                "cached path would not be token-exact — serve MoE with "
                "the plain engine")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        if spec is not None and spec.plain is not engine:
            raise ValueError("spec must wrap the same DecodeEngine (shared "
                             "weights/programs), got a different instance")
        if pool is not None and pool.max_seq != engine._cache_seq:
            raise ValueError(
                f"pool rows span {pool.max_seq} slots, engine cache is "
                f"{engine._cache_seq}; gathered entries must match the "
                "extend programs' cache width")
        self._eng = engine
        self.spec = spec
        self._pool = pool
        self.capacity = capacity
        self.chunk = chunk
        self._store: "OrderedDict[bytes, object]" = OrderedDict()
        # store key -> graftmem handle of the entry's bytes (no pool)
        self._mem_handles: dict = {}
        self._lock = graftsched.lock("prefix_cache.PrefixCachingEngine._lock")
        self._store_lock = graftsched.lock(
            "prefix_cache.PrefixCachingEngine._store_lock")
        self.hits = 0
        self.misses = 0
        self._extend = graftscope.instrument(
            lambda cache, ids: engine._forward_cached(ids, cache, None),
            "prefix_cache._extend", key_fn=_extend_scope_key)

    @property
    def plain(self) -> DecodeEngine:
        return self._eng

    @staticmethod
    def _key(prompt: np.ndarray, m_chunks: int, chunk: int) -> bytes:
        """The store key: the int32 bytes of the first ``m_chunks``
        chunks (the JAX package's key for the same tokens)."""
        return np.ascontiguousarray(
            prompt[:m_chunks * chunk], dtype=np.int32).tobytes()

    def _lookup(self, prompt: np.ndarray) -> Tuple[int, Optional[object]]:
        """Longest cached prefix of ``prompt`` -> ``(n_chunks_hit,
        entry)``. Store entries are caches; pool entries are block-id
        tuples with one caller ref per block (release with
        ``allocator.free``). A demoted pool entry is promoted from the
        host tier; a refused promote walks on to shallower depths."""
        m_max = (len(prompt) - 1) // self.chunk  # leave >= 1 token
        if self._pool is not None:
            tier = self._pool.tier
            for m in range(m_max, 0, -1):
                key = self._key(prompt, m, self.chunk)
                ids = self._pool.allocator.lookup_prefix(key)
                if ids is None and tier is not None and tier.has(key):
                    ids = tier.promote(self._pool, key)
                if ids is not None:
                    return m, ids
            return 0, None
        with self._store_lock:
            for m in range(m_max, 0, -1):
                key = self._key(prompt, m, self.chunk)
                entry = self._store.get(key)
                if entry is not None:
                    self._store.move_to_end(key)
                    return m, entry
        return 0, None

    def _gather_entry(self, ids, depth: int) -> KVCache:
        """Pool mode: an entry's blocks gathered into a fresh full-width
        cache (trash past the entry, where every slot is masked)."""
        table = np.full((1, self._pool.nbm), self._pool.trash, np.int32)
        table[0, :len(ids)] = ids
        return self._pool.gather(table, depth)

    def _insert_pool(self, prompt: np.ndarray, m_total: int, cache,
                     hit_ids, m_hit: int) -> None:
        """Pool-mode insert: the new entry shares the hit entry's full
        blocks and takes fresh ones for the rest (the frontier region is
        scattered from the walk cache into a fresh block: registry
        blocks stay immutable). A full pool skips the insert and does
        not fail the request. The capacity trim demotes the LRU entry to
        an attached tier, and evicts it only when no tier takes it."""
        from .kv_pool import PoolExhausted
        alloc = self._pool.allocator
        key = self._key(prompt, m_total, self.chunk)
        if alloc.has_prefix(key):
            return
        bs = self._pool.block_size
        nb_new = alloc.blocks_for(m_total * self.chunk)
        n_share = (m_hit * self.chunk) // bs if hit_ids else 0
        share = list(hit_ids[:n_share]) if hit_ids else []
        try:
            fresh = alloc.alloc(nb_new - n_share)
        except PoolExhausted:
            return
        try:
            table = np.full((1, self._pool.nbm), self._pool.trash, np.int32)
            table[0, :n_share] = share
            table[0, n_share:nb_new] = fresh
            self._pool.scatter_columns(cache, table, n_share)
            alloc.register_prefix(key, share + fresh)
        finally:
            # the entry's own refs (if registered) keep the blocks; on a
            # scatter or register failure this returns them
            alloc.free(fresh)
        while alloc.prefix_len() > self.capacity:
            tier = self._pool.tier
            if tier is None or not tier.demote_lru(self._pool):
                alloc.evict_lru()

    def _insert(self, prompt: np.ndarray, m_chunks: int, cache) -> None:
        """Store a clone of ``cache`` as the state after ``m_chunks``
        full chunks of ``prompt`` (no-op if present)."""
        if m_chunks < 1:
            return
        key = self._key(prompt, m_chunks, self.chunk)
        with self._store_lock:
            if key in self._store:
                self._store.move_to_end(key)
                return
        entry = clone_cache(cache)
        dropped = []
        with self._store_lock:
            if key in self._store:
                return
            self._store[key] = entry
            self._mem_handles[key] = graftmem.track(
                self, "_store", "prefix_store", entry)
            while len(self._store) > self.capacity:
                old, _ = self._store.popitem(last=False)
                dropped.append(self._mem_handles.pop(old, 0))
        for handle in dropped:
            graftmem.release(handle)

    def _prefill_walk(self, prompt: np.ndarray) -> Tuple[torch.Tensor,
                                                         object, int]:
        """Store-aware chunk-aligned prefill of one prompt row:
        ``(logits [1, S_tail, V], cache, reused tokens)``. The caller
        holds ``self._lock`` and ``torch.inference_mode``. The cache
        returned is the caller's: never a stored entry."""
        eng = self._eng
        m_hit, entry = self._lookup(prompt)
        hit_ids = None
        if entry is not None:
            with self._store_lock:
                self.hits += 1
            REGISTRY.inc("prefix_cache_hits_total")
            REGISTRY.inc("prefix_cache_reused_tokens_total",
                         value=m_hit * self.chunk)
            # the hit depth on the enclosing prefill span
            tracing.annotate_span(prefix_hit=True,
                                  reused_tokens=m_hit * self.chunk)
            if self._pool is not None:
                hit_ids = entry
                try:
                    cache = self._gather_entry(hit_ids, m_hit * self.chunk)
                except BaseException:
                    self._pool.allocator.free(hit_ids)
                    raise
            else:
                cache = clone_cache(entry)
        else:
            with self._store_lock:
                self.misses += 1
            REGISTRY.inc("prefix_cache_misses_total")
            tracing.annotate_span(prefix_hit=False)
            cache = eng._fresh_cache(1)

        # extend chunk by chunk, inserting the deepest full-chunk state
        # before the ragged tail writes past it
        m_total = (len(prompt) - 1) // self.chunk
        try:
            for m in range(m_hit, m_total):
                piece = eng._ids(prompt[None, m * self.chunk:
                                        (m + 1) * self.chunk])
                _, cache = self._extend(cache, piece)
            if m_total > m_hit:
                if self._pool is not None:
                    self._insert_pool(prompt, m_total, cache, hit_ids,
                                      m_hit)
                else:
                    self._insert(prompt, m_total, cache)
        finally:
            # the lookup's caller refs must not outlive the walk, even
            # when a step raises: a phantom ref would pin the entry
            if hit_ids is not None:
                self._pool.allocator.free(hit_ids)
        logits, cache = self._extend(
            cache, eng._ids(prompt[None, m_total * self.chunk:]))
        return logits, cache, m_hit * self.chunk

    def _walk_traced(self, prompt: np.ndarray):
        """``_prefill_walk`` inside its ``prefill`` span on the ambient
        trace (the walk labels the hit depth)."""
        with tracing.span("prefill", prefix=True, prompt_len=len(prompt)):
            logits, cache, _ = self._prefill_walk(prompt)
        return logits, cache

    @torch.inference_mode()
    def prefill_state(self, prompt: np.ndarray):
        """Single-row prefill for the batchers: ``(last_logits [1, V],
        cache, prompt_len)`` with the store consulted and updated. The
        cache is right-aligned (content at ``[0, prompt_len)``) and the
        caller's to write."""
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        with self._lock:
            logits, cache = self._walk_traced(prompt)
        return logits[:, -1], cache, len(prompt)

    @torch.inference_mode()
    def prefill_shared(self, prompt: np.ndarray):
        """The paged runner's entry (pool mode only): walk the store,
        then return ``(last_logits [1, V], cache, shared_ids,
        hit_depth)``, where ``shared_ids`` are the blocks of the deepest
        entry now covering the prompt (one the walk inserted included),
        one caller ref each: the runner references them in its own
        table and frees them at retirement."""
        if self._pool is None:
            raise ValueError("prefill_shared requires a pool-backed "
                             "store (pass pool= at construction)")
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        with self._lock:
            logits, cache = self._walk_traced(prompt)
            m, ids = self._lookup(prompt)
        return logits[:, -1], cache, list(ids or ()), m * self.chunk

    @torch.inference_mode()
    def generate(self, prompt_ids, max_new_tokens: int,
                 sampling: SamplingConfig = SamplingConfig(),
                 generator: Generators = None) -> GenerateResult:
        """One prompt (``[S]`` or ``[1, S]``) through the store, then the
        speculative verify loop where ``spec`` admits the request, else
        the engine's decode loop (``DecodeEngine._decode_and_pack``).
        The walk's cache is a fresh one or a clone, the loop's to
        write."""
        eng = self._eng
        ids, batch, prompt_len, pad = prepare_generate(
            prompt_ids, max_new_tokens, eng.max_seq, sampling, generator,
            allow_ragged=False)
        if batch != 1:
            raise ValueError("prefix caching is single-stream (batch=1); "
                             "batched throughput goes through "
                             "DecodeEngine / runtime.batcher")
        with self._lock:
            t0 = time.perf_counter()
            with tracing.span("prefill", prefix=True, prompt_len=prompt_len):
                logits, cache, _ = self._prefill_walk(ids[0])
                first = select_token(logits[:, -1], sampling, generator)
                _sync(eng.device)
            prefill_seconds = time.perf_counter() - t0
            if self.spec is not None and self.spec.eligible(prompt_len,
                                                            max_new_tokens):
                # the walk's cache is right-aligned with true positions
                # and no pad, the state the verify loop starts from
                return self.spec.run_loop(
                    ids[0], first, cache, prompt_len, generator,
                    max_new_tokens, sampling,
                    prefill_seconds=prefill_seconds)
            return eng._decode_and_pack(ids, pad, None, first, cache,
                                        max_new_tokens, sampling, generator,
                                        prompt_len, prefill_seconds)

    def stats(self) -> dict:
        with self._store_lock:
            entries = (self._pool.allocator.prefix_len()
                       if self._pool is not None else len(self._store))
            out = {"entries": entries, "hits": self.hits,
                   "misses": self.misses, "capacity": self.capacity,
                   "chunk": self.chunk}
            if self._pool is not None:
                out["pooled"] = True
            return out
