"""Iteration-level continuous batching: joins and retirements at segment
boundaries, on contiguous caches or on the paged pool.

Counterpart of ``llm_sharding_demo_tpu/runtime/iterbatch.py``.
``runtime.batcher`` batches
at admission and runs each round to its end; here the decode runs as
segments of ``seg_steps`` steps (``DecodeEngine._decode_seg``), and
between two segments the scheduler

- **admits** queued requests into free rows: a solo prefill at a
  bucketed length, whose K/V is copied into the live cache so that the
  row's content ends at the batch's current depth d (content at
  ``[d - plen, d)``, pad ``d - plen``: what a solo run's cache holds,
  shifted; ``_admit_cache``);
- **retires** rows that reached ``max_new_tokens`` or emitted their
  ``eos_id``, freeing the row for the next join.

Exactness is the admission batcher's, per row: a greedy row equals its
solo run, since attention is row-independent and masks the left pad; a
seeded sampled row is byte-equal to its solo run, since each row draws
from its own request's generator, once a step, and ghost rows draw
nothing (``engine.select_token``).

Batches are policy-pure (one ``SamplingConfig`` per live batch); an
incompatible arrival closes admission and seeds the next batch, FIFO
kept. A batch runs at the smallest power-of-two width that fits it and
grows when an arrival finds no free row (``_grow``); ghost rows copy
row 0. Past 16 rows a decode step leaves the megakernels for the
per-layer kernels (``models.gpt2.mega_step``).

Degraded mode: a ``graftfault.TransientFault`` at a segment parks every
live row and resumes it by recompute (a re-prefill of prompt plus
emitted tokens), at most ``FAULT_PARK_BUDGET`` times a row; deadlines and
caller timeouts cancel a row at the next boundary.

Paged KV (``pool=``, ``runtime.kv_pool``): between segments the rows'
K/V live in ref-counted pool blocks (block tables, pad-prefix entries on
the trash block) instead of a ``[B, max_seq]`` cache; each segment
gathers the tables into a contiguous cache, runs the same segment and
scatters it back, so fp32 rows stay byte-equal to their solo runs. The
pool is the admission authority, in blocks, never bytes:

- a policy-compatible request whose blocks the allocator's watermark
  refuses (``BlockAllocator.admit_alloc``) waits without closing the
  batch, and serving turns sustained refusal into 429 + Retry-After
  (``admission_load``);
- when live rows grow past a block boundary and the allocator is
  exhausted, the youngest row is preempted (``_preempt_lowest``): its
  tokens are read, its blocks freed, and it resumes later by recompute
  through the park path above, byte-identical to the unpreempted
  stream. A quantized pool re-quantizes what it re-scatters, so its
  streams hold ``kv.int8`` / ``kv.fp8`` instead.

Prefix store (``prefix=``, a ``PrefixCachingEngine`` over the same
engine, with or without a pool): an admission that is not a resume
prefills through the store (``prefill_state``), so a joiner whose prompt
shares a cached prefix forwards only its suffix; the store's cache is
right-aligned, so the row's content sits at ``[0, plen)`` of it.

Speculative segments (``spec=``, a ``SpecDecodeEngine`` over the same
engine): a batch whose policy carries ``SamplingConfig.spec`` advances
by the spec engine's verify segment (``SpecDecodeEngine._seg_b``), up to
``seg_steps // (draft_len + 1)`` verifies a segment, each row accepting
its own drafts and the batch re-syncing at one uniform depth, so joins
and retirements work as in plain batches. The batch keeps the verify
token buffer on the host (``_BatchState.buf``: prompt and emitted tokens
per row, content ending at ``depth + 1``); a row's stream is read from
it. Each row draws from its request's own generator, which carries the
row's sampling chain across segments and across a park, so every row,
seeded sampled rows included, is byte-equal to its solo speculative
run. The ``spec`` flag is part of policy equality: spec and plain
batches never mix. Spec rows keep ``draft_len`` slots of verify
headroom. With a pool, a spec segment first owns the blocks its worst
case can write (``_ensure_blocks``), after it the blocks its re-sync
rolled content down into (``_extend_blocks_down``), then scatters whole
rows (``SEG_REWRITES_FULL_CACHE``).

The worker thread owns all device work, under ``torch.inference_mode``
(which is thread-local). It publishes its decisions on the timeline
(utils.grafttime): ``admission`` (a seed or a join), ``resume``,
``preempt``, ``park`` and the fault-park budget's ``breaker``; the
events of a shared prefill or segment carry the rids of its rows, and
``replica`` labels every event of the worker.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import is_window_independent
from ..ops.attention import KVCache
from ..utils import (graftfault, graftmem, graftsched, graftscope,
                     grafttime, tracing)
from ..utils.metrics import REGISTRY, kv_block_gauges
from ..utils.device import device_scope
from .batcher import _round_up, check_compositions
from .engine import (DecodeEngine, GenerateResult, SamplingConfig,
                     select_token)
from .kv_pool import PoolExhausted
from .spec_decode import SEG_REWRITES_FULL_CACHE

# a row that keeps faulting past this many transient-fault parks fails
# typed instead of cycling forever
FAULT_PARK_BUDGET = 3


def _rid_of(req) -> Optional[str]:
    """The request's timeline correlation: its trace's X-Request-ID."""
    return getattr(req.trace, "request_id", None)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class _Req:
    prompt: np.ndarray
    max_new_tokens: int
    sampling: SamplingConfig
    generator: Optional[torch.Generator]
    eos_id: Optional[int]
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    payload: Optional[tuple] = None   # (_Slot, eos_at): the caller assembles
    error: Optional[Exception] = None
    # set by generate() on timeout: the scheduler drops the request at
    # dequeue and frees its row at the next boundary
    cancelled: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    deadline: Optional[graftfault.Deadline] = None
    trace: Optional[object] = None
    t_submit: float = 0.0

    def fail(self, e: Exception) -> None:
        """Deliver an error once (several paths may see the same
        request)."""
        if not self.done.is_set():
            self.error = e
            self.done.set()


class _SegOut:
    """One segment's ``[B, n]`` tokens. On the card the copy to pinned
    host memory starts at construction, behind the segment on the same
    stream, so the scheduler never waits on it; the first reader waits
    for that copy alone. Several retiring rows may share one segment,
    and caller threads race the read, hence the lock."""

    def __init__(self, arr: torch.Tensor):
        self._np = None
        self._lock = graftsched.lock("iterbatch._SegOut._lock")
        self._event = None
        if arr.is_cuda:
            self._host = torch.empty(arr.shape, dtype=arr.dtype,
                                     pin_memory=True)
            self._host.copy_(arr, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = arr

    @property
    def np(self) -> np.ndarray:
        with self._lock:
            if self._np is None:
                if self._event is not None:
                    self._event.synchronize()
                self._np = self._host.numpy().copy()
            return self._np


@dataclasses.dataclass
class _Slot:
    req: _Req
    plen: int
    row: int                      # this slot's batch row (fixed)
    first_ref: Optional[_SegOut]  # holds the first generated token ...
    first_idx: int                # ... at this index (None when resumed)
    emitted: int = 1              # tokens generated so far (incl. first)
    segs: List = dataclasses.field(default_factory=list)  # (_SegOut, n)
    order: int = 0                # admission order
    # tokens emitted before a park (host copy); delivery prepends them in
    # place of first_ref
    resumed_prefix: Optional[np.ndarray] = None
    fault_budget_used: int = 0
    t0: float = 0.0
    done_t: float = 0.0
    # pool mode: this row's block ids at table columns [blk_lo, blk_lo +
    # len(blk_ids)); every other column points at the trash block
    blk_lo: int = 0
    blk_ids: List[int] = dataclasses.field(default_factory=list)
    # spec rows: the last segment's token buffer (never written after)
    # and this row's pad in it; the row's stream is read from there
    spec_buf: Optional[np.ndarray] = None
    spec_pad: int = 0


def _admit_cache_impl(cache, solo, slot: int, depth: int, sp: int,
                      plen: int):
    """Copy a solo-prefilled row into batch row ``slot``: its content at
    solo slots ``[sp - plen, sp)`` lands at ``[depth - plen, depth)``,
    in place. What the row held before stays outside that window: below
    it the new pad masks it, above it decode writes each slot before
    attention reads it. Plain, fused (placeholder ``v``) and staged
    (list) caches."""
    def one(c: KVCache, s: KVCache) -> None:
        c.k[:, slot, :, depth - plen:depth] = s.k[:, 0, :, sp - plen:sp]
        if not c.fused:
            c.v[:, slot, :, depth - plen:depth] = s.v[:, 0, :, sp - plen:sp]

    for c, s in (zip(cache, solo) if isinstance(cache, list)
                 else [(cache, solo)]):
        one(c, s)
    return cache


def _admit_cache_scope_key(cache, solo, slot, depth, sp, plen):
    """(batch width, cache width, solo prefill width)."""
    c = cache[0] if isinstance(cache, list) else cache
    return (int(c.k.shape[1]), int(c.k.shape[3]), sp)


_admit_cache = graftscope.instrument(_admit_cache_impl,
                                     "iterbatch._admit_cache",
                                     key_fn=_admit_cache_scope_key)


@dataclasses.dataclass
class _Parked:
    """A row between a park (a preemption or a fault) and its resume:
    what the recompute path needs to continue the stream."""

    req: _Req
    plen: int
    emitted: int                  # tokens generated before the park
    tokens: np.ndarray            # those tokens, on the host
    order: int
    t0: float
    park_t: float = 0.0
    fault_budget_used: int = 0


class _BatchState:
    """The live batch between segments (worker-thread state)."""

    def __init__(self, sampling, token, cache, pad, depth):
        self.sampling = sampling
        self.token = token            # [B] device int64
        self.cache = cache            # None once a pool holds the rows
        self.pad = pad                # [B] device int32
        self.depth = depth            # uniform cache depth
        self.tables: Optional[np.ndarray] = None   # [B, NBm] (pool mode)
        self.slots: List[Optional[_Slot]] = []
        self.closed = False           # True: no more admissions (FIFO)
        self.mem_cache = graftmem.track(self, "cache", "engine_cache", cache)
        # spec batches: the host token buffer [B, max_seq + K + 1]; an
        # edit copies it (retired rows read the array they were left)
        self.spec_mode = False
        self.buf: Optional[np.ndarray] = None

    def active(self) -> bool:
        return any(s is not None for s in self.slots)


class IterBatchingEngine:
    """Thread-safe iteration-level batching front end over a
    ``DecodeEngine`` (the calling convention of ``BatchingEngine``, plus
    ``eos_id`` and ``deadline``).

    ``seg_steps`` is the scheduling granularity: admissions and
    retirements happen every ``seg_steps`` decode steps, so a request's
    worst-case join delay is one segment.

    ``pool`` (a ``runtime.kv_pool.KVBlockPool`` of this engine's cache
    geometry) turns on paged storage, watermark admission and
    preemption. ``queue_limit`` (default ``max_batch``) feeds
    ``admission_load``, the serving 429 decision. ``spec`` (a
    ``SpecDecodeEngine`` over this engine) runs spec-flagged batches by
    verify segments.
    """

    def __init__(self, engine: DecodeEngine, max_batch: int = 8,
                 seg_steps: int = 32, max_wait_ms: float = 2.0,
                 prompt_bucket: int = 16, spec=None, prefix=None,
                 pool=None, queue_limit: Optional[int] = None,
                 replica: Optional[str] = None):
        if not is_window_independent(engine.config):
            raise NotImplementedError(
                "iteration-level batching requires window-independent "
                "routing (a joined MoE row's tokens could depend on "
                "batch composition); MoE serves via the admission "
                "batcher")
        if engine.prefill_chunk:
            raise NotImplementedError(
                "iteration-level batching prefills admissions solo at "
                "bucketed lengths; it does not compose with "
                "prefill_chunk (use the admission batcher)")
        if pool is not None and pool.max_seq != engine._cache_seq:
            raise ValueError(
                f"pool rows span {pool.max_seq} slots, engine cache is "
                f"{engine._cache_seq}; gathered segments must match the "
                "compiled programs' cache width")
        check_compositions(engine, prefix, spec)
        self.engine = engine
        self.prefix = prefix
        self.spec = spec
        self.pool = pool
        self.replica = replica
        self.queue_limit = max_batch if queue_limit is None else queue_limit
        self.max_batch = max_batch
        self.seg_steps = seg_steps
        self.max_wait_s = max_wait_ms / 1e3
        self.prompt_bucket = prompt_bucket
        self._queue: "queue.Queue[_Req]" = queue.Queue()
        self._pending: Optional[_Req] = None
        self._parked: List[_Parked] = []   # fault-parked rows, oldest first
        self._order = 0                    # admission counter (worker only)
        self._stats_lock = graftsched.lock(
            "iterbatch.IterBatchingEngine._stats_lock")
        self.batches_run = 0
        self.rows_served = 0
        self.joins = 0                # admissions into a live batch
        self.segments_run = 0
        self.spec_segments_run = 0    # verify segments (spec batches)
        self.eos_retires = 0
        self.grows = 0                # width upgrades of a live batch
        self.resumes = 0              # parked rows recomputed back in
        self.fault_parks = 0          # transient-fault park events
        self.preemptions = 0          # rows parked under pool pressure
        self.deferrals = 0            # admissions the pool's watermark held
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- caller side ---------------------------------------------------------

    def generate(self, prompt_ids, max_new_tokens: int,
                 sampling: SamplingConfig = SamplingConfig(),
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = None,
                 deadline: Optional[graftfault.Deadline] = None,
                 ) -> GenerateResult:
        prompt = np.asarray(prompt_ids, dtype=np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must be non-empty")
        if len(prompt) + max_new_tokens > self.engine.max_seq:
            raise ValueError(
                f"prompt_len={len(prompt)} + max_new_tokens="
                f"{max_new_tokens} exceeds max_seq={self.engine.max_seq}")
        if sampling.mode != "greedy" and generator is None:
            raise ValueError(
                "sample-mode requests must carry their own torch.Generator")
        if sampling.spec:
            # refused here, with this request's numbers, not mid-batch
            if self.spec is None:
                raise ValueError(
                    "sampling.spec requested but this scheduler has no "
                    "speculative engine attached (pass spec= at "
                    "construction)")
            self.spec.check_request(len(prompt), max_new_tokens)
        if deadline is not None:
            deadline.raise_if_expired("iter-batched generate")
        req = _Req(prompt=prompt, max_new_tokens=max_new_tokens,
                   sampling=sampling, generator=generator, eos_id=eos_id,
                   deadline=deadline, trace=tracing.current_trace(),
                   t_submit=time.perf_counter())
        self._queue.put(req)
        REGISTRY.gauge("queue_depth", self._queue.qsize(), scheduler="iter")
        wait = timeout
        if deadline is not None:
            rem = deadline.remaining()
            wait = rem if wait is None else min(wait, rem)
        if not req.done.wait(wait):
            # cancel, not just abandon: the scheduler skips the request
            # at dequeue or frees its row at the next boundary
            req.cancelled.set()
            if deadline is not None and deadline.expired():
                raise graftfault.DeadlineExceeded(
                    "iter-batched generate: deadline budget exhausted; "
                    "in-flight work is cancelled at the next segment "
                    "boundary")
            raise TimeoutError("iter-batched generate timed out")
        if req.error is not None:
            raise req.error
        # token assembly (the device->host reads) happens here, on the
        # caller's thread: the scheduler only marks rows done
        s, eos_at = req.payload
        new = self._row_tokens(s)
        if eos_at is not None:
            new = new[:eos_at + 1]
        tokens = np.concatenate([req.prompt, new])[None, :]
        # decode_seconds is the row's wall time from admission to
        # retirement (prefill, shared segments and scheduling)
        return GenerateResult(
            tokens=tokens, prompt_len=s.plen, prefill_seconds=0.0,
            decode_seconds=s.done_t - s.t0, new_tokens=len(new),
            decode_steps=len(new) - 1)

    def stats(self) -> dict:
        with self._stats_lock:
            return {"batches": self.batches_run, "rows": self.rows_served,
                    "joins": self.joins, "segments": self.segments_run,
                    "spec_segments": self.spec_segments_run,
                    "eos_retires": self.eos_retires, "grows": self.grows,
                    "resumes": self.resumes,
                    "fault_parks": self.fault_parks,
                    "preemptions": self.preemptions,
                    "deferrals": self.deferrals,
                    "parked": len(self._parked)}

    def admission_load(self, prompt_len: int,
                       max_new_tokens: int) -> Tuple[bool, float]:
        """The serving 429 decision: ``(admit, retry_after_s)``. Shed only
        when the pool cannot admit the prompt's blocks AND the waiting
        line is already at ``queue_limit``; without a pool, always admit.
        Advisory: the worker's grant is ``admit_alloc``'s."""
        if self.pool is None:
            return True, 0.0
        # the admission footprint; growth past it is preemption's business
        need = self.pool.allocator.blocks_for(prompt_len)
        with self._stats_lock:
            waiting = (self._queue.qsize() + len(self._parked)
                       + (1 if self._pending is not None else 0))
        # a seeded pool-exhaustion spike sheds as a real storm would
        spike = graftfault.inject("iterbatch.admission_load", "pool_spike")
        if spike is None and (self.pool.allocator.can_admit(need)
                              or waiting < self.queue_limit):
            return True, 0.0
        # each max_batch-wide wave of waiters takes about one batch
        # lifetime to drain
        return False, float(1 + waiting // max(self.max_batch, 1))

    # -- worker side: leaf-locked access to what serving threads read -------

    def _peek_parked(self) -> Optional[_Parked]:
        with self._stats_lock:
            return self._parked[0] if self._parked else None

    def _pop_parked(self) -> Optional[_Parked]:
        with self._stats_lock:
            return self._parked.pop(0) if self._parked else None

    def _park(self, parked: _Parked) -> None:
        with self._stats_lock:
            self._parked.append(parked)
            self._parked.sort(key=lambda p: p.order)

    def _take_pending(self) -> Optional[_Req]:
        with self._stats_lock:
            req, self._pending = self._pending, None
            return req

    def _get_pending(self) -> Optional[_Req]:
        with self._stats_lock:
            return self._pending

    def _set_pending(self, req: Optional[_Req]) -> None:
        with self._stats_lock:
            self._pending = req

    def _req_dead(self, req: _Req) -> bool:
        """Cancelled or past its deadline: nobody wants the work. A
        past-deadline request is failed typed here and marked
        cancelled."""
        if req.cancelled.is_set():
            return True
        if req.deadline is not None and req.deadline.expired():
            req.fail(graftfault.DeadlineExceeded(
                "deadline budget exhausted before the scheduler could "
                "run this request"))
            req.cancelled.set()
            return True
        return False

    def _loop(self):
        if self.replica is not None:
            # the worker's events carry the app's replica label
            grafttime.set_thread_replica(self.replica)
        with torch.inference_mode(), device_scope(self.engine.device):
            while True:
                # parked rows outrank every queued request (they were
                # admitted first)
                head = self._pop_parked()
                if head is not None:
                    if self._req_dead(head.req):
                        continue
                else:
                    head = self._take_pending()
                    if head is None:
                        head = self._queue.get()
                    if self._req_dead(head):
                        continue
                try:
                    self._run_batch(head)
                except Exception as e:  # noqa: BLE001 — per request
                    self._ent_req(head).fail(e)

    def _compatible(self, state: _BatchState, ent) -> bool:
        """Can this entry (a fresh ``_Req`` or a ``_Parked`` resume) join
        the live batch now? Same policy (the ``spec`` flag included), its
        prefill fits below the current depth, and its remaining
        generation fits the cache, with a spec batch's verify headroom."""
        return (self._ent_req(ent).sampling == state.sampling
                and len(self._ent_ids(ent)) <= state.depth
                and state.depth + self._ent_need(ent) + self._reserve(ent)
                <= self.engine.max_seq)

    def _run_batch(self, head):
        state = self._seed(head)
        try:
            while state.active():
                if not state.closed:
                    self._admit(state)
                try:
                    # the segment serves every live row: its events carry
                    # their rids
                    with grafttime.correlate([_rid_of(s.req)
                                              for s in state.slots
                                              if s is not None]):
                        self._advance(state)
                except graftfault.TransientFault as e:
                    self._fault_park_all(state, e)
        except Exception as e:  # noqa: BLE001
            for i, s in enumerate(state.slots):
                if s is not None:
                    s.req.fail(e)
                    # nothing else will release an aborted row's blocks
                    self._release_blocks(state, i)
            raise
        finally:
            graftmem.release(state.mem_cache)

    # -- seeding -------------------------------------------------------------

    @staticmethod
    def _ent_req(e) -> _Req:
        return e.req if isinstance(e, _Parked) else e

    @staticmethod
    def _ent_ids(e) -> np.ndarray:
        """The tokens an entry's prefill forwards: the prompt or, for a
        parked row, the prompt and every emitted token but the last (the
        live token the segment loop carries)."""
        if isinstance(e, _Parked):
            return np.concatenate([e.req.prompt, e.tokens[:-1]])
        return e.prompt

    @staticmethod
    def _ent_need(e) -> int:
        """Cache slots the entry still needs past its prefill."""
        if isinstance(e, _Parked):
            return e.req.max_new_tokens - e.emitted + 1
        return e.max_new_tokens

    def _seed(self, head) -> _BatchState:
        """Start a batch: same-policy parked rows first, then queued peers
        that fit, for up to ``max_wait_ms``. A failure past gathering is
        delivered to every gathered request."""
        seed = [head]
        sampling = self._ent_req(head).sampling
        while len(seed) < self.max_batch:
            nxt = self._peek_parked()
            if nxt is None:
                break
            if self._req_dead(nxt.req):
                self._pop_parked()
                continue
            if nxt.req.sampling == sampling and self._fits(seed + [nxt]):
                seed.append(self._pop_parked())
            else:
                break
        deadline = time.monotonic() + self.max_wait_s
        # a held head (``_pending``, left by an earlier batch while parked
        # rows seed this one) stays first in line: gathering past it would
        # break FIFO, and holding a second arrival would drop the first
        while len(seed) < self.max_batch and self._get_pending() is None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if self._req_dead(nxt):
                continue
            if nxt.sampling == sampling and self._fits(seed + [nxt]):
                seed.append(nxt)
            else:
                # held as the FIFO head: _admit reconsiders it first, and
                # otherwise it seeds the next batch
                self._set_pending(nxt)
                break
        try:
            return self._seed_batch(seed)
        except Exception as e:  # noqa: BLE001
            for r in seed:
                self._ent_req(r).fail(e)
            raise

    def _seed_batch(self, seed: List) -> _BatchState:
        eng = self.engine
        sampling = self._ent_req(seed[0]).sampling
        s_max = self._seed_smax(seed)
        rows = [self._ent_ids(e) for e in seed]
        # right-sized: the next power of two that fits the seed; _admit
        # grows it on demand
        b = min(_next_pow2(len(seed)), self.max_batch)
        ids = np.zeros((b, s_max), dtype=np.int64)
        pad = np.zeros((b,), dtype=np.int32)
        for i in range(b):
            row = rows[min(i, len(seed) - 1)]  # free rows copy the last
            ids[i, s_max - len(row):] = row
            pad[i] = s_max - len(row)
        # the admission (or resume) decision, before the prefill it causes
        for e in seed:
            r = self._ent_req(e)
            if isinstance(e, _Parked):
                grafttime.emit("resume", rid=_rid_of(r), emitted=e.emitted,
                               mode="seed", width=b)
            else:
                grafttime.emit("admission", rid=_rid_of(r), mode="seed",
                               width=b, prompt_len=len(r.prompt))
        t0 = time.monotonic()
        sp0 = time.perf_counter()
        with grafttime.correlate([_rid_of(self._ent_req(e)) for e in seed]):
            logits, cache = eng._prefill(eng._ids(ids), eng._pad(pad))
        # a resumed row's live token is its last emitted one, known: it
        # draws nothing here; free rows draw nothing either
        generators = None
        if sampling.mode != "greedy":
            generators = [None if isinstance(e, _Parked) else e.generator
                          for e in seed] + [None] * (b - len(seed))
        first = select_token(logits[:, -1], sampling, generators)
        for i, e in enumerate(seed):
            if isinstance(e, _Parked):
                first[i] = int(e.tokens[-1])
        sp1 = time.perf_counter()
        for e in seed:
            r = self._ent_req(e)
            if r.trace is not None:
                if isinstance(e, _Parked):
                    r.trace.add_span("preempted", e.park_t, sp0,
                                     scheduler="iter")
                    r.trace.add_span("prefill", sp0, sp1, kind="resume",
                                     width=b, emitted=e.emitted)
                else:
                    r.trace.add_span("queue_wait", r.t_submit, sp0,
                                     scheduler="iter")
                    r.trace.add_span("prefill", sp0, sp1, kind="seed",
                                     width=b, prompt_len=len(r.prompt))
        state = _BatchState(sampling, first,
                            cache, torch.as_tensor(pad, device=eng.device),
                            s_max)
        if sampling.spec:
            # the verify loop's entry state: prompt, then the live
            # (unforwarded) token at the depth, per row
            state.spec_mode = True
            state.buf = np.zeros((b, eng.max_seq + self.spec.draft_len + 1),
                                 dtype=np.int64)
            state.buf[:, :s_max] = ids
            state.buf[:, s_max] = first.cpu().numpy()
        first_ref = _SegOut(first)          # one shared [B] read
        state.slots = [None] * b
        n_res = 0
        for i, e in enumerate(seed):
            r = self._ent_req(e)
            if isinstance(e, _Parked):
                n_res += 1
                state.slots[i] = _Slot(
                    req=r, plen=e.plen, row=i, first_ref=None, first_idx=0,
                    emitted=e.emitted, resumed_prefix=e.tokens,
                    order=e.order, t0=e.t0,
                    fault_budget_used=e.fault_budget_used)
            else:
                self._order += 1
                state.slots[i] = _Slot(req=r, plen=len(r.prompt), row=i,
                                       first_ref=first_ref, first_idx=i,
                                       order=self._order, t0=t0)
        if self.pool is not None:
            self._init_tables(state, pad)
        with self._stats_lock:
            self.batches_run += 1
            self.resumes += n_res
        REGISTRY.inc("iter_batches_total")
        if n_res:
            REGISTRY.inc("kv_pool_resumes_total", value=n_res)
        self._retire_finished(state)      # max_new_tokens == 1 rows
        self._set_gauges(state)
        return state

    def _fits(self, ents: List) -> bool:
        s_max = self._seed_smax(ents)
        ok = all(s_max + self._ent_need(e) + self._reserve(ents[0])
                 <= self.engine.max_seq
                 and len(self._ent_ids(e)) <= s_max for e in ents)
        if ok and self.pool is not None:
            # the current footprint only (blocks covering the seed depth):
            # future growth is oversubscribed on purpose, preemption
            # handles it
            alloc = self.pool.allocator
            need = sum(
                alloc.blocks_for(s_max)
                - (s_max - len(self._ent_ids(e))) // self.pool.block_size
                for e in ents)
            ok = need <= alloc.available()
        return ok

    def _reserve(self, ent) -> int:
        """Cache slots held back past the generation: ``draft_len`` of
        verify headroom for a spec row."""
        return (self.spec.draft_len
                if self._ent_req(ent).sampling.spec else 0)

    def _seed_smax(self, ents: List) -> int:
        raw = max(len(self._ent_ids(e)) for e in ents)
        need = max(self._ent_need(e) for e in ents)
        return min(_round_up(raw, self.prompt_bucket),
                   self.engine.max_seq - need - self._reserve(ents[0]))

    # -- admission -----------------------------------------------------------

    def _reserve_blocks(self, state: _BatchState, ent):
        """The pool grant for one would-be row's current footprint: blocks
        covering its content at the live depth (pad-prefix columns stay
        on the trash block), checked against the watermark and granted
        under one allocator hold. ``(p_lo, ids)``, or None to defer."""
        if self.pool is None:
            return 0, []
        bs = self.pool.block_size
        p_lo = (state.depth - len(self._ent_ids(ent))) // bs
        p_hi = -(-state.depth // bs)
        ids = self.pool.allocator.admit_alloc(p_hi - p_lo)
        if ids is None:
            with self._stats_lock:
                self.deferrals += 1
            return None
        return p_lo, ids

    def _admit(self, state: _BatchState):
        """Parked rows first (oldest first), then compatible queued
        requests, into free rows. Strict FIFO: an incompatible head
        closes admission and seeds the next batch; the held head
        (``_pending``) is reconsidered first and never overwritten. A
        head that is compatible but lacks pool room waits without
        closing (blocks come back as rows retire). With no free row, a
        batch narrower than ``max_batch`` grows."""
        while True:
            ent = self._peek_parked()
            if ent is None:
                break
            if self._req_dead(ent.req):
                self._pop_parked()
                continue
            if not self._compatible(state, ent):
                # a policy mismatch closes admission; a depth mismatch
                # waits for the next batch to seed from it
                if ent.req.sampling != state.sampling:
                    state.closed = True
                return
            if not self._slot_possible(state):
                return  # full: retried at the next boundary
            reserved = self._reserve_blocks(state, ent)
            if reserved is None:
                return  # stays parked until blocks come back
            slot = self._free_slot(state)
            ent = self._pop_parked()
            try:
                self._admit_one(state, ent.req, slot, resume=ent,
                                reserved=reserved)
            except Exception as e:  # noqa: BLE001
                ent.req.fail(e)
                raise
        while True:
            req = self._get_pending()
            if req is None:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return
                self._set_pending(req)
            if self._req_dead(req):
                self._set_pending(None)
                continue
            if not self._compatible(state, req):
                state.closed = True  # req stays held as the FIFO head
                return
            if not self._slot_possible(state):
                return  # full: req stays the head
            reserved = self._reserve_blocks(state, req)
            if reserved is None:
                return  # req stays the head until blocks come back
            slot = self._free_slot(state)
            self._set_pending(None)
            try:
                self._admit_one(state, req, slot, reserved=reserved)
            except Exception as e:  # noqa: BLE001 — not in state.slots
                req.fail(e)        # yet: without this its caller would
                raise              # block forever

    def _slot_possible(self, state: _BatchState) -> bool:
        """Is there a free row, or room to grow one? Checked before any
        pool grant, so that a full batch takes no blocks."""
        return (any(s is None for s in state.slots)
                or len(state.slots) < self.max_batch)

    def _free_slot(self, state: _BatchState) -> int:
        """A free row, growing the batch when it has none (the caller
        checked ``_slot_possible``)."""
        if all(s is not None for s in state.slots):
            self._grow(state)
        return next(i for i, s in enumerate(state.slots) if s is None)

    def _grow(self, state: _BatchState):
        """Widen the live batch to the next power of two: token, pad and
        cache gain rows that copy row 0 (any live row is valid ghost
        material: rows are independent)."""
        old = len(state.slots)
        new = min(_next_pow2(old + 1), self.max_batch)
        extra = new - old

        def rep(x: torch.Tensor, dim: int) -> torch.Tensor:
            return torch.cat([x] + [x.narrow(dim, 0, 1)] * extra, dim=dim)

        def grow_cache(c: KVCache) -> KVCache:
            return KVCache(k=rep(c.k, 1), v=c.v if c.fused else rep(c.v, 1),
                           length=c.length)

        state.token = rep(state.token, 0)
        state.pad = rep(state.pad, 0)
        if state.buf is not None:
            # ghost rows copy row 0's lane; with no budget they stay inert
            state.buf = np.concatenate([state.buf]
                                       + [state.buf[:1]] * extra)
        if state.cache is not None:
            state.cache = ([grow_cache(c) for c in state.cache]
                           if isinstance(state.cache, list)
                           else grow_cache(state.cache))
            graftmem.update(state.mem_cache, state.cache)
        if state.tables is not None:
            # ghost rows read and write the trash block only
            state.tables = np.concatenate(
                [state.tables, np.full((extra, self.pool.nbm),
                                       self.pool.trash, dtype=np.int32)])
        state.slots = state.slots + [None] * extra
        with self._stats_lock:
            self.grows += 1
        REGISTRY.inc("iter_grows_total")

    def _admit_one(self, state: _BatchState, req: _Req, slot: int,
                   resume: Optional[_Parked] = None, *,
                   reserved: Tuple[int, List[int]]):
        """``reserved`` is the row's pool grant (``_reserve_blocks``):
        placed on success, freed on any failure."""
        try:
            self._admit_one_inner(state, req, slot, resume, reserved)
        except BaseException:
            if self.pool is not None:
                self.pool.allocator.free(reserved[1])
                if state.tables is not None:
                    state.tables[slot, :] = self.pool.trash
            raise

    def _admit_one_inner(self, state: _BatchState, req: _Req, slot: int,
                         resume: Optional[_Parked],
                         reserved: Tuple[int, List[int]]):
        eng = self.engine
        stream = self._ent_ids(resume) if resume is not None else req.prompt
        plen_eff = len(stream)            # tokens the prefill forwards
        # the join (or resume) decision, before the prefill it causes
        if resume is not None:
            grafttime.emit("resume", rid=_rid_of(req), emitted=resume.emitted,
                           mode="join", depth=state.depth)
        else:
            grafttime.emit("admission", rid=_rid_of(req), mode="join",
                           depth=state.depth, prompt_len=plen_eff)
        plen = resume.plen if resume is not None else plen_eff
        t0 = resume.t0 if resume is not None else time.monotonic()
        p0 = time.perf_counter()
        if req.trace is not None:
            if resume is not None:
                req.trace.add_span("preempted", resume.park_t, p0,
                                   scheduler="iter")
            else:
                req.trace.add_span("queue_wait", req.t_submit, p0,
                                   scheduler="iter")
        if self.prefix is not None and resume is None:
            # through the store: its cache is right-aligned (content at
            # [0, plen)), so sp = plen; the store records this row's
            # prefill span, hit depth labelled
            with tracing.use_trace(req.trace):
                last, solo, sp = self.prefix.prefill_state(stream)
        else:
            sp = min(_round_up(plen_eff, self.prompt_bucket), state.depth)
            sp = max(sp, plen_eff)  # a bucket past the depth: exact length
            ids = np.zeros((1, sp), dtype=np.int64)
            ids[0, sp - plen_eff:] = stream
            with grafttime.correlate([_rid_of(req)]):
                logits, solo = eng._prefill(
                    eng._ids(ids),
                    eng._pad(np.asarray([sp - plen_eff], np.int32)))
            last = logits[:, -1]
            if req.trace is not None:
                req.trace.add_span(
                    "prefill", p0, time.perf_counter(),
                    kind="resume" if resume is not None else "admit",
                    depth=state.depth, prompt_len=plen_eff)
        if resume is not None:
            # the live token is the parked row's last emitted one
            first = torch.full((1,), int(resume.tokens[-1]),
                               dtype=torch.int64, device=eng.device)
        else:
            first = select_token(
                last, state.sampling,
                None if state.sampling.mode == "greedy" else [req.generator])
        if self.pool is not None:
            self._place_admitted(state, slot, solo, state.depth - sp,
                                 reserved)
        else:
            _admit_cache(state.cache, solo, slot, state.depth, sp, plen_eff)
        state.pad[slot] = state.depth - plen_eff
        # a new tensor, never a write into the last segment's output (the
        # retired rows' tokens are read from it)
        token = state.token.clone()
        token[slot] = first[0]
        state.token = token
        if state.spec_mode:
            # the joiner's lane: what its prefill forwarded at [depth -
            # plen_eff, depth), the live token at depth; a copy, since a
            # retired row may still be read from the old buffer
            buf = state.buf.copy()
            buf[slot] = 0
            buf[slot, state.depth - plen_eff:state.depth] = stream
            buf[slot, state.depth] = int(first[0])
            state.buf = buf
        self._order += 1
        state.slots[slot] = _Slot(
            req=req, plen=plen, row=slot,
            first_ref=None if resume is not None else _SegOut(first),
            first_idx=0, t0=t0,
            emitted=resume.emitted if resume is not None else 1,
            resumed_prefix=resume.tokens if resume is not None else None,
            order=resume.order if resume is not None else self._order,
            fault_budget_used=(resume.fault_budget_used
                               if resume is not None else 0),
            blk_lo=reserved[0], blk_ids=reserved[1])
        with self._stats_lock:
            if resume is not None:
                self.resumes += 1
            else:
                self.joins += 1
        REGISTRY.inc("kv_pool_resumes_total" if resume is not None
                     else "iter_joins_total")
        if req.max_new_tokens <= (resume.emitted if resume is not None
                                  else 1):
            self._retire_finished(state)

    # -- paged storage (pool mode) -------------------------------------------

    def _init_tables(self, state: _BatchState, pad: np.ndarray) -> None:
        """Seed placement: allocate each live row's content blocks
        (pad-prefix columns stay on the trash block), scatter the seed
        prefill into them and drop the contiguous cache: between
        segments the pool is the only storage."""
        bs = self.pool.block_size
        state.tables = np.full((len(state.slots), self.pool.nbm),
                               self.pool.trash, dtype=np.int32)
        p_hi = -(-state.depth // bs)
        try:
            for i, s in enumerate(state.slots):
                if s is None:
                    continue
                s.blk_lo = int(pad[i]) // bs
                s.blk_ids = self.pool.allocator.alloc(p_hi - s.blk_lo)
                state.tables[i, s.blk_lo:p_hi] = s.blk_ids
            self.pool.scatter(state.cache, state.tables)
        except BaseException:
            # rows placed before the failure must not keep their refs
            for i in range(len(state.slots)):
                self._release_blocks(state, i)
            raise
        state.cache = None
        graftmem.release(state.mem_cache)
        state.mem_cache = 0

    def _place_admitted(self, state: _BatchState, slot: int, solo,
                        roll: int, reserved: Tuple[int, List[int]]) -> None:
        """Point row ``slot`` at its granted blocks and scatter the rolled
        solo prefill into them (the paged form of ``_admit_cache``)."""
        p_lo, ids = reserved
        state.tables[slot, :] = self.pool.trash
        state.tables[slot, p_lo:p_lo + len(ids)] = ids
        self.pool.scatter_row(solo, state.tables[slot], roll)

    def _release_blocks(self, state: _BatchState, i: int) -> None:
        s = state.slots[i]
        if self.pool is None or s is None or not s.blk_ids:
            return
        self.pool.allocator.free(s.blk_ids)
        s.blk_ids = []
        if state.tables is not None:
            state.tables[i, :] = self.pool.trash

    def _ensure_blocks(self, state: _BatchState, new_depth: int) -> None:
        """Before a segment: every live row owns blocks covering the
        segment's writes (slots below ``new_depth``). Rows are served
        oldest first, so that when the pool is exhausted the rows
        preempted to make room are the youngest."""
        p_hi = -(-new_depth // self.pool.block_size)
        for s in sorted((s for s in state.slots if s is not None),
                        key=lambda s: s.order):
            if state.slots[s.row] is not s:
                continue  # preempted by an earlier iteration
            while True:
                missing = p_hi - (s.blk_lo + len(s.blk_ids))
                if missing <= 0:
                    break
                try:
                    ids = self.pool.allocator.alloc(missing)
                except PoolExhausted:
                    if not self._preempt_lowest(state):
                        raise
                    if state.slots[s.row] is not s:
                        break  # this row was the youngest: it parked
                    continue
                col = s.blk_lo + len(s.blk_ids)
                state.tables[s.row, col:p_hi] = ids
                s.blk_ids.extend(ids)

    def _extend_blocks_down(self, state: _BatchState,
                            pad: np.ndarray) -> None:
        """After a spec segment: a re-sync roll that shrank a row's pad
        moved content into columns below ``blk_lo``; own them before the
        whole-row scatter, preempting younger rows when the pool is
        exhausted."""
        bs = self.pool.block_size
        for s in sorted((s for s in state.slots if s is not None),
                        key=lambda s: s.order):
            if state.slots[s.row] is not s:
                continue  # preempted by an earlier iteration
            new_lo = int(pad[s.row]) // bs
            while new_lo < s.blk_lo:
                try:
                    ids = self.pool.allocator.alloc(s.blk_lo - new_lo)
                except PoolExhausted:
                    if not self._preempt_lowest(state):
                        raise
                    if state.slots[s.row] is not s:
                        break  # this row was the youngest: it parked
                    continue
                state.tables[s.row, new_lo:s.blk_lo] = ids
                s.blk_ids = ids + s.blk_ids
                s.blk_lo = new_lo

    def _preempt_lowest(self, state: _BatchState) -> bool:
        """Park the youngest live row (the highest admission order),
        whichever row's growth asked; False with no live row."""
        live = [s for s in state.slots if s is not None]
        if not live:
            return False
        victim = max(live, key=lambda s: s.order)
        grafttime.emit("preempt", rid=_rid_of(victim.req), order=victim.order)
        self._park_slot(state, victim, victim.fault_budget_used)
        if victim.req.trace is not None:
            victim.req.trace.labels["preempted"] = (
                victim.req.trace.labels.get("preempted", 0) + 1)
        with self._stats_lock:
            self.preemptions += 1
        REGISTRY.inc("kv_pool_preemptions_total")
        return True

    # -- degraded mode -------------------------------------------------------

    def _park_slot(self, state: _BatchState, s: _Slot,
                   fault_budget_used: int, reason: str = "preempt") -> None:
        """Park one live row for recompute-resume (a preemption or a
        fault): read its emitted tokens (a host sync: parking is the slow
        path), free its blocks and its row, queue it oldest first."""
        tokens = np.asarray(self._row_tokens(s), dtype=np.int64)
        parked = _Parked(req=s.req, plen=s.plen,
                         emitted=min(s.emitted, s.req.max_new_tokens),
                         tokens=tokens, order=s.order, t0=s.t0,
                         park_t=time.perf_counter(),
                         fault_budget_used=fault_budget_used)
        self._release_blocks(state, s.row)
        state.slots[s.row] = None
        self._park(parked)
        grafttime.emit("park", rid=_rid_of(s.req), reason=reason,
                       emitted=parked.emitted)

    def _fault_park_all(self, state: _BatchState,
                        fault: Exception) -> None:
        """A transient fault before a segment: park every live row (the
        failed segment never ran, so each row's snapshot is its
        pre-segment state); a row past ``FAULT_PARK_BUDGET`` fails
        typed."""
        for i, s in enumerate(state.slots):
            if s is None:
                continue
            if s.fault_budget_used + 1 > FAULT_PARK_BUDGET:
                if s.req.trace is not None:
                    t = time.perf_counter()
                    s.req.trace.add_span("fault_budget_exhausted", t, t,
                                         scheduler="iter",
                                         parks=s.fault_budget_used)
                # the row's park budget opens its breaker: no more
                # recovery
                grafttime.emit("breaker", state="open", rid=_rid_of(s.req),
                               scope="iterbatch.fault_park_budget",
                               used=s.fault_budget_used,
                               budget=FAULT_PARK_BUDGET)
                s.req.fail(graftfault.FaultBudgetError(
                    f"row exhausted its transient-fault park budget "
                    f"({FAULT_PARK_BUDGET}); last fault: {fault}"))
                self._release_blocks(state, i)
                state.slots[i] = None
                continue
            if s.req.trace is not None:
                s.req.trace.labels["fault_parks"] = (
                    s.req.trace.labels.get("fault_parks", 0) + 1)
            grafttime.emit("breaker", state="closed", rid=_rid_of(s.req),
                           scope="iterbatch.fault_park_budget",
                           used=s.fault_budget_used + 1,
                           budget=FAULT_PARK_BUDGET)
            self._park_slot(state, s, s.fault_budget_used + 1, reason="fault")
        with self._stats_lock:
            self.fault_parks += 1
        REGISTRY.inc("iter_fault_parks_total")

    # -- the segment step ----------------------------------------------------

    def _set_gauges(self, state: _BatchState) -> None:
        live = sum(1 for s in state.slots if s is not None)
        width = len(state.slots)
        occupancy = round(live / max(width, 1), 4)
        depth = self._queue.qsize()
        REGISTRY.gauge("iter_live_rows", live)
        REGISTRY.gauge("batch_occupancy", occupancy, scheduler="iter")
        if self.pool is not None:
            self.pool.note_gauges(component="iter")
        else:
            kv_block_gauges("iter", state.depth * live,
                            width * self.engine._cache_seq)
        REGISTRY.gauge("queue_depth", depth, scheduler="iter")
        graftscope.sample("iter_live_rows", live)
        graftscope.sample("batch_occupancy", occupancy, scheduler="iter")
        graftscope.sample("queue_depth", depth, scheduler="iter")

    def _advance(self, state: _BatchState):
        # injected faults fire before any state changes, so a transient
        # park snapshots exactly the pre-segment state
        kind = graftfault.inject("iterbatch.decode_seg", "decode_transient",
                                 "decode_permanent", "decode_slow")
        if kind == "decode_slow":
            time.sleep(0.05)
        elif kind == "decode_transient":
            raise graftfault.TransientFault(
                "iterbatch.decode_seg", kind,
                "graftfault: injected transient decode fault")
        elif kind == "decode_permanent":
            raise graftfault.PermanentFault(
                "iterbatch.decode_seg", kind,
                "graftfault: injected permanent engine fault")
        if state.spec_mode:
            self._advance_spec(state)
            return
        eng = self.engine
        d = state.depth
        n = min(self.seg_steps, eng.max_seq - d)
        if n < 1:
            raise RuntimeError("live rows past max_seq (an admission bug)")
        pooled = self.pool is not None
        cache = state.cache
        if pooled:
            # every live row's blocks must cover this segment's writes:
            # the preemption point
            self._ensure_blocks(state, d + n)
            if not state.active():
                return  # every row parked
            cache = self.pool.gather(state.tables, d)
        generators = None
        if state.sampling.mode != "greedy":
            generators = [None if s is None else s.req.generator
                          for s in state.slots]
        t0 = time.perf_counter()
        out, cache = eng._decode_seg(state.token, cache, state.pad, n,
                                     state.sampling, generators)
        if pooled:
            self.pool.scatter(cache, state.tables)
        else:
            state.cache = cache
        state.token = out[:, -1]
        state.depth = d + n
        seg = _SegOut(out)
        t1 = time.perf_counter()
        # the scheduler thread's dispatch view: segments queue
        # asynchronously on the card
        REGISTRY.observe("decode_step_seconds", (t1 - t0) / n,
                         component="iter")
        with self._stats_lock:
            self.segments_run += 1
        REGISTRY.inc("iter_segments_total")
        for s in state.slots:
            if s is not None:
                s.segs.append((seg, n))
                s.emitted += n
                if s.req.trace is not None:
                    s.req.trace.add_span(
                        "decode", t0, t1, seg=True, steps=n,
                        width=len(state.slots), depth=state.depth,
                        step_ms=round((t1 - t0) / n * 1e3, 3),
                        **({"blocks": len(s.blk_ids)} if pooled else {}))
        self._retire_finished(state)
        self._set_gauges(state)

    def _advance_spec(self, state: _BatchState):
        """One verify segment of a spec batch: up to ``seg_steps //
        (draft_len + 1)`` verifies (about the device work of
        ``seg_steps`` single-token steps), each row capped at its own
        remaining budget, ghost rows at 0. The segment syncs with the
        host once a verify (``SpecDecodeEngine._fetch``)."""
        eng = self.engine
        k = self.spec.draft_len
        max_verify = max(1, self.seg_steps // (k + 1))
        pooled = self.pool is not None
        if pooled:
            # a verify writes up to depth + K, and the segment emits at
            # most max_verify * (K + 1): own the worst case first (the
            # preemption point)
            self._ensure_blocks(state, min(
                state.depth + max_verify * (k + 1) + k, eng.max_seq))
            if not state.active():
                return  # every row parked
            cache = self.pool.gather(state.tables, state.depth)
        else:
            cache = state.cache
        # budgets after any preemption above: a row parked here enters
        # the segment as an inert ghost
        b = len(state.slots)
        budgets = np.zeros((b,), dtype=np.int64)
        for i, s in enumerate(state.slots):
            if s is not None:
                budgets[i] = max(s.req.max_new_tokens - s.emitted, 0)
        generators = None
        if state.sampling.mode != "greedy":
            generators = [None if s is None else s.req.generator
                          for s in state.slots]
        t0 = time.perf_counter()
        c = self.spec._seg_b(state.buf, cache, state.depth + 1,
                             state.pad.cpu().numpy(), generators, budgets,
                             max_verify, state.sampling)
        state.buf = c.buf
        state.depth = c.total - 1
        state.pad = torch.as_tensor(c.pad, dtype=torch.int32,
                                    device=eng.device)
        state.token = eng._ids(c.buf[:, c.total - 1])
        # progress first: a preemption in the pool handoff below parks a
        # post-segment snapshot (tokens and generator advanced together)
        for s in state.slots:
            if s is not None:
                s.emitted += int(c.emitted[s.row])
                s.spec_buf = c.buf
                s.spec_pad = int(c.pad[s.row])
        if pooled:
            # the re-sync rolls whole rows: content may have moved below a
            # row's first block, and every block of a row may have changed
            assert SEG_REWRITES_FULL_CACHE
            self._extend_blocks_down(state, c.pad)
            self.pool.scatter(c.cache, state.tables)
        else:
            state.cache = c.cache
            graftmem.update(state.mem_cache, c.cache)
        t1 = time.perf_counter()
        with self._stats_lock:
            self.segments_run += 1
            self.spec_segments_run += 1
        # requests are counted at retirement (_deliver)
        self.spec._update_stats(0, int(c.emitted.sum()), c.steps)
        REGISTRY.inc("iter_segments_total")
        REGISTRY.inc("iter_spec_segments_total")
        REGISTRY.observe("decode_step_seconds", (t1 - t0) / max(c.steps, 1),
                         component="iter_spec")
        for s in state.slots:
            if s is not None and s.req.trace is not None:
                s.req.trace.add_span(
                    "decode", t0, t1, seg=True, spec=True,
                    verify_steps=c.steps, emitted=int(c.emitted[s.row]),
                    width=len(state.slots), depth=state.depth,
                    **({"blocks": len(s.blk_ids)} if pooled else {}))
        self._retire_finished(state)
        self._set_gauges(state)

    # -- retirement ----------------------------------------------------------

    def _retire_finished(self, state: _BatchState):
        eos_armed = any(s is not None and s.req.eos_id is not None
                        for s in state.slots)
        for i, s in enumerate(state.slots):
            if s is None:
                continue
            if (s.req.deadline is not None and s.req.deadline.expired()
                    and not s.req.done.is_set()):
                # past its deadline: cancelled at this boundary, typed
                s.req.fail(graftfault.DeadlineExceeded(
                    "deadline budget exhausted mid-decode; row "
                    "cancelled at the segment boundary"))
                s.req.cancelled.set()
                self._release_blocks(state, i)
                state.slots[i] = None
                continue
            if s.req.cancelled.is_set():
                # the caller timed out and left: free the row
                if s.req.trace is not None:
                    t = time.perf_counter()
                    s.req.trace.add_span("abandoned", t, t,
                                         scheduler="iter", emitted=s.emitted)
                self._release_blocks(state, i)
                state.slots[i] = None
                continue
            done = s.emitted >= s.req.max_new_tokens
            eos_at = None
            if s.req.eos_id is not None and (done or eos_armed):
                # the EOS scan reads the segment: only armed batches pay
                # this host sync
                hits = np.flatnonzero(self._row_tokens(s) == s.req.eos_id)
                if hits.size:
                    eos_at = int(hits[0])
                    done = True
            if done:
                self._deliver(state, i, s, eos_at)

    def _row_tokens(self, s: _Slot) -> np.ndarray:
        if s.spec_buf is not None:
            # a spec row's buffer lane is its stream: the prompt at [pad,
            # pad + plen), every emitted token after it (a resumed row's
            # lane was rebuilt with them)
            start = s.spec_pad + s.plen
            n = min(s.emitted, s.req.max_new_tokens)
            return s.spec_buf[s.row, start:start + n]
        if s.resumed_prefix is not None:
            # tokens emitted before the park were read then; segments
            # since the resume append after them
            parts = [s.resumed_prefix]
        else:
            parts = [s.first_ref.np[s.first_idx:s.first_idx + 1]]
        parts += [seg.np[s.row] for seg, _ in s.segs]
        return np.concatenate(parts)[:s.req.max_new_tokens]

    def _deliver(self, state: _BatchState, i: int, s: _Slot, eos_at):
        """Retire the row and hand it to its caller, whose thread
        assembles the tokens, so the scheduler keeps dispatching."""
        if eos_at is not None and eos_at + 1 < s.req.max_new_tokens:
            with self._stats_lock:
                self.eos_retires += 1
            REGISTRY.inc("iter_eos_retires_total")
        s.done_t = time.monotonic()
        s.req.payload = (s, eos_at)
        s.req.done.set()
        self._release_blocks(state, i)
        state.slots[i] = None
        with self._stats_lock:
            self.rows_served += 1
        if state.spec_mode:
            self.spec._update_stats(1, 0, 0)
        REGISTRY.inc("iter_rows_total")
