"""Request batching for serving: concurrent /generate calls share a card.

Counterpart of ``llm_sharding_demo_tpu/runtime/batcher.py``, the
admission batcher: callers block in ``generate`` while one worker thread
drains a queue, gathers compatible requests for up to ``max_wait_ms``,
left-pads the ragged prompts, runs ONE batched ``DecodeEngine.generate``
and hands each row back truncated to its own ``max_new_tokens``.

- Shapes are bucketed as in the JAX package: the batch width rounds up
  to a power of two (dummy rows copy the last real request's ids and
  draw nothing), prompt lengths to ``prompt_bucket``, steps to
  ``steps_bucket``. Requests whose bucketed shapes cannot share
  ``max_seq`` split into sub-batches (``_plan``, ``_shapes``).
- Rounds are policy-pure: requests batch when their ``SamplingConfig``
  matches; an out-of-policy arrival is held as the next round's head
  (``_pending``), so FIFO survives a policy change.
- Sampled rows each draw from their own request's ``torch.Generator``
  (``engine.select_token``'s per-row form), so a seeded row is byte-equal
  to its solo run whatever it was batched with.

- With a prefix store (``prefix=``, a ``PrefixCachingEngine`` over the
  same engine) a solo round goes through ``prefix.generate``; a greedy
  round of several rows prefills each row through the store
  (``prefix.prefill_state``), merges the right-aligned row caches into
  one left-padded cache by a roll (``_merge``) and decodes once
  (``_run_prefix``). Sampled rounds of several rows bypass the store.
- With a speculative engine (``spec=``, a ``SpecDecodeEngine`` over the
  same engine) requests whose policy carries ``SamplingConfig.spec``
  gather into their own rounds (the flag is part of policy equality) and
  decode through the spec engine's batched verify loop (``_run_spec``),
  each row byte-equal to its solo speculative run, greedy and seeded;
  their shapes keep ``draft_len`` slots of verify headroom.

The worker thread enters ``torch.inference_mode`` itself (it is
thread-local) and owns all device work.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..ops.attention import KVCache
from ..utils import graftsched, graftscope, tracing
from ..utils.device import device_scope
from ..utils.metrics import REGISTRY, kv_block_gauges
from .engine import DecodeEngine, GenerateResult, SamplingConfig

def _round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _bucket_batch(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


def check_compositions(engine, prefix, spec) -> None:
    """A prefix store and a speculative engine must wrap the batcher's
    own engine (the same weights)."""
    if prefix is not None and prefix.plain is not engine:
        raise ValueError("prefix must wrap the same engine instance")
    if spec is not None and spec.plain is not engine:
        raise ValueError("spec must wrap the same DecodeEngine (shared "
                         "weights/programs), got a different instance")


def _merge_impl(solos, pads: np.ndarray, length: int):
    """Per-row right-aligned caches -> one left-padded batch cache: row
    i's content at slots ``[0, plen_i)`` rolls by ``pads[i]`` to
    ``[pad_i, s_max)`` (what wraps lands in the masked pad prefix, and
    past ``s_max`` where decode writes before it reads). Plain, fused
    (placeholder ``v``) and staged (list) caches."""
    def one(rows):
        def cat(leaves):
            if leaves[0].dim() <= 1:           # fused placeholder v
                return leaves[0]
            return torch.cat([torch.roll(x, int(pads[i]), dims=-2)
                              for i, x in enumerate(leaves)], dim=1)
        return KVCache(k=cat([c.k for c in rows]),
                       v=cat([c.v for c in rows]), length=length)

    if isinstance(solos[0], list):             # staged engine
        return [one([s[j] for s in solos]) for j in range(len(solos[0]))]
    return one(solos)


def _merge_scope_key(solos, pads, length):
    """(rows, solo cache width)."""
    first = solos[0][0] if isinstance(solos[0], list) else solos[0]
    return (len(solos), int(first.k.shape[-2]))


_merge = graftscope.instrument(_merge_impl, "batcher._merge",
                               key_fn=_merge_scope_key)


@dataclasses.dataclass
class _Request:
    prompt: np.ndarray            # [S] int64
    max_new_tokens: int
    sampling: SamplingConfig
    generator: Optional[torch.Generator]
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None   # [prompt + new] tokens
    timing: Optional[GenerateResult] = None  # the round's engine result
    error: Optional[Exception] = None
    # the caller's ambient trace rides the queue: the worker stamps queue
    # wait and fans the round's shared phases out to every row
    trace: Optional[object] = None
    t_submit: float = 0.0


class BatchingEngine:
    """Thread-safe batched front end over a ``DecodeEngine``: ``generate``
    may be called from many threads at once and blocks until its row is
    ready."""

    def __init__(self, engine: DecodeEngine, max_batch: int = 8,
                 max_wait_ms: float = 5.0, prompt_bucket: int = 16,
                 steps_bucket: int = 32, prefix=None, spec=None):
        check_compositions(engine, prefix, spec)
        self.engine = engine
        self.prefix = prefix
        self.spec = spec
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.prompt_bucket = prompt_bucket
        self.steps_bucket = steps_bucket
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: Optional[_Request] = None  # held head of next round
        self._stats_lock = graftsched.lock(
            "batcher.BatchingEngine._stats_lock")
        self.batches_run = 0
        self.rows_served = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- caller side ---------------------------------------------------------

    def generate(self, prompt_ids, max_new_tokens: int,
                 sampling: SamplingConfig = SamplingConfig(),
                 generator: Optional[torch.Generator] = None,
                 timeout: Optional[float] = None) -> GenerateResult:
        """One request's ``[S]`` (or ``[1, S]``) prompt; blocks until the
        round holding it completes, at most ``timeout`` seconds."""
        prompt = np.asarray(prompt_ids, dtype=np.int64).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must be non-empty")
        if len(prompt) + max_new_tokens > self.engine.max_seq:
            # checked on the caller's thread, naming this request's
            # numbers (the worker plans assuming every request fits)
            raise ValueError(
                f"prompt_len={len(prompt)} + max_new_tokens="
                f"{max_new_tokens} exceeds max_seq={self.engine.max_seq}")
        if sampling.mode != "greedy" and generator is None:
            raise ValueError(
                "sample-mode requests must carry their own torch.Generator")
        if sampling.spec:
            # refused here, with this request's numbers, not mid-round
            if self.spec is None:
                raise ValueError(
                    "sampling.spec requested but this batcher has no "
                    "speculative engine attached (pass spec= at "
                    "construction)")
            self.spec.check_request(len(prompt), max_new_tokens)
        req = _Request(prompt=prompt, max_new_tokens=max_new_tokens,
                       sampling=sampling, generator=generator,
                       trace=tracing.current_trace(),
                       t_submit=time.perf_counter())
        self._queue.put(req)
        REGISTRY.gauge("queue_depth", self._queue.qsize(),
                       scheduler="admission")
        if not req.done.wait(timeout):
            raise TimeoutError("batched generate timed out")
        if req.error is not None:
            raise req.error
        inner = req.timing
        return GenerateResult(
            tokens=req.result[None, :], prompt_len=len(prompt),
            prefill_seconds=inner.prefill_seconds,
            decode_seconds=inner.decode_seconds,
            new_tokens=max_new_tokens, decode_steps=inner.decode_steps)

    def stats(self) -> dict:
        with self._stats_lock:
            return {"batches": self.batches_run, "rows": self.rows_served}

    # -- worker side ---------------------------------------------------------

    def _gather(self) -> List[_Request]:
        """Block for the first request (the held head, if any), then
        collect same-policy peers for up to ``max_wait_ms``. An
        out-of-policy arrival ends the round and is held as the next
        round's head."""
        with self._stats_lock:
            first, self._pending = self._pending, None
        if first is None:
            first = self._queue.get()
        batch = [first]
        if (first.sampling.mode != "greedy" and self.prefix is not None
                and self.prefix.spec is not None):
            # a solo round through a speculating store rejection-samples,
            # a batched one would draw per step: keep such requests solo,
            # so that a seeded stream does not depend on the traffic
            return batch
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt.sampling == first.sampling:
                batch.append(nxt)
            else:
                with self._stats_lock:
                    self._pending = nxt
                break
        return batch

    def _plan(self, batch: List[_Request]) -> List[List[_Request]]:
        """Split a gathered batch into bucket-feasible sub-batches, first
        fit, arrival order kept within each."""
        subs: List[List[_Request]] = []
        for req in batch:
            for sub in subs:
                if self._shapes(sub + [req]) is not None:
                    sub.append(req)
                    break
            else:
                subs.append([req])
        return subs

    def _shapes(self, batch: List[_Request]):
        """``(s_max, steps)`` of a candidate round, or None when its
        bucketed shapes cannot fit ``max_seq`` together. Prompt bucketing
        is capped so the bucket alone never passes ``max_seq``; spec
        rounds keep ``draft_len`` slots of verify headroom."""
        raw_s = max(len(r.prompt) for r in batch)
        need = max(r.max_new_tokens for r in batch)
        reserve = self.spec.draft_len if batch[0].sampling.spec else 0
        s_max = min(_round_up(raw_s, self.prompt_bucket),
                    self.engine.max_seq - need - reserve)
        if s_max < raw_s:
            return None
        steps = min(_round_up(need, self.steps_bucket),
                    self.engine.max_seq - s_max - reserve)
        return s_max, steps

    def _loop(self):
        with torch.inference_mode(), device_scope(self.engine.device):
            while True:
                gathered = self._gather()
                for batch in self._plan(gathered):
                    try:
                        self._run(batch)
                    except Exception as e:  # noqa: BLE001 — per request
                        for req in batch:
                            req.error = e
                            req.done.set()

    def _run(self, batch: List[_Request]):
        """Stamp each request's queue wait, then run the round with its
        shared phases fanned out to every row's trace."""
        t_now = time.perf_counter()
        traces = [r.trace for r in batch if r.trace is not None]
        for r in batch:
            if r.trace is not None:
                r.trace.add_span("queue_wait", r.t_submit, t_now,
                                 scheduler="admission")
        with tracing.use_trace(tracing.fanout(traces) if traces else None):
            self._run_inner(batch)

    def _run_inner(self, batch: List[_Request]):
        if batch[0].sampling.spec:
            # spec rounds, solo included, take the batched verify loop
            # whether or not a prefix store is attached: the stream is a
            # function of the request alone
            self._run_spec(batch)
            return
        if self.prefix is not None and len(batch) == 1:
            # a solo round keeps the single-stream prefix path and its
            # true shapes
            req = batch[0]
            result = self.prefix.generate(req.prompt, req.max_new_tokens,
                                          sampling=req.sampling,
                                          generator=req.generator)
            self._deliver(batch, result)
            return
        s_max, steps = self._shapes(batch)  # planned feasible: not None
        b = _bucket_batch(len(batch), self.max_batch)
        ids, pad = self._bucket_rows(batch, b, s_max)
        kv_block_gauges("batcher", b * (s_max + steps),
                        b * self.engine._cache_seq)
        sampling = batch[0].sampling
        if self.prefix is not None and sampling.mode == "greedy":
            result = self._run_prefix(batch, ids, pad, steps)
        else:
            # dummy rows draw nothing: a real row's generator advances
            # once a step, by its own row only. Sampled rounds bypass the
            # prefix store: its first-token merge is argmax.
            generators = (None if sampling.mode == "greedy"
                          else [r.generator for r in batch]
                          + [None] * (b - len(batch)))
            result = self.engine.generate(ids, steps, sampling=sampling,
                                          generator=generators, pad=pad)
        self._deliver(batch, result, padded_rows=b - len(batch))

    def _run_spec(self, batch: List[_Request]):
        """One bucketed round through ``SpecDecodeEngine.generate``'s
        batched loop, shaped as a plain round (``_shapes`` keeps the
        verify headroom). A row past its own ``max_new_tokens`` is bucket
        over-decode, cut in ``_deliver``; the stats count what callers
        were served."""
        s_max, steps = self._shapes(batch)  # planned feasible: not None
        b = _bucket_batch(len(batch), self.max_batch)
        ids, pad = self._bucket_rows(batch, b, s_max)
        generators = None
        if batch[0].sampling.mode != "greedy":
            # dummy rows draw nothing
            generators = ([r.generator for r in batch]
                          + [None] * (b - len(batch)))
        result = self.spec.generate(
            ids, steps, sampling=batch[0].sampling, generator=generators,
            pad=pad, delivered=(len(batch),
                                sum(r.max_new_tokens for r in batch)))
        self._deliver(batch, result, padded_rows=b - len(batch))

    def _run_prefix(self, batch: List[_Request], ids: np.ndarray,
                    pad: np.ndarray, steps: int) -> GenerateResult:
        """A greedy round over per-row prefix-store prefills: each row's
        right-aligned cache rolls into one left-padded batch cache, then
        one batched decode. Dummy rows clone the last real row."""
        t0 = time.perf_counter()
        states = []
        for req in batch:
            # this row's prefill span goes to its own trace
            with tracing.use_trace(req.trace):
                last, cache, _ = self.prefix.prefill_state(req.prompt)
            states.append((last, cache))
        while len(states) < ids.shape[0]:
            states.append(states[len(batch) - 1])
        first = torch.argmax(torch.cat([s[0] for s in states]), dim=-1)
        cache = _merge([s[1] for s in states], pad, ids.shape[1])
        eng = self.engine
        return eng._decode_and_pack(ids, pad, eng._pad(pad), first, cache,
                                    steps, batch[0].sampling, None,
                                    ids.shape[1], time.perf_counter() - t0)

    @staticmethod
    def _bucket_rows(batch: List[_Request], b: int, s_max: int):
        """Right-aligned ``[b, s_max]`` prompt matrix and per-row left
        pad; dummy rows copy the last real request."""
        ids = np.zeros((b, s_max), dtype=np.int64)
        pad = np.zeros((b,), dtype=np.int32)
        for i in range(b):
            r = batch[min(i, len(batch) - 1)]
            ids[i, s_max - len(r.prompt):] = r.prompt
            pad[i] = s_max - len(r.prompt)
        return ids, pad

    def _deliver(self, batch: List[_Request], result: GenerateResult,
                 padded_rows: int = 0):
        with self._stats_lock:
            self.batches_run += 1
            self.rows_served += len(batch)
        REGISTRY.inc("decode_batches_total")
        REGISTRY.inc("batched_requests_total", value=len(batch))
        REGISTRY.inc("batched_rows_padded_total", value=padded_rows)
        width = len(batch) + padded_rows
        occupancy = round(len(batch) / width, 4)
        depth = self._queue.qsize()
        REGISTRY.gauge("batch_occupancy", occupancy, scheduler="admission")
        graftscope.sample("batch_occupancy", occupancy,
                          scheduler="admission")
        graftscope.sample("queue_depth", depth, scheduler="admission")
        kv_block_gauges("batcher", 0, width * self.engine._cache_seq)
        REGISTRY.gauge("queue_depth", depth, scheduler="admission")
        for i, req in enumerate(batch):
            # row_tokens strips the engine-reported pad: the bucket pad
            # plus any chunk-alignment pad the engine added on top
            row = result.row_tokens(i)
            req.result = row[:len(req.prompt) + req.max_new_tokens]
            req.timing = result
            req.done.set()
