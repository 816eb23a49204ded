"""Speculative decoding: prompt-lookup drafts, one verify forward a step.

Counterpart of ``llm_sharding_demo_tpu/runtime/spec_decode.py``. A verify
step forwards ``[t_last, d_1..d_K]`` through the cache at its current
length and emits 1..K+1 tokens:

- **draft** (``_draft_row``): the K tokens that followed the most recent
  earlier occurrence of the last ``ngram`` tokens (none: the last token
  repeated). The port drafts on the host, from the token buffer it keeps
  there, with the JAX function's exact rule: the ``low`` bound that keeps
  a left pad out of the search, the most recent match, the fallback.
- **verify** (``_accept_patch``): greedy keeps the longest prefix of the
  draft equal to the model's argmax and emits the argmax after it, so a
  greedy stream is the plain engine's token for token. Sample mode is
  rejection sampling against ``engine.sampler_pmf``: draft j is kept with
  probability ``p_j(d_j)``, the first rejection's bonus comes from the
  residual (``p_j`` with ``d_j`` zeroed), a full acceptance's from
  ``p_K``; every emitted token has the plain sampler's law.
- **rewind**: the cache length is a host int here (``ops.attention``),
  set back to the kept prefix. Slots past it hold stale K/V until the
  next verify writes them; attention reads only the written prefix.

The JAX package runs the whole generation as one ``lax.while_loop``; here
the loop is Python, and a verify costs one device-to-host read: the
per-row acceptance count and the K+1 patch tokens (``_fetch``), from
which the host updates its buffer, drafts the next window and sets the
cache length.

Batches (``_step_b``) keep every row at one uniform cache depth: row b's
content is ``buf[b, pad_b:total]``; after each verify the rows re-sync at
the longest row's content by a signed per-row roll of buffer and cache
(``_roll_cache_rows``, one gather a cache buffer), the slack landing in
each row's masked pad prefix. The roll is a permutation, so a row's
positions (slot - pad) and bits are unchanged and each row is byte-equal
to its solo run. ``_seg_b`` is the same step as a bounded segment, the
iteration batcher's spec segment (``runtime.iterbatch``).

Sampling draws from one ``torch.Generator`` a row: each verify draws the
row's K uniforms and then its bonus from it, so a batched row is
byte-equal to its solo run on a generator with the same seed, and a
segment boundary changes nothing. Streams cannot match the JAX PRNG's;
the law does (``sampler_pmf``).

The engine wraps a ``DecodeEngine`` pinned to the plain path
(``decode_kernel="xla"``), as the JAX engine is, so the spec stream and
its plain fallback share attention numerics; its int8 matmuls take
their kernels (``matmul_kernels``), as the JAX package's do on a TPU on
every verify window of <= 16 rows.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..models import is_window_independent
from ..ops.attention import KVCache
from ..utils import graftsched, graftscope, tracing
from ..utils.device import DeviceLike
from ..utils.metrics import REGISTRY
from .engine import (DecodeEngine, GenerateResult, Generators,
                     SamplingConfig, _sync, prepare_generate, sampler_pmf,
                     select_token)

# A spec segment may rewrite any slot of a row's cache (the re-sync roll),
# so paged storage must scatter whole rows back after it, never only the
# new columns (``runtime.iterbatch``).
SEG_REWRITES_FULL_CACHE = True


def draft_probs(probs: torch.Tensor, top_idx: torch.Tensor,
                drafts: torch.Tensor) -> torch.Tensor:
    """``p_j(d_j)`` ``[K]``: each draft's probability under the sampler
    pmf of the position before it (``probs``/``top_idx`` ``[K+1, k]``
    from ``sampler_pmf``; 0 outside the top-k survivors)."""
    k = drafts.shape[0]
    return (probs[:k] * (top_idx[:k] == drafts[:, None])).sum(-1)


def residual_pmf(probs: torch.Tensor, top_idx: torch.Tensor,
                 drafts: torch.Tensor, n_accept: torch.Tensor):
    """``(weights [k], token ids [k])`` of the bonus draw after
    ``n_accept`` kept drafts: the pmf of row ``n_accept`` with the
    rejected draft zeroed when a rejection happened there, unchanged when
    every draft was kept (unnormalized; the draw normalizes)."""
    k = drafts.shape[0]
    at = n_accept.reshape(1)
    row_p = probs.index_select(0, at)[0]
    row_i = top_idx.index_select(0, at)[0]
    d_rej = drafts.index_select(0, torch.clamp(at, max=k - 1))[0]
    zero_d = (n_accept < k) & (row_i == d_rej)
    return torch.where(zero_d, torch.zeros_like(row_p), row_p), row_i


def _with_length(cache, length: int):
    if isinstance(cache, list):
        return [_with_length(c, length) for c in cache]
    return KVCache(k=cache.k, v=cache.v, length=int(length))


@dataclasses.dataclass
class SegCarry:
    """The batched verify loop's state between steps (host side but the
    cache): row b's content is ``buf[b, pad[b]:total]``, ``cache.length
    == total - 1`` (the last emitted token is not forwarded yet)."""

    buf: np.ndarray               # [B, max_seq + K + 1] int64
    total: int
    cache: object
    pad: np.ndarray               # [B] int
    emitted: np.ndarray           # [B] tokens emitted (this call)
    steps: int = 0                # verify forwards


class SpecDecodeEngine:
    """Speculative decode engine (greedy and sample modes; single stream,
    batched, and the segment form the iteration batcher drives).

    ``draft_len`` (K) is the speculation depth: a verify forwards K+1
    tokens and emits 1..K+1. ``ngram`` is the prompt-lookup match width.
    """

    def __init__(self, params, config, max_seq: int, dtype="float32",
                 draft_len: int = 6, ngram: int = 2,
                 prefill_chunk: Optional[int] = None,
                 device: DeviceLike = None):
        if not is_window_independent(config):
            # a semantic gap, not an unported piece: a (K+1)-token verify
            # must route as the plain engine's single-token steps do
            raise NotImplementedError(
                "speculative decoding requires window-independent token "
                "routing; MoE capacity-factor routing makes multi-token "
                "verify windows route differently than single-token "
                "decode steps — serve MoE with the plain engine")
        if draft_len < 1:
            raise ValueError("draft_len must be >= 1")
        if ngram < 1:
            raise ValueError("ngram must be >= 1")
        self.draft_len = draft_len
        self.ngram = ngram
        self._eng = DecodeEngine(params, config, max_seq, dtype=dtype,
                                 prefill_chunk=prefill_chunk,
                                 decode_kernel="xla", device=device,
                                 matmul_kernels=True)
        self.config = config
        self.max_seq = max_seq
        self._stats_lock = graftsched.lock(
            "spec_decode.SpecDecodeEngine._stats_lock")
        self._requests = 0
        self._verifies = 0
        self._emitted = 0

    def _update_stats(self, n_req: int, n_tok: int, steps: int) -> None:
        """The one acceptance accounting: ``/healthz`` stats, counters
        and the acceptance-rate gauge."""
        with self._stats_lock:
            self._requests += n_req
            self._verifies += steps
            self._emitted += n_tok
            rate = self._emitted / max(self._verifies, 1)
        REGISTRY.inc("spec_verify_steps_total", value=steps)
        REGISTRY.inc("spec_emitted_tokens_total", value=n_tok)
        REGISTRY.gauge("spec_acceptance_rate", round(rate, 4))

    @property
    def plain(self) -> DecodeEngine:
        """The wrapped plain engine (same weights): the serving layer
        routes requests speculation cannot serve here."""
        return self._eng

    def check_request(self, prompt_len: int, max_new_tokens: int) -> None:
        """The speculation-eligibility rule, raising with the request's
        numbers: the batchers call it on the caller's thread."""
        if prompt_len < self.ngram:
            raise ValueError(
                f"prompt_len={prompt_len} shorter than ngram={self.ngram}")
        total = prompt_len + max_new_tokens + self.draft_len
        if total > self.max_seq:
            raise ValueError(
                f"prompt_len={prompt_len} + max_new_tokens="
                f"{max_new_tokens} + draft_len={self.draft_len} "
                f"exceeds max_seq={self.max_seq}; verify writes need "
                "draft_len slots of headroom")

    def eligible(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Boolean form of ``check_request`` (the serving router and the
        prefix store consult it; an ineligible request decodes plain)."""
        try:
            self.check_request(prompt_len, max_new_tokens)
            return True
        except ValueError:
            return False

    def stats(self) -> dict:
        """Cumulative speculation effectiveness (served at /healthz)."""
        with self._stats_lock:
            return {"requests": self._requests,
                    "verify_steps": self._verifies,
                    "emitted_tokens": self._emitted,
                    "draft_len": self.draft_len,
                    "tokens_per_verify": round(self._emitted
                                               / max(self._verifies, 1), 2)}

    # -- one verify step's pieces (solo loop, batched loop, segments) --------

    def _draft_row(self, buf: np.ndarray, low: int, total: int,
                   t_last: int) -> np.ndarray:
        """K drafts for one row: the tokens after the most recent match
        of the last ``ngram`` tokens over ``buf[low:total)`` (``low``
        keeps the left pad out of the search), the JAX function's
        clamped slices included; no match repeats ``t_last``."""
        k, ngram = self.draft_len, self.ngram
        buflen = buf.shape[0]
        at = min(max(total - ngram, 0), buflen - ngram)
        last = buf[at:at + ngram]
        j = np.arange(max(low, 0), max(total - ngram, low, 0))
        match = np.ones(j.shape, dtype=bool)
        for t in range(ngram):
            match &= buf[(j + t) % buflen] == last[t]
        hits = j[match]
        if hits.size == 0:
            return np.full((k,), t_last, dtype=np.int64)
        start = min(int(hits[-1]) + ngram, buflen - k)
        return buf[start:start + k].astype(np.int64)

    def _accept_patch(self, logits: torch.Tensor, drafts: torch.Tensor,
                      generator: Optional[torch.Generator],
                      sampling: SamplingConfig):
        """``[K+1, V]`` verify logits and ``[K]`` drafts -> ``(n_accept,
        patch [K+1])`` on the device: ``patch[j]`` for ``j <= n_accept``
        is the accepted drafts, then the bonus token. Sample mode draws
        K uniforms, then the bonus, from ``generator``."""
        k = self.draft_len
        if sampling.mode == "greedy":
            greedy = torch.argmax(logits, dim=-1)
            hits = (drafts == greedy[:k]).to(torch.int64)
            # greedy[j] is the token after x[j]: at the first mismatch the
            # bonus is the argmax itself, so the patch is the argmax row
            return torch.cumprod(hits, 0).sum(), greedy
        probs, top_idx = sampler_pmf(logits, sampling)       # [K+1, k]
        u = torch.rand((k,), generator=generator, device=logits.device)
        kept = (u < draft_probs(probs, top_idx, drafts)).to(torch.int64)
        n_accept = torch.cumprod(kept, 0).sum()
        weights, ids = residual_pmf(probs, top_idx, drafts, n_accept)
        bonus = ids[torch.multinomial(weights, 1, generator=generator)]
        dr_ext = torch.cat([drafts, drafts.new_zeros((1,))])
        pos = torch.arange(k + 1, device=logits.device)
        return n_accept, torch.where(pos < n_accept, dr_ext, bonus)

    def _accept_rows(self, logits: torch.Tensor, drafts: torch.Tensor,
                     sampling: SamplingConfig,
                     generators: Optional[Sequence]):
        """``_accept_patch`` over a batch: ``[B]`` counts and ``[B,
        K+1]`` patches. Greedy is one vectorized pass (bit-equal per row);
        sample rows each draw from their own generator, and a row whose
        entry is None (spent budget, ghost) draws nothing."""
        if sampling.mode == "greedy":
            k = self.draft_len
            greedy = torch.argmax(logits, dim=-1)
            hits = (drafts == greedy[:, :k]).to(torch.int64)
            return torch.cumprod(hits, 1).sum(1), greedy
        counts, patches = [], []
        for i, g in enumerate(generators):
            if g is None:
                counts.append(logits.new_zeros((), dtype=torch.int64))
                patches.append(torch.argmax(logits[i], dim=-1))
            else:
                n, p = self._accept_patch(logits[i], drafts[i], g, sampling)
                counts.append(n)
                patches.append(p)
        return torch.stack(counts), torch.stack(patches)

    @staticmethod
    def _fetch(n_accept: torch.Tensor, patch: torch.Tensor) -> np.ndarray:
        """The verify's one device-to-host read: ``[B, 1 + K+1]`` rows of
        (accepted drafts, patch tokens)."""
        both = torch.cat([n_accept.reshape(-1, 1), patch.reshape(
            n_accept.numel(), -1)], dim=1)
        return both.cpu().numpy()

    # -- the solo loop ---------------------------------------------------------

    @torch.inference_mode()
    def run_loop(self, prompt_row, first: torch.Tensor, cache,
                 prompt_len: int, generator: Generators,
                 max_new_tokens: int, sampling: SamplingConfig,
                 prefill_seconds: float = 0.0, pad=None,
                 delivered: Optional[tuple] = None) -> GenerateResult:
        """The verify loop off a prepared single-row prefill state
        (``first`` [1] from the prefill logits, ``cache.length ==
        prompt_len``), and its result; ``generate`` and the prefix store
        (``runtime.prefix_cache``) call it. Writes ``cache`` in place.

        ``pad`` ([1] numpy, optional) is the chunk-alignment left pad:
        masked as keys and kept out of the draft search. ``delivered``
        (``(requests, tokens)``) overrides the stats accounting for a
        front end that over-decodes."""
        sampling = dataclasses.replace(sampling, spec=False)
        if isinstance(generator, (list, tuple)):
            generator, = generator
        k, eng = self.draft_len, self._eng
        low = int(pad[0]) if pad is not None and pad.any() else 0
        pad_t = eng._pad(np.asarray(pad)) if low else None
        t1 = time.perf_counter()
        buf = np.zeros((self.max_seq + k + 1,), dtype=np.int64)
        buf[:prompt_len] = np.asarray(prompt_row).reshape(-1)[:prompt_len]
        buf[prompt_len] = int(first.reshape(-1)[0])
        total, emitted, steps = prompt_len + 1, 1, 0
        while emitted < max_new_tokens:
            t_last = int(buf[total - 1])
            drafts = self._draft_row(buf, low, total, t_last)
            x = np.concatenate([[t_last], drafts])[None]
            logits, cache = eng._forward_cached(eng._ids(x), cache, pad_t)
            n_accept, patch = self._accept_patch(
                logits[0], eng._ids(drafts), generator, sampling)
            got = self._fetch(n_accept, patch)[0]
            n_emit = min(int(got[0]) + 1, max_new_tokens - emitted)
            buf[total:total + n_emit] = got[1:1 + n_emit]
            # kept: t_last and the accepted prefix; the slots past them
            # are stale until the next verify writes them
            cache = _with_length(cache, total - 1 + n_emit)
            total += n_emit
            emitted += n_emit
            steps += 1
        t2 = time.perf_counter()
        n_req, n_tok = (delivered if delivered is not None
                        else (1, max_new_tokens))
        self._update_stats(n_req, n_tok, steps)
        tracing.record("decode", t1, t2, spec=True, batch=1,
                       verify_steps=steps, emitted=max_new_tokens)
        return GenerateResult(
            tokens=buf[None, :prompt_len + max_new_tokens].copy(),
            prompt_len=prompt_len, prefill_seconds=prefill_seconds,
            decode_seconds=t2 - t1, new_tokens=max_new_tokens,
            decode_steps=max_new_tokens - 1, verify_steps=steps,
            pad=pad if low else None)

    # -- the batched loop --------------------------------------------------------

    @staticmethod
    def _roll_cache_rows(cache, shifts):
        """Per-row signed roll of every cache buffer along the slot axis
        (``out[.., b, .., j, :] = in[.., b, .., j - shifts[b], :]``, mod
        the slot count): one gather a buffer, values intact. Plain, fused
        (placeholder ``v``) and staged (list) caches."""
        def g(x: torch.Tensor) -> torch.Tensor:
            if x.dim() <= 1:
                return x                           # fused placeholder v
            s = x.shape[-2]
            sh = torch.as_tensor(np.asarray(shifts), dtype=torch.int64,
                                 device=x.device)
            idx = (torch.arange(s, device=x.device)[None, :]
                   - sh[:, None]) % s              # [B, S]
            shape = (1, idx.shape[0]) + (1,) * (x.dim() - 4) + (s, 1)
            return torch.take_along_dim(x, idx.reshape(shape), dim=-2)

        def one(c: KVCache) -> KVCache:
            return KVCache(k=g(c.k), v=g(c.v), length=c.length)

        if isinstance(cache, list):
            return [one(c) for c in cache]
        return one(cache)

    def _step_b(self, sampling: SamplingConfig, budgets: np.ndarray,
                c: SegCarry, generators: Optional[Sequence]) -> SegCarry:
        """One batched verify and the per-row rewind and re-sync.
        ``budgets`` [B] caps each row's emission in this call (a row at
        its budget emits nothing and draws nothing); the batch re-syncs
        at the minimal uniform depth, the longest row's content, so
        writes keep the single-stream headroom bound."""
        k, eng = self.draft_len, self._eng
        buf, total, pad = c.buf, c.total, c.pad
        b, buflen = buf.shape
        t_last = buf[:, total - 1]
        drafts = np.stack([self._draft_row(buf[i], int(pad[i]), total,
                                           int(t_last[i]))
                           for i in range(b)])
        x = np.concatenate([t_last[:, None], drafts], axis=1)
        pad_t = torch.as_tensor(pad, dtype=torch.int32, device=eng.device)
        logits, cache = eng._forward_cached(eng._ids(x), c.cache, pad_t)
        room = budgets - c.emitted
        gens = None
        if sampling.mode != "greedy":
            gens = [g if room[i] > 0 else None
                    for i, g in enumerate(generators)]
        n_accept, patch = self._accept_rows(logits, eng._ids(drafts),
                                            sampling, gens)
        got = self._fetch(n_accept, patch)
        n_emit = np.clip(got[:, 0] + 1, 0, room)
        buf = buf.copy()
        for i in range(b):
            buf[i, total:total + n_emit[i]] = got[i, 1:1 + n_emit[i]]
        # re-sync: row b keeps n_emit of the K+1 verify slots, then rolls
        # so that its content ends at the new uniform depth
        content = (total - pad) + n_emit
        new_total = int(content.max())
        new_pad = new_total - content
        shifts = new_pad - pad
        if shifts.any():
            idx = (np.arange(buflen)[None, :] - shifts[:, None]) % buflen
            buf = np.take_along_axis(buf, idx, axis=1)
            cache = self._roll_cache_rows(cache, shifts)
        return SegCarry(buf=buf, total=new_total,
                        cache=_with_length(cache, new_total - 1),
                        pad=new_pad, emitted=c.emitted + n_emit,
                        steps=c.steps + 1)

    def _seg_b_impl(self, buf: np.ndarray, cache, total: int,
                    pad: np.ndarray, generators: Optional[Sequence],
                    budgets: np.ndarray, max_verify: int,
                    sampling: SamplingConfig) -> SegCarry:
        """A bounded verify SEGMENT over a live batch (the iteration
        batcher's spec segment): up to ``max_verify`` verifies, stopping
        once every row's ``budgets`` [B] are spent. The carry it returns
        resumes exactly where it stopped (each row's generator included).
        Every slot of a row may move (``SEG_REWRITES_FULL_CACHE``)."""
        sampling = dataclasses.replace(sampling, spec=False)
        budgets = np.asarray(budgets, dtype=np.int64)
        c = SegCarry(buf=buf, total=total, cache=cache,
                     pad=np.asarray(pad, dtype=np.int64),
                     emitted=np.zeros((buf.shape[0],), dtype=np.int64))
        while c.steps < max_verify and (c.emitted < budgets).any():
            c = self._step_b(sampling, budgets, c, generators)
        return c

    # each verify segment of the iteration batcher, timed into its
    # graftscope ring under (rows, verifies allowed)
    _seg_b = graftscope.instrument(
        _seg_b_impl, "spec_decode._seg_b",
        key_fn=lambda buf, *a, **k: (buf.shape[0], a[5]))

    def _run_loop_batched(self, ids: np.ndarray, first: torch.Tensor, cache,
                          prompt_len: int, generators, pad: np.ndarray,
                          max_new_tokens: int, sampling: SamplingConfig,
                          prefill_seconds: float = 0.0,
                          delivered: Optional[tuple] = None
                          ) -> GenerateResult:
        """The batched loop off a batched prefill until every row has
        ``max_new_tokens``. Rows that finish first stay as inert ghosts.
        The re-syncs keep the minimal uniform depth, so a pad common to
        every row slides out: the RETURNED pads are the ones to strip."""
        b = ids.shape[0]
        t1 = time.perf_counter()
        buf = np.zeros((b, self.max_seq + self.draft_len + 1),
                       dtype=np.int64)
        buf[:, :prompt_len] = ids
        buf[:, prompt_len] = first.cpu().numpy()
        budgets = np.full((b,), max_new_tokens, dtype=np.int64)
        c = SegCarry(buf=buf, total=prompt_len + 1, cache=cache,
                     pad=np.asarray(pad, dtype=np.int64),
                     emitted=np.ones((b,), dtype=np.int64))
        while (c.emitted < budgets).any():
            c = self._step_b(sampling, budgets, c, generators)
        t2 = time.perf_counter()
        n_req, n_tok = (delivered if delivered is not None
                        else (b, b * max_new_tokens))
        self._update_stats(n_req, n_tok, c.steps)
        tracing.record("decode", t1, t2, spec=True, batch=b,
                       verify_steps=c.steps, emitted=b * max_new_tokens)
        pad_out = c.pad.astype(np.int32)
        return GenerateResult(tokens=c.buf[:, :c.total].copy(),
                              prompt_len=prompt_len,
                              prefill_seconds=prefill_seconds,
                              decode_seconds=t2 - t1,
                              new_tokens=max_new_tokens,
                              decode_steps=max_new_tokens - 1,
                              verify_steps=c.steps,
                              pad=pad_out if pad_out.any() else None)

    # -- public API ------------------------------------------------------------

    @torch.inference_mode()
    def generate(self, prompt_ids, max_new_tokens: int,
                 sampling: SamplingConfig = SamplingConfig(),
                 generator: Generators = None,
                 pad: Optional[np.ndarray] = None,
                 delivered: Optional[tuple] = None) -> GenerateResult:
        """Speculative generate: per row the plain engine's greedy
        stream, and the plain sampler's law in sample mode. ``[S]``,
        ``[1, S]``, ``[B, S]`` and ragged prompt lists (left-padded);
        ``pad`` declares a pre-padded caller's left pads. A batched
        sample run takes one generator a row (``select_token``'s list
        form): row i is then byte-equal to its solo run on a generator
        seeded as ``generator[i]``. ``delivered`` overrides the stats
        accounting, as in ``run_loop``."""
        sampling = dataclasses.replace(sampling, spec=False)
        eng = self._eng
        ids, batch, prompt_len, pad = prepare_generate(
            prompt_ids, max_new_tokens, self.max_seq, sampling, generator,
            allow_ragged=True, pad=pad)
        min_plen = prompt_len - (int(pad.max()) if pad.any() else 0)
        if min_plen < self.ngram:
            raise ValueError(
                f"prompt_len={min_plen} shorter than ngram={self.ngram}")
        total_max = prompt_len + max_new_tokens + self.draft_len
        if total_max > self.max_seq:
            raise ValueError(
                f"prompt_len + max_new_tokens + draft_len = {total_max} "
                f"exceeds max_seq={self.max_seq}; verify writes need "
                "draft_len slots of headroom")
        if (batch > 1 and sampling.mode != "greedy"
                and not isinstance(generator, (list, tuple))):
            raise ValueError(
                "batched sample-mode speculation needs per-row "
                "generators (one torch.Generator a row; a single joint "
                "generator cannot be byte-equal to per-row solo runs)")
        ids, pad, prompt_len, chunk = eng._align_chunks(
            ids, pad, prompt_len, reserve=max_new_tokens + self.draft_len)
        t0 = time.perf_counter()
        last, cache = eng._prefill_last(ids, eng._pad(pad), chunk)
        first = select_token(last, sampling, generator)
        _sync(eng.device)
        t1 = time.perf_counter()
        tracing.record("prefill", t0, t1, batch=batch,
                       prompt_len=prompt_len, chunked=bool(chunk))
        if batch == 1:
            return self.run_loop(ids[0], first, cache, prompt_len, generator,
                                 max_new_tokens, sampling,
                                 prefill_seconds=t1 - t0,
                                 pad=pad if pad.any() else None,
                                 delivered=delivered)
        return self._run_loop_batched(ids, first, cache, prompt_len,
                                      generator, pad, max_new_tokens,
                                      sampling, prefill_seconds=t1 - t0,
                                      delivered=delivered)
