"""Speculative decoding composed with the port's front ends, against the
port's solo spec runs and the JAX package on the same numpy weights.

- ``BatchingEngine(spec=)``: spec-flagged requests gather into their own
  rounds and each row equals its solo speculative run (greedy and
  seeded); the stats count the tokens served, not the bucketed steps.
- ``IterBatchingEngine(spec=)``: a spec request joins a live speculating
  batch mid-flight, sampled rows stay byte-equal across segment
  boundaries, spec and plain batches stay apart, and on the paged pool
  the segments stay exact, under preemption and resume too (content the
  re-sync rolls below a row's first block takes new blocks first).
- ``PrefixCachingEngine(spec=)``: streams and verify counts equal to the
  JAX store with ``spec=``.
- ``SPEC_DECODE`` servers (solo, admission, iter, prefix store, iter on
  the pool) reply as the JAX app with the same knobs, with
  ``spec_decode_stats`` in ``/healthz``; the knob parses and refuses as
  JAX's does. Every blocking call has a timeout.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.runtime.prefix_cache import (
    PrefixCachingEngine as JPrefixCachingEngine)
from llm_sharding_demo_tpu.runtime.spec_decode import (
    SpecDecodeEngine as JSpecDecodeEngine)
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils import config as jconfig
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime.batcher import BatchingEngine
from llm_sharding_demo_tpu_torch.runtime.engine import SamplingConfig
from llm_sharding_demo_tpu_torch.runtime.iterbatch import IterBatchingEngine
from llm_sharding_demo_tpu_torch.runtime.kv_pool import KVBlockPool
from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
    PrefixCachingEngine)
from llm_sharding_demo_tpu_torch.runtime.spec_decode import SpecDecodeEngine
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import config as tconfig
from llm_sharding_demo_tpu_torch.utils import graftfault
from test_torch_iterbatch import _after_segments, _staggered
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

DIMS = dict(vocab_size=211, n_positions=256, n_embd=32, n_layer=2, n_head=4)
MAX_SEQ = 200
K = 5
BS = 8
WAIT = 60  # seconds: a bound on every join and blocking call
SPEC = SamplingConfig(spec=True)
SAMPLED = SamplingConfig(mode="sample", temperature=0.7, top_k=30, spec=True)


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params(seed=0, std=0.3, dims=DIMS)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def spec(weights):
    return SpecDecodeEngine(weights[1], gpt2.GPT2Config(**DIMS),
                            max_seq=MAX_SEQ, draft_len=K, device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _solo(spec, p, n, **kw):
    return spec.generate(np.asarray(p), n, **kw).tokens[0]


def _threads(fn, n):
    out = [None] * n

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 — returned to the test
            out[i] = e

    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=2 * WAIT)
        assert not t.is_alive(), "a request never completed"
    return out


# -- the admission batcher ----------------------------------------------------

def test_admission_spec_rounds_equal_solo_and_count_served(weights, spec):
    """Three spec-flagged requests share a round (bucketed to 4 rows and
    32 steps): each row equals its solo spec run, which equals the JAX
    spec engine's; stats count the tokens callers were served."""
    jspec = JSpecDecodeEngine(weights[0], jgpt2.GPT2Config(**DIMS),
                              max_seq=MAX_SEQ, draft_len=K)
    rng = np.random.default_rng(11)
    prompts = [np.asarray([5, 17, 3, 42] * 3), rng.integers(0, 211, 9),
               np.asarray([7] * 8)]
    new = [9, 5, 7]
    want = [_solo(spec, p, n) for p, n in zip(prompts, new)]
    for p, n, w in zip(prompts, new, want):
        np.testing.assert_array_equal(
            w, np.asarray(jspec.generate(p.astype(np.int32), n).tokens[0]))
    batcher = BatchingEngine(spec.plain, max_batch=4, max_wait_ms=300.0,
                             spec=spec)
    base = spec.stats()
    got = _threads(lambda i: batcher.generate(
        prompts[i], new[i], sampling=SPEC, timeout=WAIT).tokens[0], 3)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    st = spec.stats()
    assert st["requests"] - base["requests"] == 3
    assert st["emitted_tokens"] - base["emitted_tokens"] == sum(new)
    assert batcher.stats()["rows"] == 3


def test_admission_spec_sampled_rows_equal_solo(spec):
    """Seeded spec rows draw from their own generators: a round's rows
    equal their solo runs (dummy rows draw nothing)."""
    s = SamplingConfig(mode="sample", temperature=0.8, top_k=12, spec=True)
    prompts = [np.asarray([5, 9] * 4), np.asarray([3, 1, 4, 1, 5, 9, 2])]
    want = [_solo(spec, p, 14, sampling=s, generator=_gen(20 + i))
            for i, p in enumerate(prompts)]
    batcher = BatchingEngine(spec.plain, max_batch=4, max_wait_ms=300.0,
                             spec=spec)
    got = _threads(lambda i: batcher.generate(
        prompts[i], 14, sampling=s, generator=_gen(20 + i),
        timeout=WAIT).tokens[0], 2)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_spec_flag_refusals_on_the_caller_thread(spec):
    for front in (BatchingEngine(spec.plain, max_batch=2),
                  IterBatchingEngine(spec.plain, max_batch=2)):
        with pytest.raises(ValueError, match="speculative engine"):
            front.generate(np.arange(8), 4, sampling=SPEC, timeout=WAIT)
    for front in (BatchingEngine(spec.plain, max_batch=2, spec=spec),
                  IterBatchingEngine(spec.plain, max_batch=2, spec=spec)):
        with pytest.raises(ValueError, match="shorter than ngram"):
            front.generate(np.asarray([5]), 4, sampling=SPEC, timeout=WAIT)
        with pytest.raises(ValueError, match="headroom"):
            front.generate(np.arange(8), MAX_SEQ - 8, sampling=SPEC,
                           timeout=WAIT)


# -- the iteration batcher ----------------------------------------------------

def _iter(spec, **kw):
    kw.setdefault("seg_steps", 12)
    kw.setdefault("max_wait_ms", 50.0)
    return IterBatchingEngine(spec.plain, max_batch=4, spec=spec, **kw)


def test_iter_spec_midflight_join_exact(spec):
    """A spec request joins a live speculating batch at a segment
    boundary; both rows equal their solo spec runs."""
    ib = _iter(spec)
    rng = np.random.default_rng(31)
    pA = np.asarray([5, 17, 3, 42] * 6)                # accepts drafts
    pB = rng.integers(0, 211, 9)                       # mostly rejects
    wantA, wantB = _solo(spec, pA, 96), _solo(spec, pB, 40)
    resA, resB = _staggered(ib, [
        (pA, 96, 0.0, dict(sampling=SPEC)),
        (pB, 40, _after_segments(ib, 0, 1), dict(sampling=SPEC))])
    np.testing.assert_array_equal(resA.tokens[0], wantA)
    np.testing.assert_array_equal(resB.tokens[0], wantB)
    st = ib.stats()
    assert st["joins"] >= 1 and st["batches"] == 1
    assert st["spec_segments"] == st["segments"] >= 2


def test_iter_spec_sampled_rows_equal_solo_across_segments(spec):
    """One verify a segment (seg_steps < K + 1): every verify ends at a
    segment boundary, and seeded rows still equal their solo runs."""
    ib = _iter(spec, seg_steps=4)
    pA, pB = np.asarray([7, 3] * 8), np.asarray([9, 2, 11] * 4)
    wantA = _solo(spec, pA, 60, sampling=SAMPLED, generator=_gen(61))
    wantB = _solo(spec, pB, 24, sampling=SAMPLED, generator=_gen(62))
    resA, resB = _staggered(ib, [
        (pA, 60, 0.0, dict(sampling=SAMPLED, generator=_gen(61))),
        (pB, 24, _after_segments(ib, 0, 1),
         dict(sampling=SAMPLED, generator=_gen(62)))])
    np.testing.assert_array_equal(resA.tokens[0], wantA)
    np.testing.assert_array_equal(resB.tokens[0], wantB)
    assert ib.stats()["spec_segments"] >= 10


def test_iter_spec_and_plain_batches_stay_apart(spec):
    """The spec flag is part of policy equality: a plain arrival during a
    spec batch seeds its own batch, and both finish exact."""
    ib = _iter(spec)
    rng = np.random.default_rng(33)
    pS, pP = np.asarray([4, 19] * 6), rng.integers(0, 211, 7)
    wantS = _solo(spec, pS, 60)
    wantP = spec.plain.generate(pP[None], 20).tokens[0]
    resS, resP = _staggered(ib, [
        (pS, 60, 0.0, dict(sampling=SPEC)),
        (pP, 20, _after_segments(ib, 0, 1), {})])
    np.testing.assert_array_equal(resS.tokens[0], wantS)
    np.testing.assert_array_equal(resP.tokens[0], wantP)
    st = ib.stats()
    assert st["batches"] == 2 and 1 <= st["spec_segments"] < st["segments"]
    assert spec.stats()["requests"] >= 1


def test_iter_spec_eos_row_retires_early(spec):
    """A spec row armed with ``eos_id`` retires at the segment boundary
    after its EOS, its stream the solo spec run's cut there."""
    ib = _iter(spec)
    rng = np.random.default_rng(34)
    pA, pB = np.asarray([6, 2, 8] * 5), rng.integers(0, 211, 10)
    wantA, fullB = _solo(spec, pA, 80), _solo(spec, pB, 80)
    eos = int(fullB[10 + 20])                 # B's 21st new token
    n_eos = int(np.flatnonzero(fullB[10:] == eos)[0]) + 1
    resA, resB = _staggered(ib, [
        (pA, 80, 0.0, dict(sampling=SPEC)),
        (pB, 80, 0.05, dict(sampling=SPEC, eos_id=eos))])
    np.testing.assert_array_equal(resA.tokens[0], wantA)
    np.testing.assert_array_equal(resB.tokens[0], fullB[:10 + n_eos])
    assert ib.stats()["eos_retires"] >= 1


@pytest.mark.parametrize("sampling", [SPEC, SAMPLED], ids=["greedy",
                                                            "sampled"])
def test_iter_spec_fault_park_resumes_exact(spec, sampling):
    """One transient fault before a segment parks the spec row; it
    resumes by recompute (its lane rebuilt, its generator where the
    last verify left it) and equals the unfaulted solo run."""
    ib = _iter(spec, seg_steps=7, max_wait_ms=5.0)
    p = np.asarray([5, 17, 3, 42, 9, 2, 11, 7])

    def kw():
        return dict(sampling=sampling, **(
            {} if sampling.mode == "greedy" else dict(generator=_gen(8))))
    want = _solo(spec, p, 30, **kw())
    plan = _FaultAtSegment(3)
    with graftfault.use(plan):
        got = ib.generate(p, 30, timeout=WAIT, **kw())
    assert [(i.kind, i.seq) for i in plan.injections] == [
        ("decode_transient", 3)]
    st = ib.stats()
    assert st["fault_parks"] == 1 and st["resumes"] == 1
    assert st["spec_segments"] >= 4
    np.testing.assert_array_equal(got.tokens[0], want)


class _FaultAtSegment(graftfault.FaultPlan):
    """One transient fault, at the ``at``-th segment boundary (0-based),
    so that the parked row has verified before it parks."""

    def __init__(self, at: int):
        super().__init__(rate=1.0, sites={"iterbatch.decode_seg"},
                         kinds={"decode_transient"}, max_injections=1)
        self.at = at

    def _decide(self, site, n, kinds):
        return super()._decide(site, n, kinds) if n == self.at else None


def _pooled(spec, num_blocks, **kw):
    pool = KVBlockPool.for_engine(spec.plain, num_blocks=num_blocks,
                                  block_size=BS, watermark=1.0)
    return pool, _iter(spec, pool=pool, **kw)


def test_iter_spec_pool_segments_equal_solo(spec):
    pool, ib = _pooled(spec, 32)
    pA = np.asarray([5, 17, 3, 42] * 6)
    res = ib.generate(pA, 96, sampling=SPEC, timeout=WAIT)
    np.testing.assert_array_equal(res.tokens[0], _solo(spec, pA, 96))
    assert ib.stats()["spec_segments"] >= 2
    assert pool.allocator.stats().blocks_in_use == 0


@pytest.mark.parametrize("sampling", [SPEC, SAMPLED], ids=["greedy",
                                                            "sampled"])
def test_iter_spec_pool_preempt_resume_byte_identical(spec, sampling):
    """Two rows oversubscribe a pool of 25 blocks: the younger parks and
    resumes by recompute, both streams equal their solo runs. The short
    repetitive row accepts faster than the long random one, so its pad
    shrinks: the re-sync rolls its content below its first block, which
    takes new blocks before the scatter (``_extend_blocks_down``)."""
    pool, ib = _pooled(spec, 25, max_wait_ms=300.0)
    rng = np.random.default_rng(42)
    pA = np.asarray([5, 17, 3, 42] * 2)
    pB = rng.integers(0, 211, 40)

    def kw(i):   # a fresh generator of the row's seed each call
        return dict(sampling=sampling, **(
            {} if sampling.mode == "greedy" else
            dict(generator=_gen(70 + i))))
    wantA, wantB = _solo(spec, pA, 100, **kw(0)), _solo(spec, pB, 80, **kw(1))
    extended = []
    down = ib._extend_blocks_down

    def watch(state, pad):
        before = [s.blk_lo for s in state.slots if s is not None]
        down(state, pad)
        after = [s.blk_lo for s in state.slots if s is not None]
        extended.append(len(after) == len(before) and any(
            a < b for a, b in zip(after, before)))
    ib._extend_blocks_down = watch
    resA, resB = _staggered(ib, [(pA, 100, 0.0, kw(0)), (pB, 80, 0.0, kw(1))])
    np.testing.assert_array_equal(resA.tokens[0], wantA)
    np.testing.assert_array_equal(resB.tokens[0], wantB)
    st = ib.stats()
    assert st["preemptions"] >= 1 and st["resumes"] >= 1
    assert any(extended)
    assert pool.allocator.stats().blocks_in_use == 0


# -- the prefix store ---------------------------------------------------------

def test_prefix_store_with_spec_equals_jax(weights):
    """Cold, hit, partial hit and a prompt too short to speculate: the
    port's store with ``spec=`` gives the JAX store's streams, verify
    counts and stats."""
    jp, tp = weights
    mine = SpecDecodeEngine(tp, gpt2.GPT2Config(**DIMS), max_seq=192,
                            draft_len=K, device="cpu")
    ref = JSpecDecodeEngine(jp, jgpt2.GPT2Config(**DIMS), max_seq=192,
                            draft_len=K)
    pce = PrefixCachingEngine(mine.plain, capacity=2, chunk=16, spec=mine)
    jpce = JPrefixCachingEngine(ref.plain, capacity=2, chunk=16, spec=ref)
    system = np.asarray([4, 9] * 20)
    prompts = [np.concatenate([system, [4, 9] * n]) for n in (6, 11, 3)]
    prompts += [np.concatenate([system[:20], np.arange(30) % 13]),
                np.asarray([4])]
    for p in prompts:
        got = pce.generate(p, 15)
        want = jpce.generate(p.astype(np.int32), 15)
        np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
        assert got.verify_steps == want.verify_steps
        np.testing.assert_array_equal(
            got.tokens, mine.plain.generate(p[None], 15).tokens)
    assert pce.stats() == jpce.stats()
    assert mine.stats() == ref.stats()
    assert pce.stats()["hits"] >= 1 and mine.stats()["requests"] == 4


# -- serving ------------------------------------------------------------------

APP_SEQ = 96


def _app(weights, jax_app=False, **knobs):
    jp, tp = weights
    cfg = dict(model_id="t", max_seq=APP_SEQ, boundaries=(1,), **knobs)
    if jax_app:
        return JTestClient(jcreate_app(jconfig.ServingConfig(**cfg),
                                       model=(jgpt2.GPT2Config(**DIMS), jp),
                                       tokenizer=JByteTokenizer()))
    return TestClient(create_app(tconfig.ServingConfig(**cfg),
                                 model=(gpt2.GPT2Config(**DIMS), tp),
                                 tokenizer=ByteTokenizer(), device="cpu"))


@pytest.mark.parametrize("knobs", [
    {},
    dict(max_batch=4, batch_wait_ms=50.0),
    dict(max_batch=4, batch_mode="iter", batch_wait_ms=50.0),
    dict(prefix_cache=2, prefill_chunk=8),
    dict(max_batch=4, batch_wait_ms=50.0, prefix_cache=2, prefix_chunk=8),
    dict(max_batch=4, batch_mode="iter", kv_pool_blocks=48, kv_block_size=8),
], ids=["solo", "admission", "iter", "prefix", "admission-prefix",
        "iter-pool"])
def test_spec_app_replies_equal_jax(weights, knobs):
    """SPEC_DECODE=4 servers reply as the JAX app with the same knobs
    (a spec-eligible greedy request twice, one too short to speculate,
    a seeded sampled one that replays); ``/healthz`` serves the spec
    stats and, on the iter batcher, its spec segments."""
    app = _app(weights, spec_decode=4, **knobs)
    japp = _app(weights, jax_app=True, spec_decode=4, **knobs)
    bodies = [{"prompt": "Hi, Hi, Hi, Hi, ", "max_new_tokens": 10,
               "mode": "greedy"},
              {"prompt": "Hi, Hi, Hi, Hi, ", "max_new_tokens": 10,
               "mode": "greedy"},
              {"prompt": "a", "max_new_tokens": 6, "mode": "greedy"}]
    for b in bodies:
        assert app.post("/generate", json=b).json() == japp.post(
            "/generate", json=b).json()
    sample = {"prompt": "abcabc", "max_new_tokens": 8, "seed": 3}
    first = app.post("/generate", json=sample).json()
    assert "generated" in first
    assert app.post("/generate", json=sample).json() == first
    h = app.get("/healthz").json()
    assert h["spec_decode"] == 4 and h["n_stages"] == 1
    st = h["spec_decode_stats"]
    assert st["requests"] >= 3 and st["verify_steps"] >= 1
    assert st["draft_len"] == 4
    if knobs.get("batch_mode") == "iter":
        assert h["batch_stats"]["spec_segments"] >= 1
    if "prefix_cache" in knobs:
        # spec rounds bypass the store, as in the JAX batcher: only the
        # solo store sees the repeated prompt
        hits = h["prefix_cache_stats"]["hits"]
        assert hits >= 1 if "max_batch" not in knobs else hits == 0


def test_spec_decode_knob_parses_and_refuses_as_jax(weights, monkeypatch):
    """SPEC_DECODE is served: it parses from the environment, and the
    settings the JAX package refuses refuse with its messages."""
    monkeypatch.setenv("SPEC_DECODE", "3")
    assert tconfig.from_env().spec_decode == 3
    assert "SPEC_DECODE" not in tconfig.REFUSED_KNOBS
    monkeypatch.setenv("SPEC_DECODE", "-1")
    with pytest.raises(ValueError) as mine:
        tconfig.from_env()
    with pytest.raises(ValueError) as theirs:
        jconfig.from_env()
    assert str(mine.value) == str(theirs.value)
    monkeypatch.delenv("SPEC_DECODE")
    for knobs in (dict(shard_role="a"),
                  dict(kv_pool_blocks=24, kv_block_size=8)):
        errs = []
        for jax_app in (False, True):
            with pytest.raises(ValueError) as e:
                _app(weights, jax_app, spec_decode=4, **knobs)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
