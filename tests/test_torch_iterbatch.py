"""The port's iteration-level batcher (``runtime.iterbatch``) on
contiguous caches, against the port's solo runs and the JAX package's
engine and app on the same numpy weights.

The bar is the JAX package's (tests/test_iterbatch.py): whatever a
request joined mid-flight, however segments were scheduled, its tokens
equal a solo engine run; fp32 greedy rows also equal the JAX engine's
streams, seeded sampled rows the port's own solo runs. Plus the
scheduling claims: a mid-decode arrival joins the live batch within a
segment, an EOS row frees its row early, the width grows on a join, a
policy switch drains, failures and timeouts reach every caller. Every
blocking call has a timeout; arrivals wait on the scheduler's counters,
each with a time limit.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        SamplingConfig)
from llm_sharding_demo_tpu_torch.runtime.iterbatch import (
    FAULT_PARK_BUDGET, IterBatchingEngine)
from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
    PrefixCachingEngine)
from llm_sharding_demo_tpu_torch.runtime.spec_decode import SpecDecodeEngine
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import (graftfault, graftmem,
                                               graftscope, tracing)
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from llm_sharding_demo_tpu_torch.utils.metrics import REGISTRY
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

DIMS = dict(vocab_size=211, n_positions=512, n_embd=128, n_layer=2,
            n_head=2)
MAX_SEQ = 200
WAIT = 60  # seconds: a bound on every join, wait and blocking call


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params(seed=0, dims=DIMS)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def _engine(weights, **kw):
    return DecodeEngine(weights[1], gpt2.GPT2Config(**DIMS),
                        max_seq=MAX_SEQ, device="cpu", **kw)


@pytest.fixture(scope="module")
def jeng(weights):
    return jengine.DecodeEngine(weights[0], jgpt2.GPT2Config(**DIMS),
                                max_seq=MAX_SEQ)


@pytest.fixture(scope="module")
def setup(weights):
    engine = _engine(weights)
    return engine, IterBatchingEngine(engine, max_batch=4, seg_steps=8,
                                      max_wait_ms=50.0)


def _staggered(ib, jobs):
    """jobs: (prompt, steps, trigger, kwargs). ``trigger`` is a delay in
    seconds or a callable polled (for at most WAIT s) until true. Returns
    the results, or the exceptions raised, in job order."""
    res = [None] * len(jobs)

    def run(i, p, n, trigger, kw):
        if callable(trigger):
            deadline = time.monotonic() + WAIT
            while not trigger() and time.monotonic() < deadline:
                time.sleep(0.001)
        else:
            time.sleep(trigger)
        try:
            res[i] = ib.generate(p, n, timeout=WAIT, **kw)
        except Exception as e:  # noqa: BLE001 — returned to the test
            res[i] = e

    threads = [threading.Thread(target=run, args=(i, *job), daemon=True)
               for i, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * WAIT)
        assert not t.is_alive(), "a request never completed"
    return res


def _after_segments(ib, base, k):
    """Trigger: the scheduler ran ``k`` segments past ``base``, so the
    head batch is live and mid-decode."""
    return lambda: ib.stats()["segments"] >= base + k


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _solo(engine, p, n, **kw):
    return engine.generate(np.asarray(p)[None, :], n, **kw).tokens[0]


def test_mid_decode_join_is_exact_and_within_one_segment(setup, jeng):
    engine, ib = setup
    rng = np.random.default_rng(1)
    pA, pB = rng.integers(0, 211, size=(5,)), rng.integers(0, 211, size=(9,))
    wantA, wantB = _solo(engine, pA, 96), _solo(engine, pB, 40)
    np.testing.assert_array_equal(
        wantA, jeng.generate(pA[None, :].astype(np.int32), 96).tokens[0])
    before = ib.stats()
    resA, resB = _staggered(ib, [
        (pA, 96, 0.0, {}),
        (pB, 40, _after_segments(ib, before["segments"], 1), {})])
    after = ib.stats()
    np.testing.assert_array_equal(resA.tokens[0], wantA)
    np.testing.assert_array_equal(resB.tokens[0], wantB)
    # B joined A's live batch: a join, not a second batch
    assert after["joins"] - before["joins"] >= 1
    assert after["batches"] - before["batches"] == 1


def test_many_staggered_greedy_all_exact_and_equal_jax(setup, jeng):
    engine, ib = setup
    rng = np.random.default_rng(2)
    jobs, want = [], []
    for n_prompt, steps, delay in [(4, 50, 0.0), (7, 30, 0.2), (11, 40, 0.5),
                                   (6, 20, 0.9), (9, 25, 1.2)]:
        p = rng.integers(0, 211, size=(n_prompt,))
        jobs.append((p, steps, delay, {}))
        want.append(jeng.generate(p[None, :].astype(np.int32),
                                  steps).tokens[0])
    for i, r in enumerate(_staggered(ib, jobs)):
        np.testing.assert_array_equal(r.tokens[0], want[i],
                                      err_msg=f"req {i}")


def test_sampled_joiner_stream_byte_equal_solo(setup):
    """A sampled row joining mid-decode draws from its own generator,
    once a step: byte-equal to its solo run."""
    engine, ib = setup
    rng = np.random.default_rng(3)
    pA, pB = rng.integers(0, 211, size=(5,)), rng.integers(0, 211, size=(8,))
    s = SamplingConfig(mode="sample", temperature=0.7, top_k=30)
    wantA = _solo(engine, pA, 96, sampling=s, generator=_gen(11))
    wantB = _solo(engine, pB, 30, sampling=s, generator=_gen(12))
    before = ib.stats()
    resA, resB = _staggered(ib, [
        (pA, 96, 0.0, dict(sampling=s, generator=_gen(11))),
        (pB, 30, _after_segments(ib, before["segments"], 1),
         dict(sampling=s, generator=_gen(12)))])
    np.testing.assert_array_equal(resA.tokens[0], wantA)
    np.testing.assert_array_equal(resB.tokens[0], wantB)
    assert ib.stats()["joins"] - before["joins"] >= 1


def test_eos_row_retires_early_and_frees_slot(setup):
    engine, ib = setup
    rng = np.random.default_rng(4)
    pA, pB = rng.integers(0, 211, size=(5,)), rng.integers(0, 211, size=(6,))
    wantA, plainB = _solo(engine, pA, 80), _solo(engine, pB, 80)
    eosB = int(plainB[6 + 3])  # B's 4th new token
    before = ib.stats()
    resA, resB = _staggered(ib, [(pA, 80, 0.0, {}),
                                 (pB, 80, 0.1, dict(eos_id=eosB))])
    np.testing.assert_array_equal(resA.tokens[0], wantA)
    nB = resB.new_tokens
    assert nB < 80
    np.testing.assert_array_equal(resB.tokens[0], plainB[:6 + nB])
    assert int(resB.tokens[0, -1]) == eosB
    assert ib.stats()["eos_retires"] - before["eos_retires"] >= 1


def test_long_prompt_late_joiner_waits_until_depth_allows(setup):
    """A joiner whose prompt exceeds the live depth cannot merge yet; it
    still completes exactly, joining later or seeding the next batch."""
    engine, ib = setup
    rng = np.random.default_rng(5)
    pA, pB = rng.integers(0, 211, size=(4,)), rng.integers(0, 211, size=(60,))
    resA, resB = _staggered(ib, [(pA, 70, 0.0, {}), (pB, 20, 0.3, {})])
    np.testing.assert_array_equal(resA.tokens[0], _solo(engine, pA, 70))
    np.testing.assert_array_equal(resB.tokens[0], _solo(engine, pB, 20))


def test_policy_switch_drains_then_seeds_new_batch(setup):
    engine, ib = setup
    rng = np.random.default_rng(6)
    pG, pS = rng.integers(0, 211, size=(5,)), rng.integers(0, 211, size=(7,))
    s = SamplingConfig(mode="sample", temperature=0.9, top_k=15)
    before = ib.stats()["batches"]
    resG, resS = _staggered(ib, [
        (pG, 40, 0.0, {}), (pS, 20, 0.3, dict(sampling=s,
                                               generator=_gen(44)))])
    np.testing.assert_array_equal(resG.tokens[0], _solo(engine, pG, 40))
    np.testing.assert_array_equal(
        resS.tokens[0], _solo(engine, pS, 20, sampling=s,
                              generator=_gen(44)))
    assert ib.stats()["batches"] - before == 2


def test_composes_with_the_fused_cache(weights):
    """A "mega" engine (the fused [K|V] cache; the kernels' plain
    versions on the CPU) admits and retires through the same copy:
    streams stay exact."""
    engine = _engine(weights, decode_kernel="mega")
    assert engine.decode_kernel_mode == "mega" and engine._cache_seq == 256
    ib = IterBatchingEngine(engine, max_batch=2, seg_steps=8,
                            max_wait_ms=30.0)
    rng = np.random.default_rng(8)
    pA, pB = rng.integers(0, 211, size=(5,)), rng.integers(0, 211, size=(7,))
    resA, resB = _staggered(ib, [
        (pA, 40, 0.0, {}), (pB, 24, _after_segments(ib, 0, 1), {})])
    np.testing.assert_array_equal(resA.tokens[0], _solo(engine, pA, 40))
    np.testing.assert_array_equal(resB.tokens[0], _solo(engine, pB, 24))
    assert ib.stats()["joins"] >= 1
    assert graftscope.calls("iterbatch._admit_cache")


def test_composes_with_the_staged_engine(weights):
    engine = _engine(weights, boundaries=[1])
    ib = IterBatchingEngine(engine, max_batch=2, seg_steps=8,
                            max_wait_ms=30.0)
    rng = np.random.default_rng(9)
    pA, pB = rng.integers(0, 211, size=(5,)), rng.integers(0, 211, size=(6,))
    resA, resB = _staggered(ib, [
        (pA, 30, 0.0, {}), (pB, 20, _after_segments(ib, 0, 1), {})])
    np.testing.assert_array_equal(resA.tokens[0], _solo(engine, pA, 30))
    np.testing.assert_array_equal(resB.tokens[0], _solo(engine, pB, 20))
    assert ib.stats()["joins"] >= 1


def test_two_incompatible_arrivals_none_dropped(setup):
    """A request held as the FIFO head is never overwritten when a second
    incompatible request arrives: all three complete."""
    engine, ib = setup
    rng = np.random.default_rng(13)
    pG = rng.integers(0, 211, size=(5,))
    pS1, pS2 = (rng.integers(0, 211, size=(6,)),
                rng.integers(0, 211, size=(7,)))
    s1 = SamplingConfig(mode="sample", temperature=0.7, top_k=20)
    s2 = SamplingConfig(mode="sample", temperature=0.9, top_k=10)
    resG, res1, res2 = _staggered(ib, [
        (pG, 60, 0.0, {}),
        (pS1, 10, 0.3, dict(sampling=s1, generator=_gen(1))),
        (pS2, 10, 0.5, dict(sampling=s2, generator=_gen(2)))])
    np.testing.assert_array_equal(resG.tokens[0], _solo(engine, pG, 60))
    np.testing.assert_array_equal(
        res1.tokens[0], _solo(engine, pS1, 10, sampling=s1,
                              generator=_gen(1)))
    np.testing.assert_array_equal(
        res2.tokens[0], _solo(engine, pS2, 10, sampling=s2,
                              generator=_gen(2)))


def test_seed_failure_delivers_error_to_all_gathered_peers(weights):
    engine = _engine(weights)

    def boom(*a, **kw):
        raise RuntimeError("synthetic prefill OOM")

    engine._prefill = boom
    ib = IterBatchingEngine(engine, max_batch=4, seg_steps=8,
                            max_wait_ms=400.0)
    rng = np.random.default_rng(0)
    res = _staggered(ib, [(rng.integers(0, 211, size=(n,)), 8, d, {})
                          for n, d in ((5, 0.0), (6, 0.05), (7, 0.1))])
    for i, e in enumerate(res):
        assert isinstance(e, RuntimeError), (i, e)
        assert "synthetic prefill OOM" in str(e)


def test_admit_failure_delivers_error_to_popped_request(weights,
                                                        monkeypatch):
    """``_admit_one`` raising after the request left the queue, before it
    entered a row, errors that request and its batch; nobody blocks."""
    ib = IterBatchingEngine(_engine(weights), max_batch=4, seg_steps=8,
                            max_wait_ms=10.0)

    def boom(self, state, req, slot, resume=None, reserved=None):
        raise RuntimeError("synthetic admit failure")

    monkeypatch.setattr(IterBatchingEngine, "_admit_one", boom)
    rng = np.random.default_rng(1)
    res = _staggered(ib, [
        (rng.integers(0, 211, size=(5,)), 120, 0.0, {}),
        (rng.integers(0, 211, size=(6,)), 8, _after_segments(ib, 0, 1), {})])
    assert isinstance(res[1], RuntimeError)
    for r in res:
        if isinstance(r, Exception):
            assert "synthetic admit failure" in str(r)


def test_timeout_cancels_request_and_frees_slot(weights):
    ib = IterBatchingEngine(_engine(weights), max_batch=2, seg_steps=8,
                            max_wait_ms=5.0)
    rng = np.random.default_rng(2)
    with pytest.raises(TimeoutError):
        ib.generate(rng.integers(0, 211, size=(5,)), 120, timeout=1e-4)
    # the cancelled row frees at the next boundary; a later request is
    # served promptly, and the timed-out one is not counted as served
    res = ib.generate(rng.integers(0, 211, size=(6,)), 8, timeout=WAIT)
    assert res.new_tokens == 8
    assert ib.stats()["rows"] == 1


def test_deadline_cancels_mid_decode(weights):
    ib = IterBatchingEngine(_engine(weights), max_batch=2, seg_steps=8,
                            max_wait_ms=5.0)
    plan = graftfault.FaultPlan(seed=0, rate=1.0,
                                sites={"iterbatch.decode_seg"},
                                kinds={"decode_slow"})
    with graftfault.use(plan):
        with pytest.raises(graftfault.DeadlineExceeded):
            ib.generate(np.asarray([5, 6, 7]), 150, timeout=WAIT,
                        deadline=graftfault.Deadline.from_ms(300))
    res = ib.generate(np.asarray([5, 6, 7]), 8, timeout=WAIT)
    assert res.new_tokens == 8
    assert ib.stats()["rows"] == 1


def test_right_sized_width_grows_on_join(weights):
    """A lone request runs at width 1 (no grows, no joins); a mid-decode
    arrival grows the live batch, and both streams stay exact."""
    engine = _engine(weights)
    ib = IterBatchingEngine(engine, max_batch=4, seg_steps=8,
                            max_wait_ms=5.0)
    rng = np.random.default_rng(21)
    p1 = rng.integers(0, 211, size=(5,))
    np.testing.assert_array_equal(ib.generate(p1, 24, timeout=WAIT).tokens[0],
                                  _solo(engine, p1, 24))
    solo = ib.stats()
    assert solo["grows"] == 0 and solo["joins"] == 0
    pA, pB = rng.integers(0, 211, size=(5,)), rng.integers(0, 211, size=(7,))
    resA, resB = _staggered(ib, [
        (pA, 96, 0.0, {}),
        (pB, 30, _after_segments(ib, solo["segments"], 1), {})])
    np.testing.assert_array_equal(resA.tokens[0], _solo(engine, pA, 96))
    np.testing.assert_array_equal(resB.tokens[0], _solo(engine, pB, 30))
    after = ib.stats()
    assert after["joins"] - solo["joins"] >= 1
    assert after["grows"] - solo["grows"] >= 1


def test_spans_counters_series_and_memory_ledger(weights):
    """What the scheduler records for a request: its trace gets the queue
    wait, the prefill and one decode span a segment; the registry counts
    the segments; the occupancy series gains points; the batch's cache
    leaves the memory ledger when the batch ends."""
    ib = IterBatchingEngine(_engine(weights), max_batch=2, seg_steps=8,
                            max_wait_ms=5.0)
    key = ("iter_segments_total", ())
    segs0 = REGISTRY.snapshot()["counters"].get(key, 0)
    points0 = len(graftscope.series("batch_occupancy"))
    cache0 = graftmem.component_bytes().get("engine_cache", 0)
    trace = tracing.RequestTrace("iter-1")
    with tracing.use_trace(trace):
        ib.generate(np.asarray([5, 6, 7]), 20, timeout=WAIT)
    assert trace.find("queue_wait") is not None
    assert trace.find("prefill").labels["kind"] == "seed"
    assert [s.labels["steps"] for s in trace.find_all("decode")] == [8, 8, 8]
    assert REGISTRY.snapshot()["counters"][key] - segs0 == 3
    assert len(graftscope.series("batch_occupancy")) > points0
    deadline = time.monotonic() + WAIT
    while (graftmem.component_bytes().get("engine_cache", 0) != cache0
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert graftmem.component_bytes().get("engine_cache", 0) == cache0


# -- degraded mode: fault parks ----------------------------------------------

def test_transient_fault_parks_and_resumes_exact(weights):
    """One injected transient fault before a segment parks the row, which
    resumes by recompute: greedy and seeded sampled streams equal the
    unfaulted solo runs."""
    engine = _engine(weights)
    ib = IterBatchingEngine(engine, max_batch=2, seg_steps=4,
                            max_wait_ms=5.0)
    p = np.asarray([5, 17, 3, 42, 9, 2, 11, 7])
    s = SamplingConfig(mode="sample", temperature=0.8, top_k=20)
    for kw in ({}, dict(sampling=s)):
        want = _solo(engine, p, 20, **(dict(kw, generator=_gen(8))
                                       if kw else {}))
        plan = graftfault.FaultPlan(seed=0, rate=1.0, max_injections=1,
                                    sites={"iterbatch.decode_seg"},
                                    kinds={"decode_transient"})
        before = ib.stats()
        with graftfault.use(plan):
            got = ib.generate(p, 20, timeout=WAIT,
                              **(dict(kw, generator=_gen(8)) if kw else {}))
        assert [(i.site, i.kind, i.seq) for i in plan.injections] == [
            ("iterbatch.decode_seg", "decode_transient", 0)]
        after = ib.stats()
        assert after["fault_parks"] == before["fault_parks"] + 1
        assert after["resumes"] == before["resumes"] + 1
        np.testing.assert_array_equal(got.tokens[0], want)


@pytest.mark.parametrize("kind,error", [
    ("decode_transient", graftfault.FaultBudgetError),
    ("decode_permanent", graftfault.PermanentFault)])
def test_faults_fail_typed_for_every_peer(weights, kind, error):
    """Past ``FAULT_PARK_BUDGET`` transient parks a row fails typed; a
    permanent fault fails the whole batch; either way the error reaches
    every gathered request."""
    ib = IterBatchingEngine(_engine(weights), max_batch=4, seg_steps=4,
                            max_wait_ms=300.0)
    plan = graftfault.FaultPlan(seed=1, rate=1.0,
                                sites={"iterbatch.decode_seg"},
                                kinds={kind})
    with graftfault.use(plan):
        res = _staggered(ib, [(np.asarray([5, 6, 7]), 8, 0.0, {}),
                              (np.asarray([9, 10]), 8, 0.05, {})])
    for r in res:
        assert isinstance(r, error), r
        assert r.retry_after >= 0.0
    if kind == "decode_transient":
        assert ib.stats()["fault_parks"] >= FAULT_PARK_BUDGET + 1


def test_refusals(weights):
    engine = _engine(weights)
    ib = IterBatchingEngine(engine, max_batch=2)
    with pytest.raises(ValueError, match="torch.Generator"):
        ib.generate(np.asarray([5, 6]), 4,
                    sampling=SamplingConfig(mode="sample"), timeout=WAIT)
    with pytest.raises(ValueError, match="max_seq"):
        ib.generate(np.arange(190), 90, timeout=WAIT)
    with pytest.raises(NotImplementedError, match="prefill_chunk"):
        IterBatchingEngine(_engine(weights, prefill_chunk=8), max_batch=2)
    with pytest.raises(ValueError, match="same engine"):
        IterBatchingEngine(engine, max_batch=2, prefix=PrefixCachingEngine(
            _engine(weights)))
    with pytest.raises(ValueError, match="same DecodeEngine"):
        IterBatchingEngine(engine, max_batch=2, spec=SpecDecodeEngine(
            weights[1], engine.config, max_seq=MAX_SEQ, device="cpu"))


# -- serving -----------------------------------------------------------------

def test_serving_batch_mode_iter_equals_jax(weights):
    """A BATCH_MODE=iter MAX_BATCH=4 server answers concurrent greedy
    requests byte-equal to the JAX app with the same knobs."""
    jp, tp = weights
    cfg = dict(model_id="t", max_seq=48, max_batch=4, batch_mode="iter",
               batch_wait_ms=25.0, boundaries=(1,))
    app = TestClient(create_app(ServingConfig(**cfg),
                                model=(gpt2.GPT2Config(**DIMS), tp),
                                tokenizer=ByteTokenizer(), device="cpu"))
    japp = JTestClient(jcreate_app(JServingConfig(**cfg),
                                   model=(jgpt2.GPT2Config(**DIMS), jp),
                                   tokenizer=JByteTokenizer()))
    bodies = [{"prompt": p, "max_new_tokens": 6, "mode": "greedy"}
              for p in ("Hi", "Hello there", "abc", "xyzw")]
    want = [japp.post("/generate", json=b).json() for b in bodies]
    out = [None] * len(bodies)

    def post(i):
        out[i] = app.post("/generate", json=bodies[i]).json()

    threads = [threading.Thread(target=post, args=(i,), daemon=True)
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    assert out == want
    h = app.get("/healthz").json()
    assert h["batch_mode"] == "iter" and h["batch_stats"]["rows"] == 4


@pytest.mark.parametrize("knobs", [
    dict(batch_mode="iter"),
    dict(batch_mode="iter", max_batch=4, prefill_chunk=8),
    dict(batch_mode="iter", max_batch=4, shard_role="a"),
])
def test_composition_refusals_match_jax(weights, knobs):
    jp, tp = weights
    base = dict(model_id="t", max_seq=48)
    with pytest.raises(ValueError) as jerr:
        jcreate_app(JServingConfig(**base, **knobs),
                    model=(jgpt2.GPT2Config(**DIMS), jp),
                    tokenizer=JByteTokenizer())
    with pytest.raises(ValueError) as terr:
        create_app(ServingConfig(**base, **knobs),
                   model=(gpt2.GPT2Config(**DIMS), tp),
                   tokenizer=ByteTokenizer(), device="cpu")
    assert str(terr.value).split(";")[0] == str(jerr.value).split(";")[0]
