"""The port's iteration-level batcher on the paged pool (``pool=``) and
the paged server, against the port's solo runs and the JAX package's app.

The bar of tests/test_iterbatch.py's pool scenarios: paged rows equal
their solo runs with a mid-flight join; under a pool too small for two
long rows the youngest row is preempted and resumed by recompute,
byte-identical; a request arriving while a row is parked still joins;
seeded sampled paged rows equal the contiguous batcher's. Plus the
serving surface: ``admission_load`` sheds on saturation, a paged iter
app answers byte-equal to the JAX app with the same knobs, ``/healthz``
conserves blocks, a ``pool_spike`` fault answers 429 with Retry-After,
and the paged compositions refuse as the JAX app refuses. Every
blocking call has a timeout.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
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
from llm_sharding_demo_tpu_torch.runtime.iterbatch import IterBatchingEngine
from llm_sharding_demo_tpu_torch.runtime.kv_pool import KVBlockPool
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import graftfault, tracing
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from llm_sharding_demo_tpu_torch.utils.metrics import REGISTRY
from test_torch_iterbatch import WAIT, _after_segments, _staggered
from test_torch_kv_pool import DIMS
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

MAX_SEQ = 200            # tests/test_iterbatch.py's pool scenarios
BS = 8


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params(seed=0, std=0.3, dims=DIMS)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def eng(weights):
    return DecodeEngine(weights[1], gpt2.GPT2Config(**DIMS), max_seq=MAX_SEQ,
                        device="cpu")


def _pooled(eng, num_blocks=25, watermark=1.0, max_wait_ms=300.0,
            max_batch=4, **kw):
    pool = KVBlockPool.for_engine(eng, num_blocks=num_blocks,
                                  block_size=BS, watermark=watermark)
    return pool, IterBatchingEngine(eng, max_batch=max_batch, seg_steps=8,
                                    max_wait_ms=max_wait_ms, pool=pool, **kw)


def _solo(eng, p, n, **kw):
    return eng.generate(np.asarray(p)[None, :], n, **kw).tokens[0]


def test_paged_rows_byte_equal_solo_greedy_with_join(eng):
    pool, ib = _pooled(eng, num_blocks=64, max_wait_ms=50.0)
    rng = np.random.default_rng(41)
    pA, pB = rng.integers(0, 211, 5), rng.integers(0, 211, 9)
    wantA, wantB = _solo(eng, pA, 96), _solo(eng, pB, 40)
    resA, resB = _staggered(ib, [
        (pA, 96, 0.0, {}), (pB, 40, _after_segments(ib, 0, 1), {})])
    np.testing.assert_array_equal(resA.tokens[0], wantA)
    np.testing.assert_array_equal(resB.tokens[0], wantB)
    st = ib.stats()
    assert st["joins"] >= 1 and st["preemptions"] == 0
    assert pool.allocator.stats().blocks_in_use == 0


def test_preempts_lowest_priority_and_resumes_byte_identical(eng):
    """Two long rows oversubscribe a pool of one full row: growth exhausts
    it mid-decode, the younger row parks (its blocks freed) and resumes
    by recompute; both streams equal their solo runs."""
    pool, ib = _pooled(eng)
    rng = np.random.default_rng(42)
    pA, pB = rng.integers(0, 211, 5), rng.integers(0, 211, 8)
    wantA, wantB = _solo(eng, pA, 96), _solo(eng, pB, 110)
    resA, resB = _staggered(ib, [(pA, 96, 0.0, {}), (pB, 110, 0.0, {})])
    np.testing.assert_array_equal(resA.tokens[0], wantA)
    np.testing.assert_array_equal(resB.tokens[0], wantB)
    st = ib.stats()
    assert st["preemptions"] >= 1 and st["resumes"] >= 1
    assert st["parked"] == 0
    assert pool.allocator.stats().blocks_in_use == 0


def test_midflight_join_during_preemption_is_exact(eng):
    """A request arriving while a row is parked joins the live batch; all
    three streams equal solo, and the preempted row's trace carries the
    preemption (label and span) and its decode spans their blocks."""
    pool, ib = _pooled(eng)
    rng = np.random.default_rng(43)
    pA, pB, pC = (rng.integers(0, 211, n) for n in (5, 8, 6))
    want = [_solo(eng, pA, 96), _solo(eng, pB, 110), _solo(eng, pC, 16)]
    trace_b = tracing.RequestTrace("req-b", mode="greedy")
    res = [None] * 3

    def run(i, p, n):
        if i == 1:
            with tracing.use_trace(trace_b):
                res[i] = ib.generate(p, n, timeout=WAIT)
            return
        if i == 2:
            deadline = time.monotonic() + WAIT
            while (ib.stats()["preemptions"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.001)
        res[i] = ib.generate(p, n, timeout=WAIT)

    threads = [threading.Thread(target=run, args=(i, p, n), daemon=True)
               for i, (p, n) in enumerate([(pA, 96), (pB, 110), (pC, 16)])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * WAIT)
        assert not t.is_alive(), "a request never completed"
    for r, w in zip(res, want):
        np.testing.assert_array_equal(r.tokens[0], w)
    st = ib.stats()
    assert st["preemptions"] >= 1 and st["resumes"] >= 1
    assert trace_b.labels.get("preempted", 0) >= 1
    assert trace_b.find_all("preempted")
    decode = trace_b.find_all("decode")
    assert decode and all("blocks" in s.labels for s in decode)
    assert pool.allocator.stats().blocks_in_use == 0


def test_no_request_dropped_while_parked_rows_seed(eng):
    """32 concurrent requests through a pool of one full row: rows are
    preempted again and again, so batches seed from parked rows while a
    request that did not fit is held as the queue's head. Every request
    completes, equal to its solo run."""
    pool, ib = _pooled(eng, max_wait_ms=5.0, max_batch=32)
    rng = np.random.default_rng(45)
    prompts = [rng.integers(0, 211, int(n)) for n in rng.integers(19, 36, 32)]
    res = _staggered(ib, [(p, 40, 0.0, {}) for p in prompts])
    for p, r in zip(prompts, res):
        assert not isinstance(r, Exception), r
        np.testing.assert_array_equal(r.tokens[0], _solo(eng, p, 40))
    st = ib.stats()
    assert st["preemptions"] >= 1 and st["rows"] == 32 and st["parked"] == 0
    assert pool.allocator.stats().blocks_in_use == 0


def test_sampled_width1_paged_equals_contiguous(eng):
    pool, ib_pool = _pooled(eng, max_wait_ms=5.0)
    ib_plain = IterBatchingEngine(eng, max_batch=4, seg_steps=8,
                                  max_wait_ms=5.0)
    p = np.random.default_rng(44).integers(0, 211, 5)
    s = SamplingConfig(mode="sample", temperature=0.7, top_k=30)
    want = ib_plain.generate(p, 96, sampling=s, timeout=WAIT,
                             generator=torch.Generator().manual_seed(11))
    got = ib_pool.generate(p, 96, sampling=s, timeout=WAIT,
                           generator=torch.Generator().manual_seed(11))
    np.testing.assert_array_equal(got.tokens[0], want.tokens[0])
    np.testing.assert_array_equal(
        got.tokens[0], _solo(eng, p, 96, sampling=s,
                             generator=torch.Generator().manual_seed(11)))
    assert pool.allocator.stats().blocks_in_use == 0


def test_admission_load_sheds_on_saturation(eng):
    """The 429 decision: the watermark refuses the footprint AND the
    waiting line is at its limit."""
    pool = KVBlockPool.for_engine(eng, num_blocks=25, block_size=BS,
                                  watermark=0.5)
    ib = IterBatchingEngine(eng, max_batch=2, max_wait_ms=1.0, pool=pool,
                            queue_limit=0)
    ok, retry = ib.admission_load(120, 8)      # 15 blocks > 0.5 * 25
    assert not ok and retry >= 1.0
    assert ib.admission_load(8, 8) == (True, 0.0)   # 1 block fits
    assert IterBatchingEngine(eng, max_batch=2).admission_load(
        120, 8) == (True, 0.0)                  # no pool: always admit


# -- serving -----------------------------------------------------------------

APP_SEQ = 64


def _apps(weights, **knobs):
    jp, tp = weights
    cfg = dict(model_id="t", max_seq=APP_SEQ, boundaries=(1,),
               kv_block_size=BS, **knobs)
    app = TestClient(create_app(ServingConfig(**cfg),
                                model=(gpt2.GPT2Config(**DIMS), tp),
                                tokenizer=ByteTokenizer(), device="cpu"))
    japp = JTestClient(jcreate_app(JServingConfig(**cfg),
                                   model=(jgpt2.GPT2Config(**DIMS), jp),
                                   tokenizer=JByteTokenizer()))
    return app, japp


def _post_all(app, bodies):
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
    return out


def test_paged_iter_app_equals_jax_and_conserves_blocks(weights):
    """BATCH_MODE=iter MAX_BATCH=4 KV_POOL_BLOCKS=16 (two full rows):
    concurrent greedy answers byte-equal to the JAX app's, and /healthz
    reports the pool with every block free or held."""
    app, japp = _apps(weights, max_batch=4, batch_mode="iter",
                      batch_wait_ms=25.0, kv_pool_blocks=16)
    bodies = [{"prompt": p, "max_new_tokens": 12, "mode": "greedy"}
              for p in ("Hi", "Hello there", "abc", "xyzw")]
    want = [japp.post("/generate", json=b).json() for b in bodies]
    assert _post_all(app, bodies) == want
    h = app.get("/healthz").json()
    assert (h["kv_pool_blocks"], h["kv_block_size"], h["kv_pool_dtype"]) == (
        16, BS, "")
    st = h["kv_pool_stats"]
    assert st["blocks_free"] + st["blocks_in_use"] == st["blocks_total"] == 16
    assert st["blocks_in_use"] == 0 and st["block_dtype"] == "f32"
    assert h["batch_stats"]["rows"] == 4


def test_paged_solo_app_equals_jax(weights):
    app, japp = _apps(weights, kv_pool_blocks=16)
    body = {"prompt": "Paged, alone: ", "max_new_tokens": 20,
            "mode": "greedy"}
    assert app.post("/generate", json=body).json() == japp.post(
        "/generate", json=body).json()
    assert app.get("/healthz").json()["kv_pool_stats"]["blocks_free"] == 16


@pytest.mark.parametrize("knobs,site", [
    (dict(max_batch=2, batch_mode="iter"), "iterbatch.admission_load"),
    ({}, "serving.admission"),
])
def test_pool_spike_answers_429_with_retry_after(weights, knobs, site):
    """A seeded pool-exhaustion spike at the 429 gate sheds the request:
    429, Retry-After, the rejection counted; the pool is untouched."""
    app = TestClient(create_app(
        ServingConfig(model_id="t", max_seq=APP_SEQ, kv_pool_blocks=16,
                      kv_block_size=BS, **knobs),
        model=(gpt2.GPT2Config(**DIMS), weights[1]),
        tokenizer=ByteTokenizer(), device="cpu"))
    key = ("kv_pool_admission_rejections_total", ())
    before = REGISTRY.snapshot()["counters"].get(key, 0.0)
    with graftfault.use(graftfault.FaultPlan(seed=0, rate=1.0,
                                             sites=[site])) as plan:
        r = app.post("/generate", json={"prompt": "hello",
                                        "max_new_tokens": 6,
                                        "mode": "greedy"})
    assert r.status_code == 429
    assert r.json()["error"] == "kv_pool_saturated"
    assert int(r.headers["Retry-After"]) >= 1
    assert [i.kind for i in plan.injections] == ["pool_spike"]
    assert REGISTRY.snapshot()["counters"][key] == before + 1
    ok = app.post("/generate", json={"prompt": "hello", "max_new_tokens": 6,
                                     "mode": "greedy"})
    assert ok.status_code == 200
    st = app.get("/healthz").json()["kv_pool_stats"]
    assert st["blocks_free"] == st["blocks_total"] == 16


@pytest.mark.parametrize("knobs", [
    dict(kv_pool_blocks=16, prefill_chunk=8),
    dict(kv_pool_blocks=16, max_batch=4, batch_mode="admission"),
    dict(kv_pool_blocks=16, shard_role="a"),
    dict(kv_pool_blocks=16, max_seq=60),
])
def test_paged_composition_refusals_match_jax(weights, knobs):
    jp, tp = weights
    base = dict(model_id="t", max_seq=APP_SEQ, kv_block_size=BS)
    base.update(knobs)
    with pytest.raises(ValueError) as jerr:
        jcreate_app(JServingConfig(**base),
                    model=(jgpt2.GPT2Config(**DIMS), jp),
                    tokenizer=JByteTokenizer())
    with pytest.raises(ValueError) as terr:
        create_app(ServingConfig(**base),
                   model=(gpt2.GPT2Config(**DIMS), tp),
                   tokenizer=ByteTokenizer(), device="cpu")
    assert str(terr.value).split(";")[0] == str(jerr.value).split(";")[0]
