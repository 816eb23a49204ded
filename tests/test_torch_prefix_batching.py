"""The prefix store's compositions in the port, against solo runs and the
JAX package on the same numpy weights.

- The admission batcher (``BatchingEngine(prefix=)``): rounds mixing
  store hits and misses equal their solo runs (the JAX package's
  tests/test_prefix_cache.py claim), on the plain, staged and fused
  (mega) caches, and the JAX batcher's rows on the plain cache.
- The iteration batcher (``IterBatchingEngine(prefix=)``): joiners that
  prefill through the store equal their solo runs, with and without a
  pool.
- Zero-copy sharing (``PagedKVRunner(prefix=)``): a row references the
  entry's full blocks (their refcount rises), the frontier block is
  copied on write, blocks are conserved after retirement, and streams
  and allocator stats equal the JAX paged runner's.
- ``PREFIX_CACHE`` servers (solo, admission, iter, and pooled with
  ``KV_HOST_BLOCKS``) answer what the JAX app answers, with equal
  ``prefix_cache_stats``. The pooled iter server is held to its own solo
  runs and to JAX's solo app: the JAX paged iter app answers off its
  solo run now and then under concurrency (ROADMAP Queue 3).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu.runtime import kv_pool as jkv
from llm_sharding_demo_tpu.runtime.batcher import (
    BatchingEngine as JBatchingEngine)
from llm_sharding_demo_tpu.runtime.prefix_cache import (
    PrefixCachingEngine as JPrefixCachingEngine)
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime.batcher import BatchingEngine
from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
from llm_sharding_demo_tpu_torch.runtime.iterbatch import IterBatchingEngine
from llm_sharding_demo_tpu_torch.runtime.kv_pool import (KVBlockPool,
                                                         PagedKVRunner)
from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
    PrefixCachingEngine)
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

DIMS = dict(vocab_size=256, n_positions=512, n_embd=128, n_layer=2,
            n_head=2)
MAX_SEQ = 128
CHUNK = 8
BS = 8
WAIT = 60


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params(seed=2, std=0.08, dims=DIMS)
    return ((jgpt2.GPT2Config(**DIMS), jax.tree.map(jnp.asarray, tree)),
            (gpt2.GPT2Config(**DIMS), params_from_numpy(tree, device="cpu")))


def _engine(weights, **kw):
    _, (cfg, tp) = weights
    return DecodeEngine(tp, cfg, max_seq=MAX_SEQ, device="cpu", **kw)


def _threads(fn, n, delays=None):
    out = [None] * n

    def run(i):
        if delays is not None:
            trigger = delays[i]
            deadline = time.monotonic() + WAIT
            while callable(trigger) and not trigger():
                assert time.monotonic() < deadline
                time.sleep(0.001)
            if not callable(trigger):
                time.sleep(trigger)
        out[i] = fn(i)

    ts = [threading.Thread(target=run, args=(i,), daemon=True)
          for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=2 * WAIT)
        assert not t.is_alive(), "a request never completed"
    return out


def _shared_prompts(seed=0):
    """Two rows on a 24-token (three-chunk) shared prefix and a miss."""
    rng = np.random.default_rng(seed)
    shared = list(rng.integers(0, 256, 24))
    return shared, [shared + [5, 6], shared + [9],
                    list(rng.integers(0, 256, 11))]


@pytest.mark.parametrize("kind", ["plain", "staged", "mega"])
def test_admission_rounds_mixing_hits_and_misses_equal_solo(weights, kind):
    kw = {"plain": {}, "staged": {"boundaries": [1]},
          "mega": {"decode_kernel": "mega"}}[kind]
    engine = _engine(weights, **kw)
    prefix = PrefixCachingEngine(engine, capacity=4, chunk=CHUNK)
    batcher = BatchingEngine(engine, max_batch=4, max_wait_ms=300.0,
                             prefix=prefix)
    shared, prompts = _shared_prompts()
    want = [engine.generate(np.asarray([p]), 10).tokens[0] for p in prompts]
    prefix.generate(np.asarray(shared + [1]), 2)     # seed the store
    got = _threads(lambda i: batcher.generate(
        np.asarray(prompts[i]), 10, timeout=WAIT).tokens[0], 3)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"row {i}")
    st = prefix.stats()
    assert st["hits"] >= 2
    assert batcher.stats()["rows"] == 3 and batcher.stats()["batches"] < 3
    if kind != "plain":
        return
    (jcfg, jp), _ = weights
    jeng = jengine.DecodeEngine(jp, jcfg, max_seq=MAX_SEQ)
    jprefix = JPrefixCachingEngine(jeng, capacity=4, chunk=CHUNK)
    jb = JBatchingEngine(jeng, max_batch=4, max_wait_ms=300.0,
                         prefix=jprefix)
    jprefix.generate(np.asarray(shared + [1], np.int32), 2)
    jgot = _threads(lambda i: jb.generate(
        np.asarray(prompts[i], np.int32), 10, timeout=WAIT).tokens[0], 3)
    for g, j in zip(got, jgot):
        np.testing.assert_array_equal(g, j)


def _joiner_jobs(ib, shared, rng):
    """A long seed request, then two store-backed joiners on the shared
    prefix once the seed's batch has run a segment."""
    seed_prompt = list(rng.integers(0, 256, 30))
    base = ib.stats()["segments"]
    live = lambda: ib.stats()["segments"] >= base + 1  # noqa: E731
    return [(seed_prompt, 60, 0.0), (shared + [3, 4], 12, live),
            (shared + [7], 12, live)]


@pytest.mark.parametrize("pooled", [False, True])
def test_iter_joiners_through_the_store_equal_solo(weights, pooled):
    engine = _engine(weights)
    pool = (KVBlockPool.for_engine(engine, num_blocks=96, block_size=BS)
            if pooled else None)
    prefix = PrefixCachingEngine(engine, capacity=4, chunk=CHUNK, pool=pool)
    ib = IterBatchingEngine(engine, max_batch=4, seg_steps=4,
                            max_wait_ms=5.0, prefix=prefix, pool=pool)
    rng = np.random.default_rng(5)
    shared = list(rng.integers(0, 256, 24))
    prefix.prefill_state(np.asarray(shared + [1]))  # seed the store
    jobs = _joiner_jobs(ib, shared, rng)
    want = [engine.generate(np.asarray([p]), n).tokens[0]
            for p, n, _ in jobs]
    got = _threads(lambda i: ib.generate(
        np.asarray(jobs[i][0]), jobs[i][1], timeout=WAIT).tokens[0],
        len(jobs), delays=[j[2] for j in jobs])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"row {i}")
    assert ib.stats()["joins"] >= 1
    assert prefix.stats()["hits"] >= 1
    if pooled:
        deadline = time.monotonic() + WAIT
        while pool.allocator.stats().blocks_in_use != \
                pool.allocator.stats().blocks_evictable:
            assert time.monotonic() < deadline, pool.stats()
            time.sleep(0.01)
        st = pool.allocator.stats()
        assert st.prefix_entries == prefix.stats()["entries"] >= 1


def test_paged_runner_shares_blocks_and_equals_jax(weights):
    (jcfg, jp), _ = weights
    engine = _engine(weights)
    pool = KVBlockPool.for_engine(engine, num_blocks=64, block_size=BS)
    prefix = PrefixCachingEngine(engine, capacity=4, chunk=12, pool=pool)
    runner = PagedKVRunner(engine, pool, prefix=prefix)
    jeng = jengine.DecodeEngine(jp, jcfg, max_seq=MAX_SEQ)
    jpool = jkv.KVBlockPool.for_engine(jeng, num_blocks=64, block_size=BS)
    jprefix = JPrefixCachingEngine(jeng, capacity=4, chunk=12, pool=jpool)
    jrunner = jkv.PagedKVRunner(jeng, jpool, prefix=jprefix)
    rng = np.random.default_rng(9)
    shared = list(rng.integers(0, 256, 30))
    prompts = [shared + [4], shared + [8, 9, 10], shared[:20] + [1, 2],
               shared + [8, 9, 10]]
    for p in prompts:
        got = runner.generate(np.asarray([p]), 9).tokens
        np.testing.assert_array_equal(
            got, engine.generate(np.asarray([p]), 9).tokens)
        np.testing.assert_array_equal(
            got, jrunner.generate(np.asarray([p], np.int32), 9).tokens)
        assert (pool.allocator.stats().as_dict()
                == jpool.allocator.stats().as_dict())
        assert prefix.stats() == jprefix.stats()
    # a hit at depth 24 (two chunks of 12): blocks 0-2 are full and
    # shared, the entry has no frontier; depth 12 leaves a half block
    alloc = pool.allocator
    p = shared + [8, 9, 10]
    ids = np.asarray([p])
    cows = alloc.stats().cow_copies
    last, tables, owned, shared_ids = runner._prefill_tables(
        ids, 1, len(p), 9, np.zeros(1, np.int32), None)
    entry = alloc._prefix[PrefixCachingEngine._key(np.asarray(p), 2, 12)]
    assert list(tables[0, :3]) == list(entry) == shared_ids[0]
    assert all(alloc.refcount(b) >= 2 for b in entry)
    assert not set(owned[0]) & set(entry)
    for row in owned + shared_ids:
        alloc.free(row)
    # a depth-12 hit: block 1 holds 4 of its 8 slots, copied on write
    q = shared[:12] + [77] * 5
    last, tables, owned, shared_ids = runner._prefill_tables(
        np.asarray([q]), 1, len(q), 4, np.zeros(1, np.int32), None)
    assert alloc.stats().cow_copies == cows + 1
    assert len(shared_ids[0]) == 1 and tables[0, 1] == owned[0][0]
    for row in owned + shared_ids:
        alloc.free(row)
    st = alloc.stats()
    assert st.blocks_in_use == st.blocks_evictable
    assert st.blocks_in_use + st.blocks_free == st.blocks_total


def _apps(weights, **knobs):
    (jcfg, jp), (tcfg, tp) = weights
    cfg = dict(model_id="t", max_seq=MAX_SEQ, boundaries=(1,),
               kv_block_size=BS)
    cfg.update(knobs)
    app = TestClient(create_app(ServingConfig(**cfg), model=(tcfg, tp),
                                tokenizer=ByteTokenizer(), device="cpu"))
    jknobs = {k: v for k, v in cfg.items() if k != "kv_host_blocks"}
    japp = JTestClient(jcreate_app(JServingConfig(**jknobs),
                                   model=(jcfg, jp),
                                   tokenizer=JByteTokenizer()))
    return app, japp


BODIES = [{"prompt": "You are a careful assistant. " + q,
           "max_new_tokens": 10, "mode": "greedy"}
          for q in ("Hi", "Tell me more", "Hi", "Bye")]


@pytest.mark.parametrize("knobs", [
    dict(prefix_cache=2, prefix_chunk=8),
    dict(prefix_cache=2, prefix_chunk=16, max_batch=4),
    dict(prefix_cache=2, prefix_chunk=8, max_batch=4, batch_mode="iter"),
])
def test_prefix_servers_equal_jax(weights, knobs):
    app, japp = _apps(weights, **knobs)
    for body in BODIES:
        r = app.post("/generate", json=body)
        assert r.status_code == 200
        assert r.json() == japp.post("/generate", json=body).json()
    h, jh = app.get("/healthz").json(), japp.get("/healthz").json()
    assert h["prefix_cache_stats"] == jh["prefix_cache_stats"]
    assert (h["prefix_cache"], h["prefix_chunk"]) == (
        knobs["prefix_cache"], knobs["prefix_chunk"])
    if "batch_mode" not in knobs:
        # one request at a time: every round is solo, through the store
        # (the iter batcher seeds each lone request without it)
        assert h["prefix_cache_stats"]["hits"] >= 2


def test_pooled_tier_server_equals_solo_runs_and_conserves(weights):
    """MAX_SEQ=256 MAX_BATCH=4 BATCH_MODE=iter KV_POOL_BLOCKS=96
    PREFIX_CACHE=1 PREFIX_CHUNK=8 KV_HOST_BLOCKS=32: a 200-token request
    holds a batch open for six segments
    and the rest join it through the store (entries past the capacity
    demote to the tier); replies equal the JAX solo prefix app's, and
    after each wave /healthz shows the tier conserved and no row's block
    left behind."""
    app, _ = _apps(weights, max_seq=256, max_batch=4, batch_mode="iter",
                   batch_wait_ms=20.0, kv_pool_blocks=96, prefix_cache=1,
                   prefix_chunk=8, kv_host_blocks=32)
    _, jsolo = _apps(weights, max_seq=256, prefix_cache=1, prefix_chunk=8)
    holder = {"prompt": "Hold the batch open: ", "max_new_tokens": 200,
              "mode": "greedy"}
    bodies = [holder] + BODIES + [dict(BODIES[1],
                                       prompt="Other system text, " + q)
                                  for q in ("a", "bb")]
    want = [jsolo.post("/generate", json=b).json() for b in bodies]
    for wave in (bodies, [holder] + bodies[:0:-1]):
        base = app.get("/healthz").json()["batch_stats"]["segments"]
        live = lambda: app.get("/healthz").json()[  # noqa: E731
            "batch_stats"]["segments"] > base
        got = _threads(lambda i: app.post("/generate", json=wave[i]).json(),
                       len(wave), delays=[0.0] + [live] * (len(wave) - 1))
        assert got == [want[bodies.index(b)] for b in wave]
        h = app.get("/healthz").json()
        st = h["kv_pool_stats"]
        assert st["blocks_in_use"] == st["blocks_evictable"]
        assert st["blocks_in_use"] + st["blocks_free"] == 96
        tier = st["tier"]
        assert tier["host_blocks_total"] == 32
        assert (tier["host_entries"] == tier["demotions"]
                - tier["promotions"] - tier["discards"])
        assert h["prefix_cache_stats"]["pooled"] is True
        assert h["kv_host_blocks"] == 32
    assert h["batch_stats"]["joins"] > 0 and tier["demotions"] > 0


def test_serving_refusals_match_jax(weights):
    for knobs in (dict(prefix_cache=2, shard_role="a"),):
        with pytest.raises(ValueError) as terr:
            _apps(weights, **knobs)
        (jcfg, jp), _ = weights
        with pytest.raises(ValueError) as jerr:
            jcreate_app(JServingConfig(model_id="t", max_seq=MAX_SEQ,
                                       boundaries=(1,), **knobs),
                        model=(jcfg, jp), tokenizer=JByteTokenizer())
        assert str(terr.value) == str(jerr.value)
        assert "PREFIX_CACHE=2" in str(terr.value)
