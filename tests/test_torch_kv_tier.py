"""The port's host KV tier (``runtime.kv_tier.HostKVTier``) and the pool
hooks it drives, against the JAX package's on the same numpy weights and
call sequences (the claims of tests/test_kv_tier.py).

- A demoted prefix entry promoted back decodes byte-identically to a
  never-demoted run, greedy and seeded; the tier's ``stats()`` equal
  JAX's apart from ``promote_ms_total`` (a wall time).
- int8 and fp8 pools spill codes and scales, bit-equal to the JAX pool's
  ``spill_blocks`` for the same blocks, and a round trip is bit exact.
- A host budget too small for an entry falls back to eviction; the
  tier's own budget discards its LRU entries (LRU to oblivion).
- graftmem bytes are conserved across demote and promote, and the
  per-tier conservation holds through a preempt/resume storm in the
  pooled iteration batcher under ``GRAFTSAN=1``.
- ``KV_HOST_BLOCKS`` without a pool refuses with JAX's message.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.ops import kv_quant as JKVQ
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu.runtime import kv_pool as jkv
from llm_sharding_demo_tpu.runtime.kv_tier import HostKVTier as JHostKVTier
from llm_sharding_demo_tpu.runtime.prefix_cache import (
    PrefixCachingEngine as JPrefixCachingEngine)
from llm_sharding_demo_tpu.utils import config as jconfig
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.ops import kv_quant as KVQ
from llm_sharding_demo_tpu_torch.runtime import kv_pool as tkv
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        SamplingConfig)
from llm_sharding_demo_tpu_torch.runtime.iterbatch import IterBatchingEngine
from llm_sharding_demo_tpu_torch.runtime.kv_pool import (KVBlockPool,
                                                         PoolExhausted)
from llm_sharding_demo_tpu_torch.runtime.kv_tier import HostKVTier
from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
    PrefixCachingEngine)
from llm_sharding_demo_tpu_torch.utils import config as tconfig
from llm_sharding_demo_tpu_torch.utils import graftmem
from llm_sharding_demo_tpu_torch.utils.metrics import REGISTRY
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

# tests/test_kv_tier.py's shapes
DIMS = dict(vocab_size=211, n_positions=256, n_embd=32, n_layer=2, n_head=4)
MAX_SEQ = 64
BS = 8


@pytest.fixture(scope="module")
def setup():
    tree = np_gpt2_params(seed=0, std=0.3, dims=DIMS)
    jeng = jengine.DecodeEngine(jax.tree.map(jnp.asarray, tree),
                                jgpt2.GPT2Config(**DIMS), max_seq=MAX_SEQ)
    tp = params_from_numpy(tree, device="cpu")
    return tp, jeng, DecodeEngine(tp, gpt2.GPT2Config(**DIMS),
                                  max_seq=MAX_SEQ, device="cpu")


def _tiered(mod, tier_mod, prefix_cls, eng, num_blocks=40, host_blocks=64,
            chunk=20, capacity=4, block_dtype=None):
    pool = mod.KVBlockPool.for_engine(eng, num_blocks=num_blocks,
                                      block_size=BS, block_dtype=block_dtype)
    pool.attach_tier(tier_mod(host_blocks))
    pref = prefix_cls(eng, capacity=capacity, chunk=chunk, pool=pool)
    return pool, pref, mod.PagedKVRunner(eng, pool, prefix=pref)


def _port(eng, **kw):
    return _tiered(tkv, HostKVTier, PrefixCachingEngine, eng, **kw)


def _jax(jeng, **kw):
    return _tiered(jkv, JHostKVTier, JPrefixCachingEngine, jeng, **kw)


def _demote_all(pool):
    n = 0
    while pool.allocator.prefix_len() > 0:
        assert pool.tier.demote_lru(pool)
        n += 1
    return n


def _tier_stats(pool):
    st = dict(pool.tier.stats())
    del st["promote_ms_total"]   # a wall time
    return st


def _codes(q) -> np.ndarray:
    """Raw code bytes of either package's codes (fp8 compared as bits)."""
    if isinstance(q, torch.Tensor):
        return (q.numpy() if q.dtype in (torch.int8, torch.float32)
                else q.view(torch.uint8).numpy())
    a = np.asarray(q)
    return a if a.dtype in (np.int8, np.float32) else a.view(np.uint8)


def test_demote_promote_byte_identical_greedy(setup):
    _, jeng, eng = setup
    runs = {}
    for name, (pool, _, runner) in (("port", _port(eng)),
                                    ("jax", _jax(jeng))):
        long = np.random.default_rng(11).integers(0, 211, 30)
        ids = long.astype(np.int32 if name == "jax" else np.int64)[None, :]
        toks = [runner.generate(ids, 12).tokens]      # miss and insert
        assert _demote_all(pool) == 1
        stats = [_tier_stats(pool)]
        assert pool.allocator.stats().prefix_entries == 0
        toks.append(runner.generate(ids, 12).tokens)  # promotes
        stats.append(_tier_stats(pool))
        assert pool.allocator.stats().prefix_entries == 1
        toks.append(runner.generate(ids, 12).tokens)  # a device hit
        stats.append(_tier_stats(pool))
        pool.tier.graftsan_check("test")
        runs[name] = toks, stats, pool.allocator.stats().as_dict()
    want = eng.generate(np.random.default_rng(11).integers(0, 211, 30)[None],
                        12).tokens
    for got in runs["port"][0]:
        np.testing.assert_array_equal(got, want)
    for got, jgot in zip(runs["port"][0], runs["jax"][0]):
        np.testing.assert_array_equal(got, jgot)
    assert runs["port"][1] == runs["jax"][1]
    assert runs["port"][1][1]["promotions"] == 1
    assert runs["port"][1][1]["host_bytes"] == 0
    assert runs["port"][2] == runs["jax"][2]


def test_demote_promote_byte_identical_seeded_sample(setup):
    _, _, eng = setup
    pool, _, runner = _port(eng)
    long = np.random.default_rng(12).integers(0, 211, 26)[None, :]
    s = SamplingConfig(mode="sample", temperature=0.7, top_k=17)

    def gen():
        return torch.Generator().manual_seed(9)

    want = eng.generate(long, 10, sampling=s, generator=gen()).tokens
    np.testing.assert_array_equal(
        runner.generate(long, 10, sampling=s, generator=gen()).tokens, want)
    assert _demote_all(pool) >= 1
    got = runner.generate(long, 10, sampling=s, generator=gen()).tokens
    np.testing.assert_array_equal(got, want)
    assert pool.tier.stats()["promotions"] >= 1


@pytest.mark.parametrize("regime", ["int8", "fp8"])
def test_quantized_spill_codes_and_scales_equal_jax(setup, regime):
    """Both packages' quantized pools hold the same entry (the blocks'
    raw planes written with ``fill_blocks`` from each package's codec,
    whose codes and scales are bit-equal, tests/test_torch_kv_quant.py;
    the JAX pool's jitted scatter rounds some scales an ulp off its own
    eager codec, so the planes are not scattered). Its host copies
    (``spill_blocks``), the tier's demoted entry and the planes after a
    promote are bit-equal to the JAX pool's, codes and scales, never
    dequantized."""
    _, jeng, eng = setup
    hd = DIMS["n_embd"] // DIMS["n_head"]
    blk = (np.random.default_rng(13).standard_normal(
        (DIMS["n_layer"], 4, 2, DIMS["n_head"], BS, hd))
        * 10.0 ** np.random.default_rng(14).uniform(
            -2, 1, (DIMS["n_layer"], 4, 2, DIMS["n_head"], 1, 1))
           ).astype(np.float32)
    spilled = {}
    for name, mod, tier_cls, e, planes in (
            ("port", tkv, HostKVTier, eng,
             KVQ.QUANTIZERS[regime](torch.from_numpy(blk))),
            ("jax", jkv, JHostKVTier, jeng,
             [np.asarray(x) for x in getattr(
                 JKVQ, f"quantize_blocks_{regime}")(jnp.asarray(blk))])):
        pool = mod.KVBlockPool.for_engine(e, num_blocks=20, block_size=BS,
                                          block_dtype=regime)
        pool.attach_tier(tier_cls(64))
        a = pool.allocator
        ids = a.alloc(4)
        pool.fill_blocks(ids, *planes)
        a.register_prefix(b"entry", ids)
        a.free(ids)
        codes0, scales0 = pool.spill_blocks(list(ids))
        assert _demote_all(pool) == 1
        entry = pool.tier._entries[b"entry"]
        new_ids = pool.tier.promote(pool, b"entry")
        codes1, scales1 = pool.spill_blocks(list(new_ids))
        a.free(new_ids)
        spilled[name] = [_codes(x) for x in (codes0, scales0, entry.codes,
                                             entry.scales, codes1, scales1)]
        assert _tier_stats(pool)["promotions"] == 1
    np.testing.assert_array_equal(spilled["port"][0], _codes(
        KVQ.QUANTIZERS[regime](torch.from_numpy(blk))[0]))
    assert spilled["port"][0].dtype in (np.int8, np.uint8)
    for got, want in zip(spilled["port"], spilled["jax"]):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(spilled["port"][4], spilled["port"][0])
    np.testing.assert_array_equal(spilled["port"][5], spilled["port"][1])


def _register(a, tags, n=2):
    for tag in tags:
        ids = a.alloc(n)
        a.register_prefix(tag, ids)
        a.free(ids)


def test_host_budget_exhaustion_falls_back_to_eviction(setup):
    _, jeng, eng = setup
    out = []
    for mod, tier_cls, e in ((tkv, HostKVTier, eng),
                             (jkv, JHostKVTier, jeng)):
        pool = mod.KVBlockPool.for_engine(e, num_blocks=8, block_size=BS)
        pool.attach_tier(tier_cls(1))            # < any 2-block entry
        a = pool.allocator
        _register(a, (b"p1", b"p2"))
        assert not pool.tier.demote_lru(pool)    # a typed refusal
        big = a.alloc(8)                         # eviction instead
        st = a.stats()
        assert st.evictions >= 2 and st.prefix_entries == 0
        with pytest.raises(mod.PoolExhausted):
            a.alloc(20)
        a.free(big)
        pool.tier.graftsan_check("test")
        out.append((_tier_stats(pool), a.stats().as_dict()))
    assert out[0] == out[1]
    assert out[0][0]["demotions"] == 0


def test_tier_budget_lru_to_oblivion(setup):
    _, jeng, eng = setup
    out = []
    for mod, tier_cls, e in ((tkv, HostKVTier, eng),
                             (jkv, JHostKVTier, jeng)):
        pool = mod.KVBlockPool.for_engine(e, num_blocks=12, block_size=BS)
        pool.attach_tier(tier_cls(4))            # two 2-block entries
        _register(pool.allocator, (b"p1", b"p2", b"p3"))
        assert _demote_all(pool) == 3
        assert not pool.tier.has(b"p1")
        assert pool.tier.has(b"p2") and pool.tier.has(b"p3")
        pool.tier.graftsan_check("test")
        out.append((_tier_stats(pool), pool.allocator.stats().as_dict()))
    assert out[0] == out[1]
    assert (out[0][0]["discards"], out[0][0]["host_blocks_in_use"],
            out[0][0]["host_entries"]) == (1, 4, 2)


def test_allocation_pressure_demotes_before_evicting(setup):
    """``alloc`` under pressure moves the LRU entry down a tier (no
    eviction counted), in both packages alike."""
    _, jeng, eng = setup
    out = []
    for mod, tier_cls, e in ((tkv, HostKVTier, eng),
                             (jkv, JHostKVTier, jeng)):
        pool = mod.KVBlockPool.for_engine(e, num_blocks=8, block_size=BS)
        pool.attach_tier(tier_cls(16))
        a = pool.allocator
        _register(a, (b"p1", b"p2", b"p3"))
        got = a.alloc(5)
        out.append((_tier_stats(pool), a.stats().as_dict()))
        a.free(got)
    assert out[0] == out[1]
    assert out[0][0]["demotions"] == 2 and out[0][1]["evictions"] == 0


def test_ledger_bytes_conserved_across_demote_promote(setup):
    _, _, eng = setup
    pool, _, runner = _port(eng)
    plane = graftmem.holding_bytes(pool, "data")
    assert plane == pool.data.nelement() * pool.data.element_size()
    before = graftmem.component_bytes().get("host_spill", 0)
    long = np.random.default_rng(14).integers(0, 211, 30)[None, :]
    runner.generate(long, 8)
    assert _demote_all(pool) == 1
    host = graftmem.component_bytes()["host_spill"] - before
    assert host == pool.tier.stats()["host_bytes"] > 0
    assert graftmem.holding_bytes(pool, "data") == plane
    runner.generate(long, 8)                      # promotes
    assert graftmem.component_bytes()["host_spill"] == before
    assert pool.tier.stats()["host_bytes"] == 0
    pool.note_gauges()
    snap = REGISTRY.snapshot()
    assert snap["gauges"][("kv_host_blocks_total",
                           (("component", "pool"),))] == 64
    assert snap["counters"][("tier_demotions_total", ())] >= 1
    assert snap["counters"][("tier_promotions_total", ())] >= 1


def test_tier_conservation_through_preempt_resume_storm(setup, monkeypatch):
    """Two rows whose joint footprint passes the pool force preemption
    and resume while allocation pressure demotes registered entries;
    per-tier conservation, the byte ledger and the sanitizer's sweep
    hold throughout, and both streams equal their solo runs."""
    monkeypatch.setenv("GRAFTSAN", "1")
    tp, _, _ = setup
    eng = DecodeEngine(tp, gpt2.GPT2Config(**DIMS), max_seq=200,
                       device="cpu")
    pool = KVBlockPool.for_engine(eng, num_blocks=25, block_size=BS)
    assert pool.allocator.sanitize
    pool.attach_tier(HostKVTier(64))
    plane = graftmem.holding_bytes(pool, "data")
    _register(pool.allocator, (b"p1", b"p2", b"p3"))
    ib = IterBatchingEngine(eng, max_batch=4, seg_steps=8,
                            max_wait_ms=300.0, pool=pool)
    rng = np.random.default_rng(42)
    jobs = [(rng.integers(0, 211, 5), 96), (rng.integers(0, 211, 8), 110)]
    res = [None, None]

    def run(i):
        res[i] = ib.generate(jobs[i][0], jobs[i][1], timeout=300)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    for (p, n), r in zip(jobs, res):
        np.testing.assert_array_equal(
            r.tokens[0], eng.generate(p[None], n).tokens[0])
    st = ib.stats()
    assert st["preemptions"] >= 1 and st["resumes"] >= 1
    tst = pool.tier.stats()
    assert tst["demotions"] >= 1
    pool.tier.graftsan_check("storm")
    assert graftmem.holding_bytes(pool, "data") == plane
    tkv.graftsan_sweep(timeout=10.0)


def test_host_blocks_without_a_pool_refuses_as_jax(monkeypatch):
    monkeypatch.setenv("KV_HOST_BLOCKS", "8")
    with pytest.raises(ValueError) as jerr:
        jconfig.from_env()
    with pytest.raises(ValueError) as terr:
        tconfig.from_env()
    assert str(terr.value) == str(jerr.value)
    assert "KV_HOST_BLOCKS" in str(terr.value)
    with pytest.raises(ValueError, match="host_blocks"):
        HostKVTier(0)
    with pytest.raises(PoolExhausted):
        KVBlockPool(2, 4, 2, BS, 8, 32, device="cpu").allocator.alloc(5)
