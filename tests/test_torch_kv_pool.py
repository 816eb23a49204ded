"""The port's paged KV memory (``runtime.kv_pool``) against the JAX
package's on the same numpy weights and call sequences.

- ``BlockAllocator``: the four scenarios of tests/test_kv_pool.py run
  through both allocators; ids, refcounts and stats agree at every step.
- ``PagedKVRunner``: fp32 greedy streams (solo, EOS-armed, ragged batch)
  byte-equal to the JAX package's paged runner and to the port's
  contiguous engine; seeded sampled streams equal to the contiguous
  engine with the same generators; bf16 paged equal to bf16 contiguous
  and, teacher-forced through the pool, within ``decode.bf16`` of the
  JAX fp32 logits.
- Recompute resume (the preemption mechanism) is byte-identical.
- The pool gauges, ``for_engine``'s refusals.
- The seeded sanitizer faults of tests/test_graftsan.py: double free,
  leak at teardown, use-after-free gather, copy-on-write write to a
  shared block, refcount drift; each traps with provenance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu.runtime import kv_pool as jkv
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        SamplingConfig)
from llm_sharding_demo_tpu_torch.runtime.kv_pool import (BlockAllocator,
                                                         GraftsanError,
                                                         KVBlockPool,
                                                         PagedKVRunner,
                                                         PoolExhausted,
                                                         graftsan_sweep)
from llm_sharding_demo_tpu_torch.runtime.kv_tier import HostKVTier
from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
    PrefixCachingEngine)
from llm_sharding_demo_tpu_torch.utils import graftnum
from llm_sharding_demo_tpu_torch.utils.metrics import REGISTRY
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

# tests/test_kv_pool.py's shapes
DIMS = dict(vocab_size=211, n_positions=256, n_embd=32, n_layer=2, n_head=4)
MAX_SEQ = 64
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


@pytest.fixture(scope="module")
def jrunner(weights):
    """The one JAX engine of this file, paged."""
    e = jengine.DecodeEngine(weights[0], jgpt2.GPT2Config(**DIMS),
                             max_seq=MAX_SEQ)
    return jkv.PagedKVRunner(e, jkv.KVBlockPool.for_engine(
        e, num_blocks=24, block_size=BS))


def _runner(eng, num_blocks=24, **kw):
    return PagedKVRunner(eng, KVBlockPool.for_engine(
        eng, num_blocks=num_blocks, block_size=BS, **kw))


# -- BlockAllocator: the same call sequences through both packages -----------

def _alloc_free_refcount(mod, log):
    a = mod.BlockAllocator(num_blocks=8, block_size=BS)
    ids = a.alloc(3)
    log.append(ids)
    log.append(a.stats())
    a.ref(ids[:1])
    a.free(ids)
    log.append(a.stats())
    a.free(ids[:1])
    log.append(a.stats())
    for bad in (lambda: a.free(ids[:1]), lambda: a.ref([ids[0]])):
        with pytest.raises(ValueError):
            bad()


def _all_or_nothing(mod, log):
    a = mod.BlockAllocator(num_blocks=4, block_size=BS)
    first = a.alloc(3)
    with pytest.raises(mod.PoolExhausted):
        a.alloc(2)
    log.append(a.stats())
    last = a.alloc(1)
    log += [first, last]
    a.free(first)
    a.free(last)
    log.append(a.stats())


def _prefix_sharing_lru(mod, log):
    a = mod.BlockAllocator(num_blocks=8, block_size=BS)
    ids1 = a.alloc(2)
    a.register_prefix(b"p1", ids1)
    a.free(ids1)
    log.append(a.stats())
    ids2 = a.alloc(2)
    a.register_prefix(b"p2", list(ids1) + ids2)
    a.free(ids2)
    log.append(a.stats())
    got = a.lookup_prefix(b"p1")
    log += [got, a.refcount(ids1[0])]
    a.free(got)
    ids6 = a.alloc(6)          # evicts p2 (p1 was looked up last)
    log += [ids6, a.stats(), a.refcount(ids1[0])]
    with pytest.raises(mod.PoolExhausted):
        a.alloc(3)             # even evicting p1 yields only 2
    log.append(a.stats())
    a.free(ids6)
    ids = a.alloc(3)
    a.register_prefix(b"p3", ids[:2])
    a.register_prefix(b"p4", ids[1:])
    a.free(ids)
    log += [a.has_prefix(b"p3"), a.prefix_len(), a.drop_prefix(b"p3"),
            a.drop_prefix(b"p3"), a.stats()]
    a.evict_lru()              # drops p4, freeing its blocks
    log += [a.prefix_len(), a.available(), a.stats()]


def _watermark(mod, log):
    a = mod.BlockAllocator(num_blocks=10, block_size=BS, watermark=0.8)
    log += [a.can_admit(8), a.can_admit(9)]
    ids = a.alloc(9)           # alloc itself may use the reserve
    log += [ids, a.can_admit(1)]
    a.free(ids)
    log += [a.can_admit(8), a.blocks_for(17), a.admit_alloc(9),
            a.admit_alloc(2), a.stats()]


@pytest.mark.parametrize("scenario", [_alloc_free_refcount, _all_or_nothing,
                                      _prefix_sharing_lru, _watermark])
def test_allocator_scenarios_equal_jax(scenario):
    import llm_sharding_demo_tpu_torch.runtime.kv_pool as tkv
    want, got = [], []
    scenario(jkv, want)
    scenario(tkv, got)
    norm = [x.as_dict() if hasattr(x, "as_dict") else x for x in got]
    assert norm == [x.as_dict() if hasattr(x, "as_dict") else x
                    for x in want]


def test_allocator_claims():
    """The facts tests/test_kv_pool.py asserts on the scenarios."""
    a = BlockAllocator(num_blocks=8, block_size=BS)
    ids1 = a.alloc(2)
    a.register_prefix(b"p1", ids1)
    a.free(ids1)
    st = a.stats()
    assert st.blocks_evictable == 2 and st.prefix_entries == 1
    ids6 = a.alloc(6)
    assert a.stats().blocks_free == 0
    a.alloc(2)                 # evicts p1: its two blocks come back
    assert a.stats().evictions == 1 and a.stats().prefix_entries == 0
    with pytest.raises(PoolExhausted):
        a.alloc(1)
    a.free(ids6)


# -- PagedKVRunner -----------------------------------------------------------

def test_runner_greedy_and_eos_equal_jax_and_contiguous(eng, jrunner):
    runner = _runner(eng)
    prompt = np.random.default_rng(3).integers(0, 211, 7)
    want = eng.generate(prompt[None, :], 20).tokens
    got = runner.generate(prompt[None, :], 20).tokens
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jrunner.generate(prompt[None, :].astype(np.int32), 20).tokens)
    assert len(set(got[0, 7:].tolist())) > 3, "degenerate stream"
    assert runner.pool.allocator.stats().blocks_in_use == 0
    eos = int(want[0, -1])
    want_e = eng.generate(prompt[None, :], 40, eos_id=eos)
    got_e = runner.generate(prompt[None, :], 40, eos_id=eos)
    np.testing.assert_array_equal(got_e.tokens, want_e.tokens)
    assert got_e.new_tokens == want_e.new_tokens < 40
    np.testing.assert_array_equal(
        got_e.tokens, jrunner.generate(prompt[None, :].astype(np.int32), 40,
                                       eos_id=eos).tokens)


def test_runner_ragged_batch_equal_jax_and_contiguous(eng, jrunner):
    runner = _runner(eng)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 211, 5), rng.integers(0, 211, 9)]
    want = eng.generate(prompts, 16)
    got = runner.generate(prompts, 16)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.pad, want.pad)
    jgot = jrunner.generate([p.astype(np.int32) for p in prompts], 16)
    np.testing.assert_array_equal(got.tokens, jgot.tokens)
    assert runner.pool.allocator.stats().blocks_in_use == 0


def test_runner_seeded_sampled_equal_contiguous(eng):
    runner = _runner(eng)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 211, 5), rng.integers(0, 211, 9)]
    s = SamplingConfig(mode="sample", temperature=0.7, top_k=17)

    def gens():
        return [torch.Generator().manual_seed(1),
                torch.Generator().manual_seed(2)]

    want = eng.generate(prompts, 40, sampling=s, generator=gens())
    got = runner.generate(prompts, 40, sampling=s, generator=gens())
    np.testing.assert_array_equal(got.tokens, want.tokens)
    one = eng.generate(prompts[0][None, :], 12, sampling=s,
                       generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(
        runner.generate(prompts[0][None, :], 12, sampling=s,
                        generator=torch.Generator().manual_seed(9)).tokens,
        one.tokens)


def tf_paged(eng, pool, prompt, forced):
    """f32 logits ``[T, vocab]`` of one row, teacher-forced through the
    pool: the prefill scattered into blocks, then each forced token one
    gather, one cached forward and one scatter (a quantized pool
    re-quantizes every position, as a served row's segments do)."""
    alloc = pool.allocator
    tables = np.full((1, pool.nbm), pool.trash, np.int32)
    row = alloc.alloc(alloc.blocks_for(len(prompt) + len(forced)))
    tables[0, :len(row)] = row
    try:
        with torch.inference_mode():
            logits, cache = eng._prefill(eng._ids([prompt]), None)
            pool.scatter(cache, tables)
            out = [logits[0, -1]]
            for t, tok in enumerate(forced[:-1]):
                cache = pool.gather(tables, len(prompt) + t)
                logits, cache = eng._forward_cached(
                    eng._ids([[tok]]), cache, None)
                pool.scatter(cache, tables)
                out.append(logits[0, -1])
    finally:
        alloc.free(row)
    return torch.stack(out).float()


def test_bf16_paged_equal_contiguous_and_within_budget_of_jax():
    """On weights at the scale ``decode.bf16`` was set for (std 0.04, as
    tests/test_torch_model.py's budget test)."""
    tree = np_gpt2_params(seed=0, dims=DIMS)
    jp, tp = (jax.tree.map(jnp.asarray, tree),
              params_from_numpy(tree, device="cpu"))
    cfg = gpt2.GPT2Config(**DIMS)
    eng16 = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, dtype="bfloat16",
                         device="cpu")
    runner = _runner(eng16)
    assert runner.pool.data.dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 211, 6), rng.integers(0, 211, 11)]
    np.testing.assert_array_equal(runner.generate(prompts, 20).tokens,
                                  eng16.generate(prompts, 20).tokens)
    prompt = rng.integers(0, 211, 6).tolist()
    forced = rng.integers(0, 211, 24).tolist()
    exact = np.asarray(jgpt2.forward(jp, jnp.asarray([prompt + forced]),
                                     jgpt2.GPT2Config(**DIMS)))[
        0, len(prompt) - 1:-1]
    approx = tf_paged(eng16, runner.pool, prompt, forced)
    rep = graftnum.compare("decode.bf16", approx, torch.tensor(exact))
    assert rep["n_positions"] == len(forced)


def test_recompute_resume_byte_identical_greedy_and_sampled(eng):
    """The preemption mechanism at engine level: after k emitted tokens,
    re-prefill prompt + emitted[:-1], carry emitted[-1] as the live token
    and continue on the same generator: the continuation equals the
    unpreempted stream."""
    prompt = np.random.default_rng(9).integers(0, 211, 7)
    n, k = 20, 6
    s = SamplingConfig(mode="sample", temperature=0.8, top_k=12)
    for sampling, seed in ((SamplingConfig(), None), (s, 42)):
        def gen():
            return None if seed is None else torch.Generator().manual_seed(
                seed)
        toks = eng.generate(prompt[None, :], n, sampling=sampling,
                            generator=gen()).tokens[0]
        g = gen()
        emitted = eng.generate(prompt[None, :], k, sampling=sampling,
                               generator=g).tokens[0, len(prompt):]
        ext = np.concatenate([prompt, emitted[:-1]])
        with torch.inference_mode():
            _, cache = eng._prefill(eng._ids(ext[None, :]), None)
            token = torch.tensor([int(emitted[-1])])
            out, _ = eng._decode_seg(token, cache, None, n - k, sampling, g)
        np.testing.assert_array_equal(out[0].numpy(), toks[len(prompt) + k:])


def test_runner_emits_pool_gauges(eng):
    runner = _runner(eng)
    runner.generate(np.random.default_rng(5).integers(0, 211, 6)[None, :], 8)
    gauges = REGISTRY.snapshot()["gauges"]
    key = (("block_dtype", "f32"), ("component", "paged"))
    assert gauges[("kv_cache_blocks_total", key)] == 24
    assert gauges[("kv_cache_blocks_in_use", key)] == 0
    hd = DIMS["n_embd"] // DIMS["n_head"]
    assert gauges[("kv_pool_bytes_per_block", key)] == (
        runner.pool._bytes_per_block)
    assert runner.pool._bytes_per_block == (
        DIMS["n_layer"] * 2 * DIMS["n_head"] * BS * hd * 4)
    st = runner.pool.stats()
    assert (st["blocks_total"], st["blocks_free"], st["block_dtype"],
            st["blocks_per_row"]) == (24, 24, "f32", MAX_SEQ // BS)


def test_for_engine_refusals(weights, eng):
    """A decode kernel (with the JAX package's reason), a staged engine,
    chunked prefill, another device; prefix= and the host tier name
    ROADMAP item 10."""
    jp, tp = weights
    cfg = gpt2.GPT2Config(**dict(DIMS, n_embd=128, n_head=2))
    jcfg = jgpt2.GPT2Config(**dict(DIMS, n_embd=128, n_head=2))
    tree = np_gpt2_params(seed=1, dims=dict(DIMS, n_embd=128, n_head=2))
    kernel = DecodeEngine(params_from_numpy(tree, device="cpu"), cfg,
                          max_seq=256, decode_kernel="layer", device="cpu")
    jkernel = jengine.DecodeEngine(jax.tree.map(jnp.asarray, tree), jcfg,
                                   max_seq=256, decode_kernel="interpret")
    with pytest.raises(NotImplementedError) as jerr:
        jkv.KVBlockPool.for_engine(jkernel, num_blocks=64, block_size=BS)
    with pytest.raises(NotImplementedError) as terr:
        KVBlockPool.for_engine(kernel, num_blocks=64, block_size=BS)
    assert str(terr.value) == str(jerr.value)
    staged = DecodeEngine(tp, gpt2.GPT2Config(**DIMS), max_seq=MAX_SEQ,
                          boundaries=[1], device="cpu")
    with pytest.raises(NotImplementedError, match="unstaged"):
        KVBlockPool.for_engine(staged, num_blocks=24, block_size=BS)
    chunked = DecodeEngine(tp, gpt2.GPT2Config(**DIMS), max_seq=MAX_SEQ,
                           prefill_chunk=8, device="cpu")
    with pytest.raises(NotImplementedError, match="prefill_chunk"):
        KVBlockPool.for_engine(chunked, num_blocks=24, block_size=BS)
    with pytest.raises(ValueError, match="device"):
        KVBlockPool.for_engine(eng, num_blocks=24, block_size=BS,
                               device="meta")
    with pytest.raises(ValueError, match="one full row"):
        KVBlockPool.for_engine(eng, num_blocks=4, block_size=BS)
    pool = KVBlockPool.for_engine(eng, num_blocks=24, block_size=BS)
    # the prefix store must share the runner's pool (the JAX check)
    with pytest.raises(ValueError, match="same pool"):
        PagedKVRunner(eng, pool, prefix=PrefixCachingEngine(eng))
    # the host tier's hooks: attach, then a spill/fill round trip of the
    # raw planes into another block
    tier = HostKVTier(4)
    pool.attach_tier(tier)
    assert pool.tier is tier and pool.stats()["tier"] == tier.stats()
    src, dst = pool.allocator.alloc(2)
    pool.data[:, src].normal_()
    codes, scales = pool.spill_blocks([src])
    assert codes.shape == pool.data[:, [src]].shape and scales is None
    pool.fill_blocks([dst], codes)
    assert torch.equal(pool.data[:, dst], pool.data[:, src])
    pool.allocator.free([src, dst])


def test_scatter_columns_writes_only_the_tail(eng):
    """The column-offset scatter behind a shared prefix: columns below
    ``nb_lo`` keep their blocks' bytes, the tail takes the cache's."""
    pool = KVBlockPool.for_engine(eng, num_blocks=24, block_size=BS)
    row = pool.allocator.alloc(4)
    tables = np.full((1, pool.nbm), pool.trash, np.int32)
    tables[0, :4] = row
    before = pool.data.clone()
    cache = pool.gather(tables, 4 * BS)
    cache.k.fill_(1.0)
    cache.v.fill_(2.0)
    pool.scatter_columns(cache, tables, 2)
    assert torch.equal(pool.data[:, row[:2]], before[:, row[:2]])
    assert (pool.data[:, row[2:], 0] == 1.0).all()
    assert (pool.data[:, row[2:], 1] == 2.0).all()
    pool.allocator.free(row)


# -- the sanitizer's seeded faults -------------------------------------------

def _san_pool(eng, num_blocks=8) -> KVBlockPool:
    pool = KVBlockPool.for_engine(eng, num_blocks=num_blocks, block_size=BS,
                                  sanitize=True)
    assert pool.allocator.sanitize
    return pool


def test_seeded_double_free_traps_with_provenance():
    a = BlockAllocator(8, BS, sanitize=True)
    ids = a.alloc(2)
    a.free(ids)
    with pytest.raises(GraftsanError, match="double-free of block") as e:
        a.free([ids[0]])
    assert "previously freed at" in str(e.value)
    assert "test_torch_kv_pool.py" in str(e.value)
    with pytest.raises(ValueError):       # still the documented contract
        a.free([ids[0]])


def test_seeded_leak_reports_owner_provenance_at_teardown():
    a = BlockAllocator(8, BS, sanitize=True)
    leaked = a.alloc(1)
    report = a.graftsan_report()
    assert [(r["block"], r["leaked_refs"]) for r in report] == [
        (leaked[0], 1)]
    assert any("test_torch_kv_pool.py" in s
               for s in report[0]["grant_sites"])
    with pytest.raises(GraftsanError, match="teardown leak"):
        a.graftsan_assert_quiesced(timeout=0.05)
    with pytest.raises(GraftsanError, match="teardown leak"):
        graftsan_sweep(timeout=0.05)      # every live sanitizing allocator
    a.free(leaked)
    a.graftsan_assert_quiesced(timeout=0.05)
    ids = a.alloc(2)                      # prefix refs are not leaks
    a.register_prefix(b"k", ids)
    a.free(ids)
    a.graftsan_assert_quiesced(timeout=0.05)


def test_seeded_use_after_free_gather_traps_with_freeing_site(eng):
    pool = _san_pool(eng)
    row = pool.allocator.alloc(2)
    tables = np.full((1, pool.nbm), pool.trash, np.int32)
    tables[0, :2] = row
    pool.gather(tables, 8)                # live: fine
    pool.allocator.free(row)              # poisons the blocks
    assert torch.equal(pool.data[:, row[0]], pool.data[:, pool.trash])
    with pytest.raises(GraftsanError) as exc:
        pool.gather(tables, 8)
    msg = str(exc.value)
    assert "use-after-free" in msg and "poisoned block" in msg
    assert "freed at" in msg and "test_torch_kv_pool.py" in msg


def test_seeded_cow_write_to_shared_block_traps(eng):
    pool = _san_pool(eng)
    row = pool.allocator.alloc(1)
    pool.allocator.ref(row)               # refcount 2: shared
    tables = np.full((1, pool.nbm), pool.trash, np.int32)
    tables[0, 0] = row[0]
    cache = pool.gather(tables, 8)        # reads stay legal
    with pytest.raises(GraftsanError, match="CoW violation") as exc:
        pool.scatter(cache, tables)
    assert "test_torch_kv_pool.py" in str(exc.value)
    private = pool.cow_copy(row[0])       # the private copy is writable
    assert torch.equal(pool.data[:, private], pool.data[:, row[0]])
    tables[0, 0] = private
    pool.scatter(cache, tables)
    assert pool.allocator.stats().cow_copies == 1
    pool.allocator.free(row)
    pool.allocator.free(row)
    pool.allocator.free([private])
    pool.allocator.graftsan_assert_quiesced(timeout=0.05)


def test_seeded_refcount_conservation_drift_traps():
    a = BlockAllocator(8, BS, sanitize=True)
    ids = a.alloc(2)
    a._ref[ids[0]] += 1       # corrupt the accounting behind the API
    with pytest.raises(GraftsanError, match="conservation"):
        a.can_admit(1)
    a._ref[ids[0]] -= 1
    a.free(ids)


def test_paged_decode_byte_equal_with_sanitizer_armed(eng):
    runner = PagedKVRunner(eng, _san_pool(eng, num_blocks=12))
    prompt = np.arange(1, 9)
    np.testing.assert_array_equal(runner.generate(prompt, 10).tokens,
                                  eng.generate(prompt, 10).tokens)
    runner.pool.allocator.graftsan_assert_quiesced(timeout=0.05)
