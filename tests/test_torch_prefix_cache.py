"""The port's prefix cache (``runtime.prefix_cache.PrefixCachingEngine``)
against the JAX package's on the same numpy weights.

- Cold, exact-hit, partial-hit and deeper-extension prompts give fp32
  greedy streams byte-equal to the JAX ``PrefixCachingEngine`` and to
  the port's plain engine with the cache off: GPT-2 and llama, unstaged
  and staged, on the plain path and on the kernel modes ("layer",
  "mega"; on the CPU their plain versions over the fused cache) against
  the JAX engines in interpret mode. ``stats()`` equals JAX's after the
  same sequence.
- Hits extend a clone of the stored entry (the port writes caches in
  place), so three identical requests stay exact.
- LRU eviction and the graftmem ledger, seeded sampling (cold, warm and
  the plain engine equal within the port), the guards.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu_torch.models.moe import MoEConfig
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu.runtime.prefix_cache import (
    PrefixCachingEngine as JPrefixCachingEngine)
from llm_sharding_demo_tpu_torch.models import gpt2, llama
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        SamplingConfig)
from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
    PrefixCachingEngine, clone_cache)
from llm_sharding_demo_tpu_torch.runtime.spec_decode import SpecDecodeEngine
from llm_sharding_demo_tpu_torch.utils import graftmem
from test_torch_llama import np_llama_params
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

GPT2_DIMS = dict(vocab_size=211, n_positions=1024, n_embd=128, n_layer=2,
                 n_head=2)
LLAMA_DIMS = dict(vocab_size=211, n_positions=1024, n_embd=256, n_layer=2,
                  n_head=4, n_kv_head=2, intermediate_size=256)
MAX_SEQ = 96
CHUNK = 8
NEW = 6
JAX_MODES = {"xla": "xla", "layer": "layer-interpret",
             "mega": "mega-interpret"}


@pytest.fixture(scope="module")
def models():
    out = {}
    for fam, dims, np_fn, jmod, tmod in (
            ("gpt2", GPT2_DIMS, np_gpt2_params, jgpt2, gpt2),
            ("llama", LLAMA_DIMS, np_llama_params, jllama, llama)):
        tree = np_fn(seed=1, std=0.08, dims=dims)
        cfg_cls = "LlamaConfig" if fam == "llama" else "GPT2Config"
        out[fam] = (getattr(jmod, cfg_cls)(**dims),
                    jax.tree.map(jnp.asarray, tree),
                    getattr(tmod, cfg_cls)(**dims),
                    params_from_numpy(tree, device="cpu"))
    return out


def _prompts():
    """Cold (stores 16 tokens), exact hit, partial hit (16 of a
    possible 24) and deeper extension (16, extended to 32): a 20-token
    system prefix, chunk 8."""
    rng = np.random.default_rng(0)
    system = rng.integers(0, 211, 20)
    return [system,
            system,
            np.concatenate([system[:16], rng.integers(0, 211, 10)]),
            np.concatenate([system, rng.integers(0, 211, 13)])]


@pytest.mark.parametrize("mode", ["xla", "layer", "mega"])
@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_streams_equal_jax_and_plain_engine(models, family, staged, mode):
    jcfg, jp, tcfg, tp = models[family]
    bounds = [1] if staged else None
    eng = DecodeEngine(tp, tcfg, max_seq=MAX_SEQ, boundaries=bounds,
                       decode_kernel=mode, device="cpu")
    assert eng.decode_kernel_mode == mode
    jeng = jengine.DecodeEngine(jp, jcfg, max_seq=MAX_SEQ,
                                boundaries=bounds,
                                decode_kernel=JAX_MODES[mode])
    pce = PrefixCachingEngine(eng, capacity=4, chunk=CHUNK)
    jpce = JPrefixCachingEngine(jeng, capacity=4, chunk=CHUNK)
    for i, p in enumerate(_prompts()):
        got = pce.generate(p, NEW).tokens
        np.testing.assert_array_equal(got, eng.generate(p[None], NEW).tokens,
                                      err_msg=f"prompt {i} vs plain")
        np.testing.assert_array_equal(
            got, jpce.generate(p.astype(np.int32), NEW).tokens,
            err_msg=f"prompt {i} vs JAX")
    st = pce.stats()
    assert st == jpce.stats()
    assert (st["hits"], st["misses"], st["entries"]) == (3, 1, 3)


def test_three_identical_requests_extend_a_clone(models):
    """Hits extend a clone: the stored entry keeps its bytes, so the
    second and third identical requests stay exact."""
    _, _, tcfg, tp = models["gpt2"]
    eng = DecodeEngine(tp, tcfg, max_seq=MAX_SEQ, device="cpu")
    pce = PrefixCachingEngine(eng, capacity=2, chunk=CHUNK)
    prompt = (np.arange(30) * 7) % 211
    want = eng.generate(prompt[None], 8).tokens
    pce.generate(prompt, 8)
    (key, entry), = pce._store.items()
    snapshot = clone_cache(entry)
    for _ in range(2):
        np.testing.assert_array_equal(pce.generate(prompt, 8).tokens, want)
    assert torch.equal(pce._store[key].k, snapshot.k)
    assert torch.equal(pce._store[key].v, snapshot.v)
    assert pce.stats()["hits"] == 2


def test_lru_eviction_releases_the_ledger(models):
    _, _, tcfg, tp = models["gpt2"]
    eng = DecodeEngine(tp, tcfg, max_seq=MAX_SEQ, device="cpu")
    before = graftmem.component_bytes().get("prefix_store", 0)
    pce = PrefixCachingEngine(eng, capacity=2, chunk=CHUNK)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 211, 20) for _ in range(4)]
    for p in prompts:
        pce.generate(p, 3)
    assert pce.stats()["entries"] == 2
    held = graftmem.component_bytes()["prefix_store"] - before
    one = graftmem.measure(next(iter(pce._store.values())))
    assert held == 2 * one > 0
    # the two oldest were evicted: their prompts miss again
    misses = pce.stats()["misses"]
    pce.generate(prompts[0], 3)
    assert pce.stats()["misses"] == misses + 1


def test_seeded_sampling_cold_warm_and_plain_equal(models):
    _, _, tcfg, tp = models["gpt2"]
    eng = DecodeEngine(tp, tcfg, max_seq=MAX_SEQ, device="cpu")
    pce = PrefixCachingEngine(eng, capacity=4, chunk=CHUNK)
    s = SamplingConfig(mode="sample", temperature=0.7, top_k=20)
    prompt = np.random.default_rng(3).integers(0, 211, 26)

    def gen():
        return torch.Generator().manual_seed(11)

    want = eng.generate(prompt[None], 10, sampling=s, generator=gen()).tokens
    cold = pce.generate(prompt, 10, sampling=s, generator=gen()).tokens
    warm = pce.generate(prompt, 10, sampling=s, generator=gen()).tokens
    np.testing.assert_array_equal(cold, want)
    np.testing.assert_array_equal(warm, want)
    assert pce.stats()["hits"] == 1


def test_guards(models):
    _, _, tcfg, tp = models["gpt2"]
    eng = DecodeEngine(tp, tcfg, max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        PrefixCachingEngine(eng, capacity=0)
    with pytest.raises(ValueError, match="chunk"):
        PrefixCachingEngine(eng, chunk=0)
    with pytest.raises(ValueError, match="same DecodeEngine"):
        PrefixCachingEngine(eng, spec=SpecDecodeEngine(
            tp, tcfg, max_seq=MAX_SEQ, device="cpu"))
    # the port's own MoE family (ported) is window-dependent
    moe = types.SimpleNamespace(config=MoEConfig(
        vocab_size=64, n_positions=64, n_embd=32, n_layer=2, n_head=4))
    with pytest.raises(NotImplementedError, match="window-dependent"):
        PrefixCachingEngine(moe)
    pce = PrefixCachingEngine(eng, chunk=CHUNK)
    with pytest.raises(ValueError, match="single-stream"):
        pce.generate(np.asarray([[1, 2, 3], [4, 5, 6]]), 4)
    with pytest.raises(ValueError, match="max_seq"):
        pce.generate(np.arange(90) % 211, 10)
    with pytest.raises(ValueError, match="pool-backed"):
        pce.prefill_shared(np.arange(10))
