"""The port's quantized KV blocks (``ops.kv_quant`` and the quantized
pool) against the JAX package's on the same numpy inputs.

- int8 and fp8 (e4m3fn) codes and scales bit-equal to the JAX codecs on
  seeded blocks, all-zero blocks (the 1e-8 floor), values at the clip
  and half-way ties;
- the quantized movers (scatter with trash duplicates, gather, copy)
  equal to the JAX movers;
- a quantized ``PagedKVRunner``, teacher-forced through the pool, within
  ``kv.int8`` / ``kv.fp8`` of the fp32 run, and replay-identical;
- the ``KV_POOL_DTYPE`` validation of tests/test_kv_quant.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.ops import kv_quant as JKVQ
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.ops import kv_quant as KVQ
from llm_sharding_demo_tpu_torch.ops import paged_attention as PA
from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
from llm_sharding_demo_tpu_torch.runtime.kv_pool import (KVBlockPool,
                                                         PagedKVRunner,
                                                         bytes_per_block)
from llm_sharding_demo_tpu_torch.utils import graftnum
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_kv_pool import BS, DIMS, MAX_SEQ, tf_paged
from test_torch_model import np_gpt2_params

L, HKV, HD, NB = 2, 2, 4, 10
NBM = MAX_SEQ // BS
QMAX = {"int8": 127.0, "fp8": 448.0}


def _codes(q) -> np.ndarray:
    """Raw code bytes of either package's codes (fp8 compared as bits)."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy() if q.dtype != torch.int8 \
            else q.numpy()
    a = np.asarray(q)
    return a.view(np.uint8) if a.dtype != np.int8 else a


def _blocks(regime: str) -> np.ndarray:
    """[6, 3, BS, 16] f32 blocks: seeded normals over four decades of
    scale, an all-zero block, blocks whose absmax sits on several
    entries of both signs (the clip), and blocks of exact half-way
    ties (scale 1: int8 values k + 0.5; fp8 midpoints of adjacent e4m3
    codes)."""
    rng = np.random.default_rng(0)
    blk = (rng.normal(size=(6, 3, BS, 16))
           * 10.0 ** rng.uniform(-3, 1, size=(6, 3, 1, 1))).astype(np.float32)
    blk[0, 0] = 0.0
    q = QMAX[regime]
    clip = blk[1, 1].copy()
    m = np.abs(clip).max()
    clip.reshape(-1)[:6] = [m, -m, m, -m, m * (1 - 1e-7), -m * (1 - 1e-7)]
    blk[1, 1] = clip
    if regime == "int8":
        ties = rng.integers(-126, 126, size=(BS, 16)) + 0.5
    else:
        grid = np.asarray([1.0625, 1.1875, 2.125, 2.375, 13.0, 15.0,
                           0.5625, 0.2109375, 208.0, 240.0, 416.0])
        ties = rng.choice(grid, size=(BS, 16)) * rng.choice([-1, 1],
                                                              size=(BS, 16))
    ties.reshape(-1)[0] = q            # absmax q: scale exactly 1
    blk[2, 2] = ties.astype(np.float32)
    return blk


@pytest.mark.parametrize("regime", ["int8", "fp8"])
def test_codes_and_scales_bit_equal_jax(regime):
    blk = _blocks(regime)
    tq, ts = KVQ.QUANTIZERS[regime](torch.tensor(blk))
    jq, js = getattr(JKVQ, f"quantize_blocks_{regime}")(jnp.asarray(blk))
    np.testing.assert_array_equal(_codes(tq), _codes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == KVQ.STORAGE_DTYPES[regime]
    assert float(ts[2, 2]) == 1.0       # the ties block ran at scale 1
    assert float(ts[0, 0]) == np.float32(1e-8) / np.float32(QMAX[regime])
    assert not _codes(tq)[0, 0].any()   # zero block: zero codes
    deq = KVQ.dequantize_blocks(tq, ts, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(JKVQ.dequantize_blocks(jq, js, jnp.float32)))
    np.testing.assert_array_equal(deq[0, 0].numpy(), 0.0)
    # the round trip within half a step of the block's scale (int8)
    if regime == "int8":
        err = np.abs(deq.numpy() - blk).max(axis=(-2, -1))
        assert (err <= 0.5 * ts.numpy() * (1 + 1e-6)).all()


@pytest.mark.parametrize("regime", ["int8", "fp8"])
def test_quantized_movers_equal_jax(regime):
    rng = np.random.default_rng(1)
    data = np.zeros(PA.pool_shape(L, NB, HKV, BS, HD), np.int8)
    sc = np.zeros(KVQ.scales_shape(L, NB, HKV), np.float32)
    k, v = (rng.normal(size=(L, 2, HKV, NBM * BS, HD)).astype(np.float32)
            for _ in range(2))
    tables = np.array([[NB, 4, 6, 1, NB, NB, NB, NB],
                       [0, 2, 3, 5, 7, 8, 9, NB]], np.int32)
    jdata = jnp.asarray(data).astype(JKVQ.STORAGE_DTYPES[regime])
    tdata = torch.tensor(data).to(KVQ.STORAGE_DTYPES[regime])
    jd, js = getattr(JKVQ, f"scatter_kv_{regime}")(
        jdata, jnp.asarray(sc), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(tables))
    td, ts = getattr(KVQ, f"scatter_kv_{regime}")(
        tdata, torch.tensor(sc), torch.tensor(k), torch.tensor(v), tables)
    np.testing.assert_array_equal(_codes(td), _codes(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for out_dtype, jout in ((torch.float32, jnp.float32),
                            (torch.bfloat16, jnp.bfloat16)):
        gk, gv = KVQ.gather_kv_q(td, ts, tables, out_dtype)
        jk, jv = JKVQ.gather_kv_q(jd, js, jnp.asarray(tables), jout)
        np.testing.assert_array_equal(gk.float().numpy(),
                                      np.asarray(jk, np.float32))
        np.testing.assert_array_equal(gv.float().numpy(),
                                      np.asarray(jv, np.float32))
    td, ts = KVQ.copy_blocks_q(td, ts, [4], [NB - 1])
    jd, js = JKVQ.copy_blocks_q(jd, js, jnp.asarray([4], jnp.int32),
                                jnp.asarray([NB - 1], jnp.int32))
    np.testing.assert_array_equal(_codes(td), _codes(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.fixture(scope="module")
def eng():
    """Weights at the scale the ``kv.*`` budgets were set for (std 0.04)."""
    tree = np_gpt2_params(seed=0, dims=DIMS)
    return DecodeEngine(params_from_numpy(tree, device="cpu"),
                        gpt2.GPT2Config(**DIMS), max_seq=MAX_SEQ,
                        device="cpu")


@pytest.mark.parametrize("regime,path", [("int8", "kv.int8"),
                                         ("fp8", "kv.fp8")])
def test_quantized_runner_within_budget_and_replays(eng, regime, path):
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 211, 9).tolist()
    forced = rng.integers(0, 211, 40).tolist()
    full = KVBlockPool.for_engine(eng, num_blocks=24, block_size=BS)
    exact = tf_paged(eng, full, prompt, forced)
    pool = KVBlockPool.for_engine(eng, num_blocks=24, block_size=BS,
                                  block_dtype=regime)
    assert pool.scales is not None and pool.data.dtype == (
        KVQ.STORAGE_DTYPES[regime])
    approx = tf_paged(eng, pool, prompt, forced)
    rep = graftnum.compare(path, approx, exact)
    assert rep["n_positions"] == len(forced) and rep["logit_mse"] > 0.0
    torch.testing.assert_close(tf_paged(eng, pool, prompt, forced), approx,
                               rtol=0, atol=0)
    runner = PagedKVRunner(eng, pool)
    a = runner.generate(np.asarray(prompt), 24).tokens
    np.testing.assert_array_equal(runner.generate(np.asarray(prompt),
                                                  24).tokens, a)
    assert pool.allocator.stats().blocks_in_use == 0
    st = pool.stats()
    hd = DIMS["n_embd"] // DIMS["n_head"]
    assert st["block_dtype"] == regime
    assert st["bytes_per_block"] == bytes_per_block(
        DIMS["n_layer"], DIMS["n_head"], BS, hd, block_dtype=regime) == (
        DIMS["n_layer"] * 2 * DIMS["n_head"] * (BS * hd + 4))
    assert 4 * st["bytes_per_block"] > full.stats()["bytes_per_block"] >= (
        2 * st["bytes_per_block"])


def test_pool_rejects_full_precision_and_undeclared_block_dtypes(eng):
    for spelling in ("f32", "bfloat16"):
        with pytest.raises(ValueError, match="full-precision"):
            KVBlockPool.for_engine(eng, num_blocks=24, block_size=BS,
                                   block_dtype=spelling)
    with pytest.raises(graftnum.GraftnumError, match="regime"):
        KVBlockPool.for_engine(eng, num_blocks=24, block_size=BS,
                               block_dtype="int4")
    assert KVQ.fp8_supported()


@pytest.mark.parametrize("knobs", [
    dict(kv_pool_dtype="int8"),                                # no pool
    dict(kv_pool_dtype="int4", kv_pool_blocks=24, kv_block_size=8,
         max_seq=64),                                          # a typo
    dict(kv_pool_dtype="bfloat16", kv_pool_blocks=24, kv_block_size=8,
         max_seq=64),                                          # full precision
    dict(kv_pool_blocks=-1),
    dict(kv_pool_blocks=24, kv_block_size=0),
])
def test_serving_config_kv_pool_dtype_validation(knobs):
    """The knobs refuse as the JAX config refuses, with its message."""
    with pytest.raises(ValueError) as jerr:
        JServingConfig(**knobs)
    with pytest.raises(ValueError) as terr:
        ServingConfig(**knobs)
    assert str(terr.value).split(":")[0] == str(jerr.value).split(":")[0]
    ok = dict(kv_pool_dtype="int8", kv_pool_blocks=24, kv_block_size=8,
              max_seq=64)
    assert ServingConfig(**ok).kv_pool_dtype == JServingConfig(
        **ok).kv_pool_dtype == "int8"
