"""The port's paged-KV movers (``ops.paged_attention``) against the JAX
package's on the same numpy inputs, and the paged decode attention
against the port's contiguous cached attention.

The six claims of tests/test_paged_attention.py: scatter then gather is
a byte-exact round trip; duplicate (trash) targets resolve as the JAX
package's unrolled chain does, last entry wins, with the whole pool
equal after the same scatter; ``copy_blocks`` copies and isolates;
single-token paged attention equals the contiguous path byte for byte
(and the JAX op in fp32); float tables are refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.ops import paged_attention as JPA
from llm_sharding_demo_tpu_torch.ops import paged_attention as PA
from llm_sharding_demo_tpu_torch.ops.attention import cached_attention_inplace

L, HKV, BS, HD, NB = 2, 2, 8, 4, 10   # trash block = index NB
MAX_SEQ = 32
NBM = MAX_SEQ // BS


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def test_blocks_per_row_rejects_misaligned_max_seq():
    with pytest.raises(ValueError, match="multiple"):
        PA.blocks_per_row(30, BS)
    assert PA.blocks_per_row(MAX_SEQ, BS) == NBM
    assert PA.pool_shape(L, NB, HKV, BS, HD) == JPA.pool_shape(L, NB, HKV,
                                                               BS, HD)


def test_scatter_gather_round_trip_byte_exact():
    """Any permutation placement round-trips bitwise, and the pool after
    the scatter equals the JAX package's."""
    rng = np.random.default_rng(0)
    pool = np.zeros(PA.pool_shape(L, NB, HKV, BS, HD), np.float32)
    k, v = (_normal(rng, L, 2, HKV, MAX_SEQ, HD) for _ in range(2))
    tables = np.array([[3, 0, 7, 5], [1, 9, 2, 8]], np.int32)
    got = PA.scatter_kv(torch.tensor(pool), torch.tensor(k),
                        torch.tensor(v), tables)
    gk, gv = PA.gather_kv(got, tables)
    np.testing.assert_array_equal(gk.numpy(), k)
    np.testing.assert_array_equal(gv.numpy(), v)
    want = JPA.scatter_kv(jnp.asarray(pool), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(tables))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("tables", [
    [[0, 1, 2, 3], [NB, NB, NB, NB]],          # a ghost row
    [[NB, 4, 6, NB], [NB, NB, 5, NB]],          # pad prefixes and tails
])
def test_scatter_trash_duplicates_resolve_as_jax(tables):
    """Ghost and pad entries all alias the trash block: no real block is
    disturbed, and the trash block holds what JAX's chain leaves there
    (the last entry in row-major order), so the whole pool is equal."""
    rng = np.random.default_rng(1)
    pool = _normal(rng, *PA.pool_shape(L, NB, HKV, BS, HD))
    k, v = (_normal(rng, L, 2, HKV, MAX_SEQ, HD) for _ in range(2))
    t = np.asarray(tables, np.int32)
    got = PA.scatter_kv(torch.tensor(pool), torch.tensor(k),
                        torch.tensor(v), t).numpy()
    want = np.asarray(JPA.scatter_kv(jnp.asarray(pool), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(t)))
    np.testing.assert_array_equal(got, want)
    untouched = sorted(set(range(NB)) - set(t.reshape(-1).tolist()))
    np.testing.assert_array_equal(got[:, untouched], pool[:, untouched])
    # the last trash entry (row-major) is what the trash block holds
    flat = np.flatnonzero(t.reshape(-1) == NB)[-1]
    b, j = divmod(int(flat), NBM)
    np.testing.assert_array_equal(got[:, NB, 0],
                                  k[:, b, :, j * BS:(j + 1) * BS])


def test_copy_blocks_copies_and_isolates():
    rng = np.random.default_rng(2)
    pool = _normal(rng, *PA.pool_shape(L, NB, HKV, BS, HD))
    got = PA.copy_blocks(torch.tensor(pool), [4], [6]).numpy()
    np.testing.assert_array_equal(got[:, 6], pool[:, 4])
    np.testing.assert_array_equal(got[:, 4], pool[:, 4])  # source intact
    keep = [i for i in range(NB + 1) if i != 6]
    np.testing.assert_array_equal(got[:, keep], pool[:, keep])
    want = JPA.copy_blocks(jnp.asarray(pool), jnp.asarray([4], jnp.int32),
                           jnp.asarray([6], jnp.int32))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_paged_decode_attention_byte_equal_contiguous():
    """The paged attention step equals the port's contiguous in-place step
    byte for byte (outputs and gathered cache), stepped four tokens deep
    with the rows' blocks out of order, GQA, and a pad slot; and the
    JAX op in fp32."""
    rng = np.random.default_rng(3)
    B, G = 2, 2
    H = G * HKV
    depth0 = 5
    K, V = (_normal(rng, L, B, HKV, MAX_SEQ, HD) for _ in range(2))
    K[..., depth0:, :] = 0.0
    V[..., depth0:, :] = 0.0
    tables = np.array([[7, 2, 9, 0], [5, 8, 1, 3]], np.int32)
    pool0 = np.zeros(PA.pool_shape(L, NB, HKV, BS, HD), np.float32)
    pool = PA.scatter_kv(torch.tensor(pool0), torch.tensor(K),
                         torch.tensor(V), tables)
    jpool = JPA.scatter_kv(jnp.asarray(pool0), jnp.asarray(K),
                           jnp.asarray(V), jnp.asarray(tables))
    tK, tV = torch.tensor(K), torch.tensor(V)
    vf = np.array([1, 0], np.int32)      # row 0 has one pad slot
    for step in range(4):
        off = depth0 + step
        q = _normal(rng, B, H, 1, HD)
        kn, vn = (_normal(rng, B, HKV, 1, HD) for _ in range(2))
        for li in range(L):
            want, tK, tV = cached_attention_inplace(
                torch.tensor(q), torch.tensor(kn), torch.tensor(vn), tK, tV,
                li, off, k_valid_from=torch.tensor(vf))
            got, pool = PA.paged_decode_attention(
                torch.tensor(q), torch.tensor(kn), torch.tensor(vn), pool,
                tables, li, off, torch.tensor(vf))
            np.testing.assert_array_equal(got.numpy(), want.numpy())
            jout, jpool = JPA.paged_decode_attention(
                jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jpool,
                jnp.asarray(tables), jnp.asarray(li), jnp.asarray(off),
                jnp.asarray(vf))
            np.testing.assert_allclose(got.numpy(), np.asarray(jout),
                                       atol=1e-6, rtol=1e-6)
    gk, gv = PA.gather_kv(pool, tables)
    np.testing.assert_array_equal(gk.numpy(), tK.numpy())
    np.testing.assert_array_equal(gv.numpy(), tV.numpy())
    np.testing.assert_array_equal(pool.numpy(), np.asarray(jpool))


def test_movers_reject_float_tables():
    pool = torch.zeros(PA.pool_shape(L, NB, HKV, BS, HD))
    with pytest.raises(TypeError, match="integer"):
        PA.gather_kv(pool, np.zeros((1, NBM), np.float32))
    k = torch.zeros(L, 1, HKV, MAX_SEQ, HD)
    with pytest.raises(TypeError, match="integer"):
        PA.scatter_kv(pool, k, k, np.zeros((1, NBM), np.float32))
