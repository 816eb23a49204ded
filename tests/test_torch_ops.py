"""The PyTorch port's ops against the JAX package, on the CPU.

Layers and attention in fp32 (atol/rtol 1e-5); the plain version of the
decode-attention kernel against the JAX Pallas kernel in interpret mode
(output 2e-6, cache exactly equal); int8 quantization codes exactly
equal, and the plain int8 matmul and head against the JAX Pallas
kernels in interpret mode. On the CPU each kernel wrapper runs its
plain version, so these tests hold the arithmetic the CUDA kernels are
checked against on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.ops import attention as jattn
from llm_sharding_demo_tpu.ops import layers as jlayers
from llm_sharding_demo_tpu.ops import quant as jquant
from llm_sharding_demo_tpu.ops.decode_attention import (
    decode_attention as jdecode_attention)
from llm_sharding_demo_tpu_torch.ops import attention, layers, quant
from llm_sharding_demo_tpu_torch.ops.cuda_build import launch_counts
from llm_sharding_demo_tpu_torch.ops.decode_attention import (
    MAX_CLUSTER, MIN_SPAN, WAVE_CTAS, cluster_plan, decode_attention,
    decode_attention_plain)

TOL = dict(atol=1e-5, rtol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.tensor(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, s, b = _rand(rng, 3, 5, 64, scale=3), _rand(rng, 64), _rand(rng, 64)
    want = np.asarray(jlayers.layer_norm(jnp.asarray(x, dtype), jnp.asarray(s),
                                         jnp.asarray(b)), np.float32)
    got = layers.layer_norm(_t(x).to(getattr(torch, dtype)), _t(s), _t(b))
    assert str(got.dtype) == f"torch.{dtype}"
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_gelu_new_matches_jax():
    x = _rand(np.random.default_rng(1), 4, 257, scale=4)
    want = np.asarray(jlayers.gelu_new(jnp.asarray(x)))
    np.testing.assert_allclose(layers.gelu_new(_t(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("q_offset,valid", [(0, None), (0, [0, 3]),
                                            (4, [2, 0])])
def test_causal_attention_matches_jax(q_offset, valid):
    rng = np.random.default_rng(2)
    q = _rand(rng, 2, 3, 5, 16)
    k, v = _rand(rng, 2, 3, q_offset + 5, 16), _rand(rng, 2, 3, q_offset + 5, 16)
    vf = None if valid is None else np.asarray(valid, np.int32)
    want = np.asarray(jattn.causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=q_offset,
        k_valid_from=None if vf is None else jnp.asarray(vf)))
    got = attention.causal_attention(_t(q), _t(k), _t(v), q_offset=q_offset,
                                     k_valid_from=None if vf is None
                                     else _t(vf))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("s", [1, 4])
def test_cached_attention_fused_matches_jax(s):
    rng = np.random.default_rng(3)
    L, B, H, S, hd, off, li = 2, 2, 2, 64, 16, 9, 1
    KV = _rand(rng, L, B, H, S, 2 * hd)
    KV[..., off:, :] = 0
    q, kn, vn = (_rand(rng, B, H, s, hd) for _ in range(3))
    vf = np.asarray([0, 4], np.int32)
    jout, jKV = jattn.cached_attention_fused(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(KV),
        li, off, jnp.asarray(vf))
    tKV = _t(KV)
    out, tKV2 = attention.cached_attention_fused(_t(q), _t(kn), _t(vn), tKV,
                                                 li, off, _t(vf))
    assert tKV2 is tKV                      # written in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert np.array_equal(tKV.numpy(), np.asarray(jKV))


# the JAX package's kernel parametrisation (tests/test_decode_attention.py)
@pytest.mark.parametrize("off,vf", [
    (37, None),                       # single partial block
    (255, [0, 5]),                    # block boundary - 1, ragged mask
    (256, None),                      # exactly one full block
    (509, [100, 0]),                  # deep, ragged
])
@pytest.mark.parametrize("hkv", [2, 4])   # GQA (g=2) and MHA (g=1)
def test_decode_attention_plain_matches_jax_kernel(off, vf, hkv):
    L, B, H, S, hd = 3, 2, 4, 512, 64
    rng = np.random.default_rng(off * 10 + hkv)
    KV = _rand(rng, L, B, hkv, S, 2 * hd)
    KV[..., off:, :] = 0
    q = _rand(rng, B, H, 1, hd)
    kn, vn = _rand(rng, B, hkv, 1, hd), _rand(rng, B, hkv, 1, hd)
    vf_np = None if vf is None else np.asarray(vf, np.int32)
    li = L - 1
    want, jKV = jdecode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(KV), li,
        off, None if vf_np is None else jnp.asarray(vf_np), interpret=True)
    tKV = _t(KV)
    before = launch_counts()["decode_attention"]
    got, tKV2 = decode_attention(_t(q), _t(kn), _t(vn), tKV, li, off,
                                 None if vf_np is None else _t(vf_np))
    assert tKV2 is tKV
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert launch_counts()["decode_attention"] == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)
    assert np.array_equal(tKV.numpy(), np.asarray(jKV))


def test_decode_attention_plain_self_term_only_at_offset_zero():
    """offset 0: no cached position, the output is v_new exactly."""
    rng = np.random.default_rng(4)
    KV = _t(_rand(rng, 1, 1, 2, 256, 128))
    q, kn, vn = (_t(_rand(rng, 1, 2, 1, 64)) for _ in range(3))
    out, KV = decode_attention_plain(q, kn, vn, KV, 0, 0)
    assert torch.equal(out, vn)
    assert torch.equal(KV[0, :, :, 0], torch.cat([kn, vn], -1)[:, :, 0])


@pytest.mark.parametrize("batch", [1, 8, 16])
@pytest.mark.parametrize("off", [0, 1, 63, 64, 255, 3000, 4095])
def test_cluster_plan_spans_cover_the_cache_once(off, batch):
    """The decode-attention kernel's cluster split: 1 <= C <= 16, the
    grid (C, Hkv, B) divides by its cluster (C, 1, 1), and the ranks'
    spans hold every position of [0, off) exactly once; a split into
    more than one span keeps every span at least MIN_SPAN long and all
    clusters within one wave of WAVE_CTAS CTAs."""
    for hkv in (4, 12):
        c, span = cluster_plan(off, batch, hkv)
        assert 1 <= c <= MAX_CLUSTER
        assert (c, hkv, batch)[0] % c == 0
        held = [p for r in range(c)
                for p in range(r * span, min((r + 1) * span, off))]
        assert held == list(range(off))
        if c > 1:
            assert off - (c - 1) * span >= 1  # the last rank has a span
            assert span >= MIN_SPAN
            assert c * batch * hkv <= WAVE_CTAS


def _split_merge(q, kn, vn, layer, off, vf, c, span):
    """The kernel's arithmetic, rank by rank, in f32: each span's
    (m, l, acc) over its visible positions (an empty span keeps m =
    -1e30, l = 0, acc = 0), then the ranks merged in order with the self
    term, as rank 0 merges them through distributed shared memory."""
    B, H, _, hd = q.shape
    hkv = kn.shape[1]
    g = H // hkv
    out = torch.empty(B, H, 1, hd)
    scale = float(np.float32(1.0 / hd ** 0.5))
    for b in range(B):
        for h in range(H):
            qs = q[b, h, 0] * scale
            kvh = h // g
            states = []
            for r in range(c):
                lo = max(r * span, int(vf[b]) if vf is not None else 0)
                hi = min((r + 1) * span, off)
                rows = layer[b, kvh, lo:max(lo, hi)]
                s = rows[:, :hd] @ qs
                m = s.max() if len(s) else torch.tensor(-1e30)
                p = torch.exp(s - m)
                states.append((m, p.sum(), p @ rows[:, hd:]))
            s_self = kn[b, kvh, 0] @ qs
            mf = torch.stack([s_self] + [m for m, _, _ in states]).max()
            lf, acc = torch.tensor(0.0), torch.zeros(hd)
            for m, l, a in states:
                w = torch.exp(m - mf)
                lf, acc = lf + l * w, acc + a * w
            ps = torch.exp(s_self - mf)
            out[b, h, 0] = (acc + ps * vn[b, kvh, 0]) / (lf + ps)
    return out


@pytest.mark.parametrize("mask", ["none", "spans", "all"])
@pytest.mark.parametrize("off", [0, 1, 64, 129, 255, 700, 1023])
def test_cluster_split_merge_matches_plain(off, mask):
    """The split-merge arithmetic of the cluster kernel, emulated on the
    CPU with ``cluster_plan``'s spans, equals the plain version in f32:
    empty spans (below ``valid_from``, or every position masked) merge
    with weight 0, and the spans together are the whole cache."""
    B, H, hkv, hd, S = 2, 6, 2, 64, 1024
    rng = np.random.default_rng(off + len(mask))
    KV = _t(_rand(rng, 1, B, hkv, S, 2 * hd))
    q = _t(_rand(rng, B, H, 1, hd))
    kn, vn = _t(_rand(rng, B, hkv, 1, hd)), _t(_rand(rng, B, hkv, 1, hd))
    c, span = cluster_plan(off, 1, hkv)
    vf = {"none": None,
          "spans": torch.tensor([min(off, 2 * span), min(off, span + 1)],
                                dtype=torch.int32),
          "all": torch.full((B,), off, dtype=torch.int32)}[mask]
    got = _split_merge(q, kn, vn, KV[0], off, vf, c, span)
    want, _ = decode_attention_plain(q, kn, vn, KV.clone(), 0, off, vf)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_quantize_array_codes_equal_jax(compute):
    w = _rand(np.random.default_rng(5), 3, 128, 96, scale=0.05)
    jq = jquant.quantize_array(jnp.asarray(w), getattr(jnp, compute))
    tq = quant.quantize_array(_t(w), getattr(torch, compute))
    assert tq.q.dtype == torch.int8
    assert np.array_equal(tq.q.numpy(), np.asarray(jq.q))
    np.testing.assert_allclose(tq.scale.float().numpy(),
                               np.asarray(jq.scale, np.float32), rtol=1e-6)


def test_quantize_params_pads_the_vocab_and_embeds_real_rows():
    rng = np.random.default_rng(6)
    tree = {"wte": _rand(rng, 211, 128, scale=0.05),
            "wpe": _rand(rng, 8, 128)}
    jp = jquant.quantize_params(jax.tree.map(jnp.asarray, tree), jnp.float32)
    tp = quant.quantize_params({k: _t(v) for k, v in tree.items()},
                               torch.float32)
    assert tp["wte"].rows == jp["wte"].rows == 211
    assert tuple(tp["wte"].q.shape) == jp["wte"].q.shape == (2048, 128)
    assert np.array_equal(tp["wte"].q.numpy(), np.asarray(jp["wte"].q))
    ids = np.asarray([[0, 37, 210]])
    np.testing.assert_allclose(
        quant.embed_rows(tp["wte"], _t(ids)).numpy(),
        np.asarray(jquant.embed_rows(jp["wte"], jnp.asarray(ids))), **TOL)


@pytest.mark.parametrize("rows", [1, 8, 16])
def test_quant_matmul_plain_matches_jax_kernel(rows):
    rng = np.random.default_rng(7 + rows)
    x, w = _rand(rng, rows, 256), _rand(rng, 256, 384, scale=0.05)
    jq = jquant.quantize_array(jnp.asarray(w), jnp.float32)
    want = np.asarray(jquant.quant_matmul(jnp.asarray(x), jq,
                                          force_pallas=True))
    tq = quant.quantize_array(_t(w), torch.float32)
    got = quant.quant_matmul(_t(x), tq, kernels=True)   # wrapper -> plain
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("rows", [1, 8, 16])
def test_head_logits_plain_matches_jax_kernel(rows):
    rng = np.random.default_rng(17 + rows)
    h = _rand(rng, 1, rows, 128)
    wte = _rand(rng, 211, 128, scale=0.05)
    jq = jquant.quantize_params({"wte": jnp.asarray(wte)}, jnp.float32)["wte"]
    want = np.asarray(jquant.head_logits(jnp.asarray(h), jq,
                                         force_pallas=True))
    tq = quant.quantize_params({"wte": _t(wte)}, torch.float32)["wte"]
    got = quant.head_logits(_t(h), tq, kernels=True)
    assert got.shape == (1, rows, 211) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_wrappers_check_their_operands():
    x = torch.zeros(2, 128)
    q = torch.zeros(128, 128, dtype=torch.int8)
    # plain version on the CPU: same result as the dequantized matmul
    s = torch.ones(128)
    assert torch.equal(quant.quant_linear(x, q, s),
                       quant.linear_plain(x, q, s))
    with pytest.raises(ValueError, match="single-token"):
        decode_attention(torch.zeros(1, 2, 2, 64), torch.zeros(1, 2, 1, 64),
                         torch.zeros(1, 2, 1, 64),
                         torch.zeros(1, 1, 2, 256, 128), 0, 0)
    with pytest.raises(ValueError, match="offset"):
        decode_attention(torch.zeros(1, 2, 1, 64), torch.zeros(1, 2, 1, 64),
                         torch.zeros(1, 2, 1, 64),
                         torch.zeros(1, 1, 2, 256, 128), 0, 256)
