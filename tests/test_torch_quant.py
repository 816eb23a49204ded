"""The int8 kernels' launch plans and summation orders, on the CPU.

``linear_plan`` and ``head_plan`` give the CUDA kernels (``csrc/quant.cu``)
their grids; the kernels themselves run only on the card
(``tests/test_torch_cuda.py``). Here the plans' rules are held at the
shapes the two served models give the kernels (the linear's eight
projections; the head's padded GPT-2 table and smaller ones), and each
kernel's order of f32 sums is emulated and held against its plain
version and the JAX package's Pallas kernel (interpret mode) at 1e-5:
the linear's 16-row steps per warp, warps in order, cluster ranks in
order, one scale and rounding; the head's 16-code tensor-core steps,
each added into the running sum in turn.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.ops import quant as jquant
from llm_sharding_demo_tpu_torch.ops import quant

# (d, n) of every served projection: llama's untied head, GPT-2's c_fc,
# c_attn, llama's gate/up, the 768-wide q/o/attention c_proj, GPT-2's
# mlp c_proj, llama's down, llama's k/v
SERVED_SHAPES = [(768, 32000), (768, 3072), (768, 2304), (768, 2048),
                 (768, 768), (3072, 768), (2048, 768), (768, 256)]
WARPS = 4  # the kernel's warps per CTA, each taking every fourth step


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("d,n", SERVED_SHAPES)
def test_linear_plan_rules(d, n, rows):
    bn, split = quant.linear_plan(rows, d, n)
    assert bn in quant.LINEAR_TILES
    # the column tiles cover every column once
    assert n % bn == 0
    cols = np.zeros(n, np.int64)
    for c0 in range(0, n, bn):
        cols[c0:c0 + bn] += 1
    assert (cols == 1).all()
    # the ranks cover the contraction once, in whole 16-row steps
    assert 1 <= split <= quant.LINEAR_MAX_SPLIT
    assert d % split == 0 and (d // split) % quant.LINEAR_STEP == 0
    ctas = n // bn * split
    if split > 1:
        assert d // split >= quant.LINEAR_MIN_CHUNK
        assert ctas <= quant.LINEAR_SMS  # one wave
    else:
        assert ctas >= quant.LINEAR_SMS  # the tiles alone fill the card


def test_linear_plan_at_the_served_shapes():
    """The head streams unsplit; every narrower projection is split
    until its grid nears one wave, 768->768 and 768->256 on 64-column
    tiles, which give them more CTAs than 128-column ones."""
    assert {s: quant.linear_plan(1, *s) for s in SERVED_SHAPES} == {
        (768, 32000): (128, 1), (768, 3072): (128, 4),
        (768, 2304): (128, 6), (768, 2048): (128, 8), (768, 768): (64, 8),
        (3072, 768): (128, 16), (2048, 768): (128, 16),
        (768, 256): (64, 12)}


def _kernel_order(x, q, scale, bn, split):
    """``quant_linear``'s sums in the kernel's order, in f32: each rank's
    contraction slice in 16-row steps, warp w taking steps w, w + 4, ...
    and adding them in turn; the warps' partial tiles added in warp
    order, the ranks' in rank order; then the scale and one rounding."""
    rows, d = x.shape
    n = q.shape[1]
    chunk = d // split
    steps = chunk // quant.LINEAR_STEP
    xf, wf = x.float(), q.float()
    y = torch.empty(rows, n)
    for c0 in range(0, n, bn):
        ranks = []
        for r in range(split):
            warps = []
            for w in range(WARPS):
                acc = torch.zeros(rows, bn)
                for s in range(w, steps, WARPS):
                    k = r * chunk + quant.LINEAR_STEP * s
                    acc = acc + (xf[:, k:k + quant.LINEAR_STEP]
                                 @ wf[k:k + quant.LINEAR_STEP, c0:c0 + bn])
                warps.append(acc)
            part = warps[0]
            for a in warps[1:]:
                part = part + a
            ranks.append(part)
        total = ranks[0]
        for p in ranks[1:]:
            total = total + p
        y[:, c0:c0 + bn] = total * scale.float()[c0:c0 + bn]
    return y.to(x.dtype)


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("split", [1, 2, 4, 8])
def test_kernel_order_matches_plain_and_jax(split, rows):
    """The split-and-merge order, f32, equals the plain version and the
    JAX Pallas kernel (interpret mode) at 1e-5, unsplit and split, at
    [rows, 512] x [512, 384]: 8 is the split ``linear_plan`` gives it
    (six 64-column tiles, 64-row slices)."""
    d, n = 512, 384
    bn, planned = quant.linear_plan(rows, d, n)
    assert (bn, planned) == (64, 8)
    rng = np.random.default_rng(rows * 10 + split)
    x = rng.standard_normal((rows, d)).astype(np.float32)
    w = (0.05 * rng.standard_normal((d, n))).astype(np.float32)
    tq = quant.quantize_array(torch.tensor(w), torch.float32)
    got = _kernel_order(torch.tensor(x), tq.q, tq.scale, bn, split)
    np.testing.assert_allclose(
        got.numpy(), quant.linear_plain(torch.tensor(x), tq.q,
                                        tq.scale).numpy(),
        atol=1e-5, rtol=1e-5)
    jq = jquant.quantize_array(jnp.asarray(w), jnp.float32)
    want = np.asarray(jquant.quant_matmul(jnp.asarray(x), jq,
                                          force_pallas=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    """Shape checks run before any launch; on the CPU the wrapper is the
    plain version."""
    x = torch.zeros(2, 40, dtype=torch.bfloat16)
    q = torch.zeros(40, 128, dtype=torch.int8)
    s = torch.ones(128, dtype=torch.bfloat16)
    assert torch.equal(quant.quant_linear(x, q, s),
                       quant.linear_plain(x, q, s))
    with pytest.raises(ValueError, match="unsupported device"):
        quant.quant_linear(x.to("meta"), q.to("meta"), s.to("meta"))


# -- the tied head --------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("d", [128, 768])
@pytest.mark.parametrize("v", [2048, 32768, 51200])
def test_head_plan_rules(v, d, rows):
    """Every m16 tile of the table lies in exactly one CTA's span, the
    spans differ by at most one tile, and the grid is one wave: at most
    ``HEAD_CTAS_PER_SM`` CTAs on each SM (the launch refuses a grid whose
    CTAs are not all resident at once)."""
    ctas, span = quant.head_plan(rows, v, d)
    tiles = v // quant.HEAD_TILE
    assert 1 <= ctas <= quant.HEAD_CTAS_PER_SM * quant.LINEAR_SMS
    assert ctas <= tiles
    covered = np.zeros(tiles, np.int64)
    lengths = []
    for cta in range(ctas):
        lo, hi = quant.head_span(cta, tiles, ctas)
        covered[lo:hi] += 1
        lengths.append(hi - lo)
    assert (covered == 1).all()
    assert max(lengths) - min(lengths) <= 1 and min(lengths) >= 1
    assert span == max(lengths)


def test_head_plan_at_gpt2s_table():
    """GPT-2's 50257 rows pad to 51200: 3200 m16 tiles over two CTAs on
    each of 132 SMs, spans of 12 and 13 tiles (a grid of whole 128-row
    tiles would be 400 CTAs, 3.03 waves of one CTA an SM)."""
    v = quant.round_up_vocab(50257)
    assert v == 51200
    assert quant.head_plan(1, v, 768) == (264, 13)
    spans = {quant.head_span(i, v // 16, 264)[1]
             - quant.head_span(i, v // 16, 264)[0] for i in range(264)}
    assert spans == {12, 13}


def _head_kernel_order(x, q):
    """``quant_head``'s sums in the kernel's order, in f32: for each box
    of 128 codes and each of its eight tensor-core steps j, the 16-term
    product over codes 32t + 4j + e (t, e = 0..3) of the box, added into
    the running sum in turn."""
    rows, d = x.shape
    xf, qf = x.float(), q.float()
    acc = torch.zeros(rows, q.shape[0])
    for kc in range(0, d, quant.HEAD_BOX_K):
        for j in range(8):
            k = torch.tensor([kc + 32 * t + 4 * j + e for t in range(4)
                              for e in range(4)])
            acc = acc + xf[:, k] @ qf[:, k].t()
    return acc


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("d", [128, 384])
def test_head_kernel_order_matches_plain_and_jax(d, rows):
    """The tensor-core steps' order, f32, equals ``head_plain`` and the
    JAX Pallas head (interpret mode, through ``head_logits``) at 1e-5 on
    a 211-row table padded to 2048."""
    rng = np.random.default_rng(rows * 7 + d)
    h = rng.standard_normal((1, rows, d)).astype(np.float32)
    wte = (0.05 * rng.standard_normal((211, d))).astype(np.float32)
    tq = quant.quantize_params({"wte": torch.tensor(wte)},
                               torch.float32)["wte"]
    assert tq.q.shape == (2048, d)
    hs = torch.tensor(h)[0] * tq.scale
    got = _head_kernel_order(hs, tq.q)
    np.testing.assert_allclose(got.numpy(), quant.head_plain(hs, tq.q).numpy(),
                               atol=1e-5, rtol=1e-5)
    jq = jquant.quantize_params({"wte": jnp.asarray(wte)}, jnp.float32)["wte"]
    want = np.asarray(jquant.head_logits(jnp.asarray(h), jq,
                                         force_pallas=True))[0]
    np.testing.assert_allclose(got[:, :211].numpy(), want, atol=1e-5,
                               rtol=1e-5)
