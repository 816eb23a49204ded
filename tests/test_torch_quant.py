"""The int8 linear kernel's launch plan and summation order, on the CPU.

``linear_plan`` gives the CUDA kernel (``csrc/quant.cu``) its grid; the
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here the plan's rules are held at the eight projection shapes the two
served models give the kernel, and the kernel's order of f32 sums
(16-row steps per warp, warps in order, cluster ranks in order, one
scale and rounding) is emulated and held against ``linear_plain`` and
the JAX package's ``_pallas_linear`` (interpret mode) at 1e-5.
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
