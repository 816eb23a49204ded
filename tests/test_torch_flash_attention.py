"""The port's flash attention against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_flash_attention.py does; the port's wrappers run their plain
versions on CPU tensors (the CUDA kernels are held against those plain
versions on the card, tests/test_torch_cuda.py). Inputs and weights are
drawn with numpy from a seed and carried into both packages. Where a
model-level test must reach the kernel at test shapes, both packages'
``FLASH_MIN_SEQ`` is pinned to 0, as the JAX package's own test does.

Tolerances: f32 atol/rtol 2e-5, the JAX tests' own bar (the two sides
sum in different orders). The extreme-score case keeps the JAX test's
rtol 2e-3 against the plain attention (scores near -7200 lose digits in
exp), and holds the port to the JAX kernel at the same bar.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.ops import flash_attention as jfa
from llm_sharding_demo_tpu.runtime.engine import DecodeEngine as JEngine
from llm_sharding_demo_tpu_torch.models import gpt2, llama
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.ops import flash_attention as fa
from llm_sharding_demo_tpu_torch.ops.attention import causal_attention
from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies)

TOL = dict(atol=2e-5, rtol=2e-5)
CASES = [(64, 16, 32), (128, 32, 64), (96, 32, 96), (64, 256, 256),
         (17, 8, 8)]


def _arrays(seed, shape, n):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.tensor(np.asarray(a)) for a in arrays]


@pytest.fixture
def min_seq_zero(monkeypatch):
    """Both packages take the flash path at every length."""
    monkeypatch.setattr(jfa, "FLASH_MIN_SEQ", 0)
    monkeypatch.setattr(fa, "FLASH_MIN_SEQ", 0)


@pytest.mark.parametrize("s,block_q,block_k", CASES)
def test_forward_plain_matches_jax_kernel(s, block_q, block_k):
    """out and lse against ``_forward_kernel`` (interpret mode): several
    tiles, block_q != block_k, one ragged single block (S=17)."""
    q, k, v = _arrays(s, (2, 3, s, 16), 3)
    jout, jlse = jfa._forward_kernel(*map(jnp.asarray, (q, k, v)), block_q,
                                     block_k, True)
    out, lse = fa._forward_plain(*_t(q, k, v), block_q, block_k)
    assert lse.shape == (6, s, 1) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


@pytest.mark.parametrize("s,block_q,block_k", CASES)
def test_backward_plain_matches_jax_kernels(s, block_q, block_k):
    """dq, dk, dv against ``_backward_kernels`` (interpret mode), both fed
    the JAX forward's out and lse."""
    q, k, v, g = _arrays(s + 1, (2, 3, s, 16), 4)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jout, jlse = jfa._forward_kernel(jq, jk, jv, block_q, block_k, True)
    want = jfa._backward_kernels(jq, jk, jv, jout, jlse, jg, block_q,
                                 block_k, True)
    got = fa._backward_plain(*_t(q, k, v, jout, jlse, g), block_q, block_k)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_survives_extreme_negative_scores():
    """All visible scores near -7200 (tests/test_flash_attention.py:98):
    finite, equal to the JAX kernel and to the plain attention."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 2, 128, 64)).astype(np.float32) * 30
    k = -q
    v = rng.normal(size=(1, 2, 128, 64)).astype(np.float32)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), block_q=32,
                               block_k=64, interpret=True)
    got = fa.flash_attention(*_t(q, k, v), block_q=32, block_k=64)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=2e-3)
    ref = causal_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5,
                               rtol=2e-3)


def test_function_grads_match_autograd_through_causal_attention():
    """The autograd Function (forward plain version, D, the two backward
    plain versions) against autograd through the plain causal attention,
    and against the JAX custom VJP."""
    q, k, v, g = _arrays(3, (1, 2, 64, 16), 4)
    leaves = [x.requires_grad_() for x in _t(q, k, v)]
    out = fa.flash_attention(*leaves, 16, 32)
    grads = torch.autograd.grad(out, leaves, torch.tensor(g))
    ref = [x.requires_grad_() for x in _t(q, k, v)]
    ref_grads = torch.autograd.grad(causal_attention(*ref), ref,
                                    torch.tensor(g))
    _, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(
        a, b, c, block_q=16, block_k=32, interpret=True),
        *map(jnp.asarray, (q, k, v)))
    jax_grads = vjp(jnp.asarray(g))
    for a, b, c in zip(grads, ref_grads, jax_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **TOL)


def test_without_grad_only_the_forward_runs():
    q, k, v = _t(*_arrays(4, (1, 2, 32, 16), 3))
    with torch.no_grad():
        out = fa.flash_attention(q, k, v)
    assert not out.requires_grad
    torch.testing.assert_close(out, fa._forward_plain(q, k, v)[0], rtol=0,
                               atol=0)


def test_kernel_operand_checks():
    """What the CUDA wrappers validate before a launch (the checks run
    on any tensor)."""
    q = torch.zeros(1, 2, 32, 64)
    lse = torch.zeros(2, 32, 1)
    assert fa._cuda_operands(q, q, q, q, stats=(lse, lse))[:3] == (2, 32, 64)
    with pytest.raises(ValueError, match="head_dim"):
        fa._cuda_operands(*[torch.zeros(1, 2, 32, 16)] * 3)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 32, 2, 64).transpose(1, 2)
        fa._cuda_operands(t, t, t)
    with pytest.raises(ValueError, match="dtype"):
        fa._cuda_operands(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="row statistics"):
        fa._cuda_operands(q, q, q, q, stats=(torch.zeros(2, 32), lse))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        h = q.half()
        fa._cuda_operands(h, h, h)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        fa.flash_forward(q, q, torch.zeros(1, 2, 32, 64, device="meta"))
    with pytest.raises(ValueError, match="shapes"):
        fa.flash_attention(q, q[:, :1], q)


@pytest.mark.parametrize("bh,s", [(48, 2048), (12, 2048), (48, 4096),
                                  (12, 4096), (24, 333), (1, 333)])
def test_dkv_plan_covers_every_tile_once_heaviest_first(bh, s):
    """bf16 dK/dV's work list (``dkv_plan``, the kernel's ``dkv_tile``):
    every (key block, head) tile exactly once, on at most 132 CTAs; the
    list runs heaviest first, each CTA takes one position a round, and
    the walk back and forth keeps the CTAs' q-tile sums within one
    heaviest tile of each other."""
    sms = 132
    plan = fa.dkv_plan(bh, s, sms)
    n_kt = -(-s // fa.DKV_KEYS)
    assert len(plan) == min(n_kt * bh, sms)
    tiles = [tile for cta in plan for tile in cta]
    assert sorted(tiles) == [(kt, h) for kt in range(n_kt)
                             for h in range(bh)]
    costs = [fa.dkv_tile_cost(s, kt) for kt in range(n_kt)]
    assert costs == sorted(costs, reverse=True) and costs[-1] >= 1
    for c, cta in enumerate(plan):
        positions = [kt * bh + h for kt, h in cta]
        assert [p // len(plan) for p in positions] == list(range(len(cta)))
        assert all(p % len(plan) == (c if n % 2 == 0 else len(plan) - 1 - c)
                   for n, p in enumerate(positions))
    loads = [sum(costs[kt] for kt, _ in cta) for cta in plan]
    assert max(loads) - min(loads) <= costs[0]


def _emulate_dkv_bf16(q, k, v, do, lse, delta, round_bf16):
    """bf16 dK/dV's tiling in f32 on the CPU, on flat ``[BH, S, 64]``
    operands: each 128-key block split into two warpgroups of 64 keys,
    q tiles of 64 rows from the key block's diagonal to S, a q tile wholly
    before a warpgroup's keys skipped, the mask only on q tiles that
    cross its diagonal or S, P^T in exp2 with the scale folded in, and
    (with ``round_bf16``) P^T and dS^T rounded to bf16 before their
    products."""
    bh, s, hd = q.shape
    scale, log2e = 1.0 / hd ** 0.5, 1.4426950408889634
    rnd = ((lambda x: x.to(torch.bfloat16).float()) if round_bf16
           else (lambda x: x))

    def rows(x, r0, n=64):  # rows past S load as zeros
        out = torch.zeros(bh, n, x.shape[-1])
        part = x[:, r0:r0 + n]
        out[:, :part.shape[1]] = part
        return out

    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for kt in range(-(-s // fa.DKV_KEYS)):
        for cw in range(2):
            kb = kt * fa.DKV_KEYS + 64 * cw
            if kb >= s:
                continue
            kk, vv = rows(k, kb), rows(v, kb)
            key = kb + torch.arange(64)[:, None]
            acc_k, acc_v = torch.zeros(bh, 64, hd), torch.zeros(bh, 64, hd)
            for qi in range(2 * kt, -(-s // fa.DKV_QUERIES)):
                q0 = qi * fa.DKV_QUERIES
                if q0 + 64 <= kb:
                    continue
                qt, dot = rows(q, q0), rows(do, q0)
                ls, dd = rows(lse, q0).transpose(1, 2), rows(delta, q0)
                p = torch.exp2(kk @ qt.transpose(1, 2) * (scale * log2e)
                               - ls * log2e)
                if q0 < kb + 64 or q0 + 64 > s:
                    i = q0 + torch.arange(64)[None, :]
                    p = torch.where((key <= i) & (i < s), p,
                                    torch.zeros_like(p))
                acc_v += rnd(p) @ dot
                ds = p * (vv @ dot.transpose(1, 2) - dd.transpose(1, 2))
                acc_k += rnd(ds) @ qt
            n = min(64, s - kb)
            dk[:, kb:kb + n] = (acc_k * scale)[:, :n]
            dv[:, kb:kb + n] = acc_v[:, :n]
    return dk, dv


@pytest.mark.parametrize("round_bf16", [False, True])
@pytest.mark.parametrize("s", [100, 333, 512])
def test_dkv_tiling_emulated_matches_jax_kernel(s, round_bf16):
    """bf16 dK/dV's tiles, skips and edge-only masks, emulated on the CPU,
    against the JAX ``_backward_kernels`` (interpret mode): equal at the
    f32 bar without the bf16 roundings, and within the bf16 kernels'
    ``FLASH_POLICY`` with them. S = 100 leaves the second warpgroup of the
    only key block partly past S; 333 ends inside a q tile."""
    from llm_sharding_demo_tpu_torch.utils import graftnum
    q, k, v, g = _arrays(s + 7, (1, 2, s, 64), 4)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jout, jlse = jfa._forward_kernel(jq, jk, jv, 512, 1024, True)
    _, jdk, jdv = jfa._backward_kernels(jq, jk, jv, jout, jlse, jg, 512,
                                        1024, True)
    flat = [torch.tensor(x).reshape(2, s, 64) for x in (q, k, v, g)]
    delta = fa.flash_delta(*_t(jout, g))
    dk, dv = _emulate_dkv_bf16(*flat, torch.tensor(np.asarray(jlse)), delta,
                               round_bf16)
    for name, got, want in (("dk", dk, jdk), ("dv", dv, jdv)):
        want = torch.tensor(np.asarray(want)).reshape(2, s, 64)
        if round_bf16:
            graftnum.compare_flash(name, got, want, torch.bfloat16)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("bh,s", [(48, 2048), (12, 2048), (48, 4096),
                                  (12, 4096), (24, 333), (1, 333)])
def test_dq_plan_covers_every_tile_once_heaviest_first(bh, s):
    """bf16 dQ's work list (``dq_plan``, the kernel's ``dkv_tile`` walk):
    every (q block, head) tile exactly once, on at most 132 CTAs; the list
    runs heaviest first (q blocks from the last), each CTA takes one
    position a round, and the CTAs' k-tile sums lie within one heaviest
    tile of each other."""
    sms = 132
    plan = fa.dq_plan(bh, s, sms)
    nq = -(-s // fa.DQ_ROWS)
    assert len(plan) == min(nq * bh, sms)
    tiles = [tile for cta in plan for tile in cta]
    assert sorted(tiles) == [(qb, h) for qb in range(nq) for h in range(bh)]
    costs = [fa.dq_tile_cost(s, nq - 1 - t // bh) for t in range(nq * bh)]
    assert costs == sorted(costs, reverse=True) and costs[-1] >= 1
    assert costs[0] == -(-s // fa.DQ_KEYS)  # the last block reaches S
    for c, cta in enumerate(plan):
        positions = [(nq - 1 - qb) * bh + h for qb, h in cta]
        assert [p // len(plan) for p in positions] == list(range(len(cta)))
        assert all(p % len(plan) == (c if n % 2 == 0 else len(plan) - 1 - c)
                   for n, p in enumerate(positions))
    loads = [sum(fa.dq_tile_cost(s, qb) for qb, _ in cta) for cta in plan]
    assert max(loads) - min(loads) <= costs[0]


def _emulate_dq_bf16(q, k, v, do, lse, delta, round_bf16):
    """bf16 dQ's tiling in f32 on the CPU, on flat ``[BH, S, 64]``
    operands: each 128-row q block split into two warpgroups of 64 rows,
    k tiles of 64 keys up to the warpgroup's diagonal and none wholly past
    S (the first warpgroup skips the block's last k tile), the mask only
    on the k tile that crosses the diagonal, P in exp2 with the scale
    folded in, and (with ``round_bf16``) dS rounded to bf16 before its
    product."""
    bh, s, hd = q.shape
    scale, log2e = 1.0 / hd ** 0.5, 1.4426950408889634
    rnd = ((lambda x: x.to(torch.bfloat16).float()) if round_bf16
           else (lambda x: x))

    def rows(x, r0, n=64):  # rows past S load as zeros
        out = torch.zeros(bh, n, x.shape[-1])
        part = x[:, r0:r0 + n]
        out[:, :part.shape[1]] = part
        return out

    dq = torch.zeros_like(q)
    for qb in range(-(-s // fa.DQ_ROWS)):
        n_k = fa.dq_tile_cost(s, qb)
        for cw in range(2):
            q0 = qb * fa.DQ_ROWS + 64 * cw
            if q0 >= s:
                continue
            qq, dd, dot = rows(q, q0), rows(delta, q0), rows(do, q0)
            ls = rows(lse, q0)
            row = q0 + torch.arange(64)[:, None]
            diag = 2 * qb + cw
            acc = torch.zeros(bh, 64, hd)
            for kt in range(min(diag, n_k - 1) + 1):
                kk, vv = rows(k, kt * fa.DQ_KEYS), rows(v, kt * fa.DQ_KEYS)
                p = torch.exp2(qq @ kk.transpose(1, 2) * (scale * log2e)
                               - ls * log2e)
                if kt == diag:
                    col = kt * fa.DQ_KEYS + torch.arange(64)[None, :]
                    p = torch.where(col <= row, p, torch.zeros_like(p))
                ds = p * (dot @ vv.transpose(1, 2) - dd)
                acc += rnd(ds) @ kk
            n = min(64, s - q0)
            dq[:, q0:q0 + n] = (acc * scale)[:, :n]
    return dq


@pytest.mark.parametrize("round_bf16", [False, True])
@pytest.mark.parametrize("s", [100, 300, 333, 512])
def test_dq_tiling_emulated_matches_jax_kernel(s, round_bf16):
    """bf16 dQ's tiles, skipped tile and diagonal-only mask, emulated on
    the CPU, against the JAX ``_backward_kernels`` (interpret mode): equal
    at the f32 bar without the bf16 rounding, and within the bf16
    kernels' ``FLASH_POLICY`` with it. S = 100 leaves the second
    warpgroup of the only q block partly past S; at 300 the last block's
    second warpgroup lies wholly past S and its last k tile is never
    streamed; 333 ends inside a k tile."""
    from llm_sharding_demo_tpu_torch.utils import graftnum
    q, k, v, g = _arrays(s + 11, (1, 2, s, 64), 4)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    jout, jlse = jfa._forward_kernel(jq, jk, jv, 512, 1024, True)
    jdq, _, _ = jfa._backward_kernels(jq, jk, jv, jout, jlse, jg, 512,
                                      1024, True)
    flat = [torch.tensor(x).reshape(2, s, 64) for x in (q, k, v, g)]
    delta = fa.flash_delta(*_t(jout, g))
    dq = _emulate_dq_bf16(*flat, torch.tensor(np.asarray(jlse)), delta,
                          round_bf16)
    want = torch.tensor(np.asarray(jdq)).reshape(2, s, 64)
    if round_bf16:
        graftnum.compare_flash("dq", dq, want, torch.bfloat16)
    else:
        np.testing.assert_allclose(dq.numpy(), want.numpy(), **TOL)


def test_gates_match_jax():
    for s in (1, 17, 1024, 1025, 2048, 2049, 4096, 4224):
        assert fa.flash_eligible(s) == jfa.flash_eligible(s)
        assert fa.flash_profitable(s) == jfa.flash_profitable(s)
        assert fa._pick_block(s, 512) == jfa._pick_block(s, 512)


# -- models ---------------------------------------------------------------------

GPT2_DIMS = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2,
                 n_head=4)
LLAMA_DIMS = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2,
                  n_head=4, n_kv_head=2, intermediate_size=64)


def _family(name, impl="xla"):
    """``(jax config, port config, jax params, port params)``."""
    if name == "gpt2":
        jcfg = jgpt2.GPT2Config(**GPT2_DIMS, attention_impl=impl)
        cfg = gpt2.GPT2Config(**GPT2_DIMS, attention_impl=impl)
        jp = jgpt2.init_params(jcfg, jax.random.PRNGKey(0))
    else:
        jcfg = jllama.LlamaConfig(**LLAMA_DIMS, attention_impl=impl)
        cfg = llama.LlamaConfig(**LLAMA_DIMS, attention_impl=impl)
        jp = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_model_forward_pallas_matches_jax(min_seq_zero, monkeypatch, family):
    """attention_impl="pallas" forwards (llama: kv heads repeated in HF
    order before the kernel) against the JAX package's, and against the
    port's plain attention; the flash path is taken once per layer."""
    jcfg, cfg, jp, tp = _family(family, "pallas")
    model, jmodel = (gpt2, jgpt2) if family == "gpt2" else (llama, jllama)
    calls = []
    real = fa.flash_attention
    monkeypatch.setattr(fa, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    ids = np.random.default_rng(1).integers(0, 97, size=(2, 13))
    want = jmodel.forward(jp, jnp.asarray(ids), jcfg)
    got = model.forward(tp, torch.tensor(ids), cfg)
    assert len(calls) == cfg.n_layer
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = model.forward(tp, torch.tensor(ids),
                          dataclasses.replace(cfg, attention_impl="xla"))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_below_the_crossover_pallas_takes_the_plain_attention(monkeypatch):
    """At S < FLASH_MIN_SEQ "pallas" dispatches to the plain attention,
    as the JAX package does."""
    _, cfg, _, tp = _family("llama", "pallas")
    monkeypatch.setattr(fa, "flash_attention", None)  # never reached
    ids = torch.tensor(np.random.default_rng(2).integers(0, 97, (1, 9)))
    llama.forward(tp, ids, cfg)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_remat_gives_the_same_grads(min_seq_zero, family):
    """remat recomputes each block (the flash forward included) in the
    backward pass: the gradients do not change."""
    _, cfg, _, tp = _family(family, "pallas")
    model = gpt2 if family == "gpt2" else llama
    ids = torch.tensor(np.random.default_rng(3).integers(0, 97, (2, 12)))
    leaves = list(_items(tp))

    def grads(remat):
        params = {}
        tensors = []
        for path, x in leaves:
            t = x.clone().requires_grad_()
            tensors.append(t)
            node = params
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t
        loss = model.forward(params, ids, cfg, remat=remat).square().mean()
        return torch.autograd.grad(loss, tensors)

    for a, b in zip(grads(True), grads(False)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _items(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, path + (k,))
    else:
        yield path, tree


# -- the engine's flash prefill -----------------------------------------------------

@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_flash_prefill_engine_matches_jax(min_seq_zero, monkeypatch, family):
    """A fresh-cache prefill through the flash path (the cache at kv-head
    width): greedy tokens equal to the JAX engine's with
    attention_impl="pallas" (test_flash_attention.py:117)."""
    jcfg, cfg, jp, tp = _family(family, "pallas")
    model = gpt2 if family == "gpt2" else llama
    calls = []
    real = model.flash_attention
    monkeypatch.setattr(model, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    prompt = (np.arange(17, dtype=np.int32) * 3) % cfg.vocab_size
    want = JEngine(jp, jcfg, max_seq=48).generate(prompt, 8)
    eng = DecodeEngine(tp, cfg, max_seq=48, device="cpu")
    got = eng.generate(prompt, 8)
    assert len(calls) == cfg.n_layer
    np.testing.assert_array_equal(got.tokens, want.tokens)
    plain = DecodeEngine(tp, dataclasses.replace(cfg, attention_impl="xla"),
                         max_seq=48, device="cpu").generate(prompt, 8)
    np.testing.assert_array_equal(got.tokens, plain.tokens)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_flash_prefill_on_the_fused_cache(min_seq_zero, family):
    """The kernel engine's fused cache: the flash prefill writes the rows
    the decode steps read; tokens equal to the plain engine's."""
    if family == "gpt2":
        cfg = gpt2.GPT2Config(vocab_size=211, n_positions=512, n_embd=128,
                              n_layer=2, n_head=2, attention_impl="pallas")
        params = gpt2.init_params(cfg, torch.Generator().manual_seed(0),
                                  std=0.04)
    else:
        cfg = llama.LlamaConfig(vocab_size=211, n_positions=512, n_embd=256,
                                n_layer=2, n_head=4, n_kv_head=2,
                                intermediate_size=256,
                                attention_impl="pallas")
        params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   std=0.08)
    prompt = np.asarray([[5, 9, 2, 77, 30, 8, 1]])
    eng = DecodeEngine(params, cfg, max_seq=300, decode_kernel="layer",
                       device="cpu")
    assert eng._flash_prefill(prompt.shape[1], None)
    plain = DecodeEngine(params, dataclasses.replace(cfg, attention_impl="xla"),
                         max_seq=300, decode_kernel="layer", device="cpu")
    np.testing.assert_array_equal(eng.generate(prompt, 12).tokens,
                                  plain.generate(prompt, 12).tokens)


def test_flash_prefill_gate(min_seq_zero):
    """The gate of JAX engine.py:820-842: "pallas", no pad, more than one
    token, the unstaged engine, a length the kernel tiles."""
    _, cfg, _, tp = _family("llama", "pallas")
    eng = DecodeEngine(tp, cfg, max_seq=48, device="cpu")
    assert eng._flash_prefill(17, None)
    assert not eng._flash_prefill(1, None)
    assert not eng._flash_prefill(17, torch.zeros(1, dtype=torch.int32))
    staged = DecodeEngine(tp, cfg, max_seq=48, boundaries=[1], device="cpu")
    assert not staged._flash_prefill(17, None)
    xla = DecodeEngine(tp, dataclasses.replace(cfg, attention_impl="xla"),
                       max_seq=48, device="cpu")
    assert not xla._flash_prefill(17, None)
    # a ragged long prompt the kernel would not tile (flash_eligible)
    assert not eng._flash_prefill(2049, None)


def test_attention_impl_refusals():
    for config_cls in (gpt2.GPT2Config, llama.LlamaConfig):
        assert config_cls(attention_impl="pallas").attention_impl == "pallas"
        # ring attention is ported: the config takes it (its forward
        # needs a mesh, tests/test_torch_ring_attention.py)
        assert config_cls(attention_impl="ring").attention_impl == "ring"
        with pytest.raises(ValueError, match="attention_impl"):
            config_cls(attention_impl="cuda")
