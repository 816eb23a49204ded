"""The port's tensor- and expert-parallel decode (``DecodeEngine(mesh=)``)
on gloo ranks against the JAX package's mesh engines.

One module-scoped group of two spawned CPU ranks runs every port case
(``torch_mesh_ranks``: the children import only torch and the port);
the JAX reference runs here on two of its forced host devices. Weights
come from numpy: GPT-2 with 2 layers, n_embd 128 and head_dim 64 (one
head a rank), llama with n_embd 256 and 4 query heads over 2 kv heads,
GPT-2-MoE with 4 experts, top-2. The serving knobs are
``test_torch_mesh_serving.py``'s.

Tolerances: fp32 greedy streams byte-equal to the JAX mesh engines' and
to the port's single-rank engine's; prompt logits within 1e-5 of the JAX
forward's, and bit-equal across the ranks; bf16 and int8 teacher-forced
logits inside their ``graftnum`` budgets; a sampled stream pinned by
seed replay within the port, its ``sampler_pmf`` within 1e-6 of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.models import moe as jmoe
from llm_sharding_demo_tpu.ops import quant as jquant
from llm_sharding_demo_tpu.parallel.spmd import make_mesh as jmake_mesh
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu_torch.runtime.engine import (SamplingConfig,
                                                        sampler_pmf)
from llm_sharding_demo_tpu_torch.utils import graftnum
from test_torch_llama import np_llama_params
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params,
                              np_moe_params)
from torch_mesh_ranks import RankGroup

DIMS = dict(vocab_size=211, n_positions=128, n_embd=128, n_layer=2,
            n_head=2)
LDIMS = dict(vocab_size=211, n_positions=128, n_embd=256, n_layer=2,
             n_head=4, n_kv_head=2, intermediate_size=384)
MDIMS = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
             n_head=2, n_experts=4, expert_top_k=2)
MAX_SEQ = 64
PROMPT = [[5, 9, 2, 77, 30]]
RAGGED = [[5, 9, 2, 77, 30], [42, 3]]
ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(2)
    yield group
    group.close()


@pytest.fixture(scope="module")
def gpt2_np():
    return np_gpt2_params(seed=7, dims=DIMS)


def jmodel(family, np_params, dims):
    cls = {"gpt2": jgpt2.GPT2Config, "llama": jllama.LlamaConfig,
           "moe": jmoe.MoEConfig}[family]
    return cls(**dims), jax.tree.map(jnp.asarray, np_params)


def jax_mesh_tokens(family, np_params, dims, axis, prompts, steps,
                    **kw):
    jcfg, jp = jmodel(family, np_params, dims)
    eng = jengine.DecodeEngine(jp, jcfg, max_seq=MAX_SEQ,
                               mesh=jmake_mesh({axis: 2}, jax.devices()[:2]),
                               **kw)
    return eng.generate(prompts, steps)


def jax_logits(family, np_params, dims, ids):
    jcfg, jp = jmodel(family, np_params, dims)
    if family == "moe":
        return np.asarray(jmoe.forward(jp, jnp.asarray(ids), jcfg)[0])
    fwd = jllama.forward if family == "llama" else jgpt2.forward
    return np.asarray(fwd(jp, jnp.asarray(ids), jcfg))


def mesh_run(ranks, family, np_params, dims, axis, prompts, steps, **kw):
    return ranks.run("mesh_generate", family=family, cfg_kw=dims,
                     np_params=np_params, max_seq=MAX_SEQ, prompts=prompts,
                     steps=steps, axis=axis, **kw)


def check_streams_and_logits(out, jax_tokens, jlogits):
    got = out[0]["run"]["tokens"]
    np.testing.assert_array_equal(got, jax_tokens)
    np.testing.assert_array_equal(got, out[0]["single"]["tokens"])
    # every rank computes the same logits: the sums are the group's
    np.testing.assert_array_equal(out[0]["logits"], out[1]["logits"])
    np.testing.assert_allclose(out[0]["logits"], jlogits, atol=ATOL,
                               rtol=RTOL)
    assert out[1]["served"] == 1


def test_tp_decode_matches_single_device_gpt2(ranks, gpt2_np):
    out = mesh_run(ranks, "gpt2", gpt2_np, DIMS, "tp", PROMPT, 20,
                   logit_ids=PROMPT)
    assert (out[0]["mode"], out[0]["decode_kernel"]) == ("tp", "xla")
    check_streams_and_logits(
        out, jax_mesh_tokens("gpt2", gpt2_np, DIMS, "tp", np.asarray(PROMPT),
                             20).tokens,
        jax_logits("gpt2", gpt2_np, DIMS, PROMPT))


def test_tp_decode_ragged_batch_matches_single_device(ranks, gpt2_np):
    out = mesh_run(ranks, "gpt2", gpt2_np, DIMS, "tp", RAGGED, 12)
    np.testing.assert_array_equal(out[0]["run"]["pad"], [0, 3])
    np.testing.assert_array_equal(out[0]["run"]["tokens"],
                                  out[0]["single"]["tokens"])
    np.testing.assert_array_equal(
        out[0]["run"]["tokens"],
        jax_mesh_tokens("gpt2", gpt2_np, DIMS, "tp", RAGGED, 12).tokens)


def test_tp_decode_matches_single_device_llama_gqa(ranks):
    """llama GQA: each rank attends over 2 query heads and their one kv
    head."""
    np_params = np_llama_params(seed=8, dims=LDIMS)
    out = mesh_run(ranks, "llama", np_params, LDIMS, "tp", PROMPT, 20,
                   logit_ids=PROMPT)
    check_streams_and_logits(
        out, jax_mesh_tokens("llama", np_params, LDIMS, "tp",
                             np.asarray(PROMPT), 20).tokens,
        jax_logits("llama", np_params, LDIMS, PROMPT))


def test_tp_decode_sampled_stream_matches_single_device(ranks, gpt2_np):
    """Rank 0 draws with the request's generator and broadcasts: the
    seeded tp stream is the single-rank engine's, and its pmf JAX's."""
    s = {"mode": "sample", "temperature": 0.6, "top_k": 40}
    out = mesh_run(ranks, "gpt2", gpt2_np, DIMS, "tp", PROMPT, 16,
                   sampling=s, seed=123, logit_ids=PROMPT)
    np.testing.assert_array_equal(out[0]["run"]["tokens"],
                                  out[0]["single"]["tokens"])
    probs, idx = sampler_pmf(torch.tensor(out[0]["logits"][:, -1]),
                             SamplingConfig(**s))
    jprobs, jidx = jengine.sampler_pmf(
        jnp.asarray(jax_logits("gpt2", gpt2_np, DIMS, PROMPT)[:, -1]),
        jengine.SamplingConfig(mode="sample", temperature=0.6, top_k=40))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)


def test_tp_decode_composes_with_chunked_prefill(ranks, gpt2_np):
    prompt = (np.arange(23).reshape(1, 23) % 211).tolist()
    out = mesh_run(ranks, "gpt2", gpt2_np, DIMS, "tp", prompt, 12,
                   prefill_chunk=8)
    got = out[0]["run"]
    np.testing.assert_array_equal(got["tokens"], out[0]["single"]["tokens"])
    jres = jax_mesh_tokens("gpt2", gpt2_np, DIMS, "tp", np.asarray(prompt),
                           12, prefill_chunk=8)
    assert got["pad"][0] == 1            # 23 tokens align to 3 chunks of 8
    np.testing.assert_array_equal(got["tokens"][0, 1:], jres.row_tokens(0))


def _jax_error(family, np_params, dims, mesh_shape, **kw):
    jcfg, jp = jmodel(family, np_params, dims)
    n = int(np.prod(list(mesh_shape.values())))
    with pytest.raises((ValueError, NotImplementedError)) as e:
        jengine.DecodeEngine(jp, jcfg, max_seq=32,
                             mesh=jmake_mesh(mesh_shape, jax.devices()[:n]),
                             **kw)
    return f"{type(e.value).__name__}: {e.value}"


def test_tp_decode_validation(ranks, gpt2_np):
    """Every refusal of the tp engine carries the JAX engine's message:
    no tp axis, a tp size that splits a head (n_head, and llama's
    n_kv_head), int8, stages, an explicit kernel mode."""
    g3 = dict(DIMS, n_embd=192, n_head=3)
    l1 = dict(LDIMS, n_kv_head=1)
    cases = [
        ("gpt2", gpt2_np, DIMS, {"dp": 2}, {}),
        ("gpt2", np_gpt2_params(seed=1, dims=g3), g3, {"tp": 2}, {}),
        ("llama", np_llama_params(seed=1, dims=l1), l1, {"tp": 2}, {}),
        ("gpt2", gpt2_np, DIMS, {"tp": 2}, {"dtype": "int8"}),
        ("gpt2", gpt2_np, DIMS, {"tp": 2}, {"boundaries": [1]}),
        ("gpt2", gpt2_np, DIMS, {"tp": 2}, {"decode_kernel": "layer"}),
    ]
    for family, params, dims, shape, kw in cases:
        got = ranks.run("engine_error", family=family, cfg_kw=dims,
                        np_params=params, axis="tp", mesh_shape=shape, **kw)
        want = _jax_error(family, params, dims, shape, **kw)
        assert got == [want, want], (shape, kw)


def test_tp_split_takes_per_head_qkv_columns(ranks, gpt2_np):
    """Rank r holds head r's q, k and v columns of the fused c_attn (and
    their bias entries), its MLP columns, and the matching rows of both
    row-parallel kernels; a contiguous-thirds split of c_attn, the GSPMD
    layout, gives logits far outside the tolerance."""
    d, hd = DIMS["n_embd"], DIMS["n_embd"] // DIMS["n_head"]
    leaves = ranks.run("shard_leaves", family="gpt2", cfg_kw=DIMS,
                       np_params=gpt2_np, axis="tp")
    attn = gpt2_np["blocks"]["attn"]
    mlp = gpt2_np["blocks"]["mlp"]
    for r, local in enumerate(leaves):
        cols = np.concatenate([np.arange(p * d + r * hd, p * d + (r + 1) * hd)
                               for p in range(3)])
        np.testing.assert_array_equal(
            local["blocks.attn.c_attn.kernel"],
            attn["c_attn"]["kernel"][:, :, cols])
        np.testing.assert_array_equal(local["blocks.attn.c_attn.bias"],
                                      attn["c_attn"]["bias"][:, cols])
        np.testing.assert_array_equal(
            local["blocks.attn.c_proj.kernel"],
            attn["c_proj"]["kernel"][:, r * hd:(r + 1) * hd])
        np.testing.assert_array_equal(local["blocks.attn.c_proj.bias"],
                                      attn["c_proj"]["bias"])
        f = 4 * d // 2
        np.testing.assert_array_equal(
            local["blocks.mlp.c_fc.kernel"],
            mlp["c_fc"]["kernel"][:, :, r * f:(r + 1) * f])
        np.testing.assert_array_equal(
            local["blocks.mlp.c_proj.kernel"],
            mlp["c_proj"]["kernel"][:, r * f:(r + 1) * f])
        np.testing.assert_array_equal(local["wte"], gpt2_np["wte"])
    wrong = mesh_run(ranks, "gpt2", gpt2_np, DIMS, "tp", PROMPT, 2,
                     layout="contiguous", logit_ids=PROMPT)
    err = np.abs(wrong[0]["logits"]
                 - jax_logits("gpt2", gpt2_np, DIMS, PROMPT)).max()
    assert err > 1e3 * ATOL, err


_jfwd = jax.jit(jgpt2.forward_with_cache, static_argnames=("config",))


def _jax_tf(jcfg, jp, prompt, forced, regime, fwd=_jfwd):
    """The JAX engine's cached path, teacher-forced, on ``regime``."""
    if regime == "int8":
        jp, dt = jquant.quantize_params(jp, jnp.bfloat16), jnp.bfloat16
    elif regime == "bfloat16":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
        dt = jnp.bfloat16
    else:
        dt = jnp.float32
    cache = jgpt2.make_cache(jcfg, 1, MAX_SEQ, dt)
    logits, cache = fwd(jp, jnp.asarray([prompt]), config=jcfg, cache=cache)
    rows = [logits[0, -1]]
    for tok in forced[:-1]:
        logits, cache = fwd(jp, jnp.asarray([[tok]]), config=jcfg,
                            cache=cache)
        rows.append(logits[0, -1])
    return torch.tensor(np.asarray(jnp.stack(rows), np.float32))


def test_tp_bf16_within_budget(ranks):
    """bf16 tp decode, teacher-forced, inside ``decode.bf16`` of the JAX
    engine's bf16 and fp32 logits (weights at the init std: the budgets
    are in logit units)."""
    np_small = np_gpt2_params(seed=5, std=0.02, dims=DIMS)
    jcfg, jp = jmodel("gpt2", np_small, DIMS)
    rng = np.random.default_rng(13)
    prompt = rng.integers(0, 211, 6).tolist()
    forced = rng.integers(0, 211, 24).tolist()
    tf = ranks.run("teacher_forced", kind="tp", family="gpt2", cfg_kw=DIMS,
                   np_params=np_small, max_seq=MAX_SEQ, prompt=prompt,
                   forced=forced, dtype="bfloat16")
    np.testing.assert_array_equal(tf[0], tf[1])
    for ref in ("bfloat16", "float32"):
        graftnum.compare("decode.bf16", torch.tensor(tf[0]),
                         _jax_tf(jcfg, jp, prompt, forced, ref))


@pytest.fixture(scope="module")
def moe_np():
    return np_moe_params(2, 0.04, MDIMS)


def test_ep_sharded_decode_matches_single_device(ranks, moe_np):
    """Expert-parallel MoE decode (two experts a rank, the dense
    dispatch): streams byte-equal to the JAX ep engine and the
    single-rank engine, prompt logits within 1e-5 of the JAX forward's
    (capacity binding over the prompt alike)."""
    out = mesh_run(ranks, "moe", moe_np, MDIMS, "ep", PROMPT, 20,
                   logit_ids=RAGGED[:1] + [[7, 8, 9, 10, 11]])
    assert out[0]["mode"] == "ep"
    check_streams_and_logits(
        out, jax_mesh_tokens("moe", moe_np, MDIMS, "ep", np.asarray(PROMPT),
                             20).tokens,
        jax_logits("moe", moe_np, MDIMS, RAGGED[:1] + [[7, 8, 9, 10, 11]]))
    leaves = ranks.run("shard_leaves", family="moe", cfg_kw=MDIMS,
                       np_params=moe_np, axis="ep")
    experts = moe_np["blocks"]["moe"]["experts"]
    for r, local in enumerate(leaves):
        np.testing.assert_array_equal(
            local["blocks.moe.experts.c_fc.kernel"],
            experts["c_fc"]["kernel"][:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            local["blocks.moe.router.kernel"],
            moe_np["blocks"]["moe"]["router"]["kernel"])


def test_ep_ragged_batch_matches_single_device(ranks, moe_np):
    out = mesh_run(ranks, "moe", moe_np, MDIMS, "ep", RAGGED, 10)
    np.testing.assert_array_equal(out[0]["run"]["tokens"],
                                  out[0]["single"]["tokens"])
    np.testing.assert_array_equal(
        out[0]["run"]["tokens"],
        jax_mesh_tokens("moe", moe_np, MDIMS, "ep", RAGGED, 10).tokens)


def test_ep_int8_runs_the_matmul_kernels_and_matches(ranks, moe_np):
    """int8 ep decode takes the int8 linear and head (the "matmul" mode)
    and equals the single-rank int8 engine on that path."""
    out = mesh_run(ranks, "moe", moe_np, MDIMS, "ep", RAGGED, 10,
                   dtype="int8",
                   kwargs={"decode_kernel": "xla", "matmul_kernels": True})
    assert out[0]["model_kernel"] == "matmul"
    np.testing.assert_array_equal(out[0]["run"]["tokens"],
                                  out[0]["single"]["tokens"])


def test_ep_mesh_rejects_dense_families_and_bad_splits(ranks, gpt2_np):
    """A dense family under an ep-only mesh asks for a tp axis, and
    experts that do not split over the axis refuse, with the JAX
    engine's messages."""
    got = ranks.run("engine_error", family="gpt2", cfg_kw=DIMS,
                    np_params=gpt2_np, axis="ep")
    assert got[0] == _jax_error("gpt2", gpt2_np, DIMS, {"ep": 2})
    bad = dict(MDIMS, n_experts=3)
    params = np_moe_params(1, 0.04, bad)
    got = ranks.run("engine_error", family="moe", cfg_kw=bad,
                    np_params=params, axis="ep")
    assert got[0] == _jax_error("moe", params, bad, {"ep": 2})
