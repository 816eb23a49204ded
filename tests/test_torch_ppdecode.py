"""The port's pipelined decode (``parallel.ppdecode``) on gloo ranks
against the JAX package's ``PipelinedDecoder``.

One module-scoped group of two spawned CPU ranks (and one of three for
the 3-stage case) runs every port case (``torch_mesh_ranks``; the
children import only torch and the port); the JAX reference runs here on
its forced host devices. Weights come from numpy (GPT-2: 4 layers,
n_embd 128, head_dim 64; llama: 4 layers, n_embd 256, 4 query heads
over 2 kv heads).

Tolerances: fp32 greedy streams byte-equal to the JAX decoder's and to
the port's single-rank engine's, last-stage logits within 1e-5 of the
JAX forward's; int8 pp streams equal to the port's single-rank int8
engine on the same matmul-kernel path; bf16 and int8 teacher-forced
logits equal to the single-rank engine's and inside their ``graftnum``
budgets of the JAX fp32 logits; sampled streams pinned by seed replay
within the port, their ``sampler_pmf`` within 1e-6 of JAX's. The
``PP_DECODE`` app is ``test_torch_mesh_serving.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.parallel.ppdecode import (
    PipelinedDecoder as JPipelinedDecoder,
    stage_ring_permutation as jstage_ring_permutation)
from llm_sharding_demo_tpu.parallel.spmd import make_mesh as jmake_mesh
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.parallel.pipeline import PipelineRunner
from llm_sharding_demo_tpu_torch.parallel.ppdecode import (
    stage_ring_permutation)
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        SamplingConfig,
                                                        sampler_pmf)
from llm_sharding_demo_tpu_torch.utils import graftnum
from test_torch_llama import np_llama_params
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)
from torch_mesh_ranks import RankGroup

DIMS = dict(vocab_size=211, n_positions=128, n_embd=128, n_layer=4,
            n_head=2)
LDIMS = dict(vocab_size=211, n_positions=128, n_embd=256, n_layer=4,
             n_head=4, n_kv_head=2, intermediate_size=384)
MAX_SEQ = 64
PROMPT = np.random.default_rng(0).integers(0, 211, size=(2, 7)).tolist()
RAGGED = [[5, 6, 7], [1, 2, 3, 4, 5]]
STEPS = 12
ATOL = RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(2)
    yield group
    group.close()


@pytest.fixture(scope="module")
def ranks3():
    group = RankGroup(3)
    yield group
    group.close()


@pytest.fixture(scope="module")
def np_params():
    return np_gpt2_params(seed=3, dims=DIMS)


@pytest.fixture(scope="module")
def jmodel(np_params):
    return (jgpt2.GPT2Config(**DIMS),
            jax.tree.map(jnp.asarray, np_params))


def jax_pp_tokens(jmodel, n_stages, prompts, steps, boundaries=None,
                  dtype=jnp.float32):
    jcfg, jp = jmodel
    mesh = jmake_mesh({"pp": n_stages}, jax.devices()[:n_stages])
    dec = JPipelinedDecoder(jp, jcfg, mesh, max_seq=MAX_SEQ, dtype=dtype,
                            boundaries=boundaries)
    return dec.generate(prompts, steps).tokens


def jax_logits(jmodel, ids):
    jcfg, jp = jmodel
    fwd = jllama.forward if isinstance(jcfg, jllama.LlamaConfig) \
        else jgpt2.forward
    return np.asarray(fwd(jp, jnp.asarray(ids), jcfg))


def pp(ranks, np_params, family="gpt2", dims=DIMS, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    return ranks.run("pp_generate", family=family, cfg_kw=dims,
                     np_params=np_params, **kw)


@pytest.fixture(scope="module")
def pp2(ranks, np_params):
    """The 2-stage fp32 run every greedy check reads."""
    return pp(ranks, np_params, prompts=PROMPT, steps=STEPS, single={},
              logit_ids=PROMPT)


def test_stage_ring_permutation_matches_jax():
    for n in range(1, 6):
        assert stage_ring_permutation(n) == jstage_ring_permutation(n)


@pytest.mark.parametrize("n_stages", [2, 3])
def test_ppdecode_matches_engine(request, jmodel, np_params, pp2, n_stages):
    """fp32 greedy streams byte-equal to the JAX PipelinedDecoder at the
    same stage count and to the port's single-rank engine; the last
    stage's prompt logits within 1e-5 of the JAX forward's."""
    if n_stages == 2:
        out = pp2
    else:
        out = pp(request.getfixturevalue("ranks3"), np_params,
                 prompts=PROMPT, steps=STEPS, single={}, logit_ids=PROMPT)
    last = out[-1]
    # balanced stages: 4 layers over 3 stages hold 2, 1, 1 blocks
    assert [o["stage"] for o in out] == (
        [(0, 2), (2, 4)] if n_stages == 2 else [(0, 2), (2, 3), (3, 4)])
    got = out[0]["runs"][0]["tokens"]
    np.testing.assert_array_equal(
        got, jax_pp_tokens(jmodel, n_stages, np.asarray(PROMPT), STEPS))
    np.testing.assert_array_equal(got, last["single"]["tokens"])
    np.testing.assert_allclose(last["logits"], jax_logits(jmodel, PROMPT),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(last["logits"], last["single_logits"],
                               atol=1e-6, rtol=1e-6)
    # the followers served the one request; stage 0 handed on each of its
    # STEPS forwards and the teacher-forced prompt's
    assert all(o["served"] == 1 for o in out[1:])
    assert out[0]["comm"]["hop"][0] == STEPS + 1


def test_ppdecode_matches_host_driven_runner(np_params, pp2):
    """The rank-per-stage decoder equals the one-process stage runner."""
    runner = PipelineRunner(params_from_numpy(np_params, device="cpu"),
                            gpt2.GPT2Config(**DIMS), [2], max_seq=MAX_SEQ,
                            device="cpu")
    np.testing.assert_array_equal(runner.generate(PROMPT, STEPS).tokens,
                                  pp2[0]["runs"][0]["tokens"])


def test_ppdecode_sampling_deterministic(ranks, jmodel, np_params):
    """A seeded sampled stream replays (twice on the decoder, once on the
    single-rank engine), the last stage's draws leave the caller's
    generator where the engine leaves it, and the pmf the last stage
    samples from is JAX's within 1e-6."""
    s = {"mode": "sample", "temperature": 0.6, "top_k": 40}
    out = pp(ranks, np_params, prompts=[[3, 14, 15]], steps=6, sampling=s,
             seed=7, repeat=2, single={}, logit_ids=[[3, 14, 15]])
    a, b = out[0]["runs"]
    single = out[-1]["single"]
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["tokens"], single["tokens"])
    np.testing.assert_array_equal(a["gen_state"], single["gen_state"])
    sampling = SamplingConfig(**s)
    probs, idx = sampler_pmf(torch.tensor(out[-1]["logits"][:, -1]),
                             sampling)
    jprobs, jidx = jengine.sampler_pmf(
        jnp.asarray(jax_logits(jmodel, [[3, 14, 15]])[:, -1]),
        jengine.SamplingConfig(mode="sample", temperature=0.6, top_k=40))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)


def test_ppdecode_per_row_generators_replay(ranks, np_params):
    """A ragged sampled batch with one generator a row (the batchers'
    form): each row's stream and its generator's final state are the
    single-rank engine's."""
    out = pp(ranks, np_params, prompts=RAGGED, steps=6,
             sampling={"mode": "sample", "temperature": 0.8, "top_k": 20},
             seed=[3, 4], single={})
    got, single = out[0]["runs"][0], out[-1]["single"]
    np.testing.assert_array_equal(got["tokens"], single["tokens"])
    for a, b in zip(got["gen_state"], single["gen_state"]):
        np.testing.assert_array_equal(a, b)


def test_ppdecode_ragged_batch_matches_engine(ranks, jmodel, np_params):
    """Ragged left-padded rows decode with per-row pad masks, byte-equal
    to the JAX decoder and to the single-rank engine row for row."""
    out = pp(ranks, np_params, prompts=RAGGED, steps=8, single={})
    got = out[0]["runs"][0]
    np.testing.assert_array_equal(got["pad"], [2, 0])
    np.testing.assert_array_equal(got["tokens"], out[-1]["single"]["tokens"])
    np.testing.assert_array_equal(got["tokens"],
                                  jax_pp_tokens(jmodel, 2, RAGGED, 8))


def test_ppdecode_uneven_stages_match_engine(ranks, jmodel, np_params):
    """Uneven boundaries (1 block, then 3): each rank holds only its own
    blocks (no padded stacking), streams byte-equal to JAX's padded
    decoder."""
    out = pp(ranks, np_params, prompts=PROMPT, steps=STEPS, boundaries=[1],
             single={})
    assert [o["stage"] for o in out] == [(0, 1), (1, 4)]
    got = out[0]["runs"][0]["tokens"]
    np.testing.assert_array_equal(got, out[-1]["single"]["tokens"])
    np.testing.assert_array_equal(
        got, jax_pp_tokens(jmodel, 2, np.asarray(PROMPT), STEPS,
                           boundaries=[1]))


_jfwd = jax.jit(jgpt2.forward_with_cache, static_argnames=("config",))


def _jax_tf(jmodel, prompt, forced):
    """The JAX engine's cached fp32 path, teacher-forced."""
    jcfg, jp = jmodel
    cache = jgpt2.make_cache(jcfg, 1, MAX_SEQ, jnp.float32)
    logits, cache = _jfwd(jp, jnp.asarray([prompt]), config=jcfg,
                          cache=cache)
    rows = [logits[0, -1]]
    for tok in forced[:-1]:
        logits, cache = _jfwd(jp, jnp.asarray([[tok]]), config=jcfg,
                              cache=cache)
        rows.append(logits[0, -1])
    return torch.tensor(np.asarray(jnp.stack(rows), np.float32))


def test_ppdecode_int8_matches_int8_engine(ranks, np_params):
    """int8 stages quantize as the single-rank engine does and run its
    matmul-kernel path (the int8 linear and head, plain attention): the
    streams are equal."""
    out = pp(ranks, np_params, prompts=PROMPT, steps=10, dtype="int8",
             single={"decode_kernel": "xla", "matmul_kernels": True})
    np.testing.assert_array_equal(out[0]["runs"][0]["tokens"],
                                  out[-1]["single"]["tokens"])


@pytest.mark.parametrize("regime,path", [("int8", "decode.int8"),
                                         ("bfloat16", "decode.bf16")])
def test_ppdecode_approximate_regimes_within_budget(ranks, regime, path):
    """int8 and bf16 stages, teacher-forced over a fixed sequence: equal
    to the single-rank engine on the same regime and path (int8: its
    matmul kernels' plain versions) and inside the declared budget of the
    JAX engine's fp32 logits. Weights at the model's own init std (the
    budgets are in logit units)."""
    np_small = np_gpt2_params(seed=5, std=0.02, dims=DIMS)
    jm = (jgpt2.GPT2Config(**DIMS), jax.tree.map(jnp.asarray, np_small))
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 211, 6).tolist()
    forced = rng.integers(0, 211, 24).tolist()
    case = dict(family="gpt2", cfg_kw=DIMS, np_params=np_small,
                max_seq=MAX_SEQ, prompt=prompt, forced=forced, dtype=regime)
    tf = ranks.run("teacher_forced", kind="pp", **case)[-1]
    single = ranks.run("teacher_forced", kind="single",
                       kwargs={"decode_kernel": "xla",
                               "matmul_kernels": True}, **case)[0]
    np.testing.assert_array_equal(tf, single)
    graftnum.compare(path, torch.tensor(tf),
                     _jax_tf(jm, prompt, forced))


def test_staged_engine_matches_plain(np_params, pp2):
    """The one-process staged engine (boundaries [1, 3]) equals the plain
    one, ragged batches included, and both equal the pipelined run."""
    params = params_from_numpy(np_params, device="cpu")
    cfg = gpt2.GPT2Config(**DIMS)
    staged = DecodeEngine(params, cfg, MAX_SEQ, boundaries=[1, 3],
                          device="cpu")
    plain = DecodeEngine(params, cfg, MAX_SEQ, device="cpu")
    np.testing.assert_array_equal(staged.generate(PROMPT, STEPS).tokens,
                                  pp2[0]["runs"][0]["tokens"])
    np.testing.assert_array_equal(staged.generate(RAGGED, 6).tokens,
                                  plain.generate(RAGGED, 6).tokens)


def test_llama_pipelined_decoder_matches_engine(ranks):
    """llama (GQA: a stage's cache at kv-head width) on two ranks,
    byte-equal to the JAX decoder and the single-rank engine."""
    np_params = np_llama_params(seed=4, dims=LDIMS)
    prompt = ((np.arange(9) * 11) % 211)[None].tolist()
    out = pp(ranks, np_params, family="llama", dims=LDIMS, prompts=prompt,
             steps=10, single={}, logit_ids=prompt)
    got = out[0]["runs"][0]["tokens"]
    np.testing.assert_array_equal(got, out[-1]["single"]["tokens"])
    jm = (jllama.LlamaConfig(**LDIMS), jax.tree.map(jnp.asarray, np_params))
    np.testing.assert_array_equal(got, jax_pp_tokens(jm, 2, prompt, 10))
    np.testing.assert_allclose(out[-1]["logits"], jax_logits(jm, prompt),
                               atol=ATOL, rtol=RTOL)


def test_ppdecode_refusals_carry_the_jax_messages(ranks, np_params):
    """MoE refuses, and boundaries giving another stage count than the
    mesh's pp axis raise, with the JAX decoder's messages."""
    from test_torch_model import np_moe_params
    mdims = dict(DIMS, n_experts=4, expert_top_k=2)
    from llm_sharding_demo_tpu.models import moe as jmoe
    errs = ranks.run("pp_error", family="moe", cfg_kw=mdims,
                     np_params=np_moe_params(0, 0.04, mdims))
    mcfg = jmoe.MoEConfig(**mdims)
    with pytest.raises(NotImplementedError) as j:
        JPipelinedDecoder(None, mcfg, jmake_mesh({"pp": 2},
                                                 jax.devices()[:2]), 32)
    assert errs[0] == f"NotImplementedError: {j.value}"
    errs = ranks.run("pp_error", family="gpt2", cfg_kw=DIMS,
                     np_params=np_params, boundaries=[1, 2])
    jcfg = jgpt2.GPT2Config(**DIMS)
    with pytest.raises(ValueError) as j:
        JPipelinedDecoder(jax.tree.map(jnp.asarray, np_params), jcfg,
                          jmake_mesh({"pp": 2}, jax.devices()[:2]), 32,
                          boundaries=[1, 2])
    assert errs[0] == f"ValueError: {j.value}"
