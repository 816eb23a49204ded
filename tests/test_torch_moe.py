"""The port's GPT-2-MoE family against the JAX package's, on the CPU.

The same numpy-made weights go through ``llm_sharding_demo_tpu/models/
moe.py`` and the port's ``models/moe.py``: the forward and its aux loss,
the dense dispatch under binding capacity (the same tokens dropped), the
routed decode path against the dense one, pads that do not route, a
one-expert model against dense GPT-2, fp32 greedy streams of both
``DecodeEngine``s, int8 and bf16 teacher-forced within their budgets,
the refusals with the JAX package's messages, the apps, and three train
steps. Where the two packages' routing could part at a near tie, expert
choices are compared only where the gap between the k-th and the
(k+1)-th gate exceeds ``NEAR_TIE`` (skipped ties are printed).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import moe as jmoe
from llm_sharding_demo_tpu.ops import quant as jquant
from llm_sharding_demo_tpu.runtime.engine import DecodeEngine as JDecodeEngine
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.training import train as jtrain
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu_torch.models import family_module, gpt2, moe
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        resolve_decode_kernel)
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.training import train
from llm_sharding_demo_tpu_torch.utils import graftnum
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies)
from test_torch_model import np_moe_params as model_np_moe_params

# head_dim 64 and 256 positions: the "layer" kernel path applies
DIMS = dict(vocab_size=256, n_positions=256, n_embd=128, n_layer=2,
            n_head=2, n_experts=4, expert_top_k=2)
MAX_SEQ = 64
NEAR_TIE = 1e-6


def np_moe_params(seed: int = 0, std: float = 0.04, dims=None) -> dict:
    """``test_torch_model.np_moe_params`` at this module's DIMS unless
    ``dims`` is given."""
    return model_np_moe_params(seed, std, dims or DIMS)


def build(tree, **over):
    dims = dict(DIMS, **over)
    return ((jmoe.MoEConfig(**dims), jax.tree.map(jnp.asarray, tree)),
            (moe.MoEConfig(**dims), params_from_numpy(tree, device="cpu")))


@pytest.fixture(scope="module")
def model():
    return build(np_moe_params())


def layer0_moe(tree):
    sub = jax.tree.map(lambda x: x[0], tree["blocks"]["moe"])
    return jax.tree.map(jnp.asarray, sub), params_from_numpy(sub,
                                                              device="cpu")


def assert_same_choices(jgates, tgates, k):
    """Expert choices equal wherever the k-th gate leads the (k+1)-th by
    more than NEAR_TIE; returns the number of near ties skipped."""
    jg, tg = np.asarray(jgates), tgates.numpy()
    order_j = np.argsort(-jg, axis=-1, kind="stable")[..., :k]
    order_t = np.argsort(-tg, axis=-1, kind="stable")[..., :k]
    srt = -np.sort(-jg, axis=-1)
    gaps = np.min(srt[..., :k] - srt[..., 1:k + 1], axis=-1)
    clear = gaps > NEAR_TIE
    np.testing.assert_array_equal(order_j[clear], order_t[clear])
    skipped = int((~clear).sum())
    if skipped:
        print(f"skipped {skipped} near ties (gap <= {NEAR_TIE})")
    return skipped


def test_config_validation_and_family():
    assert family_module(moe.MoEConfig(**DIMS)) is moe
    for bad, exc in ((dict(expert_top_k=5), ValueError),
                     (dict(expert_top_k=0), ValueError),
                     (dict(attention_impl="pallas"), ValueError)):
        with pytest.raises(exc) as e:
            moe.MoEConfig(**dict(DIMS, **bad))
        with pytest.raises(exc) as je:
            jmoe.MoEConfig(**dict(DIMS, **bad))
        assert str(e.value) == str(je.value)
    assert moe.expert_capacity(moe.MoEConfig(**DIMS), 10) == \
        jmoe.expert_capacity(jmoe.MoEConfig(**DIMS), 10)


def test_forward_logits_and_aux_match_jax(model):
    (jcfg, jp), (cfg, tp) = model
    ids = np.random.default_rng(1).integers(0, 256, (2, 12))
    jl, ja = jmoe.forward(jp, jnp.asarray(ids), jcfg)
    tl, ta = moe.forward(tp, torch.from_numpy(ids), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-5, rtol=1e-5)


def test_routing_choices_match_jax(model):
    (jcfg, jp), (cfg, tp) = model
    jl0, tl0 = layer0_moe(np_moe_params())
    h = np.random.default_rng(2).standard_normal((3, 16, 128)).astype(
        np.float32)
    jgates = jax.nn.softmax(jnp.asarray(h) @ jl0["router"]["kernel"], -1)
    tgates = moe._router(tl0, torch.from_numpy(h))
    assert assert_same_choices(jgates, tgates, cfg.expert_top_k) < 3 * 16


def _jax_keep(jgates, e, k, cap):
    """The JAX dispatch's kept (choice, token) pairs, from its own top-k
    selection, through its slot rule in numpy."""
    _, onehots, _ = jmoe._topk_gates(jgates, e, k)
    sel = np.stack([np.asarray(o) for o in onehots])          # [k,B,S,E]
    b, s = sel.shape[1:3]
    flat = sel.transpose(1, 0, 2, 3).reshape(b, k * s, e)
    pos = np.cumsum(flat, axis=1) - 1.0
    return ((pos < cap) & (flat > 0)).reshape(b, k, s, e).any(-1)


def test_moe_mlp_binding_capacity_drops_as_jax():
    """With capacity_factor 0.5 the dense dispatch drops tokens; the port
    drops the same (choice, token) pairs and gives the JAX outputs."""
    tree = np_moe_params(seed=4)
    (jcfg, _), (cfg, _) = build(tree, capacity_factor=0.5)
    jl0, tl0 = layer0_moe(tree)
    h = np.random.default_rng(4).standard_normal((2, 12, 128)).astype(
        np.float32)
    jout, jaux = jmoe.moe_mlp(jl0, jnp.asarray(h), jcfg)
    tout, taux = moe.moe_mlp(tl0, torch.from_numpy(h), cfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-5,
                               rtol=1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    cap = moe.expert_capacity(cfg, 12)
    jgates = jax.nn.softmax(jnp.asarray(h) @ jl0["router"]["kernel"], -1)
    want = _jax_keep(jgates, cfg.n_experts, cfg.expert_top_k, cap)
    tgates = moe._router(tl0, torch.from_numpy(h))
    assert assert_same_choices(jgates, tgates, cfg.expert_top_k) == 0
    _, onehots, _ = moe._topk_gates(tgates, cfg.n_experts, cfg.expert_top_k)
    _, keep = moe._dispatch_slots(torch.stack(onehots), cap)
    got = keep.reshape(2, cfg.expert_top_k, 12, cfg.n_experts).any(-1)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int((~want).sum()) < want.size  # some dropped, not all


def test_routed_decode_equals_dense_dispatch(model):
    """At S == 1 the routed path gathers only the chosen experts; its
    routing, combine weights and aux loss are the dense dispatch's, and
    at one row (the served decode step) its outputs are bit-equal. Two
    rows run the dense path's expert GEMM with two rows against the
    routed path's one-row products: equal to fp32 summation order."""
    (_, _), (cfg, _) = model
    _, tl0 = layer0_moe(np_moe_params())
    for b in (1, 2):
        h = torch.randn(b, 1, 128, generator=torch.Generator().manual_seed(b))
        dense, aux_d = moe.moe_mlp(tl0, h, cfg)
        routed, aux_r = moe.moe_mlp_routed(tl0, h, cfg)
        assert float(aux_d) == float(aux_r)
        if b == 1:
            assert torch.equal(dense, routed)
        else:
            torch.testing.assert_close(routed, dense, atol=1e-6, rtol=1e-6)
    # the int8 experts: the same f32-accumulate, one-rounding math
    from llm_sharding_demo_tpu_torch.ops.quant import quantize_params
    q = quantize_params(tl0, torch.bfloat16)
    h = torch.randn(1, 1, 128, generator=torch.Generator().manual_seed(9)
                    ).to(torch.bfloat16)
    assert torch.equal(moe.moe_mlp(q, h, cfg)[0],
                       moe.moe_mlp_routed(q, h, cfg)[0])


def test_quantized_expert_stacks_slice_per_layer(model):
    """``quantize_params`` gives each expert stack codes ``[L, E, in,
    out]`` with scales ``[L, E, out]``, as the JAX package's does, and
    ``unstack_params`` slices codes and scales per layer."""
    from llm_sharding_demo_tpu_torch.models.gpt2 import unstack_params
    from llm_sharding_demo_tpu_torch.ops.quant import quantize_params
    (_, jp), (cfg, tp) = model
    jq = jquant.quantize_params(jp, jnp.bfloat16)
    q = quantize_params(tp, torch.bfloat16)
    for name in ("c_fc", "c_proj"):
        got = q["blocks"]["moe"]["experts"][name]["kernel"]
        want = jq["blocks"]["moe"]["experts"][name]["kernel"]
        assert got.q.shape == want.q.shape and got.q.dim() == 4
        assert got.scale.shape == want.scale.shape == got.q.shape[:2] + (
            got.q.shape[-1],)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        layers = unstack_params(q)["blocks"]
        one = layers[1]["moe"]["experts"][name]["kernel"]
        assert torch.equal(one.q, got.q[1])
        assert torch.equal(one.scale, got.scale[1])


def test_pads_do_not_route(model):
    """Left-pad columns neither route nor take capacity: the real row's
    logits are bit-invariant to the pad ids, and equal to JAX's."""
    tree = np_moe_params(seed=13)
    (jcfg, jp), (cfg, tp) = build(tree)
    assert cfg.capacity_factor < cfg.n_experts / cfg.expert_top_k
    rng = np.random.default_rng(13)
    short, long_ = rng.integers(0, 256, 4), rng.integers(0, 256, 16)
    pad = np.asarray([12, 0], np.int32)
    got = {}
    for pad_id in (0, 7):
        ids = np.full((2, 16), pad_id, np.int64)
        ids[0, 12:], ids[1] = short, long_
        cache = moe.make_cache(cfg, 2, 32)
        out, _ = moe.forward_with_cache(tp, torch.from_numpy(ids), cfg,
                                        cache, pad=torch.from_numpy(pad))
        got[pad_id] = out[:, -1]
    assert torch.equal(got[0], got[7])
    ids = np.full((2, 16), 0, np.int32)
    ids[0, 12:], ids[1] = short, long_
    jout, _ = jmoe.forward_with_cache(jp, jnp.asarray(ids), jcfg,
                                      jmoe.make_cache(jcfg, 2, 32),
                                      pad=jnp.asarray(pad))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jout[:, -1]),
                               atol=1e-5, rtol=1e-5)


def test_single_expert_equals_dense_gpt2():
    """One expert, top-1, capacity for every token: the MoE block is the
    dense GPT-2 block with that expert as its MLP."""
    dims = dict(DIMS, n_experts=1, expert_top_k=1, capacity_factor=1.0)
    tree = np_moe_params(seed=5, dims=dims)
    cfg = moe.MoEConfig(**dims)
    tp = params_from_numpy(tree, device="cpu")
    dense = dict(tp, blocks=dict(tp["blocks"]))
    ex = dense["blocks"].pop("moe")["experts"]
    dense["blocks"]["mlp"] = {
        n: {"kernel": ex[n]["kernel"][:, 0], "bias": ex[n]["bias"][:, 0]}
        for n in ("c_fc", "c_proj")}
    gcfg = gpt2.GPT2Config(**{k: v for k, v in dims.items()
                              if k in ("vocab_size", "n_positions", "n_embd",
                                       "n_layer", "n_head")})
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (2, 9)))
    logits, _ = moe.forward(tp, ids, cfg)
    torch.testing.assert_close(logits, gpt2.forward(dense, ids, gcfg),
                               atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def engines(model):
    (jcfg, jp), (cfg, tp) = model
    return (JDecodeEngine(jp, jcfg, max_seq=MAX_SEQ),
            DecodeEngine(tp, cfg, max_seq=MAX_SEQ, device="cpu"))


@pytest.mark.parametrize("case", ["solo", "ragged3", "one_token"])
def test_fp32_greedy_streams_equal_jax(engines, case):
    je, te = engines
    rng = np.random.default_rng(21)
    prompts = {"solo": rng.integers(0, 256, (1, 7)),
               "ragged3": [rng.integers(0, 256, n) for n in (3, 9, 5)],
               "one_token": np.asarray([[17]])}[case]
    want = je.generate(prompts, 12)
    got = te.generate(prompts, 12)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    if case == "ragged3":
        np.testing.assert_array_equal(got.pad, np.asarray(want.pad))


_jfwd = jax.jit(jmoe.forward_with_cache, static_argnames=("config",))
_JAX_TF = {}


def _jax_tf_logits(jp, jcfg, prompt, forced, regime):
    """The JAX engine's cached path, teacher-forced: the prefill, then one
    single-token step a forced token, on its ``regime`` weights/cache
    (each regime computed once per module)."""
    if regime not in _JAX_TF:
        _JAX_TF[regime] = _jax_tf(jp, jcfg, prompt, forced, regime)
    return _JAX_TF[regime]


def _jax_tf(jp, jcfg, prompt, forced, regime):
    if regime == "int8":
        jp, dt = jquant.quantize_params(jp, jnp.bfloat16), jnp.bfloat16
    elif regime == "bfloat16":
        jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
        dt = jnp.bfloat16
    else:
        dt = jnp.float32
    cache = jmoe.make_cache(jcfg, 1, MAX_SEQ, dt)
    logits, cache = _jfwd(jp, jnp.asarray([prompt]), config=jcfg,
                          cache=cache)
    rows = [logits[0, -1]]
    for tok in forced[:-1]:
        logits, cache = _jfwd(jp, jnp.asarray([[tok]]), config=jcfg,
                              cache=cache)
        rows.append(logits[0, -1])
    return torch.tensor(np.asarray(jnp.stack(rows), np.float32))


@pytest.mark.parametrize("regime,path,kernel", [
    ("bfloat16", "decode.bf16", "xla"), ("int8", "decode.int8", "xla"),
    ("int8", "decode.int8", "layer")])
def test_approximate_regimes_within_budget_of_jax(regime, path, kernel):
    """bf16 and int8 (the plain path, and the "layer" kernel path's plain
    versions), teacher-forced, within the declared budgets of the JAX
    engine's same-regime path and of its fp32 logits. Weights at the
    models' own init std (the budgets are in logit units)."""
    from test_torch_model import teacher_forced_logits
    (jcfg, jp), (cfg, tp) = build(np_moe_params(seed=1, std=0.02))
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 256, 6).tolist()
    forced = rng.integers(0, 256, 24).tolist()
    eng = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, dtype=regime,
                       decode_kernel=kernel, device="cpu")
    assert eng.decode_kernel_mode == kernel
    approx = teacher_forced_logits(eng, prompt, forced)
    graftnum.compare(path, approx,
                     _jax_tf_logits(jp, jcfg, prompt, forced, regime))
    graftnum.compare(path, approx,
                     _jax_tf_logits(jp, jcfg, prompt, forced, "float32"))


def test_engine_kernel_rules(model):
    """On CUDA "auto" resolves an int8 or bf16 MoE engine to "layer" (no
    whole-stack kernel for the family), fp32 to the plain path; "mega"
    raises naming the family."""
    (_, _), (cfg, _) = model
    for regime in ("int8", "bfloat16"):
        assert resolve_decode_kernel("auto", cfg, MAX_SEQ, regime,
                                     True)[0] == "layer"
    assert resolve_decode_kernel("auto", cfg, MAX_SEQ, "float32",
                                 True)[0] is None
    with pytest.raises(ValueError, match="MoEConfig has no whole-stack"):
        resolve_decode_kernel("mega", cfg, MAX_SEQ, "int8", True)
    # the dense GPT-2 config of the same geometry still takes the mega rule
    gcfg = gpt2.GPT2Config(**{k: DIMS[k] for k in (
        "vocab_size", "n_positions", "n_embd", "n_layer", "n_head")})
    assert resolve_decode_kernel("auto", gcfg, MAX_SEQ, "int8",
                                 True)[0] == "mega"


def _messages(fn_t, fn_j, exc):
    with pytest.raises(exc) as t:
        fn_t()
    with pytest.raises(exc) as j:
        fn_j()
    assert str(t.value) == str(j.value)
    return str(t.value)


def test_refusals_carry_the_jax_messages(model):
    from llm_sharding_demo_tpu.runtime.iterbatch import (
        IterBatchingEngine as JIter)
    from llm_sharding_demo_tpu.runtime.prefix_cache import (
        PrefixCachingEngine as JPrefix)
    from llm_sharding_demo_tpu.runtime.spec_decode import (
        SpecDecodeEngine as JSpec)
    from llm_sharding_demo_tpu_torch.runtime.iterbatch import (
        IterBatchingEngine)
    from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
        PrefixCachingEngine)
    from llm_sharding_demo_tpu_torch.runtime.spec_decode import (
        SpecDecodeEngine)
    (jcfg, jp), (cfg, tp) = model
    te = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, device="cpu")
    je = JDecodeEngine(jp, jcfg, max_seq=MAX_SEQ)
    nie = NotImplementedError
    assert "decode unstaged" in _messages(
        lambda: DecodeEngine(tp, cfg, MAX_SEQ, boundaries=[1], device="cpu"),
        lambda: JDecodeEngine(jp, jcfg, MAX_SEQ, boundaries=[1]), nie)
    assert "monolithically" in _messages(
        lambda: DecodeEngine(tp, cfg, MAX_SEQ, prefill_chunk=8,
                             device="cpu"),
        lambda: JDecodeEngine(jp, jcfg, MAX_SEQ, prefill_chunk=8), nie)
    _messages(lambda: SpecDecodeEngine(tp, cfg, MAX_SEQ, device="cpu"),
              lambda: JSpec(jp, jcfg, MAX_SEQ), nie)
    _messages(lambda: PrefixCachingEngine(te, capacity=2),
              lambda: JPrefix(je, capacity=2), nie)
    _messages(lambda: IterBatchingEngine(te, max_batch=4),
              lambda: JIter(je, max_batch=4), nie)
    with pytest.raises(ValueError, match="megakernel is ineligible"):
        DecodeEngine(tp, cfg, MAX_SEQ, decode_kernel="mega", device="cpu")
    for kw in (dict(kv_pool_blocks=16), dict(max_batch=4, batch_mode="iter"),
               dict(dispatch="remote")):
        _messages(
            lambda: create_app(ServingConfig(model_id="m", max_seq=MAX_SEQ,
                                             **kw),
                               model=(cfg, tp), tokenizer=ByteTokenizer(),
                               device="cpu"),
            lambda: jcreate_app(JServingConfig(model_id="m", max_seq=MAX_SEQ,
                                               **kw),
                                model=(jcfg, jp),
                                tokenizer=JByteTokenizer()), ValueError)


def _apps(model, **kw):
    (jcfg, jp), (cfg, tp) = model
    j = jcreate_app(JServingConfig(model_id="m", max_seq=MAX_SEQ, **kw),
                    model=(jcfg, jp), tokenizer=JByteTokenizer())
    t = create_app(ServingConfig(model_id="m", max_seq=MAX_SEQ, **kw),
                   model=(cfg, tp), tokenizer=ByteTokenizer(), device="cpu")
    return JTestClient(j), TestClient(t)


def test_app_generate_and_stage_decline_as_jax(model):
    jc, tc = _apps(model)
    body = {"prompt": "Mixture", "max_new_tokens": 10, "mode": "greedy"}
    r = tc.post("/generate", json=body)
    assert r.status_code == 200
    assert r.json() == jc.post("/generate", json=body).json()
    h = tc.get("/healthz").json()
    assert (h["n_stages"], h["decode_kernel"]) == (1, "xla")
    for role in ("a", "b"):
        ja, ta = _apps(model, shard_role=role)
        path, payload = (("/forward", {"input_ids": [1, 2]}) if role == "a"
                         else ("/forward_b",
                               {"hidden_states": [[[0.0] * 128]]}))
        got = ta.post(path, json=payload).json()
        assert "dense GPT-2 only" in got["error"]
        assert got == ja.post(path, json=payload).json()


def test_admission_wave_rows_equal_jax_app(model):
    """A MAX_BATCH=4 admission server takes a wave of four ragged
    prompts as one round; every row's reply equals the JAX app's."""
    prompts = ["a", "Mixture of", "experts route", "tokens!"]
    replies = {}
    for name, client in zip(("jax", "port"), _apps(
            model, max_batch=4, batch_mode="admission",
            batch_wait_ms=2000.0)):
        out = [None] * len(prompts)

        def run(i, client=client, out=out):
            out[i] = client.post("/generate", json={
                "prompt": prompts[i], "max_new_tokens": 8,
                "mode": "greedy"}).json()

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        replies[name] = out
    assert replies["port"] == replies["jax"]
    assert all(r["generated"].startswith(p)
               for r, p in zip(replies["port"], prompts))


STEPS, LR = 3, 1e-3


def test_moe_train_steps_match_jax():
    dims = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2,
                n_head=4, n_experts=4, expert_top_k=2)
    jcfg, cfg = jmoe.MoEConfig(**dims), moe.MoEConfig(**dims)
    tree = jax.tree.map(np.asarray,
                        jmoe.init_params(jcfg, jax.random.PRNGKey(0)))
    ids = np.random.default_rng(0).integers(0, 97, size=(4, 17))
    jstep = jtrain.MoETrainStep(jcfg, jtrain.adamw(LR))
    jparams, jstate = jstep.init(jax.tree.map(jnp.asarray, tree))
    tstep = train.MoETrainStep(cfg, train.adamw(LR), device="cpu")
    tparams, tstate = tstep.init(params_from_numpy(tree, device="cpu"))
    for _ in range(STEPS):
        jparams, jstate, jloss = jstep(jparams, jstate, jnp.asarray(ids))
        tparams, tstate, tloss = tstep(tparams, tstate, ids)
        assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    got = dict(train._flatten(tparams))
    want = {tuple(k.key for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(jparams)}
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path].numpy(), value, atol=1e-5,
                                   rtol=0, err_msg=str(path))
    # MoE does not stage: GPipe refuses it with the JAX package's message
    # (its mesh training is in tests/test_torch_moe_mesh*.py and
    # tests/test_torch_mesh_training.py)
    with pytest.raises(NotImplementedError) as jerr:
        jtrain.GPipeTrainStep(jcfg, jtrain.adamw(), mesh=None)
    with pytest.raises(NotImplementedError) as err:
        train.GPipeTrainStep(cfg, train.adamw(), mesh=None, device="cpu")
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="MoETrainStep"):
        train.TrainStep(cfg, train.adamw(), device="cpu")
