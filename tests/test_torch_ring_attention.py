"""The port's ring attention and ``attention_impl="ring"`` on gloo ranks
against the JAX package's on its forced host devices.

One module-scoped group of four spawned CPU ranks runs every port case
(``torch_train_ranks``); the JAX reference runs here. Meshes: sp 2 (with
dp 2) and sp 4. Weights come from numpy: GPT-2 with 4 layers, n_embd 128
and 2 heads, llama with n_embd 256 and 4 query heads over 2 kv heads;
ids ``[8, 17]`` (16 input positions, split over sp).

Tolerances (f32): ring outputs within 2e-5 of JAX's ring (5e-5 with
scores in the hundreds, as the JAX test's), gradients of a squared-sum
loss within 5e-5 of ``jax.grad``'s; mesh forwards within 1e-5 + 1e-5 x
the largest logit of the JAX mesh forward (the card's f32 bar); a training step's loss within 1e-5 relative of the JAX
ring step's, its first gradients within rtol 2e-4 / atol 1e-6 of JAX's,
its parameters after the step within 5e-5 (the JAX ring test's bar).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.ops.ring_attention import \
    ring_attention as jring
from llm_sharding_demo_tpu.parallel import spmd as jspmd
from llm_sharding_demo_tpu.training import train as jtrain
from llm_sharding_demo_tpu_torch.models import gpt2, llama
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from test_torch_llama import np_llama_params
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)
from torch_mesh_ranks import RankGroup

DIMS = dict(vocab_size=211, n_positions=64, n_embd=128, n_layer=4,
            n_head=2)
LDIMS = dict(vocab_size=211, n_positions=64, n_embd=256, n_layer=4,
             n_head=4, n_kv_head=2, intermediate_size=384)
IDS = np.random.default_rng(3).integers(0, 211, size=(8, 17))


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.fixture(scope="module")
def weights():
    return {"gpt2": np_gpt2_params(seed=5, dims=DIMS),
            "llama": np_llama_params(seed=5, dims=LDIMS)}


def jmesh(shape):
    return jspmd.make_mesh(shape, jax.devices()[:int(np.prod(
        list(shape.values())))])


def qkv(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(2, 3, 16, 8)).astype(np.float32)
               for _ in range(3))
    return q * np.float32(scale), k, v


def by_sp(results, key, index=None):
    """The dp-0 ranks' chunks laid end to end in sp order."""
    rows = sorted((r for r in results if r["coords"].get("dp", 0) == 0),
                  key=lambda r: r["coords"]["sp"])
    return np.concatenate([r[key] if index is None else r[key][index]
                           for r in rows], axis=2)


@pytest.mark.parametrize("shape,scale,tol", [
    ({"dp": 2, "sp": 2}, 1.0, 2e-5),
    ({"sp": 4}, 1.0, 2e-5),
    ({"sp": 4}, 30.0, 5e-5),       # scores in the hundreds
], ids=["sp2", "sp4", "sp4-large-logits"])
def test_ring_matches_jax_ring(ranks, shape, scale, tol):
    q, k, v = qkv(0, scale)
    want = np.asarray(jring(*map(jnp.asarray, (q, k, v)),
                            jmesh({"sp": shape["sp"], "dp": 4 // shape["sp"]})))
    got = by_sp(ranks.run("torch_train_ranks:ring", q=q, k=k, v=v,
                          shape=shape), "out")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [{"dp": 2, "sp": 2}, {"sp": 4}],
                         ids=["sp2", "sp4"])
def test_ring_gradients_match_jax_grad(ranks, shape):
    q, k, v = qkv(5)
    mesh = jmesh({"sp": shape["sp"], "dp": 4 // shape["sp"]})
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jring(q, k, v, mesh)
                                                    ** 2),
                            argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    res = ranks.run("torch_train_ranks:ring", q=q, k=k, v=v, shape=shape,
                    grad=True)
    for i, w in enumerate(want):
        np.testing.assert_allclose(by_sp(res, "grads", i), np.asarray(w),
                                   atol=5e-5, rtol=5e-5)


def jax_message(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return str(e)
    return ""


def test_ring_validation_messages_equal_jax(ranks, weights):
    jm = jmesh({"sp": 4, "dp": 1})
    z = jnp.zeros((1, 2, 10, 4))
    want = [jax_message(lambda: jring(z, z, z, jm)),
            jax_message(lambda: jring(z, z, z, jm, axis="xx"))]
    assert want[0] == "seq 10 not divisible by sp=4"
    got = ranks.run("torch_train_ranks:ring_errors",
                    shape={"sp": 4, "dp": 1})
    assert all(g == want for g in got), (got, want)
    # a ring config without a mesh: each family's JAX message
    ids = IDS[:2, :8]
    for family, jmod, mod, dims in (("gpt2", jgpt2, gpt2, DIMS),
                                    ("llama", jllama, llama, LDIMS)):
        jcls, cls = ((jgpt2.GPT2Config, gpt2.GPT2Config) if family == "gpt2"
                     else (jllama.LlamaConfig, llama.LlamaConfig))
        jp = jax.tree.map(jnp.asarray, weights[family])
        jmsg = jax_message(lambda: jmod.forward(
            jp, jnp.asarray(ids), jcls(**dims, attention_impl="ring")))
        assert "needs a mesh" in jmsg
        msg = jax_message(lambda: mod.forward(
            params_from_numpy(weights[family], device="cpu"),
            torch.as_tensor(ids),
            cls(**dims, attention_impl="ring")))
        assert msg == jmsg
    got = ranks.run("torch_train_ranks:ring_ragged", shape={"sp": 4},
                    dims=DIMS, np_params=weights["gpt2"])
    assert got[0] == ("ring attention does not support ragged (left-padded)"
                      " batches")


@pytest.mark.parametrize("family,impl", [
    ("gpt2", "ring"), ("llama", "ring"), ("gpt2", "xla"), ("llama", "xla")])
def test_mesh_forward_matches_jax(ranks, weights, family, impl):
    """``forward(..., mesh=)`` on dp2 x sp2 (each rank embeds its chunk at
    its global positions; llama repeats its kv heads before the ring)
    against the JAX forward on the same mesh shape."""
    dims = DIMS if family == "gpt2" else LDIMS
    jmod, jcls = ((jgpt2, jgpt2.GPT2Config) if family == "gpt2"
                  else (jllama, jllama.LlamaConfig))
    ids = IDS[:, :16]
    jp = jax.tree.map(jnp.asarray, weights[family])
    mesh = jmesh({"dp": 2, "sp": 2})
    want = np.asarray(jax.jit(lambda p, i: jmod.forward(
        p, i, jcls(**dims, attention_impl=impl), mesh=mesh))(
            jp, jnp.asarray(ids)))
    got = ranks.run("torch_train_ranks:forward", family=family,
                    cfg_kw=dict(dims, attention_impl=impl),
                    np_params=weights[family], ids=ids,
                    shape={"dp": 2, "sp": 2})[0]
    assert got.shape == want.shape == (8, 16, 211)
    bar = 1e-5 + 1e-5 * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= bar


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in flat(tree[k],
                                                     prefix + (k,)).items()}
    return {prefix: np.asarray(tree)}


def test_ring_train_step_matches_jax(ranks, weights):
    """dp2 x sp2 ring ``TrainStep``: every rank holds the whole ``ids``
    and cuts its rows and its chunk of inputs and labels."""
    jcfg = jgpt2.GPT2Config(**DIMS, attention_impl="ring")
    jp = jax.tree.map(jnp.asarray, weights["gpt2"])
    mesh = jmesh({"dp": 2, "sp": 2})
    jstep = jtrain.TrainStep(jcfg, jtrain.adamw(1e-3), mesh=mesh)
    p1, s1 = jstep.init(jp)
    jparams, _, jloss = jstep(p1, s1, jnp.asarray(IDS, jnp.int32))
    jgrads = jax.jit(jax.grad(lambda p, i: jtrain.lm_loss(
        p, i, dataclasses.replace(jcfg, attention_impl="xla"))))(
            jp, jnp.asarray(IDS))
    res = ranks.run("torch_train_ranks:train", family="gpt2",
                    cfg_kw=dict(DIMS, attention_impl="ring"),
                    np_params=weights["gpt2"], ids=IDS,
                    shape={"dp": 2, "sp": 2})
    assert all(r["losses"] == res[0]["losses"] for r in res)
    assert res[0]["losses"][0] == pytest.approx(float(jloss), rel=1e-5)
    got, want = flat(res[0]["grads"]), flat(jgrads)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=2e-4,
                                   atol=1e-6, err_msg=str(path))
    got, want = flat(res[0]["params"]), flat(jparams)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=5e-5,
                                   atol=5e-5, err_msg=str(path))
