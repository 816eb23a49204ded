"""The port's mesh training (``TrainStep``, ``LlamaTrainStep`` and
``MoETrainStep`` with ``mesh=``) on gloo ranks against the JAX package's
GSPMD steps on its forced host devices.

One module-scoped group of four spawned CPU ranks runs every port case
(``torch_train_ranks``); the JAX reference runs here, each JAX step built
once. Meshes: dp2 x tp2, dp2 x sp2 (``"xla"``: the sequence gathered
for attention), tp2 x sp2, dp2 x ep2. Weights come from numpy: GPT-2 with
4 layers, n_embd 128 and 2 heads, llama with n_embd 256 and 4 query heads
over 2 kv heads, GPT-2-MoE with 4 experts, top 2; ids ``[8, 17]``.

Tolerances (f32): each step's loss within 1e-5 relative of the JAX mesh
step's; first-step gradients, unsharded, within rtol 2e-4 / atol 1e-6 of
``jax.grad``'s (the JAX package's 1F1B-against-GPipe bar); parameters
after one step within 5e-5 (the JAX ring test's bar) wherever the
gradient is above that atol (``check_first_step``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.models import moe as jmoe
from llm_sharding_demo_tpu.parallel import spmd as jspmd
from llm_sharding_demo_tpu.training import train as jtrain
from llm_sharding_demo_tpu_torch.models import gpt2, moe
from llm_sharding_demo_tpu_torch.training import train
from test_torch_llama import np_llama_params
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params,
                              np_moe_params)
from torch_mesh_ranks import RankGroup

DIMS = {"gpt2": dict(vocab_size=211, n_positions=64, n_embd=128, n_layer=4,
                     n_head=2),
        "llama": dict(vocab_size=211, n_positions=64, n_embd=256, n_layer=4,
                      n_head=4, n_kv_head=2, intermediate_size=384),
        "moe": dict(vocab_size=211, n_positions=64, n_embd=128, n_layer=2,
                    n_head=2, n_experts=4, expert_top_k=2)}
JCLS = {"gpt2": jgpt2.GPT2Config, "llama": jllama.LlamaConfig,
        "moe": jmoe.MoEConfig}
IDS = np.random.default_rng(4).integers(0, 211, size=(8, 17))
STEPS = 3
AUX = 1.0     # the MoE cases' aux weight: large enough that it moves the
#               router's gradient well past the tolerance


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.fixture(scope="module")
def weights():
    return {"gpt2": np_gpt2_params(seed=9, dims=DIMS["gpt2"]),
            "llama": np_llama_params(seed=9, dims=DIMS["llama"]),
            "moe": np_moe_params(9, 0.04, DIMS["moe"])}


def jmesh(shape):
    return jspmd.make_mesh(shape, jax.devices()[:int(np.prod(
        list(shape.values())))])


def flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in flat(tree[k],
                                                     prefix + (k,)).items()}
    return {prefix: np.asarray(tree)}


def jax_loss(family, jcfg):
    if family == "moe":
        return lambda p, i: jtrain.moe_lm_loss(p, i, jcfg, AUX)
    return lambda p, i: jtrain.lm_loss(p, i, jcfg)


_GRADS = {}


def jax_grads(family, np_params):
    """``jax.grad`` of the family's loss at the weights (one device)."""
    if family not in _GRADS:
        jcfg = JCLS[family](**DIMS[family])
        _GRADS[family] = flat(jax.jit(jax.grad(jax_loss(family, jcfg)))(
            jax.tree.map(jnp.asarray, np_params), jnp.asarray(IDS)))
    return _GRADS[family]


def jax_mesh_run(family, np_params, shape, adamw_kw=None):
    """The JAX mesh step's losses over ``STEPS`` steps and its parameters
    after the first."""
    jcfg = JCLS[family](**DIMS[family])
    mesh = jmesh(shape)
    opt = jtrain.adamw(1e-3, **(adamw_kw or {}))
    if family == "moe":
        step = jtrain.MoETrainStep(jcfg, opt, mesh=mesh, aux_weight=AUX)
    elif family == "llama":
        step = jtrain.LlamaTrainStep(jcfg, opt, mesh=mesh)
    else:
        step = jtrain.TrainStep(jcfg, opt, mesh=mesh)
    p, s = step.init(jax.tree.map(jnp.asarray, np_params))
    # the 17-long [B, S] batch does not split over sp: hand it over whole
    ids = jnp.asarray(IDS, jnp.int32)
    losses, first = [], None
    for i in range(STEPS):
        p, s, loss = step(p, s, ids)
        losses.append(float(loss))
        if i == 0:
            first = flat(p)
    return losses, first


def run_beside_jax(ranks, family, np_params, shape, adamw_kw=None,
                   **kw):
    """The port's mesh step on the ranks and the JAX one here, at once;
    checks them against each other and returns the ranks' results."""
    ranks.submit("torch_train_ranks:train", family=family,
                 cfg_kw=DIMS[family], np_params=np_params, ids=IDS,
                 shape=shape, steps=STEPS, adamw_kw=adamw_kw, **kw)
    jax_grads(family, np_params)
    jrun = jax_mesh_run(family, np_params, shape, adamw_kw)
    res = ranks.results()
    check_against_jax(res, jrun, family, np_params)
    return res


def check_against_jax(res, jrun, family, np_params):
    jlosses, jparams = jrun
    for r in res:
        assert r["losses"] == res[0]["losses"]   # every rank's global mean
    np.testing.assert_allclose(res[0]["losses"], jlosses, rtol=1e-5)
    got, want = flat(res[0]["grads"]), jax_grads(family, np_params)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=2e-4,
                                   atol=1e-6, err_msg=str(path))
    got = flat(res[0]["params"])
    assert set(got) == set(jparams)
    for path in jparams:
        check_first_step(got[path], jparams[path], want[path], path)


def check_first_step(got, want, grad, path):
    """Parameters after one step within 5e-5, except where the gradient
    is below the gradients' atol (1e-6): there Adam's first step is
    ``lr * g / (|g| + 1e-8)`` of rounding noise, and both packages' steps
    are only bounded by the learning rate (the JAX package's own mesh and
    one-device llama steps part by 1.15e-4 at such an element of this
    tree, whose gradient is -8.6e-9)."""
    noise = np.abs(grad) < 1e-6
    np.testing.assert_allclose(got[~noise], want[~noise], rtol=5e-5,
                               atol=5e-5, err_msg=str(path))
    assert float(np.abs(got - want)[noise].max(initial=0.0)) <= 2.2e-3


@pytest.mark.parametrize("family,shape", [
    ("gpt2", {"dp": 2, "tp": 2}), ("llama", {"dp": 2, "tp": 2}),
    ("gpt2", {"dp": 2, "sp": 2}), ("llama", {"dp": 2, "sp": 2}),
], ids=["gpt2-dp2-tp2", "llama-dp2-tp2", "gpt2-dp2-sp2", "llama-dp2-sp2"])
def test_mesh_train_step_matches_jax(ranks, weights, family, shape):
    res = run_beside_jax(ranks, family, weights[family], shape)
    # a replicated norm scale: the same, whole gradient on every rank
    # (Megatron's copy_to at each column-parallel input), JAX's
    ln = "ln_attn" if family == "llama" else "ln_1"
    want = jax_grads(family, weights[family])[("blocks", ln, "scale")]
    for r in res:
        np.testing.assert_allclose(r["ln_grad"], want, rtol=2e-4, atol=1e-6)


def test_moe_mesh_train_step_matches_jax(ranks, weights):
    """dp2 x ep2, the aux loss weighted 1.0: its token and gate fractions
    are averaged over dp before their product, and the router's gradient
    is whole on both ep ranks."""
    shape = {"dp": 2, "ep": 2}
    run_beside_jax(ranks, "moe", weights["moe"], shape, aux_weight=AUX)


def test_global_norm_clip_binds_on_a_sharded_mesh(ranks, weights):
    """tp2 x sp2 with ``grad_clip`` 0.05, far below the gradients' norm:
    the norm sums a tp-split leaf's squares over tp and counts a
    replicated leaf once, so it equals optax's global norm, and the
    clipped step equals JAX's."""
    shape = {"tp": 2, "sp": 2}
    kw = dict(grad_clip=0.05)
    res = run_beside_jax(ranks, "gpt2", weights["gpt2"], shape, kw)
    want = float(optax.global_norm(
        [jnp.asarray(g) for g in jax_grads("gpt2",
                                           weights["gpt2"]).values()]))
    assert want > 20 * kw["grad_clip"]
    for r in res:
        assert r["norm"] == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("family,shape", [
    ("gpt2", {"tp": 4}), ("gpt2", {"dp": 2, "tp": 2}),
    ("llama", {"tp": 2, "dp": 2}), ("moe", {"ep": 2, "tp": 2}),
], ids=["gpt2-tp4", "gpt2-dp2-tp2", "llama-tp2", "moe-ep2-tp2"])
def test_unshard_params_inverts_shard_params(ranks, weights, family,
                                             shape):
    """``unshard_params(shard_params(p)) == p`` bit for bit on every rank,
    GPT-2's fused ``c_attn`` (split by head) included."""
    assert all(ranks.run("torch_train_ranks:unshard_roundtrip",
                         family=family, cfg_kw=DIMS[family],
                         np_params=weights[family], shape=shape))


class _Mesh:
    """Axis names and sizes, all a step's mesh checks read."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = list(axes.values())

    def size(self, i):
        return self._sizes[i]


def test_moe_tp_beyond_the_heads_refuses_like_dense():
    """tp splits attention by whole heads: tp=4 at n_head=2 refuses for
    GPT-2-MoE with the dense step's message (the JAX package's GSPMD
    tiles the uneven split instead)."""
    mesh = _Mesh(tp=4)
    msgs = []
    for family, make in (("gpt2", train.TrainStep),
                         ("moe", train.MoETrainStep)):
        cfg = (moe.MoEConfig if family == "moe" else gpt2.GPT2Config)(
            **DIMS[family])
        with pytest.raises(ValueError) as e:
            make(cfg, train.adamw(), mesh=mesh, device="cpu")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert msgs[0] == ("tp=4 must divide n_head=2: attention shards over "
                       "whole heads")
