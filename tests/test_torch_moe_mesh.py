"""The port's GPT-2-MoE mesh training on tp, sp and pp meshes
(``MoETrainStep(mesh=)``) on four gloo ranks against the JAX package's
GSPMD ``MoETrainStep`` on its forced host devices.

The dims, ids, aux weight (1.0) and tolerances are
``test_torch_mesh_training``'s: each of three steps' loss within 1e-5
relative of the JAX mesh step's, first-step gradients (unsharded) within
rtol 2e-4 / atol 1e-6 of ``jax.grad``'s, parameters after one step
within 5e-5 (``check_first_step``). On every rank the router's and
``ln_2``'s gradients, which no mesh axis splits, are whole and equal to
``jax.grad``'s. The sp meshes are in ``test_torch_moe_mesh_sp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from llm_sharding_demo_tpu.models import moe as jmoe
from llm_sharding_demo_tpu.training import train as jtrain
from test_torch_mesh_training import (AUX, DIMS, IDS, STEPS,
                                      check_first_step, flat, jmesh)
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_moe_params)
from torch_mesh_ranks import RankGroup

WHOLE = [("blocks", "moe", "router", "kernel"), ("blocks", "ln_2", "scale")]


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.fixture(scope="module")
def weights():
    return np_moe_params(9, 0.04, DIMS["moe"])


def dims(capacity_factor):
    return dict(DIMS["moe"], capacity_factor=capacity_factor)


def loss_fn(jcfg):
    return lambda p, i: jtrain.moe_lm_loss(p, i, jcfg, AUX)


_GRADS = {}


def jax_grads(np_params, capacity_factor):
    """``jax.grad`` of the MoE loss on one device, once a capacity."""
    if capacity_factor not in _GRADS:
        jcfg = jmoe.MoEConfig(**dims(capacity_factor))
        _GRADS[capacity_factor] = flat(jax.jit(jax.grad(loss_fn(jcfg)))(
            jax.tree.map(jnp.asarray, np_params), jnp.asarray(IDS)))
    return _GRADS[capacity_factor]


def jax_mesh_run(np_params, shape, capacity_factor, adamw_kw):
    """The JAX ``MoETrainStep``'s losses over ``STEPS`` steps on ``shape``
    and its parameters after the first."""
    jcfg = jmoe.MoEConfig(**dims(capacity_factor))
    step = jtrain.MoETrainStep(jcfg, jtrain.adamw(1e-3, **adamw_kw),
                               mesh=jmesh(shape), aux_weight=AUX)
    p, s = step.init(jax.tree.map(jnp.asarray, np_params))
    losses, first = [], None
    for i in range(STEPS):
        p, s, loss = step(p, s, jnp.asarray(IDS, jnp.int32))
        losses.append(float(loss))
        if i == 0:
            first = flat(p)
    return losses, first


def run_case(ranks, np_params, shape, capacity_factor=1.25,
             adamw_kw=None):
    """The port's mesh step on the ranks and the JAX one here, at once,
    checked against each other; returns the ranks' results."""
    adamw_kw = adamw_kw or {}
    ranks.submit("torch_train_ranks:train", family="moe",
                 cfg_kw=dims(capacity_factor), np_params=np_params, ids=IDS,
                 shape=shape, steps=STEPS, adamw_kw=adamw_kw,
                 aux_weight=AUX, whole=WHOLE)
    want = jax_grads(np_params, capacity_factor)
    jlosses, jparams = jax_mesh_run(np_params, shape, capacity_factor,
                                    adamw_kw)
    res = ranks.results()
    for r in res:
        assert r["losses"] == res[0]["losses"]   # every rank's global mean
        for path in WHOLE:
            np.testing.assert_allclose(r["whole"][path], want[path],
                                       rtol=2e-4, atol=1e-6,
                                       err_msg=f"{r['coords']} {path}")
    np.testing.assert_allclose(res[0]["losses"], jlosses, rtol=1e-5)
    got = flat(res[0]["grads"])
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=2e-4,
                                   atol=1e-6, err_msg=str(path))
    got = flat(res[0]["params"])
    assert set(got) == set(jparams)
    for path in jparams:
        check_first_step(got[path], jparams[path], want[path], path)
    return res


@pytest.mark.parametrize("shape", [{"tp": 2, "ep": 2}, {"pp": 2, "ep": 2}],
                         ids=["tp2-ep2", "pp2-ep2"])
def test_moe_mesh_train_step_matches_jax(ranks, weights, shape):
    """Three steps against the JAX GSPMD step. tp splits the heads and
    each expert's FFN (the ``c_proj`` partial sums reduced before the
    bias); pp replicates the step."""
    run_case(ranks, weights, shape)


def test_moe_global_norm_clip_binds_on_tp_and_ep(ranks, weights):
    """tp2 x ep2 with ``grad_clip`` 0.05, far below the gradients' norm:
    an expert kernel split over both ep and tp sums its squares over the
    pair, and the norm equals optax's global norm."""
    kw = dict(grad_clip=0.05)
    res = run_case(ranks, weights, {"tp": 2, "ep": 2}, adamw_kw=kw)
    want = float(optax.global_norm(
        [jnp.asarray(g) for g in jax_grads(weights, 1.25).values()]))
    assert want > 20 * kw["grad_clip"]
    for r in res:
        assert r["norm"] == pytest.approx(want, rel=1e-5)
