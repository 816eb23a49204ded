"""The port's GPipe pipeline training (``GPipeTrainStep``,
``schedule="gpipe"``) on gloo ranks against the JAX package's on its
forced host devices.

One module-scoped group of four spawned CPU ranks runs every port case
(``torch_train_ranks``); each rank is one pipeline stage (with dp or tp
beside pp where the mesh has them) and holds only its stage's blocks.
The JAX reference runs here, beside the ranks. Weights come from numpy:
GPT-2 with 4 layers (6 for the 2-2-1-1 stages), n_embd 128 and 2 heads,
llama with n_embd 256 and 4 query heads over 2 kv heads; ids ``[8, 17]``.
Uneven stages against the JAX padded step: ``test_torch_gpipe_uneven.py``
(the same helpers).
``parallel.partition`` carries gradients between the JAX package's
stage-major layouts and the ranks' stage blocks.

Tolerances (f32): forwards within 1e-5 of JAX's ``gpipe_apply_blocks``;
each step's loss within 1e-5 relative of the JAX pipeline step's on the
same mesh shape, and within 5e-3 of the JAX one-device step's over three
steps (the JAX 1F1B test's trajectory bar); first-step gradients within
rtol 2e-4 / atol 1e-6 of ``jax.grad``'s; parameters after one step as in
``test_torch_mesh_training.check_first_step``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.models import moe as jmoe
from llm_sharding_demo_tpu.parallel import gpipe as jgpipe
from llm_sharding_demo_tpu.parallel import partition as jpartition
from llm_sharding_demo_tpu.parallel import spmd as jspmd
from llm_sharding_demo_tpu.training import train as jtrain
from llm_sharding_demo_tpu_torch.parallel import gpipe
from llm_sharding_demo_tpu_torch.parallel import partition as P_
from test_torch_llama import np_llama_params
from test_torch_mesh_training import check_first_step, flat
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params,
                              np_moe_params)
from torch_mesh_ranks import RankGroup

DIMS = {"gpt2": dict(vocab_size=211, n_positions=64, n_embd=128, n_layer=4,
                     n_head=2),
        "gpt2-6": dict(vocab_size=211, n_positions=64, n_embd=128,
                       n_layer=6, n_head=2),
        "llama": dict(vocab_size=211, n_positions=64, n_embd=256, n_layer=4,
                      n_head=4, n_kv_head=2, intermediate_size=384)}
IDS = np.random.default_rng(6).integers(0, 211, size=(8, 17))
STEPS = 3


def family_of(name):
    return "llama" if name.startswith("llama") else "gpt2"


def jconfig(name):
    cls = jllama.LlamaConfig if family_of(name) == "llama" else \
        jgpt2.GPT2Config
    return cls(**DIMS[name])


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(4)
    yield group
    group.close()


@pytest.fixture(scope="module")
def weights():
    return {"gpt2": np_gpt2_params(seed=11, dims=DIMS["gpt2"]),
            "gpt2-6": np_gpt2_params(seed=12, dims=DIMS["gpt2-6"]),
            "llama": np_llama_params(seed=11, dims=DIMS["llama"])}


def jmesh(shape):
    return jspmd.make_mesh(shape, jax.devices()[:int(np.prod(
        list(shape.values())))])


def jp(np_params):
    return jax.tree.map(jnp.asarray, np_params)


_SINGLE = {}


def jax_single(name, np_params):
    """The JAX one-device step's losses over ``STEPS`` steps and
    ``jax.grad`` of the loss at the weights (flat), once per model."""
    if name not in _SINGLE:
        jcfg = jconfig(name)
        make = (jtrain.LlamaTrainStep if family_of(name) == "llama"
                else jtrain.TrainStep)
        step = make(jcfg, jtrain.adamw(1e-3))
        p, s = step.init(jp(np_params))
        losses = []
        for _ in range(STEPS):
            p, s, loss = step(p, s, jnp.asarray(IDS))
            losses.append(float(loss))
        grads = flat(jax.jit(jax.grad(lambda p, i: jtrain.lm_loss(
            p, i, jcfg)))(jp(np_params), jnp.asarray(IDS)))
        _SINGLE[name] = losses, grads
    return _SINGLE[name]


def jax_pipeline(name, np_params, shape, **kw):
    """The JAX ``GPipeTrainStep``'s losses over ``STEPS`` steps and its
    parameters after the first, unstacked to the standard layout."""
    step = jtrain.GPipeTrainStep(jconfig(name), jtrain.adamw(1e-3),
                                 jmesh(shape), **kw)
    p, s = step.init(jp(np_params))
    ids = step.shard_batch(IDS)
    losses, first = [], None
    for i in range(STEPS):
        p, s, loss = step(p, s, ids)
        losses.append(float(loss))
        if i == 0:
            first = jax_standard(p, step)
    return losses, first


def jax_standard(gp, step):
    """A JAX pipeline tree as the standard ``[L, ...]`` tree (flat)."""
    stacked = jax.tree.map(np.asarray, gp["stacked_blocks"])
    if step.virtual_stages > 1:
        blocks = P_.unstack_virtual_chunks(torch_tree(stacked))
    elif step._equal:
        blocks = P_.unstack_stage_params(torch_tree(stacked))
    else:
        blocks = P_.unstack_stage_params_padded(torch_tree(stacked),
                                                port_specs(step._specs))
    out = {("blocks",) + k: v.numpy() for k, v in flat_torch(blocks)}
    out.update({k: v for k, v in flat({k: gp[k] for k in gp
                                       if k != "stacked_blocks"}).items()})
    return out


def port_specs(jspecs):
    return [P_.StageSpec(s.index, s.n_stages, s.start, s.end)
            for s in jspecs]


def torch_tree(tree):
    if isinstance(tree, dict):
        return {k: torch_tree(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree))


def flat_torch(tree, prefix=()):
    if isinstance(tree, dict):
        return [item for k in tree for item in flat_torch(tree[k],
                                                          prefix + (k,))]
    return [(prefix, tree)]


def stage_major(res, key, n_virtual=1):
    """The ranks' stage trees (``key``: "grads" or "params") as one flat
    standard tree: the blocks of the first rank of each stage laid end to
    end (``partition.blocks_from_stages``), the embed and head leaves
    (equal on every rank) from rank 0."""
    first = {}
    for r in res:
        c = r["coords"]
        if all(v == 0 for a, v in c.items() if a != "pp"):
            first[c["pp"]] = r
    stages = [torch_tree(first[i][key]["blocks"]) for i in sorted(first)]
    blocks = P_.blocks_from_stages(stages, n_virtual)
    out = {("blocks",) + k: v.numpy() for k, v in flat_torch(blocks)}
    out.update({k: v for k, v in flat({k: res[0][key][k]
                                       for k in res[0][key]
                                       if k != "blocks"}).items()})
    return out


def check_pipeline(res, jlosses, jfirst, single, n_virtual=1,
                   rel=1e-5):
    """Every rank's losses equal; each step's within ``rel`` of the JAX
    pipeline's and 5e-3 of the one-device step's; the first gradients
    within rtol 2e-4 / atol 1e-6 of jax.grad's; the parameters after the
    first step (``check_first_step``)."""
    slosses, sgrads = single
    for r in res:
        assert r["losses"] == res[0]["losses"]
    np.testing.assert_allclose(res[0]["losses"], jlosses, rtol=rel)
    for g, w in zip(res[0]["losses"], slosses):
        assert abs(g - w) <= 5e-3 * max(1.0, abs(w)), (res[0]["losses"],
                                                       slosses)
    got = stage_major(res, "grads", n_virtual)
    assert set(got) == set(sgrads)
    for path in sgrads:
        np.testing.assert_allclose(got[path], sgrads[path], rtol=2e-4,
                                   atol=1e-6, err_msg=str(path))
    if jfirst is not None:
        got = stage_major(res, "params", n_virtual)
        for path in jfirst:
            check_first_step(got[path], jfirst[path], sgrads[path], path)


def pipe_beside_jax(ranks, name, np_params, shape, jax_kw=None, **kw):
    """The port's pipeline step (``kw``) on the ranks and the JAX one
    (``jax_kw``, default the same keywords) here, at once."""
    ranks.submit("torch_train_ranks:pipe", family=family_of(name),
                 cfg_kw=DIMS[name], np_params=np_params, ids=IDS,
                 shape=shape, steps=STEPS, **kw)
    single = jax_single(name, np_params)
    jrun = jax_pipeline(name, np_params, shape, **(jax_kw or kw))
    return ranks.results(120.0), jrun, single


@pytest.mark.parametrize("pp,n_micro", [(2, 2), (4, 4)])
def test_gpipe_forward_and_loss_match_jax(ranks, weights, pp, n_micro):
    """``gpipe_apply_blocks`` (every stage's blocks over microbatched
    hidden states, the outputs on every rank) and the forward-only
    ``gpipe_lm_loss``, against the JAX package's."""
    np_params = weights["gpt2"]
    jcfg = jconfig("gpt2")
    h = np.random.default_rng(0).normal(size=(4, 10, 128)).astype(np.float32)
    ranks.submit("torch_train_ranks:pipe_forward", family="gpt2",
                 cfg_kw=DIMS["gpt2"], np_params=np_params, h=h, ids=IDS,
                 shape={"pp": pp, "dp": 4 // pp}, n_micro=n_micro)
    mesh = jmesh({"pp": pp, "dp": 4 // pp})
    specs = jpartition.make_stage_specs(
        4, jpartition.balanced_boundaries(4, pp))
    stacked = jgpipe.shard_stacked_blocks(
        jpartition.stack_stage_params(jp(np_params), specs), mesh)
    want = np.asarray(jgpipe.unmicrobatch(jgpipe.gpipe_apply_blocks(
        stacked, jgpipe.microbatch(jnp.asarray(h), n_micro), jcfg, mesh)))
    step = jtrain.GPipeTrainStep(jcfg, jtrain.adamw(), mesh,
                                 n_microbatches=n_micro)
    gp, _ = step.init(jp(np_params))
    jloss = float(jax.jit(lambda p, i: jtrain.gpipe_lm_loss(
        p, i, jcfg, mesh, n_micro))(gp, jnp.asarray(IDS)))
    res = ranks.results()
    assert [r["stage"] for r in res[::4 // pp]] == [[s.start, s.end]
                                                   for s in specs]
    for r in res:
        np.testing.assert_allclose(r["out"], want, atol=1e-5, rtol=1e-5)
        assert r["loss"] == pytest.approx(jloss, rel=1e-5)


def test_gpipe_training_matches_jax(ranks, weights):
    """dp2 x pp2, M = 2, remat: three steps."""
    res, jrun, single = pipe_beside_jax(
        ranks, "gpt2", weights["gpt2"], {"dp": 2, "pp": 2},
        n_microbatches=2, remat=True)
    check_pipeline(res, *jrun, single)


def test_gpipe_with_tp_matches_jax(ranks, weights):
    """pp2 x tp2: each stage's blocks split over tp, the per-block
    collectives inside the stage."""
    res, jrun, single = pipe_beside_jax(
        ranks, "gpt2", weights["gpt2"], {"pp": 2, "tp": 2},
        n_microbatches=2)
    check_pipeline(res, *jrun, single)


def test_gpipe_llama_matches_jax(ranks, weights):
    res, jrun, single = pipe_beside_jax(
        ranks, "llama", weights["llama"], {"dp": 2, "pp": 2},
        n_microbatches=2)
    check_pipeline(res, *jrun, single)


@pytest.mark.parametrize("layout", ["equal", "padded", "interleaved"])
def test_stage_major_layouts_match_jax(weights, layout):
    """``parallel.partition``'s carriers between the standard ``[L, ...]``
    tree and the JAX package's stage-major layouts: each stacking equal
    to JAX's, bit for bit, and its inverse giving back the blocks."""
    np_params = weights["gpt2-6"]
    tree = torch_tree(np_params)
    if layout == "equal":
        jspecs = jpartition.make_stage_specs(6, [2, 4])
        got = P_.stack_stage_params(tree, port_specs(jspecs))
        want = jpartition.stack_stage_params(jp(np_params), jspecs)
        back = P_.unstack_stage_params(got)
    elif layout == "padded":
        jspecs = jpartition.make_stage_specs(6, [2, 4, 5])
        got, valid = P_.stack_stage_params_padded(tree, port_specs(jspecs))
        want, jvalid = jpartition.stack_stage_params_padded(jp(np_params),
                                                            jspecs)
        assert valid.tolist() == np.asarray(jvalid).tolist()
        back = P_.unstack_stage_params_padded(got, port_specs(jspecs))
    else:
        got = P_.stack_virtual_chunks(tree, 3, 2)
        want = jpartition.stack_virtual_chunks(jp(np_params), 3, 2)
        back = P_.unstack_virtual_chunks(got)
        for d in range(3):
            chunks = P_.virtual_chunks(tree["blocks"], 3, 2, d)
            stacked = dict(flat_torch(got))
            for path, a in flat_torch(chunks):
                assert torch.equal(a, stacked[path][d])
    for mine, theirs in ((got, torch_tree(jax.tree.map(np.asarray, want))),
                         (back, tree["blocks"])):
        theirs = dict(flat_torch(theirs))
        assert set(theirs) == {path for path, _ in flat_torch(mine)}
        for path, a in flat_torch(mine):
            assert torch.equal(a, theirs[path]), path


def jax_error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def test_gpipe_validation_messages_equal_jax(ranks, weights):
    jcfg = jconfig("gpt2")
    cases = [({"dp": 4}, {}),
             ({"pp": 2, "dp": 2}, dict(boundaries=[1, 2, 3])),
             ({"pp": 2, "dp": 2}, dict(schedule="zb")),
             ({"pp": 2, "dp": 2}, dict(virtual_stages=0))]
    want = [jax_error(lambda: jtrain.GPipeTrainStep(
        jcfg, jtrain.adamw(), jmesh(shape), **kw)) for shape, kw in cases]
    assert all(want)
    got = ranks.run("torch_train_ranks:pipe_errors", family="gpt2",
                    cfg_kw=DIMS["gpt2"], np_params=weights["gpt2"],
                    cases=cases)
    assert all(g == want for g in got), (got, want)
    # MoE does not stage: JAX's message, before any mesh check
    mdims = dict(DIMS["gpt2"], n_layer=2, n_experts=4)
    jmsg = jax_error(lambda: jtrain.GPipeTrainStep(
        jmoe.MoEConfig(**mdims), jtrain.adamw(), jmesh({"pp": 4})))
    got = ranks.run("torch_train_ranks:pipe_errors", family="moe",
                    cfg_kw=mdims, np_params=np_moe_params(0, 0.04, mdims),
                    cases=[({"pp": 4}, {})])
    assert jmsg.startswith("NotImplementedError: GPipe covers")
    assert all(g == [jmsg] for g in got)
    # microbatching: JAX's message
    jmsg = jax_error(lambda: jgpipe.microbatch(jnp.zeros((5, 2, 2)), 2))
    assert jax_error(lambda: gpipe.microbatch(torch.zeros(5, 2, 2), 2)) == \
        jmsg
