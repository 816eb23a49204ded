"""The port's training step against the JAX package's, on the CPU.

The same numpy-carried weights and token ids go through three steps of
the JAX ``TrainStep``/``LlamaTrainStep`` (optax AdamW chain, jitted) and
of the port's (``AdamW`` as plain tensor functions, eager autograd); the
losses and every parameter must agree at atol 2e-5 (f32), one case with
a warmup and a cosine decay so that the schedule's step count is pinned,
one with the llama flash-attention path (both packages'
``FLASH_MIN_SEQ`` pinned to 0, the JAX kernels in interpret mode). The
JAX reference steps are built once per module.

The learning rate is 1e-3 (the JAX ``adamw`` default and the card run's):
Adam scales each gradient by its own running RMS, so a gradient that is
zero in exact arithmetic (GPT-2's key bias: adding a constant to every
score of a row leaves the softmax unchanged) is rounding noise that Adam
turns into a step of up to the learning rate, in another direction on
each side. At 1e-2 that noise reaches 3e-5 after three steps; at 1e-3 it
stays near 3e-6.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.ops import flash_attention as jfa
from llm_sharding_demo_tpu.training import train as jtrain
from llm_sharding_demo_tpu_torch.models import gpt2, llama
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.ops import flash_attention as fa
from llm_sharding_demo_tpu_torch.parallel import distributed, spmd
from llm_sharding_demo_tpu_torch.training import train

ATOL = 2e-5
STEPS = 3
LR = 1e-3
DIMS = {"gpt2": dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2,
                     n_head=4),
        "llama": dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2,
                      n_head=4, n_kv_head=2, intermediate_size=64)}
# (family, attention_impl, adamw keywords)
CASES = {
    "gpt2": ("gpt2", "xla", {}),
    "gpt2-warmup-cosine": ("gpt2", "xla", dict(warmup_steps=2,
                                               total_steps=5)),
    "llama": ("llama", "xla", {}),
    "llama-pallas-warmup": ("llama", "pallas", dict(warmup_steps=2)),
}


def _configs(family, impl):
    if family == "gpt2":
        return (jgpt2.GPT2Config(**DIMS[family], attention_impl=impl),
                gpt2.GPT2Config(**DIMS[family], attention_impl=impl))
    return (jllama.LlamaConfig(**DIMS[family], attention_impl=impl),
            llama.LlamaConfig(**DIMS[family], attention_impl=impl))


def _np_params(family, jcfg):
    init = jgpt2.init_params if family == "gpt2" else jllama.init_params
    return jax.tree.map(np.asarray, init(jcfg, jax.random.PRNGKey(0)))


def _ids():
    return np.random.default_rng(0).integers(0, 97, size=(4, 17))


_REFERENCE = {}


def jax_reference(case):
    """The JAX step's losses and parameters after each of ``STEPS``
    steps, built once per case."""
    if case not in _REFERENCE:
        family, impl, kw = CASES[case]
        jcfg, _ = _configs(family, impl)
        make = (jtrain.TrainStep if family == "gpt2"
                else jtrain.LlamaTrainStep)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jfa, "FLASH_MIN_SEQ", 0)
            step = make(jcfg, jtrain.adamw(LR, **kw))
            p, s = step.init(jax.tree.map(jnp.asarray,
                                          _np_params(family, jcfg)))
            losses = []
            for _ in range(STEPS):
                p, s, loss = step(p, s, jnp.asarray(_ids()))
                losses.append(float(loss))
        flat = {tuple(k.key for k in path): np.asarray(a)
                for path, a in jax.tree_util.tree_leaves_with_path(p)}
        _REFERENCE[case] = (losses, flat)
    return _REFERENCE[case]


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_steps_match_jax(monkeypatch, case):
    family, impl, kw = CASES[case]
    want_losses, want = jax_reference(case)
    monkeypatch.setattr(fa, "FLASH_MIN_SEQ", 0)
    jcfg, cfg = _configs(family, impl)
    make = train.TrainStep if family == "gpt2" else train.LlamaTrainStep
    step = make(cfg, train.adamw(LR, **kw), device="cpu")
    params, state = step.init(params_from_numpy(_np_params(family, jcfg),
                                                device="cpu"))
    losses = []
    for _ in range(STEPS):
        params, state, loss = step(params, state, _ids())
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, atol=ATOL, rtol=0)
    got = dict(train._flatten(params))
    assert set(got) == set(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path].cpu().numpy(), value, atol=ATOL,
                                   rtol=0, err_msg=str(path))
    assert state["count"] == STEPS


def test_lm_loss_matches_jax():
    jcfg, cfg = _configs("llama", "xla")
    npp = _np_params("llama", jcfg)
    want = jtrain.lm_loss(jax.tree.map(jnp.asarray, npp),
                          jnp.asarray(_ids()), jcfg)
    got = train.lm_loss(params_from_numpy(npp, device="cpu"),
                        torch.tensor(_ids()), cfg)
    np.testing.assert_allclose(float(got), float(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("warmup,total", [(0, None), (3, None), (0, 7),
                                          (3, 7), (6, 7)])
def test_adamw_schedule_matches_optax(warmup, total):
    """The learning rate at each step count against the schedule the JAX
    ``adamw`` builds."""
    opt = train.adamw(LR, warmup_steps=warmup, total_steps=total)
    if total is not None:
        ref = optax.warmup_cosine_decay_schedule(0.0, LR, warmup, total)
    elif warmup:
        ref = optax.linear_schedule(0.0, LR, warmup)
    else:
        def ref(count):
            return LR
    for count in range(10):
        np.testing.assert_allclose(float(opt.schedule(count)),
                                   float(ref(jnp.asarray(count))),
                                   rtol=1e-6, atol=0, err_msg=str(count))


def test_decay_mask_matches_jax():
    for family in ("gpt2", "llama"):
        jcfg, _ = _configs(family, "xla")
        npp = _np_params(family, jcfg)
        want = {tuple(k.key for k in path): bool(m) for path, m in
                jax.tree_util.tree_leaves_with_path(jtrain.decay_mask(npp))}
        got = dict(train._flatten(train.decay_mask(
            params_from_numpy(npp, device="cpu"))))
        assert got == want


def test_loss_decreases():
    """The JAX package's single-device check: ten steps at 1e-2."""
    jcfg, cfg = _configs("gpt2", "xla")
    step = train.TrainStep(cfg, train.adamw(1e-2), device="cpu")
    params, state = step.init(params_from_numpy(_np_params("gpt2", jcfg),
                                                device="cpu"))
    ids = np.random.default_rng(0).integers(0, 97, size=(8, 16))
    losses = []
    for _ in range(10):
        params, state, loss = step(params, state, ids)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.9, losses


def test_init_copies_and_step_updates_in_place():
    jcfg, cfg = _configs("llama", "xla")
    source = params_from_numpy(_np_params("llama", jcfg), device="cpu")
    before = source["wte"].clone()
    step = train.LlamaTrainStep(cfg, train.adamw(LR), remat=True,
                                device="cpu")
    params, state = step.init(source)
    wte = params["wte"]
    params, state, loss = step(params, state, _ids())
    assert params["wte"] is wte and not torch.equal(wte, before)
    assert torch.equal(source["wte"], before)
    assert loss.shape == () and not params["wte"].requires_grad


@contextlib.contextmanager
def world_of_one():
    """A one-rank process group in this process (an in-memory store, no
    peer), left when the block ends."""
    distributed.ensure_initialized("cpu")
    try:
        yield
    finally:
        distributed.destroy()


def _steps_agree(a, b, params, what, exact=True):
    """``b`` against ``a`` from the same parameters: the loss and every
    gradient (by path), then one step's parameters; bit for bit where
    ``exact``, else within the 1F1B-against-GPipe bar (rtol 2e-4, atol
    1e-6: a pipeline sums its microbatches' means in another order)."""
    pa, sa = a.init(params)
    pb, sb = b.init(params)
    la, ga = a.loss_and_grads(pa, _ids())
    lb, gb = b.loss_and_grads(pb, _ids())
    grads = dict(zip([p for p, _ in train._flatten(pb)], gb))
    tol = dict(rtol=0, atol=0) if exact else dict(rtol=2e-4, atol=1e-6)
    torch.testing.assert_close(lb, la, **tol, msg=what)
    for (path, _), g in zip(train._flatten(pa), ga):
        torch.testing.assert_close(grads[path], g, **tol,
                                   msg=f"{what} {path}")
    if exact:
        pa, sa, la = a(pa, sa, _ids())
        pb, sb, lb = b(pb, sb, _ids())
        assert float(la) == float(lb), what
        got = dict(train._flatten(pb))
        for path, x in train._flatten(pa):
            assert torch.equal(got[path], x), f"{what} {path}"


def test_refusals():
    jcfg, cfg = _configs("gpt2", "xla")
    opt = train.adamw()
    params = params_from_numpy(_np_params("gpt2", jcfg), device="cpu")
    with world_of_one():
        # mesh training is ported: a world of one rank trains as one
        # device does (the meshes of several ranks are
        # tests/test_torch_mesh_training.py)
        _steps_agree(train.TrainStep(cfg, opt, device="cpu"),
                     train.TrainStep(cfg, opt, device="cpu",
                                     mesh=spmd.make_mesh({"dp": 1, "tp": 1})),
                     params, "TrainStep(mesh=)")
        # the MoE step runs (test_torch_moe holds it to the JAX step), on
        # a mesh too (a tp or sp axis of several ranks refuses:
        # tests/test_torch_mesh_training.py)
        from llm_sharding_demo_tpu_torch.models import moe
        mcfg = moe.MoEConfig(**DIMS["gpt2"], n_experts=4)
        mstep = train.MoETrainStep(mcfg, opt, device="cpu")
        mp, ms = mstep.init(moe.init_params(mcfg, torch.Generator()
                                            .manual_seed(0)))
        _, ms, loss = mstep(mp, ms, _ids())
        assert ms["count"] == 1 and bool(torch.isfinite(loss))
        mstep = train.MoETrainStep(mcfg, opt, device="cpu",
                                   mesh=spmd.make_mesh({"dp": 1, "ep": 1}))
        assert bool(torch.isfinite(mstep.loss_and_grads(
            mstep.init(mp)[0], _ids())[0]))
        # the 1F1B pipeline step runs (one stage here; several:
        # tests/test_torch_1f1b.py), and a mesh without a pp axis refuses
        # with the JAX package's message
        _steps_agree(train.TrainStep(cfg, opt, device="cpu"),
                     train.GPipeTrainStep(cfg, opt, spmd.make_mesh({"pp": 1}),
                                          n_microbatches=2, schedule="1f1b",
                                          device="cpu"),
                     params, "GPipeTrainStep(schedule='1f1b')", exact=False)
        with pytest.raises(ValueError) as err:
            train.GPipeTrainStep(cfg, opt, spmd.make_mesh({"dp": 1}),
                                 device="cpu")
    with pytest.raises(ValueError) as jerr:
        jtrain.GPipeTrainStep(jcfg, jtrain.adamw(), jax.sharding.Mesh(
            np.asarray(jax.devices()[:1]), ("dp",)))
    assert str(err.value) == str(jerr.value)
    with pytest.raises(TypeError, match="unknown model config type"):
        train.TrainStep(jcfg, opt, device="cpu")  # another package's config
    with pytest.raises(ValueError, match="total_steps"):
        train.adamw(warmup_steps=5, total_steps=5)
    if not torch.cuda.is_available():
        # the step runs on the card unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            train.TrainStep(cfg, opt)
