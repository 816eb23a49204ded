"""Rank cases of the port's mesh-training tests (``RankGroup.run`` with
``"torch_train_ranks:<case>"``).

Each case runs on every rank of a spawned gloo group with the same
arguments and returns this rank's result. Like ``torch_mesh_ranks``, this
module imports only numpy, torch and the port: the JAX reference runs in
the test process. Results are numpy (trees as nested dicts), with the
rank's mesh coordinates where the test must pick among ranks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def _model(family: str, cfg_kw: dict, np_params):
    from torch_mesh_ranks import _model as model
    return model(family, cfg_kw, np_params)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    # a copy: an unsplit leaf comes back as the live tensor, which later
    # steps update in place
    return tree.detach().float().numpy().copy()


def _tree(params, grads):
    from llm_sharding_demo_tpu_torch.training import train
    return train._unflatten(zip([p for p, _ in train._flatten(params)],
                                grads))


def _coords(mesh) -> Dict[str, int]:
    from llm_sharding_demo_tpu_torch.parallel import spmd
    return {a: spmd.axis_rank(mesh, a) for a in mesh.mesh_dim_names}


# -- ring attention -------------------------------------------------------------


def ring(q, k, v, shape: dict, grad: bool = False) -> dict:
    """This rank's chunk of ``ring_attention`` over the global q/k/v
    (``[B, H, S, hd]``), and with ``grad`` the gradients of the sum of
    the squares of the output of its chunks."""
    import torch
    from llm_sharding_demo_tpu_torch.ops.ring_attention import (
        local_chunk, ring_attention)
    from llm_sharding_demo_tpu_torch.parallel import spmd
    mesh = spmd.make_mesh(shape)
    ql, kl, vl = (local_chunk(torch.tensor(x), mesh).clone()
                  .requires_grad_(grad) for x in (q, k, v))
    out = ring_attention(ql, kl, vl, mesh)
    res: Dict[str, Any] = {"coords": _coords(mesh),
                           "out": out.detach().numpy()}
    if grad:
        (out ** 2).sum().backward()
        res["grads"] = [x.grad.numpy() for x in (ql, kl, vl)]
    return res


def ring_errors(shape: dict) -> list:
    """The messages of a length the axis does not divide and of an axis
    the mesh lacks."""
    import torch
    from llm_sharding_demo_tpu_torch.ops.ring_attention import (
        local_chunk, ring_attention)
    from llm_sharding_demo_tpu_torch.parallel import spmd
    mesh = spmd.make_mesh(shape)
    z = torch.zeros(1, 2, 10, 4)
    out = []
    for call in (lambda: local_chunk(z, mesh),
                 lambda: ring_attention(z, z, z, mesh, axis="xx")):
        try:
            call()
            out.append("")
        except ValueError as e:
            out.append(str(e))
    return out


def ring_ragged(shape: dict, dims: dict, np_params) -> str:
    """The message of a ragged (``k_valid_from``) batch into GPT-2's ring
    blocks on a mesh."""
    import dataclasses

    import torch
    from llm_sharding_demo_tpu_torch.models import gpt2
    from llm_sharding_demo_tpu_torch.parallel import spmd
    config, params = _model("gpt2", dims, np_params)
    config = dataclasses.replace(config, attention_impl="ring")
    h = torch.zeros(1, 4, config.n_embd)
    try:
        gpt2.apply_blocks(params["blocks"], h, config,
                          k_valid_from=torch.zeros(1, dtype=torch.int64),
                          mesh=spmd.make_mesh(shape))
    except NotImplementedError as e:
        return str(e)
    return ""


# -- forward and TrainStep on a mesh ----------------------------------------------


def forward(family: str, cfg_kw: dict, np_params, ids, shape: dict):
    """``forward(params, ids, config, mesh=)`` of this rank's slices: the
    whole batch's logits (rank 0), the error's message where one is
    raised."""
    import torch
    from llm_sharding_demo_tpu_torch.models import family_module
    from llm_sharding_demo_tpu_torch.parallel import distributed, spmd
    from llm_sharding_demo_tpu_torch.training.train import _pspec_fn
    config, params = _model(family, cfg_kw, np_params)
    mesh = spmd.make_mesh(shape)
    local = spmd.shard_params(params, mesh, _pspec_fn(config)(mesh))
    with torch.no_grad():
        logits = family_module(config).forward(
            local, torch.as_tensor(np.asarray(ids)), config, mesh=mesh)
    if isinstance(logits, tuple):
        logits = logits[0]
    return logits.numpy() if distributed.rank() == 0 else None


def train(family: str, cfg_kw: dict, np_params, ids, shape: dict,
          steps: int = 1, adamw_kw: Optional[dict] = None,
          aux_weight: float = 0.01, whole=()) -> dict:
    """The mesh step (``TrainStep``, ``LlamaTrainStep`` or
    ``MoETrainStep`` by family): its first loss, gradients (unsharded)
    and global norm, each rank's own gradient of the first norm scale (a
    replicated leaf) and of each path in ``whole`` (``"whole"``), the
    losses of ``steps`` steps and the parameters after the first
    (unsharded; rank 0 returns the trees), and the expert choices that
    capacity dropped in the first step's forward, of this rank's tokens
    (``"dropped"``, 0 for a dense family)."""
    from llm_sharding_demo_tpu_torch.models import moe
    from llm_sharding_demo_tpu_torch.parallel import distributed, spmd
    from llm_sharding_demo_tpu_torch.training import train as T
    config, params = _model(family, cfg_kw, np_params)
    mesh = spmd.make_mesh(shape)
    opt = T.adamw(1e-3, **(adamw_kw or {}))
    if family == "moe":
        step = T.MoETrainStep(config, opt, mesh=mesh, aux_weight=aux_weight,
                              device="cpu")
    elif family == "llama":
        step = T.LlamaTrainStep(config, opt, mesh=mesh, device="cpu")
    else:
        step = T.TrainStep(config, opt, mesh=mesh, device="cpu")
    p, s = step.init(params)
    with moe.counting_drops() as drops:
        loss, grads = step.loss_and_grads(p, ids)
    gtree = _tree(p, grads)
    ln = "ln_attn" if family == "llama" else "ln_1"
    by_path = dict(T._flatten(gtree))
    out = {"coords": _coords(mesh), "loss0": float(loss),
           "norm": float(step.mesh_norm(p, grads)),
           "ln_grad": gtree["blocks"][ln]["scale"].numpy().copy(),
           "whole": {tuple(path): by_path[tuple(path)].numpy().copy()
                     for path in whole},
           "dropped": int(sum(int(n) for n in drops))}
    full_grads = _np(spmd.unshard_params(gtree, mesh, step._specs))
    losses = []
    for i in range(steps):
        p, s, loss = step(p, s, ids)
        losses.append(float(loss))
        if i == 0:
            first = _np(spmd.unshard_params(p, mesh, step._specs))
    out["losses"] = losses
    if distributed.rank() == 0:
        out["grads"], out["params"] = full_grads, first
    return out


def unshard_roundtrip(family: str, cfg_kw: dict, np_params,
                      shape: dict) -> bool:
    """``unshard_params(shard_params(p))`` equals ``p`` bit for bit (the
    family's table; GPT-2's fused ``c_attn`` split by head)."""
    import torch
    from llm_sharding_demo_tpu_torch.parallel import spmd
    from llm_sharding_demo_tpu_torch.training import train as T
    config, params = _model(family, cfg_kw, np_params)
    mesh = spmd.make_mesh(shape)
    table = T._pspec_fn(config)(mesh)
    back = spmd.unshard_params(spmd.shard_params(params, mesh, table), mesh,
                               table)
    return all(torch.equal(a, b) for (_, a), (_, b)
               in zip(T._flatten(back), T._flatten(params)))


# -- pipelines ------------------------------------------------------------------


def _pipe_step(family, cfg_kw, np_params, shape, **kw):
    from llm_sharding_demo_tpu_torch.parallel import spmd
    from llm_sharding_demo_tpu_torch.training import train as T
    config, params = _model(family, cfg_kw, np_params)
    mesh = spmd.make_mesh(shape)
    step = T.GPipeTrainStep(config, T.adamw(kw.pop("lr", 1e-3)), mesh,
                            device="cpu", **kw)
    return config, params, mesh, step


def pipe(family: str, cfg_kw: dict, np_params, ids, shape: dict,
         steps: int = 0, **kw) -> dict:
    """A ``GPipeTrainStep`` (``kw``: its schedule, microbatches,
    boundaries, virtual stages, remat): this rank's coordinates, its
    stage's first loss and gradients (unsharded over tp: the stage's
    blocks and the embed/head leaves), the stash's high-water mark, the
    losses of ``steps`` steps and the rank's parameters after the first
    (unsharded over tp)."""
    from llm_sharding_demo_tpu_torch.parallel import spmd
    config, params, mesh, step = _pipe_step(family, cfg_kw, np_params,
                                            shape, **kw)
    p, s = step.init(params)
    loss, grads = step.loss_and_grads(p, ids)
    out = {"coords": _coords(mesh), "loss0": float(loss),
           "grads": _np(spmd.unshard_params(_tree(p, grads), mesh,
                                            step._table)),
           "high": step.stash_high_water}
    losses = []
    for i in range(steps):
        p, s, loss = step(p, s, ids)
        losses.append(float(loss))
        if i == 0:
            out["params"] = _np(spmd.unshard_params(p, mesh, step._table))
    out["losses"] = losses
    return out


def pipe_forward(family: str, cfg_kw: dict, np_params, h, ids, shape: dict,
                 n_micro: int, boundaries=None) -> dict:
    """``gpipe_apply_blocks`` over the hidden states ``h`` [B, s, D] in
    ``n_micro`` microbatches (the blocks' outputs on every rank) and the
    forward-only ``gpipe_lm_loss`` of ``ids``."""
    import torch
    from llm_sharding_demo_tpu_torch.parallel import gpipe
    from llm_sharding_demo_tpu_torch.training import train as T
    config, params, mesh, step = _pipe_step(
        family, cfg_kw, np_params, shape, n_microbatches=n_micro,
        boundaries=boundaries)
    p, _ = step.init(params)
    hm = gpipe.microbatch(torch.tensor(h), n_micro)
    with torch.no_grad():
        out = gpipe.gpipe_apply_blocks(
            p["blocks"], hm if step.spec.is_first else None, config, mesh,
            shape=hm.shape, dtype=hm.dtype)
    loss = T.gpipe_lm_loss(p, ids, config, mesh, n_micro)
    return {"out": gpipe.unmicrobatch(out).numpy(), "loss": float(loss),
            "stage": [step.spec.start, step.spec.end]}


def pipe_errors(family: str, cfg_kw: dict, np_params, cases: list) -> list:
    """The message each ``(mesh shape, GPipeTrainStep keywords)`` raises
    ("" where none)."""
    out = []
    for shape, kw in cases:
        try:
            _pipe_step(family, cfg_kw, np_params, shape, **kw)
            out.append("")
        except (ValueError, NotImplementedError) as e:
            out.append(f"{type(e).__name__}: {e}")
    return out
