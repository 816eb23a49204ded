"""Training: the next-token LM loss, AdamW, and a train step.

Counterpart of ``llm_sharding_demo_tpu/training/train.py``. One step is
an eager forward (each block optionally recomputed in the backward pass,
``remat``), an autograd backward (through the flash-attention kernels
when ``attention_impl="pallas"``, ``ops.flash_attention``), and the
optimizer update. The JAX package's optimizer is an optax chain; here it
is ``AdamW``, plain tensor functions that reproduce that chain step for
step: global-norm clip, Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias correction), decoupled weight decay masked by
``decay_mask``, and the learning-rate schedule read at the pre-increment
step count. Moments are kept in each parameter's dtype, as optax keeps
them.

Unlike the JAX step, which returns new arrays, the update writes the
parameters and moments in place (a step allocates no second copy of
either) and returns the same dicts.

The step runs on the card unless the caller passes ``device="cpu"``.
``MoETrainStep`` trains GPT-2-MoE on the CE loss plus the weighted router
aux loss (``moe_lm_loss``). Sharded training (``mesh=``) and the GPipe
and 1F1B pipeline steps refuse, naming their ROADMAP items.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import family_module, is_moe
from ..models.gpt2 import Params
from ..utils.device import DeviceLike, resolve_device

MESH_ITEM = ("ROADMAP Queue 1 item 14 (multi-device training: dp/tp/sp "
             "meshes over torch.distributed)")
PIPELINE_ITEM = ("ROADMAP Queue 1 item 14 (pipeline-parallel training, "
                 "GPipe and 1F1B, on several cards)")

_DECAYED = ("kernel", "wte", "wpe")
# optax.adamw's defaults, which the JAX package's adamw keeps
B1, B2, EPS = 0.9, 0.999, 1e-8


def _flatten(tree: Params, path: Tuple[str, ...] = ()):
    """``[(path, leaf), ...]`` of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _flatten(v, path + (k,))]
    return [(path, tree)]


def _unflatten(items) -> Params:
    tree: Dict[str, Any] = {}
    for path, leaf in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def decay_mask(params: Params) -> Params:
    """True for the leaves that take weight decay: matmul kernels and the
    embedding tables, never biases or norm scales (the GPT-2 recipe).
    Path-based, as in the JAX package: stacked biases are 2-D too."""
    return _unflatten((path, path[-1] in _DECAYED)
                      for path, _ in _flatten(params))


def lm_loss(params: Params, ids: torch.Tensor, config,
            remat: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy over ``ids`` [B, S] (S >= 2): logits
    for positions ``0..S-2`` predict tokens ``1..S-1``, in f32 whatever
    the activation dtype."""
    logits = family_module(config).forward(params, ids[:, :-1], config,
                                           remat=remat)
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           ids[:, 1:].reshape(-1))


def moe_lm_loss(params: Params, ids: torch.Tensor, config,
                aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token CE plus ``aux_weight`` times the router load-balance
    loss (``models.moe.forward``)."""
    from ..models import moe
    logits, aux = moe.forward(params, ids[:, :-1], config)
    ce = F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                         ids[:, 1:].reshape(-1))
    return ce + aux_weight * aux


def _linear_value(init: float, end: float, steps: int,
                  count: int) -> np.float32:
    """optax.linear_schedule(init, end, steps) at ``count``, in its f32
    arithmetic."""
    if steps <= 0:
        return np.float32(init)
    frac = np.float32(1) - (np.float32(min(max(count, 0), steps))
                            / np.float32(steps))
    return np.float32(init - end) * frac + np.float32(end)


def _cosine_value(init: float, decay_steps: int, count: int) -> np.float32:
    """optax.cosine_decay_schedule(init, decay_steps) (alpha 0, exponent
    1) at ``count``, in its f32 arithmetic."""
    c = np.float32(min(count, decay_steps))
    decayed = np.float32(0.5) * (np.float32(1) + np.cos(
        np.float32(np.pi) * c / np.float32(decay_steps)))
    return np.float32(init) * decayed


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The JAX package's ``adamw`` optax chain as plain tensor functions
    (see the module docstring). ``init(params)`` gives the state (the
    step count and the two moments); ``update(params, grads, state)``
    applies one step in place."""

    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    grad_clip: float = 1.0

    def __post_init__(self):
        if (self.total_steps is not None
                and self.total_steps - self.warmup_steps <= 0):
            raise ValueError(
                f"total_steps={self.total_steps} must exceed warmup_steps="
                f"{self.warmup_steps} (the cosine decay needs steps)")

    def schedule(self, count: int) -> np.float32:
        """The learning rate at step ``count`` (0-based): optax's
        warmup_cosine_decay_schedule(0, lr, warmup, total) with
        ``total_steps``, linear_schedule(0, lr, warmup) with only a
        warmup, else the constant."""
        lr = self.learning_rate
        if self.total_steps is not None:
            if count < self.warmup_steps:
                return _linear_value(0.0, lr, self.warmup_steps, count)
            return _cosine_value(lr, self.total_steps - self.warmup_steps,
                                 count - self.warmup_steps)
        if self.warmup_steps:
            return _linear_value(0.0, lr, self.warmup_steps, count)
        return np.float32(lr)

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = [(path, torch.zeros_like(x)) for path, x in _flatten(params)]
        return {"count": 0, "mu": _unflatten(zeros),
                "nu": _unflatten((path, torch.zeros_like(x))
                                 for path, x in zeros)}

    @torch.no_grad()
    def update(self, params: Params, grads: List[torch.Tensor],
               state: Dict[str, Any]) -> Tuple[Params, Dict[str, Any]]:
        """One step: ``grads`` are the gradients of ``params``' leaves in
        ``_flatten`` order. Writes ``params`` and the moments in place."""
        leaves = _flatten(params)
        mus = [x for _, x in _flatten(state["mu"])]
        nus = [x for _, x in _flatten(state["nu"])]
        # the global norm is summed in f32 (optax sums each leaf in its
        # own dtype; the same for f32 parameters)
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        keep = norm < self.grad_clip
        count = state["count"]
        t = np.float32(count + 1)
        bc1 = float(np.float32(1) - np.float32(B1) ** t)
        bc2 = float(np.float32(1) - np.float32(B2) ** t)
        step = float(-self.schedule(count))
        for (path, p), g, mu, nu in zip(leaves, grads, mus, nus):
            g = torch.where(keep, g, g / norm.to(g.dtype) * self.grad_clip)
            mu.mul_(B1).add_((1 - B1) * g)
            nu.mul_(B2).add_((1 - B2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            if path[-1] in _DECAYED:
                u = u + self.weight_decay * p
            p.add_(step * u)
        state["count"] = count + 1
        return params, state


def adamw(learning_rate: float = 1e-3, weight_decay: float = 0.01,
          warmup_steps: int = 0, total_steps: Optional[int] = None,
          grad_clip: float = 1.0) -> AdamW:
    """The stock GPT training recipe: AdamW (decay masked off biases and
    norm scales) with a global-norm clip, optional linear warmup and
    cosine decay."""
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps,
                 grad_clip)


@dataclasses.dataclass
class TrainStep:
    """A train step bound to ``(config, optimizer)`` on one device.

    ``init(params)`` copies the parameters to the device and builds the
    optimizer state there; ``__call__(params, opt_state, ids)`` runs one
    step and returns ``(params, opt_state, loss)`` (the parameters and
    moments updated in place, the loss an f32 scalar tensor).
    ``loss_fn(params, ids)`` replaces ``lm_loss`` (``MoETrainStep``
    binds the MoE loss)."""

    config: Any
    optimizer: AdamW
    mesh: Any = None
    remat: bool = False
    device: DeviceLike = "cuda"
    loss_fn: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                f"TrainStep(mesh=...) is not ported; sharded training waits "
                f"for {MESH_ITEM}")
        family_module(self.config)  # refuses an unknown family
        if is_moe(self.config) and self.loss_fn is None:
            raise ValueError("MoE models train through MoETrainStep (its "
                             "loss adds the router's aux term)")
        self.device = resolve_device(self.device)

    def init(self, params: Params) -> Tuple[Params, Dict[str, Any]]:
        params = _unflatten((path, x.detach().to(self.device, copy=True))
                            for path, x in _flatten(params))
        return params, self.optimizer.init(params)

    def shard_batch(self, ids) -> torch.Tensor:
        """Token ids as an int64 tensor on the step's device (the JAX
        step's name; one device, nothing to shard)."""
        return torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                               device=self.device)

    def loss_and_grads(self, params: Params,
                       ids) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The step's loss and the gradients of ``params``' leaves (in
        nested-dict order), before the optimizer update."""
        ids = (ids.to(self.device, torch.int64) if torch.is_tensor(ids)
               else self.shard_batch(ids))
        items = [(path, x.detach().requires_grad_())
                 for path, x in _flatten(params)]
        with torch.enable_grad():
            tree = _unflatten(items)
            loss = (lm_loss(tree, ids, self.config, self.remat)
                    if self.loss_fn is None else self.loss_fn(tree, ids))
            grads = torch.autograd.grad(loss, [x for _, x in items])
        return loss.detach(), list(grads)

    def __call__(self, params: Params, opt_state: Dict[str, Any], ids):
        loss, grads = self.loss_and_grads(params, ids)
        params, opt_state = self.optimizer.update(params, grads, opt_state)
        return params, opt_state, loss


def LlamaTrainStep(config, optimizer: AdamW, mesh: Any = None,
                   remat: bool = False,
                   device: DeviceLike = "cuda") -> TrainStep:
    """The llama family's train step: the shared LM loss (``lm_loss``
    dispatches on the config's family)."""
    return TrainStep(config, optimizer, mesh=mesh, remat=remat,
                     device=device)


def MoETrainStep(config, optimizer: AdamW, mesh: Any = None,
                 aux_weight: float = 0.01,
                 device: DeviceLike = "cuda") -> TrainStep:
    """GPT-2-MoE's train step: a ``TrainStep`` with ``moe_lm_loss`` bound.
    ``mesh`` (expert-parallel training) refuses as ``TrainStep``'s does."""
    return TrainStep(config, optimizer, mesh=mesh, device=device,
                     loss_fn=lambda p, ids: moe_lm_loss(p, ids, config,
                                                        aux_weight))


def GPipeTrainStep(config, optimizer: AdamW, mesh: Any = None,
                   n_microbatches: int = 4, remat: bool = False,
                   boundaries: Any = None, schedule: str = "gpipe",
                   virtual_stages: int = 1):
    """Refuses: pipeline-parallel training is not ported."""
    raise NotImplementedError(
        f"GPipeTrainStep (schedule={schedule!r}) is not ported; it waits "
        f"for {PIPELINE_ITEM}")
