"""GPipe pipeline-parallel training over ``torch.distributed``.

Counterpart of ``llm_sharding_demo_tpu/parallel/gpipe.py``. The JAX
package runs every stage inside one jitted SPMD program: the blocks
stacked stage-major over the ``pp`` axis, a ``lax.scan`` over M + S - 1
ticks, activations crossing the ring by ``ppermute``, and reverse-mode AD
through the whole schedule. Here each pipeline stage is one process (a
rank of the mesh's ``pp`` axis) and the schedule is written out:

- a rank holds only its stage's blocks (uneven stages need no padded
  stacking) and the embed and head leaves, whole;
- the batch is split into M microbatches; the first stage embeds each,
  every stage runs its blocks and hands the activation on
  (``distributed.hop``), and the last stage applies the head and takes
  the loss. Each rank keeps its M microbatch graphs (with ``remat`` each
  block's activations are recomputed in the backward pass);
- then the backward, microbatch by microbatch: the last stage from its
  loss, every other stage from the gradient the next stage sends back,
  each handing its input's gradient to the stage before;
- the embed and head leaves' gradients sum over the ``pp`` group (GPT-2's
  tied ``wte`` takes the embedding's share on the first stage and the
  head's on the last).

Other mesh axes ride inside a stage as in ``TrainStep``: its ``dp`` rows,
its ``sp`` chunk, its ``tp`` slices (``PipeStage``). The stages run no
bubble ticks: the JAX program computes and masks them where tp or sp
put collectives inside its blocks.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.gpt2 import Params
from ..training.train import _flatten, _unflatten
from . import distributed, spmd

# Placement contract (utils/graftshard): ``pp`` is the axis of the stage
# blocks; tp and sp ride inside the blocks.
PLACEMENT_CONTRACT = {
    "mesh_axes": ("pp", "tp", "sp"),
    "entry:gpipe_loss_and_grads": "pp",
}

# the embed and head leaves a pipeline rank holds whole, by family
SHARED = ("wte", "wpe", "ln_f", "lm_head")


def microbatch(h: torch.Tensor, n_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]; B must divide by M."""
    b = h.shape[0]
    if b % n_microbatches:
        raise ValueError(
            f"batch {b} not divisible by n_microbatches={n_microbatches}")
    return h.reshape((n_microbatches, b // n_microbatches)
                     + tuple(h.shape[1:]))


def unmicrobatch(h: torch.Tensor) -> torch.Tensor:
    """[M, mb, ...] -> [M*mb, ...]."""
    return h.reshape((h.shape[0] * h.shape[1],) + tuple(h.shape[2:]))


class PipeStage:
    """This rank's place in a pipeline: its stage on the ``pp`` axis, the
    groups of the other axes, and the family's pieces (embed, blocks,
    head) at the rank's shard: its sp chunk's global positions, its tp
    slices."""

    def __init__(self, config, mesh):
        from ..models import family_module, llama
        from ..models.gpt2 import tp_config
        self.config, self.mesh = config, mesh
        self.family = family_module(config)
        self.is_llama = isinstance(config, llama.LlamaConfig)
        self.n_stages = spmd.axis_size(mesh, "pp")
        self.stage = spmd.axis_rank(mesh, "pp")
        self.pp = spmd.group(mesh, "pp")
        self.tp = spmd.group(mesh, "tp")
        self.local_config = tp_config(config, self.tp)

    @property
    def is_first(self) -> bool:
        return self.stage == 0

    @property
    def is_last(self) -> bool:
        return self.stage == self.n_stages - 1

    def embed(self, params: Params, ids: torch.Tensor) -> torch.Tensor:
        """The first stage's input: ids [mb, s] at their global
        positions."""
        if self.is_llama:
            return self.family.embed(params, ids)
        return self.family.embed(params, ids,
                                 spmd.seq_offset(self.mesh, ids.shape[1]))

    def blocks(self, blocks: Params, h: torch.Tensor,
               remat: bool = False) -> torch.Tensor:
        """A stack of this rank's blocks over ``h`` [mb, s, D]."""
        kw = dict(remat=remat, tp_group=self.tp, mesh=self.mesh)
        if self.is_llama:
            s = h.shape[1]
            cos, sin = self.family.angles(
                self.config, s, spmd.seq_offset(self.mesh, s), None,
                h.device)
            return self.family.apply_blocks(blocks, h, self.local_config,
                                            cos, sin, **kw)[0]
        return self.family.apply_blocks(blocks, h, self.local_config,
                                        **kw)[0]

    def logits(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        if self.is_llama:
            return self.family.final_logits(params, h, self.config)
        return self.family.final_logits(params, h,
                                        self.config.layer_norm_epsilon)

    def head_loss(self, params: Params, h: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
        """Mean next-token cross-entropy (f32) of one microbatch."""
        logits = self.logits(params, h)
        return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                               labels.reshape(-1))

    def act_shape(self, ids: torch.Tensor) -> Tuple[int, int, int]:
        return (ids.shape[0], ids.shape[1], self.config.n_embd)

    def shared_grads_sum(self, leaves: Sequence[Tuple[Tuple[str, ...],
                                                      torch.Tensor]],
                         grads: List[torch.Tensor]) -> None:
        """In place: the embed and head leaves' gradients summed over the
        pp group (one f32 transfer)."""
        idx = [i for i, (path, _) in enumerate(leaves) if path[0] in SHARED]
        if self.pp is None or not idx:
            return
        flat = torch.cat([grads[i].reshape(-1).float() for i in idx])
        distributed.all_reduce_sum(flat, self.pp)
        off = 0
        for i in idx:
            n = grads[i].numel()
            grads[i].copy_(flat[off:off + n].view_as(grads[i]))
            off += n

    def loss_to_all(self, loss: Optional[torch.Tensor],
                    dev: torch.device) -> torch.Tensor:
        """The last stage's loss on every pp rank."""
        out = (loss.detach().float().reshape(1).clone() if self.is_last
               else torch.zeros(1, dtype=torch.float32, device=dev))
        if self.pp is not None:
            distributed.broadcast(out, self.n_stages - 1, self.pp)
        return out[0]


def tracked_leaves(params: Params):
    """``(items, tree)``: detached copies of ``params``' leaves that
    require grad (``[(path, leaf)]`` in nested-dict order) and the tree
    over them."""
    items = [(path, x.detach().requires_grad_())
             for path, x in _flatten(params)]
    return items, _unflatten(items)


def leaf_grads(items) -> List[torch.Tensor]:
    """Each leaf's accumulated gradient, zeros where the rank never used
    it (the embeddings on a middle stage)."""
    return [x.grad if x.grad is not None else torch.zeros_like(x)
            for _, x in items]


def gpipe_apply_blocks(stage_blocks: Params, h_micro: Optional[torch.Tensor],
                       config, mesh, remat: bool = False,
                       shape: Optional[Sequence[int]] = None,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Microbatched hidden states ``[M, mb, s, D]`` through every stage's
    blocks (the forward alone): the first stage takes ``h_micro``, each
    stage hands each microbatch on, and the last stage's outputs are
    broadcast to every pp rank, as the JAX program replicates them. The
    other stages pass None with the ``shape`` and ``dtype`` they
    receive (by default ``h_micro``'s)."""
    st = PipeStage(config, mesh)
    shape = tuple(shape if shape is not None else h_micro.shape)
    dtype = dtype or h_micro.dtype
    dev = (h_micro.device if h_micro is not None
           else distributed.device() or torch.device("cpu"))
    outs = []
    for m in range(shape[0]):
        x = (h_micro[m] if st.is_first else
             distributed.hop(None, st.stage - 1, st.stage, shape[1:], dtype,
                             dev, st.pp))
        y = st.blocks(stage_blocks, x, remat)
        if not st.is_last:
            distributed.hop(y, st.stage, st.stage + 1, shape[1:], dtype, dev,
                            st.pp)
        outs.append(y)
    out = (torch.stack(outs) if st.is_last
           else torch.empty(shape, dtype=dtype, device=dev))
    if st.pp is not None:
        distributed.broadcast(out, st.n_stages - 1, st.pp)
    return out


def gpipe_loss_and_grads(params: Params, ids: torch.Tensor, config, mesh,
                         n_microbatches: int, remat: bool = False,
                         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The GPipe schedule on this rank: ``params`` its pipeline tree
    (``GPipeTrainStep.init``: the embed and head leaves, ``blocks`` its
    stage's), ``ids`` the global ``[B, S]`` batch. Returns the mean loss
    of this rank's rows (on every pp rank) and the gradients of
    ``params``' leaves (nested-dict order) before any dp reduction; the
    embed and head leaves' are summed over the pp group."""
    st = PipeStage(config, mesh)
    inp = microbatch(spmd.local_batch(ids[:, :-1], mesh), n_microbatches)
    lab = microbatch(spmd.local_batch(ids[:, 1:], mesh), n_microbatches)
    items, tree = tracked_leaves(params)
    dev = items[0][1].device
    dtype = params["wte"].dtype
    shape = st.act_shape(inp[0])
    saved = []
    total = None
    with torch.enable_grad():
        for m in range(n_microbatches):
            if st.is_first:
                x = st.embed(tree, inp[m])
            else:
                x = distributed.hop(None, st.stage - 1, st.stage, shape,
                                    dtype, dev, st.pp).requires_grad_()
            y = st.blocks(tree["blocks"], x, remat)
            if st.is_last:
                y = st.head_loss(tree, y, lab[m]) / n_microbatches
                total = y.detach() if total is None else total + y.detach()
            else:
                distributed.hop(y.detach(), st.stage, st.stage + 1, shape,
                                dtype, dev, st.pp)
            saved.append((x, y))
        for m in reversed(range(n_microbatches)):
            x, y = saved[m]
            saved[m] = None
            if st.is_last:
                torch.autograd.backward(y)
            else:
                dy = distributed.hop(None, st.stage + 1, st.stage, shape,
                                     dtype, dev, st.pp)
                torch.autograd.backward(y, dy)
            if not st.is_first:
                distributed.hop(x.grad, st.stage, st.stage - 1, shape, dtype,
                                dev, st.pp)
    grads = leaf_grads(items)
    st.shared_grads_sum(items, grads)
    return st.loss_to_all(total, dev), grads
