"""1F1B pipeline training: one forward, then one backward, a stage a tick.

Counterpart of ``llm_sharding_demo_tpu/parallel/pipeline_1f1b.py``.
``parallel.gpipe`` runs every microbatch's forward before any backward,
so each stage keeps M graphs. Here the backward is scheduled by hand, on
the JAX program's ticks:

- ticks ``t = 0 .. M + 2VS - 3`` over ``VS = v * S`` virtual stages; at
  tick t, virtual stage ``vs`` runs the forward of microbatch ``t - vs``
  and the backward of microbatch ``t - (2VS - 2 - vs)``, each where it
  is in range. The last virtual stage takes the backward of a
  microbatch in the tick of its forward;
- a stage stashes only each in-flight microbatch's *input*, not its
  graph: at most ``min(M, 2VS - 1)`` live entries a chunk
  (``stats["stash_high_water"]``). Its backward recomputes the stage's
  forward with grad enabled from the stashed input and runs
  ``torch.autograd.backward(y, dy)`` when ``dy`` arrives, as the JAX
  program recomputes under ``jax.vjp``. So the blocks run forward twice
  a microbatch, whatever ``remat`` says;
- the first virtual stage embeds (its recompute re-embeds, so the
  embeddings take their gradient there); the last one applies the head
  and the loss, whose gradient starts that tick's backward;
- after each tick, every stage's outputs go to the next virtual stage and
  its input gradients to the previous one in one posted exchange
  (``distributed.exchange``): two neighbours may send each other
  something in the same tick. Every rank posts the tick's transfers in
  the same order.

Interleaved 1F1B (``virtual_stages = v > 1``): stage d owns the chunks
``d, d + S, ...`` (``partition.stack_virtual_chunks``), so a microbatch
makes v trips around the ring, and the wrap from the last stage to the
first carries chunk j's output to chunk j + 1. The stages run no bubble
ticks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..models.gpt2 import Params, layer_params
from . import distributed, spmd
from .gpipe import PipeStage, leaf_grads, microbatch, tracked_leaves

# Placement contract (utils/graftshard): as ``parallel.gpipe``'s: ``pp``
# is the axis of the stage blocks; dp and tp ride inside a stage.
PLACEMENT_CONTRACT = {
    "mesh_axes": ("pp", "tp", "dp"),
    "entry:one_f_one_b_loss_and_grads": "pp",
}


def stash_depth(n_micro: int, n_stages: int, n_virtual: int = 1) -> int:
    """The most stashed inputs a chunk holds: ``min(M, 2VS - 1)``."""
    return min(n_micro, 2 * n_stages * n_virtual - 1)


def one_f_one_b_loss_and_grads(params: Params, ids: torch.Tensor, config,
                               mesh, n_microbatches: int,
                               virtual_stages: int = 1,
                               stats: Optional[Dict] = None,
                               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The 1F1B schedule on this rank: ``params`` its pipeline tree
    (``GPipeTrainStep.init``: the embed and head leaves; ``blocks`` its
    stage's, ``[v, per_chunk, ...]`` leaves when ``virtual_stages > 1``),
    ``ids`` the global ``[B, S]`` batch. Returns the mean loss of this
    rank's rows (on every pp rank) and the gradients of ``params``'
    leaves (nested-dict order) before any dp reduction; the embed and
    head leaves' are summed over the pp group. ``stats`` receives
    ``stash_high_water``: the most inputs one chunk held at once."""
    st = PipeStage(config, mesh)
    n_micro, v, S, d = (n_microbatches, virtual_stages, st.n_stages,
                        st.stage)
    VS = v * S
    inp = microbatch(spmd.local_batch(ids[:, :-1], mesh), n_micro)
    lab = microbatch(spmd.local_batch(ids[:, 1:], mesh), n_micro)
    items, tree = tracked_leaves(params)
    # chunk j: the [v, per_chunk, ...] leaves' slice j (views)
    chunks = ([tree["blocks"]] if v == 1 else
              [layer_params(tree["blocks"], j) for j in range(v)])
    dev = items[0][1].device
    dtype = params["wte"].dtype
    shape = st.act_shape(inp[0])

    def act_f(u: int, t: int) -> bool:
        return 0 <= t - u < n_micro

    def act_b(u: int, t: int) -> bool:
        return 0 <= t - (2 * (VS - 1) - u) < n_micro

    if st.pp is not None and dist.get_backend(st.pp) == "nccl":
        # nccl's batched point-to-point needs every rank of the group in
        # the group's first collective; a tick's transfers involve two
        dist.barrier(group=st.pp)
    stash: List[Dict[int, Optional[torch.Tensor]]] = [{} for _ in range(v)]
    fwd_in: List[Optional[torch.Tensor]] = [None] * v
    bwd_in: List[Optional[torch.Tensor]] = [None] * v
    high, total = 0, None
    for t in range(n_micro + 2 * VS - 2):
        ys: Dict[int, torch.Tensor] = {}
        dxs: Dict[int, torch.Tensor] = {}
        for j in range(v):
            vs = j * S + d
            if act_f(vs, t):
                m = t - vs
                x = None if vs == 0 else fwd_in[j]
                with torch.no_grad():
                    h = st.embed(tree, inp[m]) if vs == 0 else x
                    y = st.blocks(chunks[j], h)
                stash[j][m] = x
                high = max(high, len(stash[j]))
                if vs == VS - 1:
                    # the head's loss and its gradient, this tick
                    yl = y.detach().requires_grad_()
                    with torch.enable_grad():
                        loss = st.head_loss(tree, yl, lab[m]) / n_micro
                        torch.autograd.backward(loss)
                    total = (loss.detach() if total is None
                             else total + loss.detach())
                    bwd_in[j] = yl.grad
                else:
                    ys[j] = y
            if act_b(vs, t):
                m = t - (2 * (VS - 1) - vs)
                x = stash[j].pop(m)
                with torch.enable_grad():
                    h = (st.embed(tree, inp[m]) if vs == 0
                         else x.detach().requires_grad_())
                    y = st.blocks(chunks[j], h)
                    torch.autograd.backward(y, bwd_in[j])
                if vs > 0:
                    dxs[j] = h.grad
        fwd_in, bwd_in = _tick_transfers(t, st, v, ys, dxs, act_f, act_b,
                                         shape, dtype, dev)
    if stats is not None:
        stats["stash_high_water"] = high
    grads = leaf_grads(items)
    st.shared_grads_sum(items, grads)
    return st.loss_to_all(total, dev), grads


def _tick_transfers(t: int, st: PipeStage, v: int, ys, dxs, act_f, act_b,
                    shape, dtype, dev):
    """The transfers that end tick ``t``: virtual stage u's output to
    u + 1 and its input gradient to u - 1, wherever the sender ran that
    slot. Every rank walks the same list (forward transfers by u, then
    backward ones) and posts its own part; returns the next tick's
    ``(fwd_in, bwd_in)`` by chunk."""
    S, d = st.n_stages, st.stage
    VS = v * S
    sends, recvs, where = [], [], []
    fwd_in: List[Optional[torch.Tensor]] = [None] * v
    bwd_in: List[Optional[torch.Tensor]] = [None] * v
    moves = ([(0, u, u + 1) for u in range(VS - 1) if act_f(u, t)]
             + [(1, u, u - 1) for u in range(1, VS) if act_b(u, t)])
    for kind, src, dst in moves:
        tag = kind * VS + src
        payload = (ys if kind == 0 else dxs).get(src // S) \
            if src % S == d else None
        into = fwd_in if kind == 0 else bwd_in
        if src % S == d and dst % S == d:
            into[dst // S] = payload      # a one-stage ring: no transfer
        elif src % S == d:
            sends.append((payload, dst % S, tag))
        elif dst % S == d:
            recvs.append((shape, src % S, tag))
            where.append((into, dst // S))
    got = distributed.exchange(sends, recvs, dtype, dev, st.pp) \
        if sends or recvs else []
    for (into, j), x in zip(where, got):
        into[j] = x
    return fwd_in, bwd_in
