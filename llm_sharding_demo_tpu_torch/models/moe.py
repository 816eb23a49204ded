"""GPT-2-MoE: the dense MLP swapped for a top-k mixture of experts.

Counterpart of ``llm_sharding_demo_tpu/models/moe.py``, same parameter
layout: per block a router ``[L, d, E]`` and the experts stacked on
their own axis, kernels ``[L, E, d, 4d]`` / ``[L, E, 4d, d]`` (weight-only
int8: a ``QuantizedTensor`` with scales ``[L, E, out]``). The attention
half is GPT-2's (``gpt2._block`` with ``mlp_fn``), so decode attention
and the int8 linear kernels run unchanged inside MoE blocks.

Routing is the capacity-factor formulation: the top-k experts by
iterative argmax, per (batch row, expert) a slot from a masked cumsum
over the k-major flattened choices, tokens past capacity dropped onto
the residual. Left-pad columns (``token_valid``) never route. A
single-token step with ``B * k <= E`` takes the routed path, which
gathers only the chosen experts' kernels; capacity cannot bind there,
and its outputs are bit-equal to the dense dispatch's.

Under expert parallelism (``ep_group``; ``routed_mlp=False``, the dense
dispatch) a rank holds ``E / ep`` consecutive experts: the router,
top-k and capacity run over all ``E`` on every rank (the router is
whole), each rank sums its own experts' weighted outputs, and the sum
over the group completes every token. In training the experts' input and
the combine weights pass ``distributed.copy_to``, so the router's, the
attention's and the embeddings' gradients are whole on every rank, and
the load-balance loss reads its token and gate fractions averaged over
the data group (dp x sp) before their product (its global value).

On a training mesh (``mesh_forward``) the attention half runs over the
``tp`` heads and the ``sp`` sequence as in dense GPT-2. Under ``tp``
each expert's FFN hidden dim is split (Megatron within the expert): the
``c_proj`` partial products sum over tp before their whole bias. Under
``sp`` a rank routes its own chunk of the sequence against the
capacity of the whole sequence: the ranks all-gather their per-(row,
choice, expert) selection counts, which place each local choice in the
k-major order of the whole sequence (``_dispatch_slots``); a kept
choice's expert row depends on its own token alone, so the rank
dispatches only its own tokens, to slots of its own.

The expert contractions are batched ``torch.einsum``/``bmm`` products,
as the JAX package computes them outside any Pallas kernel; int8 experts
accumulate in f32 and round once, after the scale.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple, Union

import torch

from ..ops.attention import KVCache
from ..ops.layers import gelu_new, linear
from ..ops.quant import QuantizedTensor, is_quantized
from . import gpt2
from .gpt2 import GPT2Config, Params, embed, final_logits, unstack_blocks


@dataclasses.dataclass(frozen=True)
class MoEConfig(GPT2Config):
    """GPT2Config + router/expert hyperparameters."""

    n_experts: int = 8
    expert_top_k: int = 2
    capacity_factor: float = 1.25

    def __post_init__(self):
        super().__post_init__()
        if not 1 <= self.expert_top_k <= self.n_experts:
            raise ValueError(
                f"expert_top_k={self.expert_top_k} not in "
                f"[1, n_experts={self.n_experts}]")
        if self.attention_impl != "xla":
            raise ValueError(
                "MoE blocks support attention_impl='xla' only (the pallas "
                "kernel is wired into the dense model path)")


def expert_capacity(config: MoEConfig, seq_len: int) -> int:
    """Static per-expert slot count for one batch row."""
    cap = int(config.capacity_factor * config.expert_top_k * seq_len
              / config.n_experts)
    return max(cap, 1)


def init_params(config: MoEConfig, generator: torch.Generator,
                dtype=torch.float32, std: float = 0.02) -> Params:
    """Like ``gpt2.init_params`` with a router and stacked experts per
    block, drawn in a fixed order from ``generator`` on its device."""
    d, l, e = config.n_embd, config.n_layer, config.n_experts
    dev = generator.device

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * std
                ).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "wte": normal(config.vocab_size, d),
        "wpe": normal(config.n_positions, d),
        "blocks": {
            "ln_1": {"scale": ones(l, d), "bias": zeros(l, d)},
            "attn": {
                "c_attn": {"kernel": normal(l, d, 3 * d),
                           "bias": zeros(l, 3 * d)},
                "c_proj": {"kernel": normal(l, d, d), "bias": zeros(l, d)},
            },
            "ln_2": {"scale": ones(l, d), "bias": zeros(l, d)},
            "moe": {
                "router": {"kernel": normal(l, d, e)},
                "experts": {
                    "c_fc": {"kernel": normal(l, e, d, 4 * d),
                             "bias": zeros(l, e, 4 * d)},
                    "c_proj": {"kernel": normal(l, e, 4 * d, d),
                               "bias": zeros(l, e, d)},
                },
            },
        },
        "ln_f": {"scale": ones(d), "bias": zeros(d)},
    }


def _expert_einsum(eq: str, x: torch.Tensor, kernel) -> torch.Tensor:
    """Batched-over-experts contraction, int8-aware: a quantized
    ``[E, in, out]`` kernel contracts in f32 and takes its per-(expert,
    out-channel) scale before the one rounding to x's dtype."""
    if is_quantized(kernel):
        e, _, out = kernel.q.shape
        y = torch.einsum(eq, x.float(), kernel.q.float())
        scale = kernel.scale.float().reshape(
            (e,) + (1,) * (x.dim() - 2) + (out,))
        return (y * scale).to(x.dtype)
    return torch.einsum(eq, x, kernel)


def _gather_expert(kernel, idx: torch.Tensor):
    """Expert slices of a stacked ``[E, in, out]`` kernel by token:
    ``idx`` [N] -> [N, in, out] (a device gather: no host sync). A
    ``QuantizedTensor`` gathers its codes and scales together."""
    if is_quantized(kernel):
        return QuantizedTensor(kernel.q.index_select(0, idx),
                               kernel.scale.index_select(0, idx))
    return kernel.index_select(0, idx)


def _gathered_einsum(x: torch.Tensor, kernel) -> torch.Tensor:
    """[N, in] x per-token gathered [N, in, out] -> [N, out], with the
    int8 math of ``_expert_einsum``."""
    if is_quantized(kernel):
        y = torch.bmm(x.float()[:, None, :], kernel.q.float())[:, 0]
        return (y * kernel.scale.float()).to(x.dtype)
    return torch.bmm(x[:, None, :], kernel)[:, 0]


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``F.one_hot`` without its range check, which syncs the host on a
    card (a decode step is captured into a CUDA graph)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _topk_gates(gates: torch.Tensor, e: int, k: int,
                token_valid: Optional[torch.Tensor] = None):
    """The top-k selection: take the argmax (the first maximum), zero it,
    repeat. Returns ``(idxs [k x (B,S)], onehots [k x (B,S,E)], w
    [k,B,S])``, ``w`` renormalized to sum to 1 per token; one definition
    for the dense and the routed path."""
    sel_gates = gates
    idxs, onehots, weights = [], [], []
    for _ in range(k):
        idx = torch.argmax(sel_gates, dim=-1)
        oh = _one_hot(idx, e, gates.dtype)
        if token_valid is not None:
            oh = oh * token_valid[..., None].to(gates.dtype)
        idxs.append(idx)
        onehots.append(oh)
        weights.append(torch.sum(sel_gates * oh, dim=-1))
        sel_gates = sel_gates * (1.0 - oh)
    w = torch.stack(weights)
    w = w / torch.clamp(torch.sum(w, dim=0, keepdim=True), min=1e-9)
    return idxs, onehots, w


def _router(moe_params: Params, h: torch.Tensor) -> torch.Tensor:
    """f32 softmax gates [B, S, E] (the router takes the plain matmul:
    its E outputs are not 128-aligned)."""
    gate_logits = linear(h, moe_params["router"]["kernel"])
    return torch.softmax(gate_logits.float(), dim=-1)


def _aux_loss(top1: torch.Tensor, gates: torch.Tensor, e: int,
              data_group=None):
    """Switch-style load balance over the top-1 assignment. Under
    ``data_group`` (the ranks holding the batch's equal shards: dp x sp)
    the two fractions are means over the whole batch before their
    product."""
    frac_tokens, frac_gates = top1.mean(dim=(0, 1)), gates.mean(dim=(0, 1))
    if data_group is not None:
        from ..parallel.distributed import all_reduce
        import torch.distributed as dist
        n = dist.get_world_size(data_group)
        frac_tokens = all_reduce(frac_tokens.detach(), data_group) / n
        frac_gates = all_reduce(frac_gates, data_group) / n
    return torch.sum(frac_tokens * frac_gates) * e


def moe_mlp_routed(moe_params: Params, h: torch.Tensor, config: MoEConfig,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert MLP of a single-token step: only the top-k chosen
    experts' kernels are gathered, per token (k/E of the dense path's
    weight traffic). Capacity cannot bind at ``S == 1``, so routing and
    outputs are the dense dispatch's, bit for bit."""
    b, s, d = h.shape
    e, k = config.n_experts, config.expert_top_k
    experts = moe_params["experts"]
    gates = _router(moe_params, h)
    idxs, onehots, w = _topk_gates(gates, e, k)
    hf = h.reshape(b * s, d)
    out = torch.zeros_like(hf)
    for i in range(k):
        idx = idxs[i].reshape(b * s)
        h1 = _gathered_einsum(hf, _gather_expert(experts["c_fc"]["kernel"],
                                                 idx))
        h1 = gelu_new(h1 + experts["c_fc"]["bias"].index_select(0, idx))
        h2 = _gathered_einsum(h1, _gather_expert(
            experts["c_proj"]["kernel"], idx))
        h2 = h2 + experts["c_proj"]["bias"].index_select(0, idx)
        out = out + w[i].reshape(b * s, 1).to(h.dtype) * h2
    return out.reshape(b, s, d), _aux_loss(onehots[0], gates, e)


_DROP_COUNTS: List[List[torch.Tensor]] = []


@contextlib.contextmanager
def counting_drops():
    """Within the block, every dense dispatch appends the number of this
    rank's expert choices that capacity dropped (a 0-d tensor, no host
    sync) to the yielded list. On a mesh the ranks of one data shard
    (its tp and ep ranks) count the same choices."""
    box: List[torch.Tensor] = []
    _DROP_COUNTS.append(box)
    try:
        yield box
    finally:
        _DROP_COUNTS.remove(box)


def _earlier_choices(sel: torch.Tensor, sp_group) -> torch.Tensor:
    """``[B, k*S, E]``: what the whole sequence's k-major order puts
    before each of this rank's k-major flattened choices, of the same
    (row, expert), beyond the rank's own earlier choices (which its local
    cumsum counts): the other ranks' choices of earlier choice indices,
    and the earlier ranks' choices of its own index. One all-gather of
    the ``[k, B, E]`` selection counts (no gradient)."""
    import torch.distributed as dist
    from ..parallel.distributed import all_gather
    k, b, s, e = sel.shape
    r = dist.get_rank(sp_group)
    counts = all_gather(sel.sum(dim=2)[None], 0, sp_group)    # [n,k,B,E]
    others = counts.sum(dim=0) - counts[r]                      # [k,B,E]
    before = (torch.cumsum(others, dim=0) - others
              + counts[:r].sum(dim=0))
    return before.permute(1, 0, 2)[:, :, None, :].expand(
        b, k, s, e).reshape(b, k * s, e)


def _dispatch_slots(sel: torch.Tensor, cap: int, sp_group=None):
    """``[k, B, S, E]`` one-hot choices -> ``(slot, keep)``, each ``[B,
    k*S, E]`` over the k-major flattened choices: the cumsum along them
    hands out distinct slots per (row, expert); a choice past ``cap`` is
    not kept.

    ``sp_group``: ``sel`` holds this rank's chunk of the sequence. A
    choice's place in the whole sequence's order (``_earlier_choices``
    plus the local cumsum) decides whether it is kept; the kept local
    choices then take local slots in order, each below
    ``min(cap, S)``."""
    k, b, s, e = sel.shape
    sel_flat = sel.permute(1, 0, 2, 3).reshape(b, k * s, e)
    pos = torch.cumsum(sel_flat, dim=1) - 1.0
    if sp_group is not None:
        pos = pos + _earlier_choices(sel, sp_group)
    keep = (pos < cap) & (sel_flat > 0)
    if sp_group is not None:
        pos = torch.cumsum(keep.to(pos.dtype), dim=1) - 1.0
    if _DROP_COUNTS:
        dropped = (sel_flat > 0).sum() - keep.sum()
        for box in _DROP_COUNTS:
            box.append(dropped)
    return torch.where(keep, pos, torch.zeros_like(pos)).long(), keep


def moe_mlp(moe_params: Params, h: torch.Tensor, config: MoEConfig,
            token_valid: Optional[torch.Tensor] = None, ep_group=None,
            data_group=None, tp_group=None, sp_group=None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed expert MLP with the dense dispatch. [B, S, d] ->
    ([B, S, d], aux scalar).

    ``token_valid`` ([B, S] bool): tokens marked False (left-pad columns)
    neither route nor take capacity; their output rows are zero. Each
    token's output is the sum, in choice order, of its kept choices'
    weighted expert rows (the routed path's order).

    ``ep_group``: ``moe_params["experts"]`` hold this rank's ``E / ep``
    consecutive experts. Routing, slots and weights are computed over all
    ``E`` as without the group; the rank dispatches to and combines from
    its own experts only (another rank's choice weighs 0 here), and the
    partial outputs sum over the group. A token's at most ``k`` nonzero
    terms add in the same order as on one device. The experts' input and
    the combine weights pass ``copy_to`` (their gradients summed over
    the group: each rank's holds only its own experts' share); the router
    and the aux loss read ``h`` and the gates whole.

    ``tp_group``: the experts' FFN hidden dim is this rank's slice
    (``c_fc`` columns and bias, ``c_proj`` rows). The experts' input
    passes ``copy_to`` over tp too, and the ``c_proj`` products sum over
    tp before their bias, which is whole and so added once.

    ``sp_group``: ``h`` is this rank's chunk of the sequence; capacity is
    the whole sequence's and the slots follow its order
    (``_dispatch_slots``).

    ``data_group``: the aux loss's fractions averaged over it
    (``_aux_loss``)."""
    from ..parallel.distributed import copy_to, reduce_from
    b, s, d = h.shape
    e, k = config.n_experts, config.expert_top_k
    if sp_group is not None:
        import torch.distributed as dist
        cap = expert_capacity(config, s * dist.get_world_size(sp_group))
        slots = min(cap, s)
    else:
        cap = slots = expert_capacity(config, s)
    experts = moe_params["experts"]
    e_loc = experts["c_fc"]["bias"].shape[0]
    e0 = 0
    if ep_group is not None:
        import torch.distributed as dist
        e0 = dist.get_rank(ep_group) * e_loc
    gates = _router(moe_params, h)
    idxs, onehots, w = _topk_gates(gates, e, k, token_valid)
    aux = _aux_loss(onehots[0], gates, e, data_group)
    h, w = copy_to(copy_to(h, ep_group), tp_group), copy_to(w, ep_group)
    sel = torch.stack(onehots)                                  # [k,B,S,E]
    slot, keep = _dispatch_slots(sel, cap, sp_group)
    slot_oh = _one_hot(slot, slots, gates.dtype) * keep[..., None]
    # [B, k*S, E, C] un-flattens as (k, s): the merged axis is k-major
    dispatch = slot_oh.reshape(b, k, s, e, slots).sum(dim=1)    # [B,S,E,C]
    local = dispatch[:, :, e0:e0 + e_loc] if e_loc != e else dispatch
    xin = torch.einsum("bsec,bsd->ebcd", local.to(h.dtype), h)
    h1 = _expert_einsum("ebcd,edf->ebcf", xin, experts["c_fc"]["kernel"])
    h1 = gelu_new(h1 + experts["c_fc"]["bias"][:, None, None, :])
    h2 = reduce_from(_expert_einsum("ebcf,efd->ebcd", h1,
                                    experts["c_proj"]["kernel"]), tp_group)
    h2 = h2 + experts["c_proj"]["bias"][:, None, None, :]       # [E,B,C,d]
    # combine: each choice's expert row at its slot, weighted, dropped
    # choices weighted 0
    slot_k = slot.reshape(b, k, s, e)
    keep_k = keep.reshape(b, k, s, e)
    rows = torch.arange(b, device=h.device)[:, None]
    out = torch.zeros_like(h)
    for i in range(k):
        idx = idxs[i]                                           # [B,S]
        c = slot_k[:, i].gather(-1, idx[..., None])[..., 0]
        kept = keep_k[:, i].gather(-1, idx[..., None])[..., 0]
        wi = torch.where(kept, w[i], torch.zeros_like(w[i]))
        if e_loc != e:
            mine = (idx >= e0) & (idx < e0 + e_loc)
            wi = torch.where(mine, wi, torch.zeros_like(wi))
            idx = torch.clamp(idx - e0, 0, e_loc - 1)
        out = out + wi[..., None].to(h.dtype) * h2[idx, rows, c]
    return reduce_from(out, ep_group), aux


def _moe_block(p: Params, h: torch.Tensor, config: MoEConfig,
               cache: Optional[KVCache] = None, layer_idx: int = 0,
               offset: Union[int, torch.Tensor] = 0,
               k_valid_from: Optional[torch.Tensor] = None,
               decode_kernel: Optional[str] = None,
               routed_mlp: bool = True, ep_group=None, mesh=None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pre-LN MoE block (GPT-2's attention half, the expert MLP via
    ``mlp_fn``). Returns ``(h, aux)``. Left-pad columns
    (``k_valid_from``) are kept out of routing; with ``routed_mlp`` a
    single-token step with ``B * k <= E`` takes the routed path.
    ``mesh`` (training): ``p`` is this rank's slices, attention runs over
    its tp heads and across the sp axis, and the expert MLP over its tp
    slices, its sp chunk and the data group (``moe_mlp``)."""
    token_valid = None
    if k_valid_from is not None:
        s = h.shape[1]
        token_valid = ((offset + torch.arange(s, device=h.device))[None, :]
                       >= k_valid_from[:, None])
    use_routed = (routed_mlp and h.shape[1] == 1
                  and h.shape[0] * config.expert_top_k <= config.n_experts)
    groups = {}
    tp_group = None
    if mesh is not None:
        from ..parallel import spmd
        tp_group = spmd.group(mesh, "tp")
        groups = dict(tp_group=tp_group, sp_group=spmd.group(mesh, "sp"),
                      data_group=spmd.axis_group(mesh, ("dp", "sp")))
    aux_cell: List[torch.Tensor] = []

    def mlp_fn(block_params: Params, m: torch.Tensor) -> torch.Tensor:
        if use_routed:
            out, aux = moe_mlp_routed(block_params["moe"], m, config)
        else:
            out, aux = moe_mlp(block_params["moe"], m, config, token_valid,
                               ep_group, **groups)
        aux_cell.append(aux)
        return out

    n_head = gpt2.tp_config(config, tp_group).n_head
    h = gpt2._block(p, h, n_head, config.layer_norm_epsilon, cache,
                    layer_idx, offset, k_valid_from, decode_kernel,
                    mlp_fn=mlp_fn, tp_group=tp_group, mesh=mesh)
    return h, aux_cell[0]


def apply_blocks(blocks: Union[Params, List[Params]], h: torch.Tensor,
                 config: MoEConfig, cache: Optional[KVCache] = None,
                 k_valid_from: Optional[torch.Tensor] = None,
                 decode_kernel: Optional[str] = None,
                 routed_mlp: bool = True, ep_group=None, mesh=None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, Optional[KVCache]]:
    """The block stack (stacked dict or its ``unstack_blocks`` list):
    ``(h, summed f32 aux, cache one window longer or None)``."""
    offset = cache.length if cache is not None else 0
    layers = blocks if isinstance(blocks, list) else unstack_blocks(blocks)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for li, p in enumerate(layers):
        h, layer_aux = _moe_block(p, h, config, cache, li, offset,
                                  k_valid_from, decode_kernel, routed_mlp,
                                  ep_group, mesh)
        aux = aux + layer_aux
    if cache is not None:
        cache = KVCache(k=cache.k, v=cache.v, length=offset + h.shape[1])
    return h, aux, cache


def forward(params: Params, input_ids: torch.Tensor, config: MoEConfig,
            remat: bool = False, mesh=None,
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] -> ([B, S, vocab] f32 logits, summed router aux loss).
    ``remat`` is refused: the JAX MoE forward has no per-block remat.
    ``mesh``: ``params`` are this rank's slices
    (``spmd.moe_param_pspecs``), ``input_ids`` the global batch; the
    logits of the whole batch are gathered onto every rank, the aux loss
    is the global one."""
    if remat:
        raise NotImplementedError("the MoE forward has no remat")
    if mesh is not None:
        from ..parallel import spmd
        logits, aux = mesh_forward(params, spmd.local_batch(input_ids, mesh),
                                   config, mesh)
        return spmd.gather_batch(logits, mesh), aux
    h = embed(params, input_ids, 0)
    h, aux, _ = apply_blocks(params["blocks"], h, config)
    return final_logits(params, h, config.layer_norm_epsilon), aux


def mesh_forward(params: Params, input_ids: torch.Tensor, config: MoEConfig,
                 mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's logits and the global aux loss on a mesh of any of
    dp, tp, sp, ep and pp: ``input_ids`` is its shard (its dp rows, its
    sp chunk, embedded at the chunk's global positions), its experts are
    ``E / ep`` of them (the dense dispatch, summed over ``ep``) at its tp
    slices, the aux loss's fractions are averaged over dp x sp. A ``pp``
    axis, which no layout table or batch spec names, replicates the
    whole computation, as in the JAX package."""
    from ..parallel import spmd
    h = embed(params, input_ids, spmd.seq_offset(mesh, input_ids.shape[1]))
    h, aux, _ = apply_blocks(params["blocks"], h, config,
                             routed_mlp=False, ep_group=spmd.group(mesh, "ep"),
                             mesh=mesh)
    return final_logits(params, h, config.layer_norm_epsilon), aux


def forward_with_cache(params: Params, input_ids: torch.Tensor,
                       config: MoEConfig, cache: KVCache,
                       pad: Optional[torch.Tensor] = None,
                       decode_kernel: Optional[str] = None,
                       flash_prefill: bool = False,
                       routed_mlp: bool = True, ep_group=None,
                       ) -> Tuple[torch.Tensor, KVCache]:
    """Cached MoE forward with ``gpt2.forward_with_cache``'s contract (the
    aux loss is dropped). ``decode_kernel`` is "layer", "matmul" or None:
    the family has no whole-stack kernel. A single-token step routes one
    token against a fresh capacity of at least one slot per expert, so
    decode never drops. ``routed_mlp=False`` keeps every step on the
    dense dispatch, which expert-parallel decode (``ep_group``, this
    rank's experts in ``params``) needs: the routed path would gather
    experts another rank holds."""
    if flash_prefill:
        raise NotImplementedError(
            "flash prefill covers the dense families; MoEConfig enforces "
            "attention_impl='xla'")
    offset = cache.length if pad is None else cache.length - pad[:, None]
    h = embed(params, input_ids, offset)
    h, _, cache = apply_blocks(params["blocks"], h, config, cache, pad,
                               decode_kernel, routed_mlp, ep_group)
    return final_logits(params, h, config.layer_norm_epsilon,
                        kernels=decode_kernel is not None), cache


def make_cache(config: MoEConfig, batch: int, max_seq: int,
               dtype=torch.float32, device=None) -> KVCache:
    """KV cache for the MoE model (its attention is GPT-2's)."""
    return gpt2.make_cache(config, batch, max_seq, dtype, device)
