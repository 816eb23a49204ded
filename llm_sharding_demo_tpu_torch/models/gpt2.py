"""GPT-2 as plain functions over a parameter dict of tensors.

Counterpart of ``llm_sharding_demo_tpu/models/gpt2.py``, same parameter
layout: transformer blocks stacked on a leading ``[L, ...]`` layer axis,
``[in, out]`` kernels (HF ``Conv1D`` storage) and the LM head tied to
``wte``. The block stack is a Python loop over the layer axis (the JAX
package's ``lax.scan``). Cached forwards write the KV cache in place.

``GPT2Config.attention_impl`` selects the no-cache forward's attention:
"xla" is the plain path, "pallas" the flash-attention kernels
(``ops.flash_attention``) from ``FLASH_MIN_SEQ`` positions on, as in the
JAX package; "ring" the sequence-parallel ring over a mesh's ``sp`` axis
(``ops.ring_attention``), which needs ``forward(..., mesh=)``.

On a mesh (``forward(..., mesh=)``, mesh training) each rank runs its
shard: its ``dp`` rows, its ``sp`` chunk of positions embedded at their
global positions, its ``tp`` heads and MLP columns (Megatron's
``copy_to`` at every column-parallel input, ``reduce_from`` after every
row-parallel product, ``parallel.distributed``), so every replicated
leaf's gradient is whole and equal on the tp ranks.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import (KVCache, cached_attention_fused,
                             cached_attention_inplace, merge_heads,
                             split_heads, write_kv_layer,
                             write_kv_layer_fused)
from ..ops.decode_attention import decode_attention
from ..ops.decode_layer import (MAX_BATCH, decode_layers, mega_downgrade,
                                mega_requested)
from ..ops.flash_attention import flash_attention, self_attention
from ..ops.layers import gelu_new, layer_norm, linear, row_linear
from ..ops.quant import QuantizedTensor, embed_rows, head_logits, is_quantized
from ..ops.ring_attention import mesh_attention
from ..parallel.distributed import copy_to

Params = Dict[str, Any]


def check_attention_impl(impl: str) -> None:
    """Accept "xla", "pallas" and "ring"; anything else is a ValueError
    (both families' configs call this)."""
    if impl not in ("xla", "pallas", "ring"):
        raise ValueError(f"attention_impl={impl!r} not xla|pallas|ring")


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """Architecture hyperparameters (the HF ``GPT2Config`` fields used)."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    # "xla": the plain attention; "pallas": the flash-attention kernels
    # where flash_profitable holds (the no-cache forward, i.e. training);
    # "ring": ring attention over a mesh's sp axis
    attention_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def __post_init__(self):
        if self.n_embd % self.n_head != 0:
            raise ValueError(
                f"n_embd={self.n_embd} not divisible by n_head={self.n_head}")
        check_attention_impl(self.attention_impl)


# "tiny-gpt2" matches sshleifer/tiny-gpt2 (the reference's default
# MODEL_ID); "gpt2" is GPT-2 124M; "gpt2-medium" the 355M config.
CONFIGS: Dict[str, GPT2Config] = {
    "tiny-gpt2": GPT2Config(vocab_size=50257, n_positions=1024, n_embd=2,
                            n_layer=2, n_head=2),
    "gpt2": GPT2Config(vocab_size=50257, n_positions=1024, n_embd=768,
                       n_layer=12, n_head=12),
    "gpt2-medium": GPT2Config(vocab_size=50257, n_positions=1024, n_embd=1024,
                              n_layer=24, n_head=16),
}


def init_params(config: GPT2Config, generator: torch.Generator,
                dtype=torch.float32, std: float = 0.02) -> Params:
    """Random-init parameters (normal(std) weights, zero biases, unit LN)
    on the generator's device, drawn in a fixed order from ``generator``."""
    d, l = config.n_embd, config.n_layer
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
            "mlp": {
                "c_fc": {"kernel": normal(l, d, 4 * d),
                         "bias": zeros(l, 4 * d)},
                "c_proj": {"kernel": normal(l, 4 * d, d),
                           "bias": zeros(l, d)},
            },
        },
        "ln_f": {"scale": ones(d), "bias": zeros(d)},
    }


def map_params(fn, tree):
    """Apply ``fn`` to every tensor / QuantizedTensor leaf of a param dict."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_params(blocks: Params, li) -> Params:
    """One layer's (or a slice of layers') view of the stacked blocks."""
    return map_params(lambda x: x[li], blocks)


def n_stacked(blocks: Params) -> int:
    """The layer count of a stacked block tree (any family): the leading
    axis of its first leaf."""
    leaf = blocks
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return (leaf.q if isinstance(leaf, QuantizedTensor) else leaf).shape[0]


def unstack_blocks(blocks: Params) -> List[Params]:
    """The stacked blocks as a list of per-layer views (no copies). A
    long-lived runner builds it once, so a decode step does not re-slice
    every leaf of every layer."""
    return [layer_params(blocks, li) for li in range(n_stacked(blocks))]


def unstack_params(params: Params) -> Params:
    """``params`` with its stacked ``blocks`` replaced by their per-layer
    list (what ``apply_blocks`` also takes); the stacked tensors stay
    beside it as ``stacked_blocks`` (views, no copies) for the
    whole-stack kernel, which takes a pointer and a layer stride."""
    return dict(params, blocks=unstack_blocks(params["blocks"]),
                stacked_blocks=params["blocks"])


def embed(params: Params, input_ids: torch.Tensor,
          position_offset: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Token + position embeddings. [B, S] ids -> [B, S, D].

    ``position_offset`` is the absolute position of the first token; a
    ``[B, 1]`` tensor gives per-row positions for left-padded batches (pad
    columns clip to position 0, and their outputs are never read)."""
    seq_len = input_ids.shape[-1]
    positions = torch.clamp(
        position_offset + torch.arange(seq_len, device=input_ids.device),
        min=0)
    wte = params["wte"]
    tok = (embed_rows(wte, input_ids) if is_quantized(wte)
           else wte[input_ids])
    return tok + params["wpe"][positions]


def _block(p: Params, h: torch.Tensor, n_head: int, eps: float,
           cache: Optional[KVCache] = None, layer_idx: int = 0,
           offset: int = 0, k_valid_from: Optional[torch.Tensor] = None,
           decode_kernel: Optional[str] = None, attn_impl: str = "xla",
           flash_prefill: bool = False, mlp_fn=None,
           tp_group=None, mesh=None) -> torch.Tensor:
    """One pre-LN transformer block; with ``cache``, writes this layer's
    K/V at ``offset`` in place and attends over the written prefix.

    ``decode_kernel`` ("layer") routes single-token steps on a fused cache
    through the decode-attention kernel and lets the int8 matmuls take
    their kernels; "matmul" keeps the int8 matmul kernels alone; ``None``
    is the plain path. ``attn_impl`` picks the
    no-cache attention (``ops.flash_attention.self_attention``).
    ``flash_prefill`` (a fresh-cache prefill: offset 0, no pad) writes
    the cache, then runs the flash kernel over the new K/V alone.
    ``mlp_fn(p, m) -> mlp_out`` swaps the dense MLP for another
    feed-forward (``models.moe`` passes its expert MLP), so the attention
    half exists once for both families.

    ``tp_group`` (tensor parallelism): ``p`` holds this rank's Megatron
    slices and ``n_head`` its local heads; the column-parallel inputs
    pass ``copy_to`` and the row-parallel ``c_proj`` products sum over
    the group before their bias (``ops.layers.row_linear``). ``mesh``
    (no-cache path): attention over the mesh's ``sp`` axis
    (``ops.ring_attention.mesh_attention``); ``attn_impl == "ring"``
    needs it."""
    kernels = decode_kernel is not None
    a = layer_norm(h, p["ln_1"]["scale"], p["ln_1"]["bias"], eps)
    qkv = linear(copy_to(a, tp_group), p["attn"]["c_attn"]["kernel"],
                 p["attn"]["c_attn"]["bias"], kernels)
    q, k, v = (split_heads(x, n_head) for x in qkv.chunk(3, dim=-1))
    if cache is None:
        if attn_impl == "ring":
            if mesh is None:
                raise ValueError(
                    "attention_impl='ring' needs a mesh with an 'sp' axis: "
                    "pass forward(..., mesh=mesh) (or TrainStep(mesh=...))")
            if k_valid_from is not None:
                raise NotImplementedError(
                    "ring attention does not support ragged (left-padded) "
                    "batches")
        attn = (self_attention(q, k, v, attn_impl, offset, k_valid_from)
                if mesh is None else
                mesh_attention(q, k, v, attn_impl, mesh, k_valid_from))
    elif flash_prefill:
        write_kv(cache, k, v, layer_idx, offset)
        attn = flash_attention(q, k, v)
    elif cache.fused:
        if decode_kernel == "layer" and q.shape[2] == 1:
            attn, _ = decode_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), cache.k, layer_idx,
                                       offset, k_valid_from)
        else:
            attn, _ = cached_attention_fused(q, k, v, cache.k, layer_idx,
                                             offset, k_valid_from)
    else:
        attn, _, _ = cached_attention_inplace(q, k, v, cache.k, cache.v,
                                              layer_idx, offset, k_valid_from)
    attn = row_linear(merge_heads(attn), p["attn"]["c_proj"]["kernel"],
                      p["attn"]["c_proj"]["bias"], kernels, tp_group)
    h = h + attn
    m = layer_norm(h, p["ln_2"]["scale"], p["ln_2"]["bias"], eps)
    if mlp_fn is not None:
        return h + mlp_fn(p, m)
    m = row_linear(gelu_new(linear(copy_to(m, tp_group),
                                   p["mlp"]["c_fc"]["kernel"],
                                   p["mlp"]["c_fc"]["bias"], kernels)),
                   p["mlp"]["c_proj"]["kernel"], p["mlp"]["c_proj"]["bias"],
                   kernels, tp_group)
    return h + m


def write_kv(cache: KVCache, k: torch.Tensor, v: torch.Tensor,
             layer_idx: int, offset: int) -> None:
    """Write new K/V into either cache layout, in place."""
    if cache.fused:
        write_kv_layer_fused(cache.k, k, v, layer_idx, offset)
    else:
        write_kv_layer(cache.k, cache.v, k, v, layer_idx, offset)


def run_layers(block_fn, layers: List[Params], h: torch.Tensor,
               remat: bool) -> torch.Tensor:
    """``h = block_fn(p, h, li)`` over the layers; ``remat`` recomputes
    each block's activations in the backward pass instead of keeping
    them (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``
    per block)."""
    for li, p in enumerate(layers):
        fn = functools.partial(block_fn, p, li=li)
        h = checkpoint(fn, h, use_reentrant=False) if remat else fn(h)
    return h


def apply_blocks(blocks: Union[Params, List[Params]], h: torch.Tensor,
                 config: GPT2Config, cache: Optional[KVCache] = None,
                 k_valid_from: Optional[torch.Tensor] = None,
                 decode_kernel: Optional[str] = None, remat: bool = False,
                 flash_prefill: bool = False, tp_group=None, mesh=None,
                 ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run a stack of blocks: the stacked dict (leading layer axis) or its
    ``unstack_blocks`` list. With ``cache`` (leading axis matching the
    stack) the new K/V land at ``cache.length`` and the returned cache is
    one window longer (same buffers). ``remat`` applies to the no-cache
    path (training). Under ``tp_group`` the blocks are this rank's slices
    and ``config`` its ``tp_config``; ``mesh`` as in ``_block``."""
    eps = config.layer_norm_epsilon
    offset = cache.length if cache is not None else 0
    layers = blocks if isinstance(blocks, list) else unstack_blocks(blocks)

    def block(p, h, li):
        return _block(p, h, config.n_head, eps, cache, li, offset,
                      k_valid_from, decode_kernel, config.attention_impl,
                      flash_prefill, tp_group=tp_group, mesh=mesh)

    h = run_layers(block, layers, h, remat and cache is None)
    if cache is None:
        return h, None
    return h, KVCache(k=cache.k, v=cache.v, length=offset + h.shape[1])


def final_logits(params: Params, h: torch.Tensor, eps: float,
                 kernels: bool = False) -> torch.Tensor:
    """ln_f followed by the tied LM head; logits in float32 whatever the
    activation dtype (f32 products of the upcast operands)."""
    h = layer_norm(h, params["ln_f"]["scale"], params["ln_f"]["bias"], eps)
    wte = params["wte"]
    if isinstance(wte, QuantizedTensor):
        return head_logits(h, wte, kernels=kernels)
    return torch.matmul(h.float(), wte.float().t())


def forward(params: Params, input_ids: torch.Tensor,
            config: GPT2Config, remat: bool = False,
            mesh=None) -> torch.Tensor:
    """Full no-cache forward: [B, S] -> [B, S, vocab] f32 logits.
    ``remat`` recomputes each block in the backward pass (training).

    ``mesh`` (every rank of it calls): ``params`` are this rank's slices
    under the family's layout table (``parallel.spmd``) and ``input_ids``
    the global batch; the rank runs its shard (``mesh_forward``) and the
    logits of the whole batch are gathered onto every rank, as the JAX
    call returns them. ``attention_impl="ring"`` needs the mesh."""
    if mesh is not None:
        from ..parallel import spmd
        return spmd.gather_batch(mesh_forward(
            params, spmd.local_batch(input_ids, mesh), config, mesh, remat),
            mesh)
    h = embed(params, input_ids, 0)
    h, _ = apply_blocks(params["blocks"], h, config, remat=remat)
    return final_logits(params, h, config.layer_norm_epsilon)


def mesh_forward(params: Params, input_ids: torch.Tensor, config: GPT2Config,
                 mesh, remat: bool = False) -> torch.Tensor:
    """This rank's logits on a mesh: ``input_ids`` is its shard
    (``spmd.local_batch``: its dp rows, its sp chunk), embedded at the
    chunk's global positions; the blocks run over its tp slices and
    attend across the sp axis."""
    from ..parallel import spmd
    tp = spmd.group(mesh, "tp")
    h = embed(params, input_ids, spmd.seq_offset(mesh, input_ids.shape[1]))
    h, _ = apply_blocks(params["blocks"], h, tp_config(config, tp),
                        remat=remat, tp_group=tp, mesh=mesh)
    return final_logits(params, h, config.layer_norm_epsilon)


def mega_step(blocks: Params, h: torch.Tensor, config: GPT2Config,
              cache: KVCache, pad: Optional[torch.Tensor],
              ) -> Optional[Tuple[torch.Tensor, KVCache]]:
    """All the stacked ``blocks`` for one embedded ``[B, 1, D]`` token in
    one whole-stack launch (``ops.decode_layer``), the one GPT-2 mega
    route that ``forward_with_cache`` and the stage runner share. Returns
    ``(h, cache)``, or ``None`` past ``MAX_BATCH`` rows: the caller then
    takes the per-layer kernels (``mega_downgrade``)."""
    if h.shape[0] > MAX_BATCH:
        return None
    h, KV = decode_layers(blocks, h, cache.k, cache.length,
                          k_valid_from=pad, n_head=config.n_head,
                          eps=config.layer_norm_epsilon)
    return h, KVCache(k=KV, v=cache.v, length=cache.length + 1)


def run_blocks(params: Params, h: torch.Tensor, config: GPT2Config,
               cache: Optional[KVCache], pad: Optional[torch.Tensor],
               decode_kernel: Optional[str], flash_prefill: bool = False,
               tp_group=None,
               ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """The block stack of a forward or a stage: one megakernel launch for
    a single cached token on a mega engine, else the per-layer loop.
    ``params`` are plain or from ``unstack_params`` (whose
    ``stacked_blocks`` the megakernel takes). ``tp_group``: see
    ``forward_with_cache`` (no kernel mode runs under it)."""
    if cache is not None and mega_requested(decode_kernel, h.shape[1]):
        step = mega_step(params.get("stacked_blocks", params["blocks"]), h,
                         config, cache, pad)
        if step is not None:
            return step
    return apply_blocks(params["blocks"], h, config, cache, k_valid_from=pad,
                        decode_kernel=mega_downgrade(decode_kernel),
                        flash_prefill=flash_prefill, tp_group=tp_group)


def forward_with_cache(params: Params, input_ids: torch.Tensor,
                       config: GPT2Config, cache: KVCache,
                       pad: Optional[torch.Tensor] = None,
                       decode_kernel: Optional[str] = None,
                       flash_prefill: bool = False, tp_group=None,
                       ) -> Tuple[torch.Tensor, KVCache]:
    """Cached forward (prefill when ``cache.length == 0``, a decode step
    otherwise): full-sequence f32 logits and the cache one window longer.

    ``pad`` ([B] int) enables ragged batches of left-padded prompts: row
    b's first ``pad[b]`` cache slots are pad tokens, so its positions
    shift down by ``pad[b]`` and those slots are masked as keys.
    ``decode_kernel="mega"`` runs single-token inputs (decode steps, a
    1-token prompt's prefill) through the whole-stack kernel.
    ``flash_prefill`` (the engine's fresh-cache gate) runs each layer's
    attention through the flash kernel; a padded batch never does.

    ``tp_group`` (tensor-parallel decode): ``params["blocks"]`` are this
    rank's Megatron slices (``parallel.spmd.param_pspecs``), the cache
    holds its ``n_head / tp`` heads, attention runs over those heads, and
    the row-parallel products sum over the group; embeddings, norms and
    the head are whole on every rank, so every rank gets the same
    logits."""
    offset = cache.length if pad is None else cache.length - pad[:, None]
    h = embed(params, input_ids, offset)
    h, cache = run_blocks(params, h, tp_config(config, tp_group), cache, pad,
                          decode_kernel, flash_prefill and pad is None,
                          tp_group=tp_group)
    return final_logits(params, h, config.layer_norm_epsilon,
                        kernels=decode_kernel is not None), cache


def tp_config(config, tp_group):
    """The config a tensor-parallel rank runs its blocks with: head
    counts and widths divided by the group's size (``head_dim`` kept);
    ``config`` itself without a group."""
    if tp_group is None:
        return config
    import torch.distributed as dist
    tp = dist.get_world_size(tp_group)
    if tp == 1:
        return config
    kw = {"n_head": config.n_head // tp, "n_embd": config.n_embd // tp}
    for name in ("n_kv_head", "intermediate_size"):
        if hasattr(config, name):
            kw[name] = getattr(config, name) // tp
    return dataclasses.replace(config, **kw)


def make_cache(config: GPT2Config, batch: int, max_seq: int,
               dtype=torch.float32, device=None) -> KVCache:
    """Allocate a fixed-size KV cache (bounded by ``n_positions``: past the
    position table a write would have no position embedding)."""
    if max_seq > config.n_positions:
        raise ValueError(
            f"max_seq={max_seq} exceeds n_positions={config.n_positions}")
    return KVCache.create(config.n_layer, batch, config.n_head, max_seq,
                          config.head_dim, dtype, device)
