"""The llama family (RMSNorm, RoPE, SwiGLU, grouped-query attention) as
plain functions over a parameter dict of tensors.

Counterpart of ``llm_sharding_demo_tpu/models/llama.py``, same parameter
layout: blocks stacked on a leading ``[L, ...]`` layer axis, ``[in,
out]`` kernels, no biases, an untied ``lm_head``. Against GPT-2:

- positions are rotary (``ops.rope``), computed and not looked up, so
  context is bounded only by the cache (``n_positions`` is a cache and
  serving bound, not a table size);
- the KV cache is allocated at ``n_kv_head`` width; query head ``i``
  reads kv head ``i // (n_head / n_kv_head)``;
- the MLP is ``down(silu(gate(x)) * up(x))``.

The block stack is a Python loop over the layer axis; cached forwards
write the KV cache in place. On a mesh (``forward(..., mesh=)``, mesh
training) a rank runs its shard as in ``models.gpt2``; its ``sp`` chunk
takes the RoPE angles of its global positions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..ops.attention import (KVCache, cached_attention_fused,
                             cached_attention_inplace, merge_heads,
                             split_heads)
from ..ops.decode_attention import decode_attention
from ..ops.decode_layer import (MAX_BATCH, decode_layers_llama,
                                mega_downgrade, mega_requested)
from ..ops.flash_attention import flash_attention, repeat_kv, self_attention
from ..ops.layers import linear, rms_norm, row_linear
from ..ops.quant import embed_rows, is_quantized
from ..ops.ring_attention import mesh_attention
from ..ops.rope import apply_rope, rope_angles
from ..parallel.distributed import copy_to
from .gpt2 import (check_attention_impl, run_layers, tp_config,
                   unstack_blocks, write_kv)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Architecture hyperparameters (the HF ``LlamaConfig`` fields used,
    ``n_*`` names as in ``GPT2Config``)."""

    vocab_size: int = 32000
    n_positions: int = 4096          # cache/serving bound, not a table
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_kv_head: int = 12              # < n_head: grouped-query attention
    intermediate_size: int = 2048
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # "xla", "pallas" (the flash kernels where flash_profitable holds) or
    # "ring" (ring attention over a mesh's sp axis)
    attention_impl: str = "xla"

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def __post_init__(self):
        if self.n_embd % self.n_head != 0:
            raise ValueError(
                f"n_embd={self.n_embd} not divisible by n_head={self.n_head}")
        if self.n_head % self.n_kv_head != 0:
            raise ValueError(f"n_head={self.n_head} not a multiple of "
                             f"n_kv_head={self.n_kv_head}")
        check_attention_impl(self.attention_impl)


# "llama-124m" is the GPT-2-124M-comparable geometry; "llama-tiny" a
# test size. Both use GQA (n_kv_head < n_head).
CONFIGS: Dict[str, LlamaConfig] = {
    "llama-tiny": LlamaConfig(vocab_size=256, n_positions=512, n_embd=32,
                              n_layer=2, n_head=4, n_kv_head=2,
                              intermediate_size=64),
    "llama-124m": LlamaConfig(vocab_size=32000, n_positions=4096, n_embd=768,
                              n_layer=12, n_head=12, n_kv_head=4,
                              intermediate_size=2048),
}


def init_params(config: LlamaConfig, generator: torch.Generator,
                dtype=torch.float32, std: float = 0.02) -> Params:
    """Random-init parameters (normal(std) kernels, unit RMSNorm scales)
    on the generator's device, drawn in a fixed order from
    ``generator``."""
    d, l = config.n_embd, config.n_layer
    i = config.intermediate_size
    kv = config.n_kv_head * config.head_dim
    dev = generator.device

    def normal(*shape):
        return (torch.randn(shape, generator=generator, device=dev) * std
                ).to(dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "wte": normal(config.vocab_size, d),
        "blocks": {
            "ln_attn": {"scale": ones(l, d)},
            "attn": {
                "wq": {"kernel": normal(l, d, d)},
                "wk": {"kernel": normal(l, d, kv)},
                "wv": {"kernel": normal(l, d, kv)},
                "wo": {"kernel": normal(l, d, d)},
            },
            "ln_mlp": {"scale": ones(l, d)},
            "mlp": {
                "gate": {"kernel": normal(l, d, i)},
                "up": {"kernel": normal(l, d, i)},
                "down": {"kernel": normal(l, i, d)},
            },
        },
        "ln_f": {"scale": ones(d)},
        "lm_head": {"kernel": normal(d, config.vocab_size)},
    }


def _block(p: Params, h: torch.Tensor, config: LlamaConfig,
           cos: torch.Tensor, sin: torch.Tensor,
           cache: Optional[KVCache] = None, layer_idx: int = 0,
           offset: int = 0, k_valid_from: Optional[torch.Tensor] = None,
           decode_kernel: Optional[str] = None,
           flash_prefill: bool = False, tp_group=None,
           mesh=None) -> torch.Tensor:
    """One pre-norm llama block; with ``cache``, writes this layer's
    rotated K and V at ``offset`` in place and attends over the written
    prefix. ``decode_kernel`` ("layer") routes single-token steps on a
    fused cache through the decode-attention kernel and the int8
    matmuls through theirs; "matmul" keeps the int8 matmul kernels
    alone; ``None`` is the plain path. The no-cache
    attention follows ``config.attention_impl``; ``flash_prefill`` (a
    fresh-cache prefill) writes the cache at kv-head width, then runs the
    flash kernel over the new K/V repeated to the query heads. Under
    ``tp_group`` ``p`` holds this rank's Megatron slices and ``config``
    its local head counts (``gpt2.tp_config``); the column-parallel
    inputs pass ``copy_to``, and ``wo`` and ``down`` sum over the group.
    ``mesh`` (no-cache path): attention over its ``sp`` axis, the ring's
    K/V repeated to the query heads first."""
    kernels = decode_kernel is not None
    eps = config.rms_norm_eps
    a = copy_to(rms_norm(h, p["ln_attn"]["scale"], eps), tp_group)
    attn = p["attn"]
    q = split_heads(linear(a, attn["wq"]["kernel"], None, kernels),
                    config.n_head)
    k = split_heads(linear(a, attn["wk"]["kernel"], None, kernels),
                    config.n_kv_head)
    v = split_heads(linear(a, attn["wv"]["kernel"], None, kernels),
                    config.n_kv_head)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is None:
        impl = config.attention_impl
        if impl == "ring":
            if mesh is None:
                raise ValueError("attention_impl='ring' needs a mesh with "
                                 "an 'sp' axis: pass forward(..., mesh=mesh)")
            if k_valid_from is not None:
                raise NotImplementedError(
                    "ring attention does not support ragged batches")
        out = (self_attention(q, k, v, impl, offset, k_valid_from)
               if mesh is None else
               mesh_attention(q, k, v, impl, mesh, k_valid_from))
    elif flash_prefill:
        write_kv(cache, k, v, layer_idx, offset)
        out = flash_attention(q, *repeat_kv(k, v, config.n_head))
    elif cache.fused:
        if decode_kernel == "layer" and q.shape[2] == 1:
            out, _ = decode_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), cache.k, layer_idx,
                                      offset, k_valid_from)
        else:
            out, _ = cached_attention_fused(q, k, v, cache.k, layer_idx,
                                            offset, k_valid_from)
    else:
        out, _, _ = cached_attention_inplace(q, k, v, cache.k, cache.v,
                                             layer_idx, offset, k_valid_from)
    h = h + row_linear(merge_heads(out), attn["wo"]["kernel"], None, kernels,
                       tp_group)
    m = copy_to(rms_norm(h, p["ln_mlp"]["scale"], eps), tp_group)
    mlp = p["mlp"]
    m = row_linear(F.silu(linear(m, mlp["gate"]["kernel"], None, kernels))
                   * linear(m, mlp["up"]["kernel"], None, kernels),
                   mlp["down"]["kernel"], None, kernels, tp_group)
    return h + m


def apply_blocks(blocks: Union[Params, List[Params]], h: torch.Tensor,
                 config: LlamaConfig, cos: torch.Tensor, sin: torch.Tensor,
                 cache: Optional[KVCache] = None,
                 k_valid_from: Optional[torch.Tensor] = None,
                 decode_kernel: Optional[str] = None, remat: bool = False,
                 flash_prefill: bool = False, tp_group=None, mesh=None,
                 ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run a stack of llama blocks (the stacked dict or its
    ``unstack_blocks`` list) at the rotary angles ``cos``/``sin``. With
    ``cache`` the new K/V land at ``cache.length`` and the returned cache
    is one window longer (same buffers). ``remat`` (no-cache path)
    recomputes each block in the backward pass; ``tp_group`` and
    ``mesh`` as in ``_block``."""
    offset = cache.length if cache is not None else 0
    layers = blocks if isinstance(blocks, list) else unstack_blocks(blocks)

    def block(p, h, li):
        return _block(p, h, config, cos, sin, cache, li, offset,
                      k_valid_from, decode_kernel, flash_prefill, tp_group,
                      mesh)

    h = run_layers(block, layers, h, remat and cache is None)
    if cache is None:
        return h, None
    return h, KVCache(k=cache.k, v=cache.v, length=offset + h.shape[1])


def embed(params: Params, input_ids: torch.Tensor) -> torch.Tensor:
    """Token embeddings (no position table). [B, S] ids -> [B, S, D]."""
    wte = params["wte"]
    return embed_rows(wte, input_ids) if is_quantized(wte) else wte[input_ids]


def angles(config: LlamaConfig, seq_len: int, offset: int,
           pad: Optional[torch.Tensor], device: torch.device,
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) for positions ``offset + arange(S)``: ``[S, hd]``, or
    ``[B, S, hd]`` shifted down per row by ``pad`` for a left-padded
    batch (pad columns clip to position 0: masked as keys, never read
    as outputs)."""
    pos = offset + torch.arange(seq_len, device=device)
    if pad is not None:
        pos = torch.clamp(pos[None, :] - pad.to(device)[:, None], min=0)
    return rope_angles(pos, config.head_dim, config.rope_theta)


def final_logits(params: Params, h: torch.Tensor, config: LlamaConfig,
                 kernels: bool = False) -> torch.Tensor:
    """RMSNorm, then the untied head; f32 logits. An int8 head is the
    int8 linear (its kernel where ``kernels`` and the shape allow),
    rounded to the activation dtype, then f32; a float head an f32
    product of the upcast operands."""
    h = rms_norm(h, params["ln_f"]["scale"], config.rms_norm_eps)
    kernel = params["lm_head"]["kernel"]
    if is_quantized(kernel):
        return linear(h, kernel, None, kernels).float()
    return torch.matmul(h.float(), kernel.float())


def forward(params: Params, input_ids: torch.Tensor,
            config: LlamaConfig, remat: bool = False,
            mesh=None) -> torch.Tensor:
    """Full no-cache forward: [B, S] -> [B, S, vocab] f32 logits.
    ``remat`` recomputes each block in the backward pass (training).
    ``mesh``: as ``gpt2.forward``'s (this rank's slices, the global
    batch, the whole batch's logits gathered onto every rank)."""
    if mesh is not None:
        from ..parallel import spmd
        return spmd.gather_batch(mesh_forward(
            params, spmd.local_batch(input_ids, mesh), config, mesh, remat),
            mesh)
    h = embed(params, input_ids)
    cos, sin = angles(config, input_ids.shape[1], 0, None, h.device)
    h, _ = apply_blocks(params["blocks"], h, config, cos, sin, remat=remat)
    return final_logits(params, h, config)


def mesh_forward(params: Params, input_ids: torch.Tensor,
                 config: LlamaConfig, mesh, remat: bool = False,
                 ) -> torch.Tensor:
    """This rank's logits on a mesh (``gpt2.mesh_forward``): its shard of
    the batch, RoPE at the sp chunk's global positions."""
    from ..parallel import spmd
    tp = spmd.group(mesh, "tp")
    h = embed(params, input_ids)
    s = input_ids.shape[1]
    cos, sin = angles(config, s, spmd.seq_offset(mesh, s), None, h.device)
    h, _ = apply_blocks(params["blocks"], h, tp_config(config, tp), cos, sin,
                        remat=remat, tp_group=tp, mesh=mesh)
    return final_logits(params, h, config)


def mega_step(blocks: Params, h: torch.Tensor, config: LlamaConfig,
              cache: KVCache, pad: Optional[torch.Tensor],
              cos: torch.Tensor, sin: torch.Tensor,
              ) -> Optional[Tuple[torch.Tensor, KVCache]]:
    """All the stacked ``blocks`` for one embedded ``[B, 1, D]`` token in
    one whole-stack launch (``ops.decode_layer.decode_layers_llama``),
    the llama mega route that ``forward_with_cache`` and the stage runner
    share. ``cos``/``sin`` are the step's angles in either ``angles``
    layout; they become the kernel's ``[B, hd]``. Returns ``(h, cache)``,
    or ``None`` past ``MAX_BATCH`` rows."""
    b = h.shape[0]
    if b > MAX_BATCH:
        return None
    hd = config.head_dim
    cos1, sin1 = (t.reshape(-1, hd).expand(b, hd).float().contiguous()
                  for t in (cos, sin))
    h, KV = decode_layers_llama(blocks, h, cache.k, cache.length, cos1, sin1,
                                k_valid_from=pad, n_head=config.n_head,
                                eps=config.rms_norm_eps)
    return h, KVCache(k=KV, v=cache.v, length=cache.length + 1)


def run_blocks(params: Params, h: torch.Tensor, config: LlamaConfig,
               cos: torch.Tensor, sin: torch.Tensor,
               cache: Optional[KVCache], pad: Optional[torch.Tensor],
               decode_kernel: Optional[str], flash_prefill: bool = False,
               tp_group=None,
               ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """The block stack of a forward or a stage: one megakernel launch for
    a single cached token on a mega engine, else the per-layer loop.
    ``params`` are plain or from ``unstack_params``; ``tp_group`` as in
    ``forward_with_cache``."""
    if cache is not None and mega_requested(decode_kernel, h.shape[1]):
        step = mega_step(params.get("stacked_blocks", params["blocks"]), h,
                         config, cache, pad, cos, sin)
        if step is not None:
            return step
    return apply_blocks(params["blocks"], h, config, cos, sin, cache,
                        k_valid_from=pad,
                        decode_kernel=mega_downgrade(decode_kernel),
                        flash_prefill=flash_prefill, tp_group=tp_group)


def forward_with_cache(params: Params, input_ids: torch.Tensor,
                       config: LlamaConfig, cache: KVCache,
                       pad: Optional[torch.Tensor] = None,
                       decode_kernel: Optional[str] = None,
                       flash_prefill: bool = False, tp_group=None,
                       ) -> Tuple[torch.Tensor, KVCache]:
    """Cached forward (prefill when ``cache.length == 0``, a decode step
    otherwise): full-sequence f32 logits and the cache one window longer.
    Same contract as ``gpt2.forward_with_cache`` (``tp_group`` included:
    the rank attends over its ``n_head / tp`` query heads and
    ``n_kv_head / tp`` kv heads); the rotary positions shift down by
    ``pad`` per row."""
    h = embed(params, input_ids)
    cos, sin = angles(config, input_ids.shape[1], cache.length, pad,
                      h.device)
    h, cache = run_blocks(params, h, tp_config(config, tp_group), cos, sin,
                          cache, pad, decode_kernel,
                          flash_prefill and pad is None, tp_group=tp_group)
    return final_logits(params, h, config,
                        kernels=decode_kernel is not None), cache


def make_cache(config: LlamaConfig, batch: int, max_seq: int,
               dtype=torch.float32, device=None) -> KVCache:
    """KV cache at kv-head width (``[L, B, n_kv_head, max_seq, hd]``);
    ``n_positions`` bounds ``max_seq`` as the configured serving bound."""
    if max_seq > config.n_positions:
        raise ValueError(
            f"max_seq={max_seq} exceeds n_positions={config.n_positions}")
    return KVCache.create(config.n_layer, batch, config.n_kv_head, max_seq,
                          config.head_dim, dtype, device)
