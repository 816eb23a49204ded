"""Multi-head causal self-attention with a KV cache.

Counterpart of ``llm_sharding_demo_tpu/ops/attention.py``. Masks come
from absolute positions (query i attends key j iff ``j <= q_offset + i``,
``j < kv_length`` and ``j >= k_valid_from[b]``), softmax runs in float32
whatever the activation dtype. Unlike the JAX package, cache writes
update the buffers IN PLACE (the stacked ``[L, B, H, max_seq, hd]``
tensors are written at ``(layer, :, :, offset)``): nothing is copied, and
the functions return the same tensors they were given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

NEG_INF = -1e9  # large-negative additive mask; finite so 0*inf NaNs can't leak


@dataclasses.dataclass
class KVCache:
    """Per-layer-group KV cache. ``k``/``v`` are ``[n_layer, batch,
    n_kv_head, max_seq, head_dim]``; in the FUSED layout ``k`` holds
    ``[n_layer, batch, n_kv_head, max_seq, 2*head_dim]`` rows ``[K | V]``
    and ``v`` is an empty placeholder. ``length`` is the number of
    positions written, a Python int."""

    k: torch.Tensor
    v: torch.Tensor
    length: int = 0

    @staticmethod
    def create(n_layer: int, batch: int, n_head: int, max_seq: int,
               head_dim: int, dtype=torch.float32, device=None) -> "KVCache":
        shape = (n_layer, batch, n_head, max_seq, head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))

    @property
    def fused(self) -> bool:
        return self.v.dim() == 1 and self.v.shape[0] == 0


def split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """[B, S, D] -> [B, H, S, hd]."""
    b, s, d = x.shape
    return x.reshape(b, s, n_head, d // n_head).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, hd] -> [B, S, D]."""
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int = 0, kv_length: Optional[int] = None,
                     k_valid_from: Optional[torch.Tensor] = None,
                     ) -> torch.Tensor:
    """Scaled dot-product attention with causal masking by absolute
    position. q: [B, H, Sq, hd]; k, v: [B, Hkv, Skv, hd]. ``k_valid_from``
    ([B] int) makes row b ignore keys at positions ``< k_valid_from[b]``
    (the left-pad prefix of a ragged batch).

    Grouped-query attention (the llama family): with ``Hkv < H`` query
    head ``i`` reads kv head ``i // (H / Hkv)`` (HF ``repeat_kv`` order)
    through grouped products; K and V are never repeated."""
    b, h, sq, hd = q.shape
    h_kv, skv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    g = h // h_kv
    # [B, Hkv, g*Sq, hd] x [B, Hkv, hd, Skv]: the g query heads of a kv
    # head share its K (a view, no copy of K or V)
    qg = q.float().reshape(b, h_kv, g * sq, hd)
    scores = (torch.matmul(qg, k.float().transpose(-1, -2))
              .reshape(b, h, sq, skv) * _scale(hd))
    dev = q.device
    q_pos = q_offset + torch.arange(sq, device=dev)[:, None]
    k_pos = torch.arange(skv, device=dev)[None, :]
    allowed = k_pos <= q_pos
    if kv_length is not None:
        allowed = allowed & (k_pos < kv_length)
    if k_valid_from is None:
        allowed = allowed[None, None]
    else:
        allowed = (allowed[None] & (k_pos[None] >= k_valid_from.to(dev)[
            :, None, None]))[:, None]
    scores = torch.where(allowed, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores, dim=-1)
    # the weights stay f32 through the value product, rounded once at the
    # end, as in the decode-attention kernel (the JAX package's XLA path
    # rounds them to the value dtype first; in fp32 the two agree)
    out = torch.matmul(weights.reshape(b, h_kv, g * sq, skv), v.float())
    return out.reshape(b, h, sq, hd).to(v.dtype)


def write_kv_layer(K: torch.Tensor, V: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, layer_idx: int, offset: int) -> None:
    """Write new K/V ``[B, H, S, hd]`` into the stacked cache at
    ``(layer_idx, :, :, offset)``, in place."""
    s = k_new.shape[2]
    _check_room(K, offset, s)
    K[layer_idx, :, :, offset:offset + s] = k_new.to(K.dtype)
    V[layer_idx, :, :, offset:offset + s] = v_new.to(V.dtype)


def cached_attention_inplace(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, K: torch.Tensor,
                             V: torch.Tensor, layer_idx: int, offset: int,
                             k_valid_from: Optional[torch.Tensor] = None,
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Write the new K/V into the stacked cache, then attend against the
    written prefix of that layer. Returns ``(out, K, V)``."""
    s = k_new.shape[2]
    write_kv_layer(K, V, k_new, v_new, layer_idx, offset)
    end = offset + s
    out = causal_attention(q, K[layer_idx, :, :, :end],
                           V[layer_idx, :, :, :end], q_offset=offset,
                           kv_length=end, k_valid_from=k_valid_from)
    return out, K, V


def create_fused_cache(n_layer: int, batch: int, n_kv_head: int,
                       max_seq: int, head_dim: int, dtype,
                       device=None) -> KVCache:
    """FUSED layout: ``k`` holds ``[L, B, Hkv, max_seq, 2*hd]`` rows
    ``[K | V]``, ``v`` is empty. One position is one contiguous row, the
    layout the decode-attention kernel streams (256 bytes in bf16 at
    hd = 64) and writes with one row copy."""
    shape = (n_layer, batch, n_kv_head, max_seq, 2 * head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros((0,), dtype=dtype, device=device))


def write_kv_layer_fused(KV: torch.Tensor, k_new: torch.Tensor,
                         v_new: torch.Tensor, layer_idx: int,
                         offset: int) -> torch.Tensor:
    """Fused-layout sibling of ``write_kv_layer``: rows
    ``concat([K, V])`` written in place."""
    s = k_new.shape[2]
    _check_room(KV, offset, s)
    KV[layer_idx, :, :, offset:offset + s] = torch.cat(
        [k_new, v_new], dim=-1).to(KV.dtype)
    return KV


def cached_attention_fused(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, KV: torch.Tensor,
                           layer_idx: int, offset: int,
                           k_valid_from: Optional[torch.Tensor] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-token cached attention over the FUSED cache (the plain path:
    prefill and other multi-token windows)."""
    s = k_new.shape[2]
    hd = k_new.shape[-1]
    write_kv_layer_fused(KV, k_new, v_new, layer_idx, offset)
    end = offset + s
    layer = KV[layer_idx, :, :, :end]
    out = causal_attention(q, layer[..., :hd], layer[..., hd:],
                           q_offset=offset, kv_length=end,
                           k_valid_from=k_valid_from)
    return out, KV


def _scale(hd: int) -> float:
    """1/sqrt(hd) rounded as float32 arithmetic gives it (the JAX
    package's f32 sqrt and divide)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _check_room(cache: torch.Tensor, offset: int, s: int) -> None:
    # the JAX package's dynamic_update_slice would clamp an overflowing
    # write; here slicing would silently write fewer rows — refuse instead
    if offset < 0 or offset + s > cache.shape[3]:
        raise ValueError(f"cache write [{offset}, {offset + s}) outside "
                         f"the {cache.shape[3]}-slot cache")
