"""Single-token cached attention with an in-place fused-cache write.

Counterpart of ``llm_sharding_demo_tpu/ops/decode_attention.py``. The
hand-written CUDA kernel (``csrc/decode_attention.cu``) replaces the TPU
kernel ``_kernel`` there: scores over cached positions ``p`` with
``k_valid_from[b] <= p < offset`` plus the self term from ``k_new``,
f32 softmax and accumulator, output in q's dtype, and the row
``[k_new | v_new]`` written into ``KV[layer, :, :, offset]`` in place.
The kernel splits the cached positions over a thread-block cluster
(``cluster_plan``) and merges the spans' softmax states on chip.

``decode_attention`` runs ``decode_attention_plain`` only for CPU tensors;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_build as cb

BLOCK_S = 256  # the engine allocates kernel-mode caches in whole blocks
KERNEL_HEAD_DIM = 64  # the CUDA kernel's head dim (every GPT-2 size)
_MAX_G = 8


def eligible(max_seq: int, head_dim: int, q_len: int) -> bool:
    """Whether the kernel applies: a single-token query, fused rows of a
    whole number of 128-element groups, and a cache of whole blocks (the
    JAX package's rule, kept so both packages size caches alike)."""
    return (q_len == 1 and (2 * head_dim) % 128 == 0
            and max_seq % BLOCK_S == 0 and max_seq >= BLOCK_S)


# The cluster split of the kernel (csrc/decode_attention.cu): C CTAs per
# (row, kv head), each taking a contiguous span of ceil(off / C) cached
# positions, merged through distributed shared memory. A CTA holds one
# SM's registers at g = 3, and a cluster must fit inside one GPC, so the
# split stops at WAVE_CTAS CTAs in all: on an H100 (80GB HBM3, 700 W;
# tools/cluster_sweep.py) 8 rows x 4 kv heads take 18 us at C=3 (96 CTAs)
# and 27 us at C=4 (128 CTAs, a second wave).
WAVE_CTAS = 96       # CTAs that run as one wave on an H100's 132 SMs
MIN_SPAN = 64        # the fewest positions worth a CTA of its own
MAX_CLUSTER = 16     # Hopper's largest (non-portable) cluster


def cluster_plan(offset: int, batch: int, kv_heads: int) -> Tuple[int, int]:
    """``(C, span)`` for a launch over ``offset`` cached positions: the
    most CTAs per (row, kv head) that keep all ``batch * kv_heads``
    clusters within ``WAVE_CTAS`` CTAs, no span shorter than
    ``MIN_SPAN`` and C at most ``MAX_CLUSTER``, never fewer than one. CTA
    rank ``r`` reads positions ``[r * span, min((r + 1) * span,
    offset))``, so the spans cover ``[0, offset)`` once each; the grid is
    ``(C, kv_heads, batch)`` with cluster ``(C, 1, 1)``."""
    c = min(MAX_CLUSTER, offset // MIN_SPAN, WAVE_CTAS // (batch * kv_heads))
    c = max(1, c)
    return c, -(-offset // c)


def _q_scale(hd: int) -> float:
    # 1/sqrt(hd) in double, applied to the f32 query (the TPU kernel's
    # python-float scale)
    return float(np.float32(1.0 / hd ** 0.5))


def _check(q, k_new, v_new, KV, layer_idx, offset, k_valid_from):
    if q.dim() != 4 or q.shape[2] != 1:
        raise ValueError(f"decode attention is single-token only: q "
                         f"{tuple(q.shape)}")
    B, H, _, hd = q.shape
    if KV.dim() != 5 or KV.shape[1] != B or KV.shape[-1] != 2 * hd:
        raise ValueError(f"cache {tuple(KV.shape)} is not a fused "
                         f"[L, {B}, Hkv, Smax, {2 * hd}] cache")
    L, _, Hkv, Smax, _ = KV.shape
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, Hkv, 1, hd):
            raise ValueError(f"{name} must be [{B}, {Hkv}, 1, {hd}], got "
                             f"{tuple(t.shape)}")
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    if not 0 <= layer_idx < L or not 0 <= offset < Smax:
        raise ValueError(f"layer {layer_idx} / offset {offset} outside the "
                         f"cache [{L} layers, {Smax} slots]")
    if k_valid_from is not None and tuple(k_valid_from.shape) != (B,):
        raise ValueError(f"k_valid_from must be [{B}], got "
                         f"{tuple(k_valid_from.shape)}")
    return B, H, hd, Hkv, Smax


def decode_attention_plain(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, KV: torch.Tensor,
                           layer_idx: int, offset: int,
                           k_valid_from: Optional[torch.Tensor] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same inputs, same result)."""
    B, H, hd, Hkv, _ = _check(q, k_new, v_new, KV, layer_idx, offset,
                              k_valid_from)
    g = H // Hkv
    q32 = q.float().reshape(B, Hkv, g, hd) * _q_scale(hd)
    layer = KV[layer_idx, :, :, :offset].float()          # [B, Hkv, off, 2hd]
    kn = k_new.float()[:, :, 0]                            # [B, Hkv, hd]
    vn = v_new.float()[:, :, 0]
    s = torch.einsum("bkgd,bkpd->bkgp", q32, layer[..., :hd])
    if k_valid_from is not None:
        pos = torch.arange(offset, device=q.device)
        ok = pos[None, :] >= k_valid_from.to(q.device)[:, None]  # [B, off]
        s = torch.where(ok[:, None, None, :], s,
                        torch.full_like(s, float("-inf")))
    s_self = torch.einsum("bkgd,bkd->bkg", q32, kn)[..., None]
    p = torch.softmax(torch.cat([s, s_self], dim=-1), dim=-1)
    out = (torch.einsum("bkgp,bkpd->bkgd", p[..., :offset], layer[..., hd:])
           + p[..., offset:] * vn[:, :, None, :])
    KV[layer_idx, :, :, offset] = torch.cat([kn, vn], dim=-1).to(KV.dtype)
    return out.to(q.dtype).reshape(B, H, 1, hd), KV


def decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, KV: torch.Tensor, layer_idx: int,
                     offset: int, k_valid_from: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token cached attention + in-place fused-cache update.

    q ``[B, H, 1, hd]``; k_new/v_new ``[B, Hkv, 1, hd]``; ``KV`` the fused
    ``[L, B, Hkv, Smax, 2*hd]`` cache, updated in place and returned;
    ``k_valid_from`` ([B] int32) masks each row's left-pad prefix. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, KV, layer_idx, offset,
                                      k_valid_from)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    B, H, hd, Hkv, Smax = _check(q, k_new, v_new, KV, layer_idx, offset,
                                 k_valid_from)
    if hd != KERNEL_HEAD_DIM or H // Hkv > _MAX_G:
        raise ValueError(f"decode_attention kernel takes head_dim "
                         f"{KERNEL_HEAD_DIM} and <= {_MAX_G} query heads per "
                         f"kv head, got hd={hd} g={H // Hkv}")
    tensors = [q, k_new, v_new, KV]
    if any(t.dtype != q.dtype for t in tensors):
        raise ValueError("decode_attention: q, k_new, v_new and the cache "
                         f"must share one dtype, got {[t.dtype for t in tensors]}")
    if k_valid_from is not None:
        if k_valid_from.dtype != torch.int32:
            raise ValueError("k_valid_from must be int32")
        tensors.append(k_valid_from)
    for t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("decode_attention operands must be contiguous "
                             "and on one CUDA device")
    out = torch.empty_like(q)
    cb.DECODE_ATTENTION.launch(
        q.device, q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), KV.data_ptr(),
        None if k_valid_from is None else k_valid_from.data_ptr(),
        out.data_ptr(), cb.dtype_code(q), B, Hkv, H // Hkv, hd, Smax,
        layer_idx, offset, cluster_plan(offset, B, Hkv)[0], _q_scale(hd),
        cb.stream_handle(q))
    return out, KV
