"""Rotary position embeddings (RoPE), the llama family's positions.

Counterpart of ``llm_sharding_demo_tpu/ops/rope.py``, HF
``LlamaRotaryEmbedding`` + ``apply_rotary_pos_emb`` (the rotate-half
convention, not interleaved):

    inv_freq_j = theta ** -(2j / hd)             j in [0, hd/2)
    emb        = concat([pos * inv_freq, pos * inv_freq])   # [.., S, hd]
    x'         = x * cos(emb) + rotate_half(x) * sin(emb)

Angles are float32 whatever the activation dtype, and the rotation is
applied in float32, then cast back. Positions are computed, not looked
up, so context is bounded only by the cache.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions ``[...]`` (int) -> (cos, sin), each ``[..., head_dim]``
    float32, on the positions' device."""
    j = torch.arange(0, head_dim, 2, dtype=torch.float32,
                     device=positions.device)
    # a Python-scalar base: no host-to-device copy, so a decode step that
    # computes its angles can be captured into a CUDA graph
    inv_freq = torch.pow(theta, -j / head_dim)               # [hd/2] f32
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)                  # [..., hd]
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """``[-x[half:], x[:half]]`` along the trailing axis."""
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` ``[B, H, S, hd]`` by per-position angles: ``cos``/
    ``sin`` are ``[S, hd]`` (one offset for every row) or ``[B, S, hd]``
    (per-row offsets of a left-padded batch); the head axis broadcasts."""
    if cos.dim() == 2:
        cos, sin = cos[None, None], sin[None, None]
    else:
        cos, sin = cos[:, None], sin[:, None]
    x32 = x.float()
    return (x32 * cos + rotate_half(x32) * sin).to(x.dtype)
