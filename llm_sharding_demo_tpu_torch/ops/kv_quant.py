"""Quantized KV block storage for the paged pool: int8 or fp8 codes plus
one f32 scale per (layer, block, k|v, kv head).

Counterpart of ``llm_sharding_demo_tpu/ops/kv_quant.py``. Each ``[bs,
hd]`` block is stored as symmetric absmax codes: int8 over +-127, or
``float8_e4m3fn`` over +-448. A scatter quantizes every block it writes
from the values written (scales hold no placement history), a gather
dequantizes into the engine's dtype with one final rounding.

The arithmetic is the reference's, step for step, so that codes and
scales equal it bit for bit, on the CPU and on the card: an f32 absmax,
``max(absmax, 1e-8) / qmax`` as a true division (``_scale``: on CUDA a
tensor divided by a Python number is multiplied by its reciprocal, which
rounds differently), ``torch.round`` (half to even, as ``jnp.round``),
and for fp8 the clip before the cast (torch's cast to e4m3fn does not
saturate).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from . import paged_attention as PA

# storage dtype per quantized KV regime (utils.graftnum.regime_of tokens)
STORAGE_DTYPES = {
    "int8": torch.int8,
    "fp8": torch.float8_e4m3fn,
}

_INT8_QMAX = 127.0
_FP8_QMAX = 448.0  # float8_e4m3fn's largest finite value


def fp8_supported() -> bool:
    """Whether this torch build round-trips ``float8_e4m3fn``: the gate a
    pool consults before it builds an fp8 pool."""
    try:
        x = torch.tensor([1.0, -2.0]).to(torch.float8_e4m3fn)
        return float(x.float()[0]) == 1.0
    except (RuntimeError, TypeError):
        return False


def scales_shape(n_layer: int, num_blocks: int,
                 n_kv_head: int) -> Tuple[int, ...]:
    """The scales' shape, beside ``paged_attention.pool_shape`` (the same
    trailing trash block)."""
    return (n_layer, num_blocks + 1, 2, n_kv_head)


def _scale(absmax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``max(absmax, 1e-8) / qmax``, divided elementwise by a tensor."""
    return torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, qmax)


def quantize_blocks_int8(blk: torch.Tensor,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., bs, hd]`` float blocks -> (int8 codes, f32 scales
    ``[...]``). The 1e-8 floor keeps an all-zero block (a fresh pool,
    the trash block) at zero codes instead of 0/0."""
    x = blk.float()
    absmax = x.abs().amax(dim=(-2, -1))
    scale = _scale(absmax, _INT8_QMAX)
    q = torch.clamp(torch.round(x / scale[..., None, None]),
                    -_INT8_QMAX, _INT8_QMAX)
    return q.to(torch.int8), scale


def quantize_blocks_fp8(blk: torch.Tensor,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[..., bs, hd]`` float blocks -> (e4m3fn codes, f32 scales
    ``[...]``): the int8 scheme scaled to 448, clipped before the cast."""
    x = blk.float()
    absmax = x.abs().amax(dim=(-2, -1))
    scale = _scale(absmax, _FP8_QMAX)
    q = torch.clamp(x / scale[..., None, None], -_FP8_QMAX, _FP8_QMAX)
    return q.to(torch.float8_e4m3fn), scale


QUANTIZERS = {"int8": quantize_blocks_int8, "fp8": quantize_blocks_fp8}


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """(codes ``[..., bs, hd]``, scales ``[...]``) -> float blocks: the
    product in f32, one final rounding to ``out_dtype``."""
    return (q.float() * scale[..., None, None]).to(out_dtype)


def gather_kv_q(data: torch.Tensor, scales: torch.Tensor, tables,
                out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``paged_attention.gather_kv`` for a quantized pool: data ``[L,
    NBp, 2, H, bs, hd]`` codes, scales ``[L, NBp, 2, H]``; returns ``(k,
    v)`` each ``[L, B, H, NBm*bs, hd]`` in ``out_dtype``, dequantized
    between the take and the permute."""
    b, nbm = np.asarray(tables).shape
    l, _, _, h, bs, hd = data.shape
    idx = PA._index(tables, data.device)
    g = dequantize_blocks(data.index_select(1, idx),
                          scales.index_select(1, idx), out_dtype)
    g = g.reshape(l, b, nbm, 2, h, bs, hd).permute(3, 0, 1, 4, 2, 5, 6)
    kv = g.reshape(2, l, b, h, nbm * bs, hd)
    return kv[0], kv[1]


def _scatter_kv_q(data: torch.Tensor, scales: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor, tables,
                  qfn: Callable) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize-on-scatter for both regimes, in place: the blocks each
    target keeps (``paged_attention.scatter_kv``'s rule, last entry
    wins) are quantized and written, codes and scales in lockstep."""
    t = np.asarray(tables)
    nbm = t.shape[1]
    dst, pos = PA._last_writes(t)
    pos = np.arange(t.size) if pos is None else pos
    q, sc = qfn(PA._blocks(k, v, nbm, pos // nbm, pos % nbm))
    idx = PA._index(dst, data.device)
    data[:, idx] = q
    scales[:, idx] = sc
    return data, scales


def scatter_kv_int8(data: torch.Tensor, scales: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, tables,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write contiguous per-row K/V back as int8 blocks and fresh
    scales."""
    return _scatter_kv_q(data, scales, k, v, tables, quantize_blocks_int8)


def scatter_kv_fp8(data: torch.Tensor, scales: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, tables,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write contiguous per-row K/V back as e4m3fn blocks and fresh
    scales."""
    return _scatter_kv_q(data, scales, k, v, tables, quantize_blocks_fp8)


def copy_blocks_q(data: torch.Tensor, scales: torch.Tensor, src, dst,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy whole quantized blocks ``src[i] -> dst[i]``: codes and scale
    move verbatim (no re-quantization), so the copy dequantizes to
    exactly what the original did."""
    PA.copy_blocks(data, src, dst)
    PA.copy_blocks(scales, src, dst)
    return data, scales
