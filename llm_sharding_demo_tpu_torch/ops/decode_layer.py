"""Whole-stack GPT-2 decode: one token through every block in one launch.

Counterpart of ``llm_sharding_demo_tpu/ops/decode_layer.py`` (the GPT-2
megakernel; its llama sibling comes with the llama family). The
hand-written CUDA kernel (``csrc/decode_layer.cu``) replaces the TPU
kernel ``_kernel`` there: for each of the stacked blocks, LN1, the fused
QKV projection, cached attention with the new row written into the
fused cache at ``offset``, the output projection and residual, LN2, the
MLP and its residual, in one persistent launch.

Numerics are the megakernel's, not the per-layer path's: every
projection is an f32 product of upcast operands, times the int8 scale,
plus the bias in f32, rounded ONCE to the activation dtype (the
per-layer path rounds before the bias add); LN statistics and attention
are f32; gelu_new runs in f32 on the rounded product.

``decode_layers`` runs ``decode_layers_plain`` only for CPU tensors; for
CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build as cb
from . import decode_attention as DA
from .decode_attention import KERNEL_HEAD_DIM, decode_attention_plain
from .layers import layer_norm
from .quant import is_quantized

# the kernel's batch budget; the model takes the per-layer kernels past it
MAX_BATCH = 16
_LANE = 128


def mega_requested(decode_kernel: Optional[str], seq_len: int) -> bool:
    """Whether a forward takes the whole-stack route: a mega engine and a
    single-token input (a decode step, or a 1-token prompt's prefill)."""
    return decode_kernel == "mega" and seq_len == 1


def mega_downgrade(decode_kernel: Optional[str]) -> Optional[str]:
    """The per-layer mode a mega engine runs where the megakernel does not
    apply (a batch past ``MAX_BATCH``, a multi-token prefill)."""
    return "layer" if decode_kernel == "mega" else decode_kernel


def eligible(config, max_seq: int) -> bool:
    """Whether the megakernel applies to this GPT-2 geometry: the
    per-layer decode kernel's rule (``decode_attention.eligible``: fused
    rows of whole 128-element groups, a cache of whole 256-slot blocks)
    at the CUDA kernels' head dim (64, every GPT-2 size), plus the JAX
    package's 128-aligned width. The batch is checked per call
    (``MAX_BATCH``)."""
    return (DA.eligible(max_seq, config.head_dim, 1)
            and config.head_dim == KERNEL_HEAD_DIM
            and config.n_embd % _LANE == 0)


_WEIGHT_ORDER = (("ln_1", "scale"), ("ln_1", "bias"),
                 ("attn", "c_attn"), ("attn", "c_proj"),
                 ("ln_2", "scale"), ("ln_2", "bias"),
                 ("mlp", "c_fc"), ("mlp", "c_proj"))


def _parts(blocks):
    """The stacked block tree in the kernel's operand order: LN vectors as
    tensors, each projection as ``(weight, scale or None, bias)``;
    returns ``(parts, quantized)``. A tree that mixes int8 and float
    kernels is refused (the kernel would read codes as floats)."""
    parts, kinds = [], set()
    for group, name in _WEIGHT_ORDER:
        if name in ("scale", "bias"):
            parts.append(blocks[group][name])
            continue
        leaf = blocks[group][name]
        w = leaf["kernel"]
        kinds.add(is_quantized(w))
        if is_quantized(w):
            parts.append((w.q, w.scale, leaf["bias"]))
        else:
            parts.append((w, None, leaf["bias"]))
    if len(kinds) != 1:
        raise ValueError("mixed quantized/float block kernels")
    return parts, kinds.pop()


def _mm(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
        bias: torch.Tensor) -> torch.Tensor:
    """The megakernel's projection: f32 product of the upcast operands,
    times the int8 scale, plus the bias, one rounding to x's dtype."""
    y = torch.matmul(x.float(), w.float())
    if scale is not None:
        y = y * scale.float()
    return (y + bias.float()).to(x.dtype)


def _check(h, KV, offset, k_valid_from, n_head):
    if h.dim() != 3 or h.shape[1] != 1:
        raise ValueError(f"megakernel is single-token only, got h "
                         f"{tuple(h.shape)}")
    b, _, d = h.shape
    if d % n_head:
        raise ValueError(f"n_embd {d} not divisible by n_head {n_head}")
    hd = d // n_head
    if KV.dim() != 5 or tuple(KV.shape[1:3]) != (b, n_head) \
            or KV.shape[-1] != 2 * hd:
        raise ValueError(f"cache {tuple(KV.shape)} is not a fused "
                         f"[L, {b}, {n_head}, Smax, {2 * hd}] cache")
    if not 0 <= offset < KV.shape[3]:
        raise ValueError(f"offset {offset} outside the {KV.shape[3]}-slot "
                         "cache")
    if k_valid_from is not None and tuple(k_valid_from.shape) != (b,):
        raise ValueError(f"k_valid_from must be [{b}], got "
                         f"{tuple(k_valid_from.shape)}")
    return b, d, hd


def decode_layers_plain(blocks, h: torch.Tensor, KV: torch.Tensor,
                        offset: int,
                        k_valid_from: Optional[torch.Tensor] = None, *,
                        n_head: int, eps: float,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (same inputs, same result):
    layer by layer, writing only row ``offset`` of each (layer, b, head)
    of the cache."""
    b, d, hd = _check(h, KV, offset, k_valid_from, n_head)
    parts, _ = _parts(blocks)
    x = h.reshape(b, d)
    for li in range(KV.shape[0]):
        ln1_s, ln1_b, qkv, out, ln2_s, ln2_b, fc, proj = (
            p[li] if isinstance(p, torch.Tensor)
            else tuple(None if t is None else t[li] for t in p)
            for p in parts)
        a = layer_norm(x, ln1_s, ln1_b, eps)
        q, k, v = (t.reshape(b, n_head, 1, hd)
                   for t in _mm(a, *qkv).split(d, dim=-1))
        attn, _ = decode_attention_plain(q, k, v, KV, li, offset,
                                         k_valid_from)
        x = x + _mm(attn.reshape(b, d), *out)
        m = layer_norm(x, ln2_s, ln2_b, eps)
        t = F.gelu(_mm(m, *fc).float(), approximate="tanh").to(x.dtype)
        x = x + _mm(t, *proj)
    return x.reshape(b, 1, d), KV


def decode_layers(blocks, h: torch.Tensor, KV: torch.Tensor, offset: int,
                  k_valid_from: Optional[torch.Tensor] = None, *,
                  n_head: int, eps: float,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the stacked GPT-2 blocks for ONE decode token.

    ``blocks``: the stacked ``[L, ...]`` block tree (bf16, or int8
    ``QuantizedTensor`` kernels with bf16 scales); ``h`` ``[B, 1, D]``
    the embedded token; ``KV`` the fused ``[L, B, H, Smax, 2*hd]`` cache,
    whose row ``offset`` is written in place; ``k_valid_from`` ([B]
    int32) masks each row's left-pad prefix. Returns ``(h [B, 1, D],
    KV)`` for ln_f and the head. CPU tensors take the plain version;
    CUDA tensors launch the kernel (bf16 activations, B <= 16, head dim
    64) or raise."""
    if h.device.type == "cpu":
        return decode_layers_plain(blocks, h, KV, offset, k_valid_from,
                                   n_head=n_head, eps=eps)
    if h.device.type != "cuda":
        raise ValueError(f"decode_layers: unsupported device {h.device}")
    b, d, hd = _check(h, KV, offset, k_valid_from, n_head)
    parts, quantized = _parts(blocks)
    if h.dtype != torch.bfloat16 or KV.dtype != torch.bfloat16:
        raise ValueError(f"decode_layers kernel takes bfloat16 activations "
                         f"and cache, got {h.dtype} / {KV.dtype}")
    if not 1 <= b <= MAX_BATCH or hd != KERNEL_HEAD_DIM or d % _LANE:
        raise ValueError(f"decode_layers kernel needs 1 <= B <= {MAX_BATCH}, "
                         f"head_dim {KERNEL_HEAD_DIM} and n_embd % {_LANE} "
                         f"== 0, got B={b} hd={hd} d={d}")
    n_layer = KV.shape[0]
    widths = (d, d, 3 * d, d, d, d, 4 * d, d)
    rows = (None, None, d, d, None, None, d, 4 * d)
    tensors = [h, KV]
    ptrs = []
    for p, width, k in zip(parts, widths, rows):
        if isinstance(p, torch.Tensor):
            _expect(p, (n_layer, width), torch.bfloat16, "LN parameter")
            tensors.append(p)
            ptrs.append(p.data_ptr())
            continue
        w, scale, bias = p
        _expect(w, (n_layer, k, width),
                torch.int8 if quantized else torch.bfloat16, "weight")
        if scale is not None:
            _expect(scale, (n_layer, width), torch.bfloat16, "scale")
        _expect(bias, (n_layer, width), torch.bfloat16, "bias")
        for t in (w, scale, bias):
            if t is not None:
                tensors.append(t)
        ptrs += [w.data_ptr(), None if scale is None else scale.data_ptr(),
                 bias.data_ptr()]
    if k_valid_from is not None:
        if k_valid_from.dtype != torch.int32:
            raise ValueError("k_valid_from must be int32")
        tensors.append(k_valid_from)
    for t in tensors:
        if t.device != h.device or not t.is_contiguous():
            raise ValueError("decode_layers operands must be contiguous and "
                             "on one CUDA device")
    h_out = torch.empty_like(h)
    # the kernel's f32 scratch (split partial sums, softmax states): its
    # size comes from the kernel source
    n_ws = cb.DECODE_LAYERS.library.load().decode_layers_workspace_floats(
        b, d, n_head, KV.shape[3])
    if n_ws < 0:
        raise ValueError(f"decode_layers: workspace for B={b} D={d} "
                         f"Smax={KV.shape[3]} exceeds 2**31 floats")
    ws = torch.empty(n_ws, dtype=torch.float32, device=h.device)
    ptr_array = (ctypes.c_void_p * len(ptrs))(*ptrs)
    cb.DECODE_LAYERS.launch(
        h.device, ctypes.addressof(ptr_array), h.data_ptr(), h_out.data_ptr(),
        KV.data_ptr(),
        None if k_valid_from is None else k_valid_from.data_ptr(),
        ws.data_ptr(), n_ws, int(quantized), n_layer, b, n_head, d,
        KV.shape[3], offset, eps, cb.stream_handle(h))
    return h_out, KV


def _expect(t: torch.Tensor, shape, dtype, what: str) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"decode_layers: {what} must be {dtype} "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
