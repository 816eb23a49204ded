"""Weight-only int8 quantization for the decode path.

Counterpart of ``llm_sharding_demo_tpu/ops/quant.py``. Symmetric
per-output-channel scales: for a ``[in, out]`` kernel,
``scale[o] = max|W[:, o]| / 127`` and ``q = round(W / scale)`` (round
half to even, clipped to +-127), stored int8 with the scale in the
activation dtype. The embedding/head table ``wte`` quantizes the same
way (its scale is per embedding dim) and its rows are padded to a
multiple of 2048 for the head kernel; ``rows`` keeps the real count.

Two hand-written CUDA kernels (``csrc/quant.cu``) stream the int8
weights at decode shapes (<= 16 activation rows):

- ``quant_linear`` replaces the TPU kernel ``_linear_kernel``; its grid
  comes from ``linear_plan``;
- ``quant_head`` replaces the TPU kernel ``_head_kernel``; its grid
  comes from ``head_plan``.

Each wrapper runs its plain PyTorch version (``linear_plain`` /
``head_plain``) only for CPU tensors; for a CUDA tensor it launches the
kernel or raises. Larger row counts (prefill) take the plain
dequantize-then-matmul form, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build as cb

Params = Dict[str, Any]

MAX_KERNEL_ROWS = 16  # the kernels' activation-row budget
_ALIGN = 128          # contraction/output alignment the kernels assume
VOCAB_PAD = 2048      # head table row padding


@dataclasses.dataclass(eq=False)
class QuantizedTensor:
    """An int8 weight plus its per-channel scale. ``rows`` is the real row
    count of a padded head table (``None`` for block kernels). Indexing
    slices both tensors along their leading (layer) axes. A dataclass,
    so that walkers of parameter trees (the memory ledger) reach its
    tensors."""

    q: torch.Tensor
    scale: torch.Tensor
    rows: Optional[int] = None

    def __getitem__(self, idx) -> "QuantizedTensor":
        return QuantizedTensor(self.q[idx], self.scale[idx], self.rows)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, QuantizedTensor)


def quantize_array(w: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> QuantizedTensor:
    """[..., in, out] float kernel -> QuantizedTensor(int8, scale[..., out])."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return QuantizedTensor(q.to(torch.int8),
                           scale.squeeze(-2).to(compute_dtype))


def dequantize_array(qleaf: QuantizedTensor,
                     dtype=torch.float32) -> torch.Tensor:
    """Materialize the float kernel (tests only); padded rows dropped."""
    w = qleaf.q.to(dtype) * qleaf.scale.unsqueeze(-2).to(dtype)
    if qleaf.rows is not None:
        w = w[..., :qleaf.rows, :]
    return w


def round_up_vocab(v: int) -> int:
    return -(-v // VOCAB_PAD) * VOCAB_PAD


def quantize_params(params: Params, compute_dtype=torch.bfloat16) -> Params:
    """Quantize every matmul ``kernel`` and the ``wte`` table; every other
    float leaf (``wpe``, LN scales, biases) casts to ``compute_dtype``."""
    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if name == "kernel":
            return quantize_array(tree, compute_dtype)
        if name == "wte":
            leaf = quantize_array(tree, compute_dtype)
            v = leaf.q.shape[0]
            v_pad = round_up_vocab(v)
            # zero rows give zero logits, sliced off before use; embedding
            # gathers only index real ids
            return QuantizedTensor(F.pad(leaf.q, (0, 0, 0, v_pad - v)),
                                   leaf.scale, rows=v)
        if tree.is_floating_point():
            return tree.to(compute_dtype)
        return tree

    return walk(params)


def embed_rows(qleaf: QuantizedTensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows of a quantized [vocab, d] table, dequantized with the
    shared per-d scale."""
    return qleaf.q[ids].to(qleaf.scale.dtype) * qleaf.scale


def kernel_eligible(d: int, out: int, rows: int) -> bool:
    """Whether the int8 streaming kernels apply: few activation rows (the
    weight stream dominates) and aligned contraction/output dims."""
    return rows <= MAX_KERNEL_ROWS and d % _ALIGN == 0 and out % _ALIGN == 0


# -- kernel 2: block linear ---------------------------------------------------

# The launch plan of the linear kernel (csrc/quant.cu): a CTA owns ``bn``
# output columns and one of ``split`` equal slices of the contraction, and
# the ``split`` CTAs of a column tile form one cluster that adds their
# partial sums through distributed shared memory. A second wave of CTAs
# cost more than it gave in the decode-attention sweep
# (tools/cluster_sweep.py), so a split grid stays within one CTA per SM.
LINEAR_SMS = 132          # an H100's SMs
LINEAR_TILES = (128, 64)  # column tiles, the wider first
LINEAR_STEP = 16          # contraction rows of one tensor-core step
LINEAR_MIN_CHUNK = 64     # the fewest contraction rows a rank takes
LINEAR_MAX_SPLIT = 16     # Hopper's largest (non-portable) cluster


@functools.lru_cache(maxsize=None)  # called every launch; a model has few shapes
def linear_plan(rows: int, d: int, n: int) -> Tuple[int, int]:
    """``(bn, split)`` for ``[rows, d] x int8 [d, n]``: split 1 with
    128-column tiles where the tiles alone fill the card (llama's untied
    head); otherwise the tile width and split that put the most CTAs to
    work within ``LINEAR_SMS``, the wider tile and the smaller split on a
    tie, each rank taking ``d / split`` contraction rows, a whole number
    of ``LINEAR_STEP``-row steps and at least ``LINEAR_MIN_CHUNK``.
    ``rows`` leaves the plan as it is: the tensor cores take up to 16
    rows at the cost of one, so every row count streams the same tiles."""
    del rows
    best, best_ctas = (LINEAR_TILES[0], 1), n // LINEAR_TILES[0]
    if best_ctas >= LINEAR_SMS:
        return best
    for bn in LINEAR_TILES:
        if n % bn:
            continue
        for split in range(2, LINEAR_MAX_SPLIT + 1):
            chunk = d // split
            if (d % split or chunk % LINEAR_STEP
                    or chunk < LINEAR_MIN_CHUNK):
                continue
            ctas = n // bn * split
            if best_ctas < ctas <= LINEAR_SMS:
                best, best_ctas = (bn, split), ctas
    return best


def linear_plain(x: torch.Tensor, q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Plain version of ``quant_linear``: f32 accumulation, one rounding
    to x's dtype (the JAX package's ``_linear_kernel`` numerics)."""
    y = torch.matmul(x.float(), q.float()) * scale.float()
    return y.to(x.dtype)


def quant_linear(x: torch.Tensor, q: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """[rows, d] x int8 [d, out] (* per-out scale) -> [rows, out] in x's
    dtype. CPU tensors take ``linear_plain``; CUDA tensors (bf16) launch
    the kernel (``csrc/quant.cu``)."""
    if x.device.type == "cpu":
        return linear_plain(x, q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_linear: unsupported device {x.device}")
    rows, d = _check_2d(x, "quant_linear")
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[0] != d:
        raise ValueError(f"quant_linear: q must be int8 [{d}, out], got "
                         f"{q.dtype} {tuple(q.shape)}")
    out = q.shape[1]
    if scale.shape != (out,) or scale.dtype != x.dtype:
        raise ValueError(f"quant_linear: scale must be [{out}] in "
                         f"{x.dtype}, got {scale.dtype} {tuple(scale.shape)}")
    if not 1 <= rows <= MAX_KERNEL_ROWS or out % 128 or d % LINEAR_STEP:
        raise ValueError(f"quant_linear: needs 1 <= rows <= "
                         f"{MAX_KERNEL_ROWS}, out % 128 == 0 and d % "
                         f"{LINEAR_STEP} == 0, got rows={rows} d={d} "
                         f"out={out}")
    _check_same_cuda(x, q, scale)
    if (x.data_ptr() | q.data_ptr()) % 16:
        raise ValueError("quant_linear: x and q must start on a 16-byte "
                         "boundary (the kernel's vector loads)")
    y = torch.empty((rows, out), dtype=x.dtype, device=x.device)
    bn, split = linear_plan(rows, d, out)
    cb.QUANT_LINEAR.launch(x.device, x.data_ptr(), q.data_ptr(),
                           scale.data_ptr(), y.data_ptr(), rows, d, out, bn,
                           split, cb.stream_handle(x))
    return y


def quant_matmul(x: torch.Tensor, qleaf: QuantizedTensor,
                 kernels: bool = False) -> torch.Tensor:
    """x [..., in] @ quantized [in, out] -> [..., out] in x's dtype.
    With ``kernels`` and decode shapes (rows <= 16, aligned dims) the
    int8 kernel runs; otherwise the plain dequantize-then-matmul form."""
    d, out = qleaf.q.shape[-2], qleaf.q.shape[-1]
    rows = x.numel() // d
    if kernels and qleaf.q.dim() == 2 and kernel_eligible(d, out, rows):
        y = quant_linear(x.reshape(rows, d).contiguous(), qleaf.q,
                         qleaf.scale)
        return y.reshape(*x.shape[:-1], out)
    return linear_plain(x, qleaf.q, qleaf.scale)


# -- kernel 3: tied LM head ---------------------------------------------------

# The launch plan of the head kernel (csrc/quant.cu): the table's [V_pad,
# d] rows go in m16 tiles of HEAD_TILE vocab rows, and each CTA streams a
# contiguous span of them. HEAD_CTAS_PER_SM CTAs an SM, all resident at
# once (the launch refuses a grid that is not), so the table streams in
# one wave and no SM idles through a tail. Two CTAs an SM give each SM two
# producer warps issuing boxes: one could not issue them fast enough
# (tools/head_sweep.py).
HEAD_TILE = 16         # vocab rows of a tensor-core tile and of a TMA box
HEAD_BOX_K = 128       # contraction codes of a box (one 128-byte swizzle row)
HEAD_CTAS_PER_SM = 2


@functools.lru_cache(maxsize=None)  # called every launch; a model has few shapes
def head_plan(rows: int, v: int, d: int) -> Tuple[int, int]:
    """``(ctas, span)`` for ``[rows, d] x int8 [v, d]^T``:
    ``HEAD_CTAS_PER_SM`` CTAs on each of ``LINEAR_SMS`` SMs, or one per
    m16 tile of a table with fewer tiles; CTA i takes ``head_span(i, v //
    HEAD_TILE, ctas)``, so the spans differ by at most one tile, and
    ``span`` is the longest. ``rows`` and ``d`` leave the plan as it is:
    the tensor cores take up to 16 rows at the cost of one, and every
    tile streams all of d."""
    del rows, d
    tiles = v // HEAD_TILE
    ctas = min(HEAD_CTAS_PER_SM * LINEAR_SMS, tiles)
    return ctas, -(-tiles // ctas)


def head_span(cta: int, tiles: int, ctas: int) -> Tuple[int, int]:
    """The m16 tiles ``[lo, hi)`` that CTA ``cta`` of ``ctas`` takes, as
    the kernel computes them."""
    return cta * tiles // ctas, (cta + 1) * tiles // ctas


def head_plain(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Plain version of ``quant_head``: f32 ``x . q^T``."""
    return torch.matmul(x.float(), q.float().t())


def quant_head(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """[rows, d] x int8 [V_pad, d] (contract d) -> [rows, V_pad] f32. CPU
    tensors take ``head_plain``; CUDA tensors (bf16) launch the kernel
    (``csrc/quant.cu``) on ``head_plan``'s grid."""
    if x.device.type == "cpu":
        return head_plain(x, q)
    if x.device.type != "cuda":
        raise ValueError(f"quant_head: unsupported device {x.device}")
    rows, d = _check_2d(x, "quant_head")
    if q.dtype != torch.int8 or q.dim() != 2 or q.shape[1] != d:
        raise ValueError(f"quant_head: q must be int8 [V, {d}], got "
                         f"{q.dtype} {tuple(q.shape)}")
    v = q.shape[0]
    if (not 1 <= rows <= MAX_KERNEL_ROWS or d % HEAD_BOX_K
            or v % HEAD_TILE or not v):
        raise ValueError(f"quant_head: needs 1 <= rows <= "
                         f"{MAX_KERNEL_ROWS}, d % {HEAD_BOX_K} == 0 and V % "
                         f"{HEAD_TILE} == 0, got rows={rows} d={d} V={v}")
    _check_same_cuda(x, q)
    if (x.data_ptr() | q.data_ptr()) % 16:
        raise ValueError("quant_head: x and q must start on a 16-byte "
                         "boundary (the kernel's vector and TMA loads)")
    out = torch.empty((rows, v), dtype=torch.float32, device=x.device)
    ctas, _ = head_plan(rows, v, d)
    cb.QUANT_HEAD.launch(x.device, x.data_ptr(), q.data_ptr(),
                         out.data_ptr(), rows, d, v, ctas,
                         cb.stream_handle(x))
    return out


def head_logits(h: torch.Tensor, qleaf: QuantizedTensor,
                kernels: bool = False) -> torch.Tensor:
    """Tied LM head against the quantized wte: [B,S,d] -> [B,S,vocab] f32.

    wte's scale is per embedding dim, the CONTRACTED axis, so it folds
    into the activation before the dot (rounded to the activation dtype,
    as the JAX package does); the padded vocab rows are sliced off."""
    b, s, d = h.shape
    v_pad = qleaf.q.shape[0]
    hs = (h.float() * qleaf.scale.float()).to(h.dtype)
    rows = b * s
    if kernels and kernel_eligible(d, v_pad, rows):
        logits = quant_head(hs.reshape(rows, d).contiguous(),
                            qleaf.q).reshape(b, s, v_pad)
    else:
        logits = head_plain(hs, qleaf.q)
    if qleaf.rows is not None:
        logits = logits[..., :qleaf.rows]
    return logits


def _check_2d(x: torch.Tensor, kernel: str):
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{kernel}: x must be a contiguous 2-D tensor, got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    if x.dtype != torch.bfloat16:
        # the int8 regime runs bf16 activations; the kernel takes no other
        raise ValueError(f"{kernel}: x must be bfloat16, got {x.dtype}")
    return x.shape


def _check_same_cuda(*tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous and on one "
                             f"CUDA device, got {[str(u.device) for u in tensors]}")
