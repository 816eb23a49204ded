"""Causal flash attention: forward, dQ and dK/dV.

Counterpart of ``llm_sharding_demo_tpu/ops/flash_attention.py``. The
hand-written CUDA kernels of ``csrc/flash_attention.cu`` replace its three
TPU kernels: ``_fwd_kernel`` (the output and the per-row logsumexp, f32
online softmax, tiles above the diagonal skipped), ``_bwd_dq_kernel`` and
``_bwd_dkv_kernel`` (the FlashAttention-2 backward: P recomputed from Q,
K and the saved logsumexp). ``flash_attention`` is a
``torch.autograd.Function`` (the JAX package's custom VJP): its forward
saves ``(q, k, v, out, lse)``, its backward computes
``D = rowsum(dO * O)`` in plain PyTorch (XLA's work in the JAX package,
not a kernel) and launches the dQ and the dK/dV kernels.

Each wrapper (``flash_forward``, ``flash_bwd_dq``, ``flash_bwd_dkv``)
runs its plain version (``_forward_plain``, ``_bwd_dq_plain``,
``_bwd_dkv_plain``) only for CPU tensors; for CUDA tensors it launches
the kernel or raises. The plain versions carry the JAX kernels'
arithmetic, k block by k block, with its two safeguards: a running max
still at ``NEG_INF`` shifts to 0 before ``exp`` (``m_safe``), and the
normaliser is clamped at 1e-20.

``block_q``/``block_k`` keep the JAX signature: the plain versions tile
by them as the JAX kernels do (``_pick_block``); the CUDA kernels pick
Hopper tiles of their own (128 x 128 for the bf16 forward, 128 keys by
64 queries for bf16 dK/dV, 64 x 64 else) and mask a ragged edge
themselves. ``dkv_plan`` spells out bf16 dK/dV's work list, which the
kernel walks on the card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import cuda_build as cb
from .attention import causal_attention

NEG_INF = -1e9
KERNEL_HEAD_DIM = 64  # the CUDA kernels' head dim (every GPT-2 size)


# bf16 dK/dV's tiles (``dkv_bf16`` in csrc/flash_attention.cu): a work
# tile is 128 keys of one head, whose q tiles of 64 rows run from the key
# block's diagonal to S
DKV_KEYS, DKV_QUERIES = 128, 64


def dkv_tile_cost(s: int, kt: int) -> int:
    """The q tiles that bf16 dK/dV's key block ``kt`` visits at length
    ``s``: from its diagonal to the last."""
    return -(-s // DKV_QUERIES) - kt * DKV_KEYS // DKV_QUERIES


def dkv_plan(bh: int, s: int, sms: int) -> List[List[Tuple[int, int]]]:
    """bf16 dK/dV's work, CTA by CTA: ``min(tiles, sms)`` persistent CTAs,
    each with the ``(key block, head)`` tiles it takes, in order. The
    list runs heaviest first (key blocks in order, heads inner), and the
    grid walks it forwards on even rounds and backwards on odd ones, so
    round ``n`` gives CTA ``c`` position ``n * G + c`` or
    ``n * G + G - 1 - c`` (``dkv_tile`` in the kernel)."""
    tiles = -(-s // DKV_KEYS) * bh
    ctas = min(tiles, sms)
    plan: List[List[Tuple[int, int]]] = [[] for _ in range(ctas)]
    for t in range(tiles):
        n, c = divmod(t, ctas)
        plan[c if n % 2 == 0 else ctas - 1 - c].append(divmod(t, bh))
    return plan


def _pick_block(s: int, block: int) -> int:
    block = min(block, s)
    while s % block and block > 128:
        block //= 2  # try halved tiles before giving up on tiling
    if s % block:
        block = s  # truly ragged (not a multiple of 128): single block
    return block


# The JAX package's measured crossover: below this length its
# attention_impl="pallas" dispatches to the plain (XLA) attention, and
# the port keeps the same rule so that both packages reach the kernel at
# the same lengths.
FLASH_MIN_SEQ = 2048


def flash_profitable(s: int) -> bool:
    """Whether ``attention_impl="pallas"`` takes the kernel at this
    sequence length (see ``FLASH_MIN_SEQ``)."""
    return s >= FLASH_MIN_SEQ


def flash_eligible(s: int, block_q: int = 512, block_k: int = 1024) -> bool:
    """The JAX package's tiling rule, kept so that both packages' engines
    gate flash prefill alike: True when ``s`` tiles without degrading to
    one full-sequence block beyond the configured tile sizes."""
    if s <= block_k:
        return True
    return (_pick_block(s, block_q) <= block_q
            and _pick_block(s, block_k) <= block_k)


def _scale(hd: int) -> float:
    return 1.0 / float(hd) ** 0.5


def _flat(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.reshape(b * h, s, hd).float()


def flash_delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``D = rowsum(dO * O)`` in f32, ``[B*H, S, 1]``: plain PyTorch
    between the forward and the backward kernels."""
    return (_flat(g) * _flat(out)).sum(-1, keepdim=True)


# -- plain versions --------------------------------------------------------------

def _forward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   block_q: int = 512, block_k: int = 1024,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B, H, S, hd] in q's dtype, lse [B*H, S, 1] f32)``: the
    forward kernel's online softmax over k blocks, all q rows at once."""
    b, h, s, hd = q.shape
    bk = _pick_block(s, block_k)
    scale = _scale(hd)
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    q_pos = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b * h, s, 1), NEG_INF, device=q.device)
    l = torch.zeros((b * h, s, 1), device=q.device)
    acc = torch.zeros((b * h, s, hd), device=q.device)
    for k0 in range(0, s, bk):
        mask = (k0 + torch.arange(bk, device=q.device))[None, :] <= q_pos
        sc = torch.matmul(qf, kf[:, k0:k0 + bk].transpose(1, 2)) * scale
        sc = torch.where(mask, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        # rows with nothing visible yet keep m at NEG_INF; shift to 0 so
        # exp() underflows to exactly 0 instead of producing 1s
        m_safe = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(m_new),
                             m_new)
        p = torch.where(mask, torch.exp(sc - m_safe), torch.zeros_like(sc))
        alpha = torch.exp(m - m_safe)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[:, k0:k0 + bk])
        m = m_safe
    l = torch.clamp(l, min=1e-20)  # causal rows always see themselves
    out = (acc / l).to(q.dtype).reshape(b, h, s, hd)
    return out, m + torch.log(l)


def _recompute(q, k, v, do, lse, delta, k0, bk, scale):
    """P and dS of k block ``[k0, k0 + bk)`` for every q row, from the
    saved logsumexp (the backward kernels' recomputation)."""
    s = q.shape[1]
    q_pos = torch.arange(s, device=q.device)[:, None]
    mask = (k0 + torch.arange(bk, device=q.device))[None, :] <= q_pos
    kb = k[:, k0:k0 + bk]
    sc = torch.matmul(q, kb.transpose(1, 2)) * scale
    p = torch.exp(torch.where(mask, sc, torch.full_like(sc, NEG_INF)) - lse)
    p = torch.where(mask, p, torch.zeros_like(p))
    dp = torch.matmul(do, v[:, k0:k0 + bk].transpose(1, 2))
    return p, p * (dp - delta), kb


def _bwd_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """dQ = scale * sum over k blocks of dS . K, in q's dtype."""
    b, h, s, hd = q.shape
    bk = _pick_block(s, block_k)
    scale = _scale(hd)
    qf, kf, vf, dof = _flat(q), _flat(k), _flat(v), _flat(do)
    dq = torch.zeros_like(qf)
    for k0 in range(0, s, bk):
        _, ds, kb = _recompute(qf, kf, vf, dof, lse, delta, k0, bk, scale)
        dq = dq + scale * torch.matmul(ds, kb)
    return dq.to(q.dtype).reshape(b, h, s, hd)


def _bwd_dkv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   block_q: int = 512, block_k: int = 1024,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK = scale * dS^T . Q and dV = P^T . dO for each k block, in q's
    dtype."""
    b, h, s, hd = q.shape
    bk = _pick_block(s, block_k)
    scale = _scale(hd)
    qf, kf, vf, dof = _flat(q), _flat(k), _flat(v), _flat(do)
    dk, dv = [], []
    for k0 in range(0, s, bk):
        p, ds, _ = _recompute(qf, kf, vf, dof, lse, delta, k0, bk, scale)
        dk.append(scale * torch.matmul(ds.transpose(1, 2), qf))
        dv.append(torch.matmul(p.transpose(1, 2), dof))
    return tuple(torch.cat(x, dim=1).to(q.dtype).reshape(b, h, s, hd)
                 for x in (dk, dv))


def _backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                    block_q: int = 512, block_k: int = 1024,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's residuals and the output
    gradient ``g``: D, then the two backward kernels' plain versions."""
    delta = flash_delta(out, g)
    dq = _bwd_dq_plain(q, k, v, g, lse, delta, block_q, block_k)
    dk, dv = _bwd_dkv_plain(q, k, v, g, lse, delta, block_q, block_k)
    return dq, dk, dv


# -- kernel wrappers ---------------------------------------------------------------

def _check(q, k, v, *more):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must be equal [B, H, S, hd] shapes: "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    return _is_cpu(q, k, v, *more)


def _is_cpu(*tensors) -> bool:
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash attention operands must all lie on the CPU "
                         f"or on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    return False


def _cuda_operands(q, k, v, *more, stats=()):
    """Validate the kernels' operands: q/k/v-shaped tensors of one dtype
    (f32 or bf16) with head_dim 64, and f32 ``[B*H, S, 1]`` row
    statistics, all contiguous on one device."""
    b, h, s, hd = q.shape
    if hd != KERNEL_HEAD_DIM:
        raise ValueError(f"the flash kernels take head_dim "
                         f"{KERNEL_HEAD_DIM}, got {hd}")
    for t in (k, v, *more):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"flash operands must share q's shape "
                             f"{tuple(q.shape)} and dtype {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for t in stats:
        if tuple(t.shape) != (b * h, s, 1) or t.dtype != torch.float32:
            raise ValueError(f"row statistics must be f32 [{b * h}, {s}, 1],"
                             f" got {tuple(t.shape)} {t.dtype}")
    for t in (q, k, v, *more, *stats):
        if not t.is_contiguous():
            raise ValueError("flash kernel operands must be contiguous")
        if t.data_ptr() % 16:
            # the bf16 forward's TMA copies need 16-byte aligned tensors
            raise ValueError("flash kernel operands must start on a "
                             "16-byte boundary")
    return b * h, s, hd, cb.dtype_code(q)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  block_q: int = 512, block_k: int = 1024,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)``: the forward kernel (``_forward_plain`` on the
    CPU)."""
    if _check(q, k, v):
        return _forward_plain(q, k, v, block_q, block_k)
    bh, s, hd, code = _cuda_operands(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s, 1), dtype=torch.float32, device=q.device)
    cb.FLASH_FWD.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), lse.data_ptr(), code, bh, s, hd,
                        _scale(hd), cb.stream_handle(q))
    return out, lse


def flash_bwd_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                 block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """dQ: the dQ kernel (``_bwd_dq_plain`` on the CPU)."""
    if _check(q, k, v, do, lse, delta):
        return _bwd_dq_plain(q, k, v, do, lse, delta, block_q, block_k)
    bh, s, hd, code = _cuda_operands(q, k, v, do, stats=(lse, delta))
    dq = torch.empty_like(q)
    cb.FLASH_BWD_DQ.launch(q.device, q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), dq.data_ptr(), code, bh, s, hd,
                           _scale(hd), cb.stream_handle(q))
    return dq


def flash_bwd_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  block_q: int = 512, block_k: int = 1024,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)``: the dK/dV kernel (``_bwd_dkv_plain`` on the CPU)."""
    if _check(q, k, v, do, lse, delta):
        return _bwd_dkv_plain(q, k, v, do, lse, delta, block_q, block_k)
    bh, s, hd, code = _cuda_operands(q, k, v, do, stats=(lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    cb.FLASH_BWD_DKV.launch(q.device, q.data_ptr(), k.data_ptr(),
                            v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                            code, bh, s, hd, _scale(hd), cb.stream_handle(q))
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The JAX package's custom VJP: the forward kernel saves the
    logsumexp, the backward recomputes P tile by tile in its two
    kernels."""

    @staticmethod
    def forward(ctx, q, k, v, block_q, block_k):
        out, lse = flash_forward(q, k, v, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = flash_delta(out, g)
        dq = flash_bwd_dq(q, k, v, g, lse, delta, *ctx.blocks)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, *ctx.blocks)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    block_q: int = 512, block_k: int = 1024) -> torch.Tensor:
    """Causal flash attention, ``[B, H, S, hd] -> [B, H, S, hd]`` (q, k
    and v of one shape: GQA heads are repeated by the caller), in q's
    dtype. Differentiable through the backward kernels; without
    gradients only the forward kernel runs."""
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    q, k, v = (x.contiguous() for x in (q, k, v))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, block_q, block_k)
    return flash_forward(q, k, v, block_q, block_k)[0]


def repeat_kv(k: torch.Tensor, v: torch.Tensor,
              n_head: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V ``[B, Hkv, S, hd]`` repeated to ``n_head`` heads in HF
    ``repeat_kv`` order (query head ``i`` reads kv head ``i // g``): the
    flash kernels take equal q/kv head counts."""
    g = n_head // k.shape[1]
    if g == 1:
        return k, v
    return k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   impl: str, offset: int = 0,
                   k_valid_from: Optional[torch.Tensor] = None,
                   ) -> torch.Tensor:
    """The no-cache forward's attention: with ``impl == "pallas"`` and
    ``flash_profitable`` the flash kernels (GQA heads repeated first),
    else the plain causal attention, which takes GQA as it is."""
    if impl == "pallas" and flash_profitable(q.shape[2]):
        return flash_attention(q, *repeat_kv(k, v, q.shape[1]))
    return causal_attention(q, k, v, q_offset=offset,
                            k_valid_from=k_valid_from)
