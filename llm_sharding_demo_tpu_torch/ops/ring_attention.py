"""Ring attention: causal self-attention over a sequence split on a mesh
axis.

Counterpart of ``llm_sharding_demo_tpu/ops/ring_attention.py``. The
sequence is split into contiguous chunks over the ``sp`` axis, one a
rank, and attention runs blockwise:

- each rank holds its own Q/K/V chunk; the K/V chunks travel one hop
  around the axis's ring a step (``parallel.distributed.shift``: rank i
  to i+1, its backward i+1 to i), so after ``sp`` steps every Q chunk has
  seen every K/V chunk and no rank ever held the whole sequence;
- the numerics are the online softmax of flash attention, in f32: a
  running max ``m``, normaliser ``l`` and unnormalised accumulator,
  rescaled as blocks arrive;
- causality comes from masks on *global* positions, so one function
  covers the diagonal block, fully visible past blocks and fully masked
  future blocks.

The JAX module runs the ring inside ``shard_map``, where each device sees
its chunk; here each rank is a process and passes its chunk
(``local_chunk`` cuts it from a global tensor). The module launches no
kernel (the JAX one has no ``pallas_call``).

``mesh_attention`` is the no-cache forward's attention on a mesh with a
``sp`` axis: the ring for ``attention_impl="ring"``; otherwise the
sequence is gathered first and each rank keeps its own query rows (what
GSPMD does for the JAX package's "xla" and "pallas").
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel import distributed
from .attention import _scale

# Placement contract (utils/graftshard): Q/K/V enter and leave with the
# sequence dim split over ``sp``; the ring's K/V shifts run over sp and
# nothing else.
PLACEMENT_CONTRACT = {
    "mesh_axes": ("sp",),
    "entry:ring_attention": "sp",
}

NEG_INF = -1e9


def _block_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor):
    """One Q chunk against one K/V chunk, flash style. q: [B, H, Sq, hd];
    k/v: [B, H, Skv, hd]; q_pos/k_pos: global positions. Returns the
    unnormalised f32 output [B, H, Sq, hd], the row max [B, H, Sq] and
    the row sum [B, H, Sq] for the online-softmax merge."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * _scale(q.shape[-1])
    mask = (k_pos[None, :] <= q_pos[:, None])[None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    # a row with no visible key would take exp(NEG_INF - NEG_INF) = 1
    # into l: clamp its max to 0 there, so exp(scores - 0) ~ 0
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(scores - m_safe[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    return torch.matmul(p, v.float()), m_safe, p.sum(dim=-1)


def _merge(acc, m, l, out_b, m_b, l_b):
    """A new block merged into the running (acc, m, l)."""
    m_new = torch.maximum(m, m_b)
    alpha = torch.exp(m - m_new)     # rescales the old accumulator
    beta = torch.exp(m_b - m_new)    # rescales the new block
    return (acc * alpha[..., None] + out_b * beta[..., None], m_new,
            l * alpha + l_b * beta)


def _check_axis(mesh, axis: str) -> None:
    names = () if mesh is None else mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"mesh has no {axis!r} axis: {names}")


def local_chunk(x: torch.Tensor, mesh, axis: str = "sp",
                dim: int = 2) -> torch.Tensor:
    """This rank's chunk of a global tensor's sequence dim ``dim`` (the
    view ``shard_map`` gives a JAX device), the length divisible by the
    axis size."""
    _check_axis(mesh, axis)
    from ..parallel.spmd import axis_rank, axis_size
    n = axis_size(mesh, axis)
    if x.shape[dim] % n:
        raise ValueError(f"seq {x.shape[dim]} not divisible by {axis}={n}")
    c = x.shape[dim] // n
    return x.narrow(dim, axis_rank(mesh, axis) * c, c)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "sp") -> torch.Tensor:
    """Causal attention of this rank's chunk: q/k/v are its
    ``[B, H, S/n, hd]`` chunk of a sequence split over ``axis`` (rank r
    holds positions ``r*chunk .. (r+1)*chunk - 1``). Returns its chunk of
    the output in q's dtype. Every rank of the axis calls together."""
    _check_axis(mesh, axis)
    from ..parallel.spmd import axis_rank, axis_size, group
    n, idx, grp = axis_size(mesh, axis), axis_rank(mesh, axis), \
        group(mesh, axis)
    chunk = q.shape[2]
    dev = q.device
    q_pos = idx * chunk + torch.arange(chunk, device=dev)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    m = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=dev)
    # K and V travel together: one transfer a hop
    kv = torch.stack([k, v])
    for s in range(n):
        # the K/V block here at step s started on rank (idx - s) mod n
        src = (idx - s) % n
        k_pos = src * chunk + torch.arange(chunk, device=dev)
        out_b, m_b, l_b = _block_attend(q, kv[0], kv[1], q_pos, k_pos)
        acc, m, l = _merge(acc, m, l, out_b, m_b, l_b)
        if s < n - 1:
            kv = distributed.shift(kv, grp)
    # l == 0 only for a row with no visible key (impossible here: a
    # position always sees itself); still, no division by 0
    l = torch.clamp(l, min=1e-20)
    return (acc / l[..., None]).to(q.dtype)


def mesh_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   impl: str, mesh,
                   k_valid_from: Optional[torch.Tensor] = None,
                   ) -> torch.Tensor:
    """The no-cache attention of this rank's chunk on a mesh whose
    ``sp`` axis splits the sequence (q: ``[B, H, chunk, hd]``; k/v at kv
    head width). ``"ring"``: K/V repeated to the query heads (HF
    ``repeat_kv`` order), then ``ring_attention``. ``"xla"`` and
    ``"pallas"``: Q, K and V gathered over ``sp``, the causal attention
    of the whole sequence (``self_attention``: the flash kernels where
    ``"pallas"`` reaches them), and this rank's query rows kept."""
    from ..parallel.spmd import axis_rank, group
    from .flash_attention import repeat_kv, self_attention
    if impl == "ring":
        return ring_attention(q, *repeat_kv(k, v, q.shape[1]), mesh)
    grp = group(mesh, "sp")
    if grp is None:
        return self_attention(q, k, v, impl, 0, k_valid_from)
    c = q.shape[2]
    q, k, v = (distributed.gather(x, 2, grp) for x in (q, k, v))
    out = self_attention(q, k, v, impl, 0, k_valid_from)
    return out.narrow(2, axis_rank(mesh, "sp") * c, c)
