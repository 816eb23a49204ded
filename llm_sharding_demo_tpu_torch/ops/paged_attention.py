"""Block-pool KV storage: the pool layout, its data movers and the
gather-based paged decode attention.

Counterpart of ``llm_sharding_demo_tpu/ops/paged_attention.py``, as
plain functions on tensors (the reference runs no Pallas kernel here:
its movers are ``jnp.take`` and ``dynamic_update_slice``).

- **pool**: one ``[n_layer, num_blocks + 1, 2, n_kv_head, block_size,
  head_dim]`` tensor (k at index 0 of the pair axis, v at 1). The last
  block is the shared TRASH block: ghost rows and pad-prefix entries
  point at it, so every scatter target is a real block.
- **block tables**: ``[B, blocks_per_row]`` host numpy int32; logical
  slot ``p`` of row ``b`` lives in block ``table[b, p // bs]`` at offset
  ``p % bs``. Each mover moves a table to the pool's device as int64
  once per call.

Writes resolve duplicate targets as the reference's unrolled update
chain does: the last entry in row-major (row, block) order wins. Every
ghost and pad entry aliases the trash block, and an indexed write with
duplicate indices has no defined order on CUDA, so ``_last_writes``
picks, on the host, the one entry a target keeps; one indexed copy then
writes each target once.

``paged_decode_attention`` is the paged sibling of
``ops.attention.cached_attention_inplace``: write the new column into
its block, gather the layer's rows, attend over the written prefix.
Byte-equal to the contiguous path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .attention import causal_attention


def pool_shape(n_layer: int, num_blocks: int, n_kv_head: int,
               block_size: int, head_dim: int) -> Tuple[int, ...]:
    """The pool's shape: one extra physical block, the trash block at
    index ``num_blocks``."""
    return (n_layer, num_blocks + 1, 2, n_kv_head, block_size, head_dim)


def blocks_per_row(max_seq: int, block_size: int) -> int:
    """Block-table width covering a ``max_seq``-slot row. ``max_seq``
    must be a block multiple, so that the gathered view is exactly the
    engine's cache width."""
    if max_seq % block_size:
        raise ValueError(
            f"max_seq={max_seq} is not a multiple of block_size="
            f"{block_size}; the gathered view must match the engine's "
            "cache width exactly")
    return max_seq // block_size


def _index(tables, device: torch.device) -> torch.Tensor:
    """A host table (or id list) as an int64 index on ``device``.
    Integer tables only: a float table is a placement bug."""
    t = np.asarray(tables)
    if t.dtype.kind not in "iu":
        raise TypeError(f"block tables must be integer, got {t.dtype}")
    return torch.as_tensor(t.reshape(-1).astype(np.int64), device=device)


def _last_writes(targets: np.ndarray) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """``(unique targets, positions)``: for each distinct target of a
    flat write list, the position of its last entry (the write an
    in-order chain leaves behind). Positions are None when every target
    is distinct (write the list as it is)."""
    flat = np.asarray(targets).reshape(-1)
    uniq, first_rev = np.unique(flat[::-1], return_index=True)
    if len(uniq) == len(flat):
        return flat, None
    return uniq, len(flat) - 1 - first_rev


def gather_kv(pool: torch.Tensor, tables) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Contiguous per-row K/V views from the pool.

    pool ``[L, NBp, 2, H, bs, hd]``; tables ``[B, NBm]``. Returns
    ``(k, v)``, each ``[L, B, H, NBm*bs, hd]``, fresh tensors (the
    engine's cache layout; trash content lands only in slots the
    attention mask excludes)."""
    b, nbm = np.asarray(tables).shape
    l, _, _, h, bs, hd = pool.shape
    g = pool.index_select(1, _index(tables, pool.device))
    g = g.reshape(l, b, nbm, 2, h, bs, hd).permute(3, 0, 1, 4, 2, 5, 6)
    kv = g.reshape(2, l, b, h, nbm * bs, hd)
    return kv[0], kv[1]


def _blocks(k: torch.Tensor, v: torch.Tensor, nbm: int,
            rows: np.ndarray, cols: np.ndarray) -> torch.Tensor:
    """The pool-shaped blocks ``[L, n, 2, H, bs, hd]`` of table entries
    ``(rows[i], cols[i])`` of contiguous ``k``/``v`` ``[L, B, H, S,
    hd]``."""
    l, b, h, s, hd = k.shape
    r = torch.as_tensor(rows.astype(np.int64), device=k.device)
    c = torch.as_tensor(cols.astype(np.int64), device=k.device)

    def pick(x):  # [n, L, H, bs, hd]
        return x.reshape(l, b, h, nbm, s // nbm, hd)[:, r, :, c]

    return torch.stack([pick(k), pick(v)], dim=2).transpose(0, 1)


def scatter_kv(pool: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               tables) -> torch.Tensor:
    """Write contiguous per-row K/V ``[L, B, H, NBm*bs, hd]`` back into
    their pool blocks, in place; returns ``pool``. The inverse of
    ``gather_kv``; a target named twice keeps the last entry's block."""
    t = np.asarray(tables)
    nbm = t.shape[1]
    dst, pos = _last_writes(t)
    pos = np.arange(t.size) if pos is None else pos
    src = _blocks(k, v, nbm, pos // nbm, pos % nbm)
    pool[:, _index(dst, pool.device)] = src.to(pool.dtype)
    return pool


def copy_blocks(pool: torch.Tensor, src, dst) -> torch.Tensor:
    """Copy whole blocks ``src[i] -> dst[i]`` across every layer, in
    place (in order, as the reference's chain): the copy-on-write
    primitive."""
    for s, d in zip(np.asarray(src).reshape(-1), np.asarray(dst).reshape(-1)):
        pool[:, int(d)] = pool[:, int(s)]
    return pool


def write_token_kv(pool: torch.Tensor, k_new: torch.Tensor,
                   v_new: torch.Tensor, tables, layer_idx: int,
                   offset: int) -> torch.Tensor:
    """Write one token's K/V ``[B, H, 1, hd]`` into its block, one layer,
    in place: logical slot ``offset`` of row ``b`` lands in block
    ``tables[b, offset // bs]`` at slot ``offset % bs``. The paged
    sibling of ``ops.attention.write_kv_layer``."""
    bs = pool.shape[4]
    dst, pos = _last_writes(np.asarray(tables)[:, offset // bs])
    rows = torch.stack([k_new[:, :, 0], v_new[:, :, 0]], dim=1)  # [B,2,H,hd]
    if pos is not None:
        rows = rows[torch.as_tensor(pos.astype(np.int64),
                                    device=rows.device)]
    pool[layer_idx, _index(dst, pool.device), :, :, offset % bs] = rows.to(
        pool.dtype)
    return pool


def paged_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                           v_new: torch.Tensor, pool: torch.Tensor, tables,
                           layer_idx: int, offset: int,
                           k_valid_from: Optional[torch.Tensor] = None,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token cached attention straight off the pool: write the new
    column into its block, gather the layer's rows, attend over the
    written prefix. q ``[B, H, 1, hd]``; k_new/v_new ``[B, Hkv, 1, hd]``;
    returns ``(out [B, H, 1, hd], pool)``, byte-equal to
    ``ops.attention.cached_attention_inplace`` on the contiguous cache."""
    write_token_kv(pool, k_new, v_new, tables, layer_idx, offset)
    k, v = gather_kv(pool[layer_idx:layer_idx + 1], tables)
    end = offset + 1
    out = causal_attention(q, k[0, :, :, :end], v[0, :, :, :end],
                           q_offset=offset, kv_length=end,
                           k_valid_from=k_valid_from)
    return out, pool
