"""Meshes and the layout tables of the mesh decoders (dp / tp / ep axes).

Counterpart of ``llm_sharding_demo_tpu/parallel/spmd.py``. The JAX
package annotates each parameter with a ``PartitionSpec`` and lets the
SPMD partitioner place it and insert the collectives; here each rank
holds plain local tensors, its own slice of every sharded leaf, and the
model code calls the collectives itself (``parallel.distributed``).

A layout table mirrors the parameter tree. Each leaf's spec is a tuple
with one entry per tensor dim: None (the dim is whole on every rank), a
mesh axis name (the dim is split into contiguous equal parts over that
axis, rank i taking part i), or ``Fused(axis, parts)``: the dim is
``parts`` equal blocks laid end to end, and each block is split over the
axis on its own.

Axes:

- ``tp`` — tensor parallel, Megatron layout: q/k/v and MLP-up kernels
  column-parallel (output dim split, their biases with it), attention-out
  and MLP-down kernels row-parallel (input dim split; their biases whole,
  added once after the sum); norms and embeddings whole. GPT-2's fused
  ``c_attn`` ``[D, 3D]`` is ``Fused("tp", 3)``: the JAX package's GSPMD
  split takes contiguous thirds and re-tiles at the head reshape, while a
  manual split must give each rank its own heads' q, k and v columns.
- ``ep`` — expert parallel: the stacked expert leaves ``[L, E, ...]``
  split on their E axis; the router whole (every token needs every
  expert's logit).
- ``dp`` — data parallel (``distributed.shard_host_batch``; training:
  ``local_batch``): the batch's rows split over the axis.
- ``sp`` — sequence parallel (training): the sequence split into
  contiguous chunks over the axis; attention gathers it
  (``ops.ring_attention.mesh_attention``), or rotates K/V around the
  axis (``attention_impl="ring"``).
- ``pp`` — the pipeline axis of ``parallel.gpipe`` and
  ``parallel.pipeline_1f1b`` (stage blocks), not of the tables here.

``unshard_params`` is ``shard_params`` run backwards (a collective):
every leaf gathered to its full layout on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..models.gpt2 import Params
from ..ops.quant import QuantizedTensor
from ..utils import graftshard
from . import distributed


@dataclasses.dataclass(frozen=True)
class Fused:
    """A dim made of ``parts`` equal blocks, each split over ``axis``."""

    axis: str
    parts: int


def make_mesh(shape: Dict[str, int], devices: Optional[Sequence[int]] = None):
    """A named ``DeviceMesh``, e.g. ``make_mesh({"dp": 2, "tp": 4})``, over
    ``devices`` (global ranks; default the whole world). Validates the
    axis product against the rank count instead of letting the reshape
    fail cryptically. Without a process group, a mesh of one rank gets a
    one-process group."""
    import numpy as np
    from torch.distributed.device_mesh import DeviceMesh

    ranks = (list(devices) if devices is not None
             else list(range(distributed.world_size())))
    n = int(np.prod(list(shape.values())))
    if n != len(ranks):
        raise ValueError(
            f"mesh shape {shape} needs {n} devices, have {len(ranks)}")
    distributed.ensure_initialized(distributed.device())
    dev = distributed.device()
    arr = torch.tensor(ranks, dtype=torch.int64).reshape(
        tuple(shape.values()))
    return DeviceMesh(dev.type, arr, mesh_dim_names=tuple(shape.keys()))


def axis_size(mesh, axis: str) -> int:
    """The axis's rank count; 1 where the mesh lacks it."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis: str) -> int:
    """This rank's place on the axis; 0 where the mesh lacks it."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_local_rank(axis)


def group(mesh, axis: str):
    """The process group of ``axis`` through this rank, or None where the
    mesh lacks the axis or it has one rank (nothing to communicate)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def axis_group(mesh, axes: Sequence[str]):
    """The group of the ranks that share this rank's place on every axis
    but ``axes`` (the data-parallel group of ``("dp", "sp")``, say), or
    None where those axes hold one rank. A collective of the world the
    first time a mesh asks for it: every rank must ask in the same
    order."""
    names = mesh.mesh_dim_names
    keep = [names.index(a) for a in names if a in axes]
    n = 1
    for i in keep:
        n *= mesh.size(i)
    if n == 1:
        return None
    if len(keep) == 1:
        return mesh.get_group(names[keep[0]])
    other = [i for i in range(len(names)) if i not in keep]
    rows = mesh.mesh.permute(*other, *keep).reshape(-1, n).tolist()
    return distributed.subgroup(rows)


def batch_pspec(mesh) -> Tuple:
    """The spec of a ``[B, S]`` token batch: rows over ``dp``, positions
    over ``sp`` (each where the mesh has it)."""
    names = mesh.mesh_dim_names
    return ("dp" if "dp" in names else None,
            "sp" if "sp" in names else None)


def replicated(mesh) -> Tuple:
    """The spec of a leaf whole on every rank (the JAX package's
    ``P()``): no dim split, whatever its rank (``shard_leaf`` takes it
    for any tensor)."""
    return ()


def local_batch(ids: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's part of a global ``[B, S]`` batch under
    ``batch_pspec``: its rows over ``dp``, its chunk of positions over
    ``sp``."""
    for dim, axis in enumerate(batch_pspec(mesh)):
        if axis is None:
            continue
        n, size = axis_size(mesh, axis), ids.shape[dim]
        if size % n:
            what = "batch" if dim == 0 else "seq"
            raise ValueError(f"{what} {size} not divisible by {axis}={n}")
        ids = ids.narrow(dim, axis_rank(mesh, axis) * (size // n), size // n)
    return ids


def seq_offset(mesh, chunk: int) -> int:
    """The global position of this rank's first position: its ``sp``
    place times the chunk length."""
    return axis_rank(mesh, "sp") * chunk


def gather_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """``local_batch`` run backwards over a ``[B, S, ...]`` tensor: the
    ``sp`` chunks, then the ``dp`` rows, gathered onto every rank
    (differentiable, ``distributed.gather``)."""
    x = distributed.gather(x, 1, group(mesh, "sp"))
    return distributed.gather(x, 0, group(mesh, "dp"))


def param_pspecs(mesh) -> Params:
    """Layout table of ``models.gpt2`` params (axes the mesh lacks are
    dropped, so the same table serves a tp mesh and a mesh without one).
    Blocks carry a leading layer axis, never split."""
    tp = "tp" if "tp" in mesh.mesh_dim_names else None
    qkv = Fused(tp, 3) if tp else None
    return {
        "wte": (None, None),
        "wpe": (None, None),
        "blocks": {
            "ln_1": {"scale": (None, None), "bias": (None, None)},
            "attn": {
                "c_attn": {"kernel": (None, None, qkv), "bias": (None, qkv)},
                "c_proj": {"kernel": (None, tp, None), "bias": (None, None)},
            },
            "ln_2": {"scale": (None, None), "bias": (None, None)},
            "mlp": {
                "c_fc": {"kernel": (None, None, tp), "bias": (None, tp)},
                "c_proj": {"kernel": (None, tp, None), "bias": (None, None)},
            },
        },
        "ln_f": {"scale": (None,), "bias": (None,)},
    }


def moe_param_pspecs(mesh) -> Params:
    """Layout table of ``models.moe`` params: experts over ``ep``, and the
    expert FFN's hidden dim over ``tp`` where the mesh has one (Megatron
    layout within each expert). The router stays whole."""
    ep = "ep" if "ep" in mesh.mesh_dim_names else None
    tp = "tp" if "tp" in mesh.mesh_dim_names else None
    dense = param_pspecs(mesh)
    blocks = dict(dense["blocks"])
    del blocks["mlp"]
    blocks["moe"] = {
        "router": {"kernel": (None, None, None)},
        "experts": {
            "c_fc": {"kernel": (None, ep, None, tp), "bias": (None, ep, tp)},
            "c_proj": {"kernel": (None, ep, tp, None),
                       "bias": (None, ep, None)},
        },
    }
    return dict(dense, blocks=blocks)


def llama_param_pspecs(mesh) -> Params:
    """Layout table of ``models.llama`` params, the Megatron recipe: wq /
    wk / wv and gate / up column-parallel, wo and down row-parallel,
    norms and embeddings whole (no biases in this family). The kv
    projections split over whole kv heads, so tp must divide
    ``n_kv_head`` (``runtime.engine`` checks)."""
    tp = "tp" if "tp" in mesh.mesh_dim_names else None
    col = (None, None, tp)
    row = (None, tp, None)
    return {
        "wte": (None, None),
        "blocks": {
            "ln_attn": {"scale": (None, None)},
            "attn": {"wq": {"kernel": col}, "wk": {"kernel": col},
                     "wv": {"kernel": col}, "wo": {"kernel": row}},
            "ln_mlp": {"scale": (None, None)},
            "mlp": {"gate": {"kernel": col}, "up": {"kernel": col},
                    "down": {"kernel": row}},
        },
        "ln_f": {"scale": (None,)},
        "lm_head": {"kernel": (None, None)},
    }


def slice_dim(t: torch.Tensor, dim: int, entry, mesh) -> torch.Tensor:
    """This rank's part of ``t`` along ``dim`` for one spec entry."""
    if entry is None:
        return t
    fused = isinstance(entry, Fused)
    axis = entry.axis if fused else entry
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    parts = entry.parts if fused else 1
    size = t.shape[dim]
    if size % (parts * n):
        raise ValueError(f"dim {dim} of size {size} does not split into "
                         f"{parts} x {n} equal parts over {axis!r}")
    block = size // parts
    step = block // n
    pieces = [t.narrow(dim, p * block + r * step, step) for p in range(parts)]
    return pieces[0] if parts == 1 else torch.cat(pieces, dim=dim)


def shard_leaf(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's slice of one tensor: ``t`` itself where no dim is
    split, else a contiguous copy (no view keeps the whole alive). An
    empty spec (``replicated``) keeps any tensor whole."""
    if len(spec) == 0:
        return t
    if len(spec) != t.dim():
        raise ValueError(f"spec {tuple(spec)} has {len(spec)} entries for "
                         f"a {t.dim()}-d tensor of shape {tuple(t.shape)}")
    out = t
    for dim, entry in enumerate(spec):
        out = slice_dim(out, dim, entry, mesh)
    return out.clone(memory_format=torch.contiguous_format) \
        if out is not t else t


def shard_params(params: Params, mesh, specs: Optional[Params] = None,
                 ) -> Params:
    """This rank's slices of a parameter tree under a layout table
    (default: the dense GPT-2 ``param_pspecs``). An int8
    ``QuantizedTensor``'s codes and per-out-channel scales split
    together: the scale's spec is the code's without the input dim."""
    if specs is None:
        specs = param_pspecs(mesh)

    def leaf(t, spec):
        # the placement record the live auditor holds the holding to
        return graftshard.place(
            shard_leaf(t, spec, mesh), t.shape,
            [(d, a, t.shape[d] // axis_size(mesh, a))
             for d, a in spec_axes(spec)])

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, QuantizedTensor):
            scale_spec = tuple(spec[:-2]) + (spec[-1],)
            return QuantizedTensor(leaf(tree.q, spec),
                                   leaf(tree.scale, scale_spec), tree.rows)
        return leaf(tree, spec)

    return walk(params, specs)


def shard_moe_params(params: Params, mesh) -> Params:
    """This rank's slices of a GPT-2-MoE tree (``moe_param_pspecs``)."""
    return shard_params(params, mesh, moe_param_pspecs(mesh))


def unshard_leaf(t: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's slice (every rank
    calls: a sum over each split axis of the slices placed in zeros).
    Inverts ``shard_leaf`` exactly, ``Fused`` dims included."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        fused = isinstance(entry, Fused)
        axis = entry.axis if fused else entry
        n, r = axis_size(mesh, axis), axis_rank(mesh, axis)
        parts = entry.parts if fused else 1
        step = t.shape[dim] // parts
        shape = list(t.shape)
        shape[dim] *= n
        full = t.new_zeros(shape)
        for p in range(parts):
            full.narrow(dim, (p * n + r) * step, step).copy_(
                t.narrow(dim, p * step, step))
        t = distributed.all_reduce_sum(full, group(mesh, axis)) \
            if n > 1 else full
    return t


def unshard_params(params: Params, mesh, specs: Optional[Params] = None,
                   ) -> Params:
    """Every leaf of this rank's tree gathered back to the full layout
    (``shard_params`` run backwards; a collective: every rank calls, in
    the same order)."""
    if specs is None:
        specs = param_pspecs(mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return unshard_leaf(tree, spec, mesh)

    return walk(params, specs)


def spec_axes(spec: Sequence) -> Tuple[Tuple[int, str], ...]:
    """``((dim, axis), ...)`` of the split dims of one leaf's spec."""
    return tuple((d, e.axis if isinstance(e, Fused) else e)
                 for d, e in enumerate(spec) if e is not None)
