"""Training: the next-token LM loss, AdamW, and a train step.

Counterpart of ``llm_sharding_demo_tpu/training/train.py``. One step is
an eager forward (each block optionally recomputed in the backward pass,
``remat``), an autograd backward (through the flash-attention kernels
when ``attention_impl="pallas"``, ``ops.flash_attention``), and the
optimizer update. The JAX package's optimizer is an optax chain; here it
is ``AdamW``, plain tensor functions that reproduce that chain step for
step: global-norm clip, Adam (b1 0.9, b2 0.999, eps 1e-8 outside the
square root, bias correction), decoupled weight decay masked by
``decay_mask``, and the learning-rate schedule read at the pre-increment
step count. Moments are kept in each parameter's dtype, as optax keeps
them.

Unlike the JAX step, which returns new arrays, the update writes the
parameters and moments in place (a step allocates no second copy of
either) and returns the same dicts.

The step runs on the card unless the caller passes ``device="cpu"``.
``MoETrainStep`` trains GPT-2-MoE on the CE loss plus the weighted router
aux loss (``moe_lm_loss``).

On a mesh (``mesh=``, a ``parallel.spmd.make_mesh`` over the process
group; one process a rank, each on ``cuda:{rank % device_count}``) the
JAX package lets GSPMD derive every collective; here each rank computes
its share and the collectives are explicit:

- ``dp`` and ``sp``: each rank takes its rows and its chunk of positions
  of the global batch (every rank is handed the whole ``ids``); its loss
  is the mean over its tokens, and every gradient is averaged over the
  dp x sp group (equal shards: the global mean's gradient);
- ``tp``: Megatron's pair inside every block (``models.gpt2``), so the
  replicated leaves' gradients are whole and equal on the tp ranks;
- ``ep`` (``MoETrainStep``): each rank's experts, the dense dispatch
  summed over ``ep``, each expert's FFN split over ``tp`` where the mesh
  has one; routing global over ``sp`` (capacity is the whole
  sequence's); the aux loss global over dp x sp;
- ``pp`` outside ``GPipeTrainStep`` (an MoE mesh): no layout table or
  batch spec names it, so every pp rank computes the same step, as the
  JAX package's replicated computation does;
- the global-norm clip sums the squares of a split leaf over the ranks
  that split it, and counts a replicated leaf once.

``GPipeTrainStep`` trains over a ``pp`` axis on the GPipe or 1F1B
schedule (``parallel.gpipe``, ``parallel.pipeline_1f1b``), composed with
dp, tp and sp inside each stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models import family_module, is_moe
from ..models.gpt2 import Params
from ..utils.device import DeviceLike, resolve_device

_DECAYED = ("kernel", "wte", "wpe")
# optax.adamw's defaults, which the JAX package's adamw keeps
B1, B2, EPS = 0.9, 0.999, 1e-8


def _flatten(tree: Params, path: Tuple[str, ...] = ()):
    """``[(path, leaf), ...]`` of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [item for k, v in tree.items()
                for item in _flatten(v, path + (k,))]
    return [(path, tree)]


def _unflatten(items) -> Params:
    tree: Dict[str, Any] = {}
    for path, leaf in items:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def decay_mask(params: Params) -> Params:
    """True for the leaves that take weight decay: matmul kernels and the
    embedding tables, never biases or norm scales (the GPT-2 recipe).
    Path-based, as in the JAX package: stacked biases are 2-D too."""
    return _unflatten((path, path[-1] in _DECAYED)
                      for path, _ in _flatten(params))


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))


def lm_loss(params: Params, ids: torch.Tensor, config,
            remat: bool = False, mesh=None) -> torch.Tensor:
    """Mean next-token cross-entropy over ``ids`` [B, S] (S >= 2): logits
    for positions ``0..S-2`` predict tokens ``1..S-1``, in f32 whatever
    the activation dtype. ``mesh``: ``params`` are this rank's slices and
    ``ids`` the global batch; the loss is the mean over this rank's
    tokens (its dp rows and sp chunk of inputs and labels)."""
    if mesh is None:
        logits = family_module(config).forward(params, ids[:, :-1], config,
                                               remat=remat)
        return _ce(logits, ids[:, 1:])
    from ..parallel import spmd
    logits = family_module(config).mesh_forward(
        params, spmd.local_batch(ids[:, :-1], mesh), config, mesh, remat)
    return _ce(logits, spmd.local_batch(ids[:, 1:], mesh))


def moe_lm_loss(params: Params, ids: torch.Tensor, config,
                aux_weight: float = 0.01, mesh=None) -> torch.Tensor:
    """Next-token CE plus ``aux_weight`` times the router load-balance
    loss (``models.moe.forward``). ``mesh``: the CE of this rank's
    tokens (its dp rows and sp chunk of inputs and labels) plus the
    global aux loss."""
    from ..models import moe
    if mesh is None:
        logits, aux = moe.forward(params, ids[:, :-1], config)
        return _ce(logits, ids[:, 1:]) + aux_weight * aux
    from ..parallel import spmd
    logits, aux = moe.mesh_forward(
        params, spmd.local_batch(ids[:, :-1], mesh), config, mesh)
    return _ce(logits, spmd.local_batch(ids[:, 1:], mesh)) + aux_weight * aux


def _linear_value(init: float, end: float, steps: int,
                  count: int) -> np.float32:
    """optax.linear_schedule(init, end, steps) at ``count``, in its f32
    arithmetic."""
    if steps <= 0:
        return np.float32(init)
    frac = np.float32(1) - (np.float32(min(max(count, 0), steps))
                            / np.float32(steps))
    return np.float32(init - end) * frac + np.float32(end)


def _cosine_value(init: float, decay_steps: int, count: int) -> np.float32:
    """optax.cosine_decay_schedule(init, decay_steps) (alpha 0, exponent
    1) at ``count``, in its f32 arithmetic."""
    c = np.float32(min(count, decay_steps))
    decayed = np.float32(0.5) * (np.float32(1) + np.cos(
        np.float32(np.pi) * c / np.float32(decay_steps)))
    return np.float32(init) * decayed


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The JAX package's ``adamw`` optax chain as plain tensor functions
    (see the module docstring). ``init(params)`` gives the state (the
    step count and the two moments); ``update(params, grads, state)``
    applies one step in place."""

    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    warmup_steps: int = 0
    total_steps: Optional[int] = None
    grad_clip: float = 1.0

    def __post_init__(self):
        if (self.total_steps is not None
                and self.total_steps - self.warmup_steps <= 0):
            raise ValueError(
                f"total_steps={self.total_steps} must exceed warmup_steps="
                f"{self.warmup_steps} (the cosine decay needs steps)")

    def schedule(self, count: int) -> np.float32:
        """The learning rate at step ``count`` (0-based): optax's
        warmup_cosine_decay_schedule(0, lr, warmup, total) with
        ``total_steps``, linear_schedule(0, lr, warmup) with only a
        warmup, else the constant."""
        lr = self.learning_rate
        if self.total_steps is not None:
            if count < self.warmup_steps:
                return _linear_value(0.0, lr, self.warmup_steps, count)
            return _cosine_value(lr, self.total_steps - self.warmup_steps,
                                 count - self.warmup_steps)
        if self.warmup_steps:
            return _linear_value(0.0, lr, self.warmup_steps, count)
        return np.float32(lr)

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = [(path, torch.zeros_like(x)) for path, x in _flatten(params)]
        return {"count": 0, "mu": _unflatten(zeros),
                "nu": _unflatten((path, torch.zeros_like(x))
                                 for path, x in zeros)}

    @torch.no_grad()
    def update(self, params: Params, grads: List[torch.Tensor],
               state: Dict[str, Any], norm: Optional[torch.Tensor] = None,
               ) -> Tuple[Params, Dict[str, Any]]:
        """One step: ``grads`` are the gradients of ``params``' leaves in
        ``_flatten`` order. Writes ``params`` and the moments in place.
        ``norm`` is the gradients' global norm where they are a rank's
        share of a sharded tree (``mesh_norm``); by default the norm of
        ``grads``."""
        leaves = _flatten(params)
        mus = [x for _, x in _flatten(state["mu"])]
        nus = [x for _, x in _flatten(state["nu"])]
        if norm is None:
            # the global norm is summed in f32 (optax sums each leaf in
            # its own dtype; the same for f32 parameters)
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        keep = norm < self.grad_clip
        count = state["count"]
        t = np.float32(count + 1)
        bc1 = float(np.float32(1) - np.float32(B1) ** t)
        bc2 = float(np.float32(1) - np.float32(B2) ** t)
        step = float(-self.schedule(count))
        for (path, p), g, mu, nu in zip(leaves, grads, mus, nus):
            g = torch.where(keep, g, g / norm.to(g.dtype) * self.grad_clip)
            mu.mul_(B1).add_((1 - B1) * g)
            nu.mul_(B2).add_((1 - B2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            if path[-1] in _DECAYED:
                u = u + self.weight_decay * p
            p.add_(step * u)
        state["count"] = count + 1
        return params, state


def adamw(learning_rate: float = 1e-3, weight_decay: float = 0.01,
          warmup_steps: int = 0, total_steps: Optional[int] = None,
          grad_clip: float = 1.0) -> AdamW:
    """The stock GPT training recipe: AdamW (decay masked off biases and
    norm scales) with a global-norm clip, optional linear warmup and
    cosine decay."""
    return AdamW(learning_rate, weight_decay, warmup_steps, total_steps,
                 grad_clip)


def _pspec_fn(config) -> Callable:
    """The family's layout table (``parallel.spmd``)."""
    from ..models import llama
    from ..parallel import spmd
    if is_moe(config):
        return spmd.moe_param_pspecs
    if isinstance(config, llama.LlamaConfig):
        return spmd.llama_param_pspecs
    return spmd.param_pspecs


class MeshGrads:
    """The reductions of a sharded step on ``mesh``: the gradient mean
    over the data-parallel group (``dp`` x ``sp``), and the global norm
    over leaves split as ``split_axes`` says (``{path: axes}``, axes a
    sorted tuple). Builds every group it will use at once, so that all
    ranks make them in the same order."""

    def __init__(self, mesh, split_axes: Dict[Tuple[str, ...],
                                              Tuple[str, ...]]):
        from ..parallel import spmd
        self.mesh = mesh
        self.data = spmd.axis_group(mesh, ("dp", "sp"))
        self.n_data = spmd.axis_size(mesh, "dp") * spmd.axis_size(mesh, "sp")
        self.axes = split_axes
        self.norm_groups = {axes: spmd.axis_group(mesh, axes)
                            for axes in sorted(set(split_axes.values()))
                            if axes}

    def mean(self, grads: List[torch.Tensor],
             loss: torch.Tensor) -> torch.Tensor:
        """In place: every gradient averaged over the data group (one f32
        transfer); returns the loss averaged too."""
        if self.data is None:
            return loss
        from ..parallel import distributed
        flat = torch.cat([g.reshape(-1).float() for g in grads]
                         + [loss.float().reshape(1)])
        distributed.all_reduce_sum(flat, self.data)
        flat /= self.n_data
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return flat[-1]

    def norm(self, params: Params,
             grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of ``grads`` (``params``' leaves' gradients in
        nested-dict order): each split leaf's squares summed over the
        ranks that split it, each replicated leaf counted once."""
        from ..parallel import distributed
        axes = [self.axes[path] for path, _ in _flatten(params)]
        sq = [(g.float() ** 2).sum() for g in grads]
        for split, grp in self.norm_groups.items():
            if grp is None:
                continue
            idx = [i for i, a in enumerate(axes) if a == split]
            summed = distributed.all_reduce_sum(
                torch.stack([sq[i] for i in idx]), grp)
            for k, i in enumerate(idx):
                sq[i] = summed[k]
        # summed as AdamW.update sums one device's leaves
        return torch.sqrt(sum(sq))


def _split_axes(params_specs: Params, extra=lambda path: ()):
    """``{path: axes}`` of a layout table's leaves: the mesh axes that
    split each (plus ``extra(path)``), as a sorted tuple."""
    from ..parallel import spmd
    return {path: tuple(sorted({a for _, a in spmd.spec_axes(spec)}
                               | set(extra(path))))
            for path, spec in _flatten(params_specs)}


def check_tp_heads(config, mesh) -> None:
    """The port splits attention over ``tp`` by whole heads: tp must
    divide ``n_head`` (and llama's ``n_kv_head``). The JAX package's
    GSPMD tiles an uneven split; this port refuses it."""
    from ..parallel import spmd
    tp = spmd.axis_size(mesh, "tp")
    heads = {name: getattr(config, name) for name in ("n_head", "n_kv_head")
             if hasattr(config, name)}
    if any(n % tp for n in heads.values()):
        raise ValueError(
            f"tp={tp} must divide "
            + " and ".join(f"{k}={v}" for k, v in heads.items())
            + ": attention shards over whole heads")


@dataclasses.dataclass
class TrainStep:
    """A train step bound to ``(config, optimizer)``, on one device or on
    a ``mesh``.

    ``init(params)`` copies the parameters to the device (on a mesh, this
    rank's slices under the family's layout table, ``parallel.spmd``) and
    builds the optimizer state there;
    ``__call__(params, opt_state, ids)`` runs one step and returns
    ``(params, opt_state, loss)`` (the parameters and moments updated in
    place, the loss an f32 scalar tensor: on a mesh the global mean, on
    every rank). ``loss_fn(params, ids)`` replaces ``lm_loss``
    (``MoETrainStep`` binds the MoE loss). Every rank of the mesh makes
    the step and calls it together."""

    config: Any
    optimizer: AdamW
    mesh: Any = None
    remat: bool = False
    device: DeviceLike = "cuda"
    loss_fn: Optional[Callable[[Params, torch.Tensor], torch.Tensor]] = None

    def __post_init__(self):
        family_module(self.config)  # refuses an unknown family
        if is_moe(self.config) and self.loss_fn is None:
            raise ValueError("MoE models train through MoETrainStep (its "
                             "loss adds the router's aux term)")
        if self.mesh is None:
            self.device = resolve_device(self.device)
            return
        from ..parallel import distributed
        check_tp_heads(self.config, self.mesh)
        self.device = distributed.rank_device(
            distributed.rank(), distributed.world_size(), self.device)
        self._specs = _pspec_fn(self.config)(self.mesh)
        self._grads = MeshGrads(self.mesh, _split_axes(self._specs))

    def init(self, params: Params) -> Tuple[Params, Dict[str, Any]]:
        if self.mesh is not None:
            from ..parallel import spmd
            params = spmd.shard_params(params, self.mesh, self._specs)
        params = _unflatten((path, x.detach().to(self.device, copy=True))
                            for path, x in _flatten(params))
        return params, self.optimizer.init(params)

    def shard_batch(self, ids) -> torch.Tensor:
        """Token ids as an int64 tensor on the step's device. On a mesh
        it is the global batch: each rank cuts its share in the loss."""
        return torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                               device=self.device)

    def loss_and_grads(self, params: Params,
                       ids) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The step's loss and the gradients of ``params``' leaves (in
        nested-dict order), before the optimizer update; on a mesh the
        global loss and this rank's gradients averaged over dp x sp."""
        ids = (ids.to(self.device, torch.int64) if torch.is_tensor(ids)
               else self.shard_batch(ids))
        items = [(path, x.detach().requires_grad_())
                 for path, x in _flatten(params)]
        with torch.enable_grad():
            tree = _unflatten(items)
            loss = (lm_loss(tree, ids, self.config, self.remat, self.mesh)
                    if self.loss_fn is None else self.loss_fn(tree, ids))
            grads = list(torch.autograd.grad(loss, [x for _, x in items]))
        loss = loss.detach()
        if self.mesh is not None:
            loss = self._grads.mean(grads, loss)
        return loss, grads

    def mesh_norm(self, params: Params,
                  grads: List[torch.Tensor]) -> Optional[torch.Tensor]:
        """The gradients' global norm on a mesh (None on one device)."""
        return None if self.mesh is None else self._grads.norm(params, grads)

    def __call__(self, params: Params, opt_state: Dict[str, Any], ids):
        loss, grads = self.loss_and_grads(params, ids)
        params, opt_state = self.optimizer.update(
            params, grads, opt_state, norm=self.mesh_norm(params, grads))
        return params, opt_state, loss


def LlamaTrainStep(config, optimizer: AdamW, mesh: Any = None,
                   remat: bool = False,
                   device: DeviceLike = "cuda") -> TrainStep:
    """The llama family's train step: the shared LM loss (``lm_loss``
    dispatches on the config's family, and so does the layout table)."""
    return TrainStep(config, optimizer, mesh=mesh, remat=remat,
                     device=device)


def MoETrainStep(config, optimizer: AdamW, mesh: Any = None,
                 aux_weight: float = 0.01,
                 device: DeviceLike = "cuda") -> TrainStep:
    """GPT-2-MoE's train step: a ``TrainStep`` with ``moe_lm_loss`` bound.
    ``mesh``: experts over ``ep`` and their FFN over ``tp``, attention's
    heads over ``tp``, the batch over ``dp`` and ``sp``, a ``pp`` axis
    replicated (``models.moe.mesh_forward``)."""
    return TrainStep(config, optimizer, mesh=mesh, device=device,
                     loss_fn=lambda p, ids: moe_lm_loss(p, ids, config,
                                                        aux_weight, mesh))


def gpipe_lm_loss(params: Params, ids, config, mesh, n_microbatches: int,
                  remat: bool = False) -> torch.Tensor:
    """The LM loss with the blocks run pipeline-parallel, forward only:
    ``params`` this rank's pipeline tree (``GPipeTrainStep.init``),
    ``ids`` the global batch. Every rank calls; each returns the global
    mean (over its pp stages' microbatches, averaged over dp x sp)."""
    from ..parallel import distributed, gpipe, spmd
    st = gpipe.PipeStage(config, mesh)
    ids = torch.as_tensor(np.asarray(ids) if not torch.is_tensor(ids)
                          else ids, dtype=torch.int64,
                          device=params["wte"].device)
    inp = gpipe.microbatch(spmd.local_batch(ids[:, :-1], mesh),
                           n_microbatches)
    lab = spmd.local_batch(ids[:, 1:], mesh)
    with torch.no_grad():
        h = st.embed(params, inp.reshape(-1, inp.shape[-1])).reshape(
            inp.shape + (config.n_embd,)) if st.is_first else None
        h = gpipe.gpipe_apply_blocks(params["blocks"], h, config, mesh,
                                     remat, inp.shape + (config.n_embd,),
                                     params["wte"].dtype)
        loss = _ce(st.logits(params, gpipe.unmicrobatch(h)), lab)
    data = spmd.axis_group(mesh, ("dp", "sp"))
    if data is not None:
        loss = distributed.all_reduce_sum(loss.reshape(1).clone(), data)[0] \
            / (spmd.axis_size(mesh, "dp") * spmd.axis_size(mesh, "sp"))
    return loss


@dataclasses.dataclass
class GPipeTrainStep:
    """Pipeline-parallel train step over the mesh's ``pp`` axis, with dp,
    tp and sp inside each stage.

    ``init(params)`` gives this rank its pipeline tree: the embed and
    head leaves (whole) and ``blocks``, its stage's blocks (its chunks,
    ``[v, per_chunk, ...]``, when ``virtual_stages > 1``), at its tp
    slices; the optimizer state follows. Stage sizes need not be equal:
    a rank holds only its own blocks. ``boundaries``: interior split
    points (the serving BOUNDARIES contract), exactly ``pp`` stages;
    default ``partition.balanced_boundaries``.

    ``schedule``: "gpipe" (every microbatch's forward, then every
    backward; ``parallel.gpipe``) or "1f1b" (one forward, one backward a
    tick; at most ``min(M, 2S - 1)`` stashed inputs a chunk,
    ``stash_high_water`` after each step; ``parallel.pipeline_1f1b``).
    ``virtual_stages`` > 1: interleaved 1F1B (needs "1f1b", default
    boundaries and ``n_layer % (pp * v) == 0``; refused on tp/sp meshes,
    as in the JAX package)."""

    config: Any
    optimizer: AdamW
    mesh: Any
    n_microbatches: int = 4
    remat: bool = False
    boundaries: Optional[Any] = None
    schedule: str = "gpipe"
    virtual_stages: int = 1
    device: DeviceLike = "cuda"

    def __post_init__(self):
        from ..models import is_stage_partitionable
        from ..parallel import distributed, partition as P_, spmd

        if not is_stage_partitionable(self.config):
            raise NotImplementedError(
                f"GPipe covers the dense GPT-2 and llama families; "
                f"{type(self.config).__name__} trains via its GSPMD step "
                "(MoETrainStep)")
        if "pp" not in self.mesh.mesh_dim_names:
            raise ValueError(
                f"mesh {self.mesh.mesh_dim_names} has no 'pp' axis")
        if self.schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"schedule={self.schedule!r} not one of ('gpipe', '1f1b')")
        pp = spmd.axis_size(self.mesh, "pp")
        if self.virtual_stages < 1:
            raise ValueError(
                f"virtual_stages={self.virtual_stages} must be >= 1")
        if self.virtual_stages > 1:
            if self.schedule != "1f1b":
                raise ValueError(
                    "virtual_stages > 1 (interleaved scheduling) "
                    "requires schedule='1f1b'")
            if self.boundaries is not None:
                raise ValueError(
                    "interleaved 1F1B uses equal chunks; explicit "
                    "boundaries are a virtual_stages=1 feature")
            if self.config.n_layer % (pp * self.virtual_stages):
                raise ValueError(
                    f"n_layer={self.config.n_layer} must divide by "
                    f"pp * virtual_stages = {pp * self.virtual_stages}")
            bad_axes = [ax for ax in ("tp", "sp")
                        if spmd.axis_size(self.mesh, ax) > 1]
            if bad_axes:
                raise ValueError(
                    f"interleaved 1F1B on a {'/'.join(bad_axes)} mesh is "
                    "strictly slower: collectives inside blocks disable "
                    "the per-core bubble skip, so every tick computes "
                    "every chunk and interleaving only adds ticks — use "
                    "virtual_stages=1 (see parallel.pipeline_1f1b)")
        bounds = (list(self.boundaries) if self.boundaries is not None
                  else P_.balanced_boundaries(self.config.n_layer, pp))
        self._specs = P_.make_stage_specs(self.config.n_layer, bounds)
        if len(self._specs) != pp:
            raise ValueError(
                f"boundaries {bounds} give {len(self._specs)} stages; the "
                f"mesh's pp axis has {pp} devices")
        self._equal = len({s.n_blocks for s in self._specs}) == 1
        self.spec = self._specs[spmd.axis_rank(self.mesh, "pp")]
        self.device = distributed.rank_device(
            distributed.rank(), distributed.world_size(), self.device)
        table = _pspec_fn(self.config)(self.mesh)
        lead = (None,) if self.virtual_stages > 1 else ()
        self._table = {k: v for k, v in table.items() if k != "blocks"}
        self._table["blocks"] = _map_specs(lambda sp: lead + tuple(sp),
                                           table["blocks"])
        self._grads = MeshGrads(self.mesh, _split_axes(
            self._table, lambda path: ("pp",) if path[0] == "blocks"
            else ()))
        self.stash_high_water = 0

    def init(self, params: Params):
        from ..parallel import partition as P_, spmd
        pp = spmd.axis_size(self.mesh, "pp")
        if self.virtual_stages > 1:
            blocks = P_.virtual_chunks(params["blocks"], pp,
                                       self.virtual_stages,
                                       spmd.axis_rank(self.mesh, "pp"))
        else:
            blocks = P_.stage_blocks(params["blocks"], self.spec)
        tree = {k: params[k] for k in params if k != "blocks"}
        tree["blocks"] = blocks
        tree = spmd.shard_params(tree, self.mesh, self._table)
        tree = _unflatten((path, x.detach().to(self.device, copy=True))
                          for path, x in _flatten(tree))
        return tree, self.optimizer.init(tree)

    def shard_batch(self, ids) -> torch.Tensor:
        """The global batch as an int64 tensor on the rank's device."""
        return torch.as_tensor(np.asarray(ids), dtype=torch.int64,
                               device=self.device)

    def loss_and_grads(self, params: Params,
                       ids) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The global loss and this rank's gradients (nested-dict order of
        its pipeline tree), averaged over dp x sp."""
        from ..parallel import gpipe, pipeline_1f1b
        ids = (ids.to(self.device, torch.int64) if torch.is_tensor(ids)
               else self.shard_batch(ids))
        if self.schedule == "1f1b":
            stats: Dict[str, int] = {}
            loss, grads = pipeline_1f1b.one_f_one_b_loss_and_grads(
                params, ids, self.config, self.mesh, self.n_microbatches,
                self.virtual_stages, stats)
            self.stash_high_water = stats["stash_high_water"]
        else:
            loss, grads = gpipe.gpipe_loss_and_grads(
                params, ids, self.config, self.mesh, self.n_microbatches,
                self.remat)
        return self._grads.mean(grads, loss), grads

    def __call__(self, params: Params, opt_state: Dict[str, Any], ids):
        loss, grads = self.loss_and_grads(params, ids)
        params, opt_state = self.optimizer.update(
            params, grads, opt_state, norm=self._grads.norm(params, grads))
        return params, opt_state, loss


def _map_specs(fn, table):
    if isinstance(table, dict):
        return {k: _map_specs(fn, v) for k, v in table.items()}
    return fn(table)
