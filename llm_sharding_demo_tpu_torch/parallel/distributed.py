"""Multi-process bootstrap and the collectives the mesh decoders use.

Counterpart of ``llm_sharding_demo_tpu/parallel/distributed.py``. The JAX
package joins one process per host into one runtime and lets XLA route
the collectives of a single program; here each rank is one process bound
to one device, and every collective is an explicit ``torch.distributed``
call:

- ``maybe_initialize`` keeps the JAX environment contract
  (``COORDINATOR_ADDRESS`` = host:port of rank 0, ``NUM_PROCESSES``,
  ``PROCESS_ID``): all three unset is the single-process no-op, some of
  them a startup error. A rank's device is ``cuda:{rank % device_count}``
  (``device="cpu"`` for CPU ranks); the backend follows from it, ``nccl``
  for CUDA and ``gloo`` for the CPU. ``backend="gloo"`` on CUDA ranks
  exists for one card that hosts several ranks (NCCL puts one rank on a
  device).
- ``global_mesh`` / ``shard_host_batch``: a named ``DeviceMesh`` over the
  world and this rank's slice of a host batch.
- ``hop`` (stage i -> i+1), ``all_reduce_sum``, ``broadcast`` and
  ``broadcast_object``: the collectives of the tp/ep engines and the
  pipelined decoder, each counted with its host-clock time
  (``comm_stats``). On a ``gloo`` group a CUDA tensor goes through a
  host buffer (decided from the group's backend, never by catching an
  error).
- ``announce`` / ``await_header``: the leader's request headers to the
  follower ranks, through the process group's store. A follower polls
  with a short timeout, so an idle server never sits inside a collective
  that would time out between requests.
- ``all_gather``, ``exchange`` (posted sends and receives, the pipeline
  ticks' transfers) and ``ring_shift``: the collectives of mesh training.
- Differentiable collectives for training, ``torch.autograd.Function``s
  over the helpers above (so a CUDA tensor on a gloo group still goes
  through host memory): Megatron's pair ``copy_to`` (identity forward,
  sum backward) and ``reduce_from`` (sum forward, identity backward);
  ``all_reduce`` (sum both ways); ``gather`` (the pieces laid end to
  end, the backward keeping this rank's piece of the summed gradient);
  ``shift`` (rank i to i+1, the backward i+1 to i: the transpose of
  ``lax.ppermute``). Each is the identity without a group or on a group
  of one rank.
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

log = logging.getLogger(__name__)

# a collective or a store read that waits longer than this fails
DEFAULT_TIMEOUT_S = 300.0
# how long a follower's store read waits before it polls again
HEADER_POLL_S = 1.0
_HEADER_KEY = "graft/header/{}"
_READ_KEY = "graft/read/{}"
# a store read that times out (a network failure is another error, and
# ends the wait)
_STORE_TIMEOUT = getattr(dist, "DistStoreError", RuntimeError)

_state: Dict[str, Any] = {"initialized": False, "device": None,
                          "announced": 0, "received": 0, "groups": {}}
# calls and host-clock seconds spent in each collective helper (a call on
# CUDA tensors through a gloo host buffer waits for the device work that
# produced them)
_COMM: Dict[str, List] = {}


def comm_stats() -> Dict[str, Tuple[int, float]]:
    """``{helper: (calls, seconds)}`` since the last reset."""
    return {k: (v[0], v[1]) for k, v in _COMM.items()}


def reset_comm_stats() -> None:
    _COMM.clear()


def _timed(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            rec = _COMM.setdefault(fn.__name__, [0, 0.0])
            rec[0] += 1
            rec[1] += time.perf_counter() - t0
    return wrapper


def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: DeviceLike = None,
                     backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join this process to the process group if configured.

    Explicit arguments win over env vars. Returns True when the group
    was initialized (now or earlier), False for the single-process no-op.
    ``device`` picks the device kind (default ``cuda``; the rank takes
    ``cuda:{rank % device_count}``). ``backend`` overrides the device's
    backend (``gloo`` for several ranks on one card). Every collective of
    the group, and the join itself, waits at most ``timeout_s``."""
    if _state["initialized"]:
        return True
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else (
        int(os.environ["NUM_PROCESSES"])
        if "NUM_PROCESSES" in os.environ else None)
    pid = process_id if process_id is not None else (
        int(os.environ["PROCESS_ID"])
        if "PROCESS_ID" in os.environ else None)

    if addr is None and nproc is None and pid is None:
        return False  # single-process: nothing to connect
    if addr is None or nproc is None or pid is None:
        raise ValueError(
            "partial multi-host config: COORDINATOR_ADDRESS, NUM_PROCESSES "
            "and PROCESS_ID must be set together "
            f"(got addr={addr!r}, nproc={nproc!r}, pid={pid!r})")
    dev = rank_device(pid, nproc, device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and nproc > torch.cuda.device_count():
        raise ValueError(
            f"NUM_PROCESSES={nproc} over nccl needs one CUDA device per "
            f"rank; this host has {torch.cuda.device_count()} (several "
            "ranks on one card take backend='gloo')")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend=backend, init_method="tcp://" + addr,
                            world_size=nproc, rank=pid,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(initialized=True, device=dev)
    log.info("joined process group: rank %d/%d via %s (%s on %s)", pid,
             nproc, addr, backend, dev)
    return True


def ensure_initialized(device: DeviceLike = None) -> None:
    """A one-process group over an in-memory store where none exists:
    a mesh of world 1 needs a group, and a lone process has no peer to
    rendezvous with."""
    if dist.is_initialized():
        if _state["device"] is None:
            _state.update(initialized=True, device=rank_device(
                dist.get_rank(), dist.get_world_size(), device))
        return
    dev = rank_device(0, 1, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        store=dist.HashStore(), world_size=1, rank=0,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    _state.update(initialized=True, device=dev)


def rank_device(rank: int, world: int, device: DeviceLike = None,
                ) -> torch.device:
    """The device a rank is bound to: ``cuda:{rank % device_count}``, or
    the CPU when the caller asks for it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def device() -> Optional[torch.device]:
    """This rank's device (None before ``maybe_initialize``)."""
    return _state["device"]


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def destroy() -> None:
    """Leave the process group (tests, and a server's shutdown)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.update(initialized=False, device=None, announced=0, received=0,
                  groups={})


def subgroup(rows: Sequence[Sequence[int]]):
    """This rank's group among ``rows`` (disjoint lists of global ranks
    covering the world), made once per distinct ``rows``: every rank must
    ask for the same rows in the same order (``new_group`` is a
    collective of the whole world)."""
    key = tuple(tuple(r) for r in rows)
    cache = _state["groups"]
    if key not in cache:
        me, mine = rank(), None
        for row in key:
            g = dist.new_group(list(row))
            if me in row:
                mine = g
        cache[key] = mine
    return cache[key]


def global_mesh(axes: Dict[str, int]):
    """A ``DeviceMesh`` over the world's ranks, dims named as given. The
    first axis varies slowest over the ranks, so put the data-parallel
    (or pipeline) axis first: it then spans hosts, and the tensor axes
    stay inside one."""
    from .spmd import make_mesh

    try:
        return make_mesh(axes)
    except ValueError as e:
        raise ValueError(  # add the multi-process context to the count error
            f"{e} (global runtime spans {world_size()} "
            "process(es))") from None


def shard_host_batch(local_batch, mesh, axis: str = "dp",
                     ) -> Tuple[torch.Tensor, Tuple[int, ...]]:
    """This rank's host batch as a tensor on its device, and the global
    batch's shape (the locals of the ``axis`` ranks stacked). Every rank
    of the axis must pass a batch of the same shape."""
    local = torch.as_tensor(np.asarray(local_batch), device=_mesh_device(mesh))
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    return local, (local.shape[0] * n,) + tuple(local.shape[1:])


def _mesh_device(mesh) -> torch.device:
    dev = device()
    if dev is not None:
        return dev
    return torch.device(mesh.device_type)


# -- collectives --------------------------------------------------------------


def _through_host(t: torch.Tensor, group) -> bool:
    """Whether ``t`` travels through a host buffer: a CUDA tensor on a
    ``gloo`` group (gloo's transports read host memory)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


@_timed
def hop(t: Optional[torch.Tensor], src: int, dst: int, shape: Sequence[int],
        dtype: torch.dtype, dev: torch.device, group=None,
        ) -> Optional[torch.Tensor]:
    """Stage ``src`` -> stage ``dst`` (group ranks): ``src`` sends ``t``,
    ``dst`` returns the received ``[shape]`` tensor, every other rank
    None. The receiver knows the shape and dtype from the request."""
    me = dist.get_rank(group)
    if me == src:
        buf = t.contiguous()
        if _through_host(buf, group):
            buf = buf.cpu()
        dist.send(buf, dist.get_global_rank(group, dst) if group else dst,
                  group=group)
        return None
    if me != dst:
        return None
    out = torch.empty(tuple(shape), dtype=dtype, device=dev)
    buf = out.cpu() if _through_host(out, group) else out
    dist.recv(buf, dist.get_global_rank(group, src) if group else src,
              group=group)
    if buf is not out:
        out.copy_(buf)
    return out


@_timed
def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group``, in place; every rank gets the same
    bits."""
    if _through_host(t, group):
        buf = t.cpu()
        dist.all_reduce(buf, group=group)
        t.copy_(buf)
        return t
    dist.all_reduce(t, group=group)
    return t


@_timed
def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from group rank ``src`` to every rank, in place."""
    root = dist.get_global_rank(group, src) if group else src
    if _through_host(t, group):
        buf = t.cpu()
        dist.broadcast(buf, root, group=group)
        t.copy_(buf)
        return t
    dist.broadcast(t, root, group=group)
    return t


@_timed
def broadcast_object(obj: Any, src: int, group=None) -> Any:
    """A small picklable object from group rank ``src`` to every rank."""
    box = [obj]
    root = dist.get_global_rank(group, src) if group else src
    dist.broadcast_object_list(box, root, group=group)
    return box[0]


@_timed
def all_gather(t: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The group's ``t`` laid end to end along ``dim``, in group-rank
    order (every rank's ``t`` has the same shape)."""
    n = dist.get_world_size(group)
    buf = t.contiguous()
    host = _through_host(buf, group)
    if host:
        buf = buf.cpu()
    parts = [torch.empty_like(buf) for _ in range(n)]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(t.device) if host else out


@_timed
def exchange(sends: Sequence[Tuple[torch.Tensor, int, int]],
             recvs: Sequence[Tuple[Sequence[int], int, int]],
             dtype: torch.dtype, dev: torch.device, group=None,
             ) -> List[torch.Tensor]:
    """Posted point-to-point transfers, waited for together: ``sends``
    are ``(tensor, dst, tag)``, ``recvs`` ``(shape, src, tag)`` (group
    ranks); returns the received tensors in ``recvs`` order. Two
    neighbours may send to each other in one call (a pair of blocking
    sends would deadlock). Every rank posts in the same global order (the
    caller's), which nccl needs; gloo matches by tag."""
    host = dev.type == "cuda" and dist.get_backend(group) == "gloo"
    peer = ((lambda r: dist.get_global_rank(group, r)) if group is not None
            else (lambda r: r))
    ops, outs, bufs = [], [], []
    for t, dst, tag in sends:
        buf = t.contiguous()
        buf = buf.cpu() if host else buf
        bufs.append(buf)
        ops.append(dist.P2POp(dist.isend, buf, peer(dst), group, tag))
    for shape, src, tag in recvs:
        out = torch.empty(tuple(shape), dtype=dtype,
                          device="cpu" if host else dev)
        outs.append(out)
        ops.append(dist.P2POp(dist.irecv, out, peer(src), group, tag))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [o.to(dev) for o in outs] if host else outs


def ring_shift(t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """Group rank i sends ``t`` to rank ``i + step`` (mod the group's
    size) and returns what rank ``i - step`` sent it."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    me = dist.get_rank(group)
    return exchange([(t, (me + step) % n, 0)],
                    [(t.shape, (me - step) % n, 0)], t.dtype, t.device,
                    group)[0]


# -- differentiable collectives (mesh training) -------------------------------


def _trivial(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """A contiguous copy of ``t`` summed over ``group``."""
    return all_reduce_sum(t.clone(memory_format=torch.contiguous_format),
                          group)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank(ctx.group)
        g = _summed(g, ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), \
            None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.group, -1), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient summed over ``group`` backward: the
    input of a column-parallel product (Megatron's f), so that what
    feeds it gets the gradient of every rank's columns."""
    if _trivial(group) or not _tracked(x):
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """Summed over ``group`` forward, identity backward: the output of a
    row-parallel product (Megatron's g). Off the autograd graph (decode)
    the sum is in place."""
    if group is None:
        return x
    if not _tracked(x):
        return all_reduce_sum(x, group)
    if dist.get_world_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Summed over ``group`` both ways: every rank holds the sum, and
    every rank's loss reads it."""
    if _trivial(group):
        return x
    if not _tracked(x):
        return _summed(x, group)
    return _AllReduce.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's pieces of ``x`` laid end to end along ``dim``; the
    backward keeps this rank's piece of the gradient summed over the
    group."""
    if _trivial(group):
        return x
    if not _tracked(x):
        return all_gather(x, dim, group)
    return _Gather.apply(x, dim, group)


def shift(x: torch.Tensor, group) -> torch.Tensor:
    """Group rank i's ``x`` to rank i+1 (the last to the first); the
    backward sends each gradient back one rank."""
    if _trivial(group):
        return x
    if not _tracked(x):
        return ring_shift(x, group, 1)
    return _Shift.apply(x, group)


# -- the leader's request headers ---------------------------------------------


def _store():
    return dist.distributed_c10d._get_default_store()


def announce(header: dict, wait_s: float = 0.0) -> None:
    """Publish the next request header to every follower rank (the
    leader, rank 0). A follower reads it with ``await_header``; the last
    follower to read a header drops its key. ``wait_s`` > 0 waits, at
    most that long, until every follower has read it: a leader about to
    exit takes the store with it."""
    seq = _state["announced"]
    key = _HEADER_KEY.format(seq)
    store = _store()
    store.set(key, pickle.dumps(header))
    _state["announced"] = seq + 1
    deadline = time.monotonic() + wait_s
    while wait_s and store.check([key]) and time.monotonic() < deadline:
        time.sleep(0.01)


def await_header(poll_s: float = HEADER_POLL_S) -> dict:
    """The next header the leader announced (a follower rank), polling
    the store every ``poll_s`` seconds."""
    seq = _state["received"]
    key = _HEADER_KEY.format(seq)
    store = _store()
    while True:
        try:
            store.wait([key], datetime.timedelta(seconds=poll_s))
        except _STORE_TIMEOUT:
            continue  # nothing announced yet
        _state["received"] = seq + 1
        header = pickle.loads(store.get(key))
        # the readers count themselves; the last one frees the store
        if store.add(_READ_KEY.format(seq), 1) == world_size() - 1:
            store.delete_key(key)
            store.delete_key(_READ_KEY.format(seq))
        return header
