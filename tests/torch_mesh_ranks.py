"""Spawned gloo ranks for the port's multi-rank CPU tests.

A ``RankGroup`` starts ``world`` processes with the ``spawn`` context;
each joins one ``gloo`` process group on the CPU (a 30 s timeout on every
collective) and then runs the cases the test process sends it, by name,
until told to exit. Every case function below runs on every rank with
the same arguments; each rank returns its own result. This module, and
so every child, imports only numpy, torch and the port: the JAX
reference runs in the test process.

Every wait has a limit: the group's start, each case (``run``'s
``timeout_s``), the children's exit. A case that fails or times out
kills the group; the next ``run`` starts a fresh one.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import Any, Dict, List, Optional

# a rank with no command for this long exits on its own
CMD_WAIT_S = 900.0
START_S = 60.0
JOIN_S = 10.0
GROUP_TIMEOUT_S = 30.0


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank: int, world: int, addr: str, cmd_q, res_q) -> None:
    import torch
    torch.set_num_threads(1)
    from llm_sharding_demo_tpu_torch.parallel import distributed
    try:
        distributed.maybe_initialize(addr, world, rank, device="cpu",
                                     timeout_s=GROUP_TIMEOUT_S)
    except Exception:  # noqa: BLE001 — reported to the test process
        res_q.put((rank, "err", traceback.format_exc()))
        return
    res_q.put((rank, "ready", None))
    while True:
        try:
            cmd = cmd_q.get(timeout=CMD_WAIT_S)
        except queue.Empty:
            break
        if cmd is None:
            break
        name, kwargs = cmd
        try:
            res_q.put((rank, "ok", _case(name)(**kwargs)))
        except Exception:  # noqa: BLE001 — reported to the test process
            res_q.put((rank, "err", traceback.format_exc()))
    distributed.destroy()


def _case(name: str):
    """A case by name: a function of this module, or ``module:function``
    of another test helper module (whose children import only torch, numpy
    and the port, as this one's)."""
    if ":" not in name:
        return globals()[name]
    import importlib
    module, fn = name.split(":")
    return getattr(importlib.import_module(module), fn)


class RankGroup:
    """``world`` gloo ranks on the CPU, started lazily and restarted after
    a failed case."""

    def __init__(self, world: int):
        self.world = world
        self._procs: List[Any] = []

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        addr = f"127.0.0.1:{free_port()}"
        self._cmd = [ctx.Queue() for _ in range(self.world)]
        self._res = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, self.world, addr, self._cmd[r],
                                         self._res), daemon=True)
                       for r in range(self.world)]
        for p in self._procs:
            p.start()
        self._collect("ready", START_S)

    def _collect(self, want: str, timeout_s: float) -> List[Any]:
        out: Dict[int, Any] = {}
        errors = []
        deadline = time.monotonic() + timeout_s
        while len(out) + len(errors) < self.world:
            try:
                rank, status, value = self._res.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    missing = sorted(set(range(self.world)) - set(out))
                    self.close()
                    raise TimeoutError(
                        f"ranks {missing} gave no result ({want}) within "
                        f"{timeout_s} s; exited: {dead}") from None
                continue
            if status == "err":
                errors.append(f"rank {rank}:\n{value}")
            else:
                out[rank] = value
        if errors:
            self.close()
            raise AssertionError("\n".join(errors))
        return [out[r] for r in range(self.world)]

    def run(self, name: str, timeout_s: float = 60.0, **kwargs) -> List[Any]:
        """Run case ``name`` (``_case``) on every rank; returns the ranks'
        results in rank order, or raises with every failing rank's
        traceback."""
        self.submit(name, **kwargs)
        return self.results(timeout_s)

    def submit(self, name: str, **kwargs) -> None:
        """Start case ``name`` on every rank and return at once (the test
        process can compute its reference meanwhile); ``results`` waits
        for it."""
        for attempt in range(3):
            if self._procs:
                break
            try:
                self._start()
            except (TimeoutError, AssertionError):
                # another process may have taken the free port first
                if attempt == 2:
                    raise
        for q in self._cmd:
            q.put((name, kwargs))

    def results(self, timeout_s: float = 60.0) -> List[Any]:
        """The submitted case's results in rank order (see ``run``)."""
        return self._collect("ok", timeout_s)

    def close(self) -> None:
        for q in getattr(self, "_cmd", []):
            try:
                q.put(None)
            except (OSError, ValueError):
                pass
        for p in self._procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.terminate()
                p.join(JOIN_S)
        self._procs = []


# -- helpers (run inside the ranks) -------------------------------------------


def _model(family: str, cfg_kw: dict, np_params):
    from llm_sharding_demo_tpu_torch.models import gpt2, llama, moe
    from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
    cls = {"gpt2": gpt2.GPT2Config, "llama": llama.LlamaConfig,
           "moe": moe.MoEConfig}[family]
    return cls(**cfg_kw), params_from_numpy(np_params, device="cpu")


def _sampling(sampling: Optional[dict]):
    from llm_sharding_demo_tpu_torch.runtime.engine import SamplingConfig
    return SamplingConfig(**(sampling or {"mode": "greedy"}))


def _generator(seed):
    """None, one seeded generator (``seed`` an int) or one a row (a
    list of seeds)."""
    import torch
    if seed is None:
        return None
    if isinstance(seed, list):
        return [torch.Generator().manual_seed(s) for s in seed]
    return torch.Generator().manual_seed(seed)


def _gen_state(g):
    if isinstance(g, list):
        return [x.get_state().numpy() for x in g]
    return g.get_state().numpy()


def _result(res) -> dict:
    return {"tokens": res.tokens, "pad": res.pad}


# -- cases ------------------------------------------------------------------


def mesh_info() -> dict:
    """The process group as this rank sees it."""
    from llm_sharding_demo_tpu_torch.parallel import distributed
    return {"rank": distributed.rank(), "world": distributed.world_size(),
            "device": str(distributed.device())}


def collectives() -> dict:
    """The collective helpers: a hop along the ring, a sum, a broadcast
    of a tensor and of an object, and a global mesh with a host batch."""
    import numpy as np
    import torch
    from llm_sharding_demo_tpu_torch.parallel import distributed, spmd
    r, w = distributed.rank(), distributed.world_size()
    got = None
    for src, dst in [(j, j + 1) for j in range(w - 1)]:
        out = distributed.hop(torch.full((2, 3), float(src + 1)), src, dst,
                              (2, 3), torch.float32, torch.device("cpu"))
        if out is not None:
            got = out.tolist()
    total = distributed.all_reduce_sum(torch.tensor([r + 1.0, 2.0 * r]))
    b = distributed.broadcast(torch.tensor([r * 10]), w - 1)
    obj = distributed.broadcast_object({"from": r}, 0)
    mesh = distributed.global_mesh({"dp": w})
    local, shape = distributed.shard_host_batch(
        np.full((2, 3), r, np.int32), mesh, axis="dp")
    mesh2 = spmd.make_mesh({"dp": 1, "tp": w})

    class CudaTensor:  # what the gloo path decides on: the device alone
        is_cuda = True

    return {"hop": got, "sum": total.tolist(), "bcast": b.tolist(),
            "obj": obj, "names": mesh.mesh_dim_names,
            "local": local.tolist(), "global_shape": shape,
            "mesh2": (mesh2.mesh_dim_names, spmd.axis_size(mesh2, "tp"),
                      spmd.axis_rank(mesh2, "tp")),
            "host_paths": {
                "cpu": distributed._through_host(torch.zeros(1), None),
                "cuda": distributed._through_host(CudaTensor(), None)}}


def header_roundtrip(n: int) -> dict:
    """Rank 0 announces ``n`` headers, after the followers' first poll
    has timed out, then a stop that it waits to see read (the key
    dropped); each follower returns what it read."""
    from llm_sharding_demo_tpu_torch.parallel import distributed
    if distributed.rank() == 0:
        time.sleep(1.0)
        for i in range(n):
            distributed.announce({"op": "x", "i": i})
        distributed.announce({"op": "stop"}, wait_s=20.0)
        key = distributed._HEADER_KEY.format(n)
        return {"sent": n + 1,
                "stop_read": not distributed._store().check([key])}
    got = []
    while True:
        hdr = distributed.await_header(poll_s=0.3)
        if hdr["op"] == "stop":
            return {"got": got, "stopped": True}
        got.append(hdr["i"])


def mesh_error(shape: dict) -> str:
    """The message of a mesh whose size does not match the world."""
    from llm_sharding_demo_tpu_torch.parallel import distributed
    try:
        distributed.global_mesh(shape)
    except ValueError as e:
        return str(e)
    return ""


def shard_leaves(family: str, cfg_kw: dict, np_params, axis: str) -> dict:
    """This rank's slices under the family's layout table."""
    from llm_sharding_demo_tpu_torch.parallel import distributed, spmd
    config, params = _model(family, cfg_kw, np_params)
    mesh = spmd.make_mesh({axis: distributed.world_size()})
    table = {"gpt2": spmd.param_pspecs, "llama": spmd.llama_param_pspecs,
             "moe": spmd.moe_param_pspecs}[family](mesh)
    local = spmd.shard_params(params, mesh, table)
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                out[prefix + k] = v.numpy()
    walk(local, "")
    return out


def pp_generate(family: str, cfg_kw: dict, np_params, max_seq: int,
                prompts, steps: int, boundaries=None, dtype="float32",
                sampling=None, seed=None, eos_id=None,
                single: Optional[dict] = None, repeat: int = 1,
                logit_ids=None) -> dict:
    """The pipelined decoder's streams on rank 0 (the others follow), the
    last stage's prompt logits, and the single-rank engine's streams
    (``single``: its extra kwargs) computed on the last rank."""
    from llm_sharding_demo_tpu_torch.parallel import distributed
    from llm_sharding_demo_tpu_torch.parallel.ppdecode import PipelinedDecoder
    from llm_sharding_demo_tpu_torch.parallel.spmd import make_mesh
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    config, params = _model(family, cfg_kw, np_params)
    w = distributed.world_size()
    distributed.reset_comm_stats()
    dec = PipelinedDecoder(params, config, make_mesh({"pp": w}), max_seq,
                           dtype=dtype, boundaries=boundaries, device="cpu")
    out: Dict[str, Any] = {"stage": (dec.spec.start, dec.spec.end)}
    s = _sampling(sampling)
    if distributed.rank() == 0:
        runs = []
        for _ in range(repeat):
            g = _generator(seed)
            runs.append(_result(dec.generate(prompts, steps, sampling=s,
                                             generator=g, eos_id=eos_id)))
            if g is not None:
                runs[-1]["gen_state"] = _gen_state(g)
        dec.stop_followers()
        out["runs"] = runs
    else:
        out["served"] = dec.follow()
    if logit_ids is not None:
        logits = dec.logits(logit_ids)
        out["logits"] = None if logits is None else logits.float().numpy()
    if single is not None and distributed.rank() == w - 1:
        eng = DecodeEngine(params, config, max_seq, dtype=dtype,
                           device="cpu", **single)
        g = _generator(seed)
        out["single"] = _result(eng.generate(prompts, steps, sampling=s,
                                             generator=g, eos_id=eos_id))
        if g is not None:
            out["single"]["gen_state"] = _gen_state(g)
        if logit_ids is not None:
            logits, _ = eng._prefill(eng._ids(logit_ids), None)
            out["single_logits"] = logits.float().numpy()
    out["comm"] = distributed.comm_stats()
    return out


def mesh_generate(family: str, cfg_kw: dict, np_params, max_seq: int,
                  prompts, steps: int, axis: str, dtype="float32",
                  sampling=None, seed=None, prefill_chunk=None,
                  layout: Optional[str] = None, kwargs=None,
                  logit_ids=None) -> dict:
    """A tp or ep engine over the world: rank 0's streams (the others
    follow), every rank's prompt logits, and (rank 0) the single-rank
    engine's. ``layout="contiguous"`` swaps GPT-2's per-head ``c_attn``
    split for contiguous thirds (the split the tests must catch)."""
    import torch
    from llm_sharding_demo_tpu_torch.parallel import distributed, spmd
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    config, params = _model(family, cfg_kw, np_params)
    w = distributed.world_size()
    saved = spmd.param_pspecs
    if layout == "contiguous":
        def contiguous(mesh):
            table = saved(mesh)
            table["blocks"]["attn"]["c_attn"] = {
                "kernel": (None, None, "tp"), "bias": (None, "tp")}
            return table
        spmd.param_pspecs = contiguous
    try:
        eng = DecodeEngine(params, config, max_seq, dtype=dtype,
                           device="cpu", prefill_chunk=prefill_chunk,
                           mesh=spmd.make_mesh({axis: w}), **(kwargs or {}))
    finally:
        spmd.param_pspecs = saved
    s = _sampling(sampling)
    out: Dict[str, Any] = {"mode": eng._mesh_mode,
                           "decode_kernel": eng.decode_kernel_mode,
                           "model_kernel": eng._model_kernel}
    if distributed.rank() == 0:
        g = _generator(seed)
        out["run"] = _result(eng.generate(prompts, steps, sampling=s,
                                          generator=g))
        eng.stop_followers()
    else:
        out["served"] = eng.follow()
    if logit_ids is not None:
        with torch.inference_mode():
            logits, _ = eng._prefill(eng._ids(logit_ids), None)
        out["logits"] = logits.float().numpy()
    if distributed.rank() == 0:
        single = DecodeEngine(params, config, max_seq, dtype=dtype,
                              device="cpu", prefill_chunk=prefill_chunk,
                              **(kwargs or {}))
        g = _generator(seed)
        out["single"] = _result(single.generate(prompts, steps, sampling=s,
                                                generator=g))
    return out


def engine_error(family: str, cfg_kw: dict, np_params, axis: str,
                 mesh_shape: Optional[dict] = None, **kw) -> str:
    """The message a mesh engine's construction raises ("" if none)."""
    from llm_sharding_demo_tpu_torch.parallel import distributed, spmd
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    config, params = _model(family, cfg_kw, np_params)
    mesh = spmd.make_mesh(mesh_shape or {axis: distributed.world_size()})
    try:
        DecodeEngine(params, config, 32, device="cpu", mesh=mesh, **kw)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def serve(family: str, cfg_kw: dict, np_params, serving: dict,
          bodies: List[dict], env: Optional[dict] = None) -> dict:
    """``create_app`` on every rank; rank 0 posts ``bodies`` through the
    in-process client and reads /healthz, then stops the followers, which
    serve from their ``follow`` loops meanwhile. Every rank returns the
    app's static plan row (``auto_plan``, None without AUTO_PLAN)."""
    from llm_sharding_demo_tpu_torch.parallel import distributed
    from llm_sharding_demo_tpu_torch.serving.app import create_app
    from llm_sharding_demo_tpu_torch.serving.http import TestClient
    from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        config, params = _model(family, cfg_kw, np_params)
        try:
            app = create_app(ServingConfig(**serving), model=(config, params),
                             tokenizer=ByteTokenizer(), device="cpu")
        except (ValueError, NotImplementedError) as e:
            return {"error": str(e)}
        mesh = app.mesh_runner
        if distributed.rank() != 0:
            # a single-device app: rank 0 serves it alone
            return {"served": mesh.follow() if mesh is not None else None,
                    "auto_plan": app.auto_plan}
        client = TestClient(app)
        replies = [client.post("/generate", json=b).json() for b in bodies]
        health = client.get("/healthz").json()
        if mesh is not None:
            mesh.stop_followers()
        return {"replies": replies, "health": health,
                "auto_plan": app.auto_plan}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def teacher_forced(kind: str, family: str, cfg_kw: dict, np_params,
                   max_seq: int, prompt, forced, dtype="float32",
                   boundaries=None, kwargs=None):
    """f32 logits ``[len(forced), vocab]``: row 0 from the prompt's
    prefill, every later row from a cached single-token step fed
    ``forced[t - 1]``, through the pipelined decoder (``kind="pp"``: on
    the last stage, None elsewhere), a mesh engine (``"tp"``/``"ep"``:
    every rank) or the single-rank engine (``"single"``: rank 0)."""
    import torch
    from llm_sharding_demo_tpu_torch.parallel import distributed, spmd
    from llm_sharding_demo_tpu_torch.parallel import partition as P
    from llm_sharding_demo_tpu_torch.parallel.ppdecode import PipelinedDecoder
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    config, params = _model(family, cfg_kw, np_params)
    w = distributed.world_size()
    rows = []
    with torch.inference_mode():
        if kind == "pp":
            dec = PipelinedDecoder(params, config, spmd.make_mesh({"pp": w}),
                                   max_seq, dtype=dtype,
                                   boundaries=boundaries, device="cpu")
            cache = P.make_stage_cache(dec.spec, config, 1, max_seq,
                                       dec.dtype, dec.device)
            feed = [list(prompt)] + [[t] for t in forced[:-1]]
            for ids in feed:
                logits, cache = dec._forward(torch.tensor([ids]), cache,
                                             None)
                if logits is not None:
                    rows.append(logits[0, -1])
            return torch.stack(rows).float().numpy() if rows else None
        if kind == "single" and distributed.rank() != 0:
            return None
        mesh = (None if kind == "single"
                else spmd.make_mesh({kind: w}))
        eng = DecodeEngine(params, config, max_seq, dtype=dtype,
                           device="cpu", mesh=mesh, **(kwargs or {}))
        cache = eng._fresh_cache(1)
        logits, cache = eng._forward_cached(eng._ids([prompt]), cache, None)
        rows.append(logits[0, -1])
        for tok in forced[:-1]:
            logits, cache = eng._forward_cached(eng._ids([[tok]]), cache,
                                                None)
            rows.append(logits[0, -1])
    return torch.stack(rows).float().numpy()


def pp_error(family: str, cfg_kw: dict, np_params, boundaries=None,
             max_seq: int = 32) -> str:
    """The message the pipelined decoder's construction raises."""
    from llm_sharding_demo_tpu_torch.parallel import distributed, spmd
    from llm_sharding_demo_tpu_torch.parallel.ppdecode import PipelinedDecoder
    config, params = _model(family, cfg_kw, np_params)
    try:
        PipelinedDecoder(params, config,
                         spmd.make_mesh({"pp": distributed.world_size()}),
                         max_seq, boundaries=boundaries, device="cpu")
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def graftshard_live(cfg_kw: dict, np_params, moe_kw: dict, moe_np) -> dict:
    """GRAFTSHARD=1 on this rank: a tp engine, an ep engine and the
    pipelined decoder register their holdings, generate, and audit
    clean; then one stage block's placement record is planted wrong (a
    share one layer too large) and the audit must find it."""
    from llm_sharding_demo_tpu_torch.parallel import distributed, spmd
    from llm_sharding_demo_tpu_torch.parallel.ppdecode import PipelinedDecoder
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.utils import graftshard
    os.environ["GRAFTSHARD"] = "1"
    graftshard.clear()
    try:
        w = distributed.world_size()
        config, params = _model("gpt2", cfg_kw, np_params)
        mconfig, mparams = _model("moe", moe_kw, moe_np)
        runners = [
            DecodeEngine(params, config, 32, device="cpu",
                         mesh=spmd.make_mesh({"tp": w})),
            DecodeEngine(mparams, mconfig, 32, device="cpu",
                         mesh=spmd.make_mesh({"ep": w})),
            PipelinedDecoder(params, config, spmd.make_mesh({"pp": w}), 32,
                             device="cpu")]
        for r in runners:
            if distributed.rank() == 0:
                r.generate([[1, 2, 3]], 3)
                r.stop_followers()
            else:
                r.follow()
        clean = graftshard.audit()
        status = graftshard.status()
        dec = runners[-1]
        leaf = dec.stage_params["stacked_blocks"]["ln_1"]["scale"]
        graftshard.place(leaf, (config.n_layer,) + tuple(leaf.shape[1:]),
                         [(0, "pp", leaf.shape[0] + 1)])
        planted = graftshard.audit()
        return {"clean": clean, "status": status, "planted": planted}
    finally:
        os.environ.pop("GRAFTSHARD", None)
        graftshard.clear()
