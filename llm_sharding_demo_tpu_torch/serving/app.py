"""HTTP serving surface, wire-compatible with the JAX package's app.

Counterpart of the core of ``llm_sharding_demo_tpu/serving/app.py``
``create_app``:

- ``POST /generate``  {"prompt", "max_new_tokens", ...} -> {"generated": str}
- ``POST /forward``   {"input_ids": [int]}       -> {"hidden_states": [[[f]]]}
- ``POST /forward_b`` {"hidden_states": [[[f]]]} -> {"logits": [[[f]]]}
- ``GET /healthz``    readiness, the serving composition, the device, the
  resolved decode kernel mode, the kernels' launch counts, the trend
  watches' state and, with a paged pool, its block stats;
- ``GET /metrics``    the registry as Prometheus text;
- ``GET /debug``      the index of the ``/debug/*`` surfaces:
  ``/debug/requests`` (the flight recorder's span trees),
  ``/debug/profile`` (graftscope's call rings, host and CUDA-event
  stream windows, and occupancy series), ``/debug/memory`` (the memory
  ledger beside the CUDA allocator), ``/debug/timeline`` (grafttime's
  event stream), ``/debug/trend`` (grafttrend's watches) and
  ``/debug/plan`` (continuous planning's state; without it ``mode:
  "startup"`` and the static plan's row under ``AUTO_PLAN=1``, else
  ``mode: "off"``).

Role guards answer HTTP 200 with ``{"error": ...}`` as the reference does.
Runner choice: ``INFERENCE_DTYPE=int8`` or ``bfloat16``, ``MAX_BATCH >
1``, ``PREFILL_CHUNK`` or ``PREFIX_CACHE`` -> the staged ``DecodeEngine``, which runs the
CUDA kernels on the GPU for bf16 and int8; otherwise the kernel-free
``PipelineRunner``, the fp32 single-stream parity path. (The JAX app
serves single-stream bf16 through its ``PipelineRunner``; here bf16
takes the engine so that its decode steps run the kernels.) With
``MAX_BATCH > 1`` the engine sits behind the admission batcher
(``BATCH_MODE=admission``, ``runtime.batcher``) or the iteration-level
batcher (``BATCH_MODE=iter``, ``runtime.iterbatch``).

``CHECKPOINT_DIR`` serves a ``utils.checkpoint`` directory and its
tokenizer assets (``serving.loader``). A GPT-2-MoE model decodes on an
unstaged ``DecodeEngine`` in every dtype (the per-layer kernels for bf16
and int8 on the card); its stage endpoints decline, and
``DISPATCH=remote``, ``BATCH_MODE=iter``, ``KV_POOL_BLOCKS``,
``PREFILL_CHUNK``, ``PREFIX_CACHE`` and ``SPEC_DECODE`` refuse it, as in
the JAX app.

``KV_POOL_BLOCKS > 0`` pages the KV cache (``runtime.kv_pool``): an
unstaged engine, its pool (``KVBlockPool.for_engine``), and
``PagedKVRunner`` at ``MAX_BATCH=1`` or the iteration batcher over the
pool. As in the JAX package, paging takes an engine without a decode
kernel (a decode kernel owns its fused in-place cache): fp32 pages on
the plain path, int8 on the plain cache with its matmuls on the int8
linear and head kernels (``matmul_kernels``, the spec engine's
composition; the JAX package's plain int8 path takes its Pallas matmul
kernels the same way), and any dtype on the spec engine's plain engine
(``SPEC_DECODE``, with ``BATCH_MODE=iter``); a bf16 pooled server on the
card refuses at startup. A request the pool cannot host while the
waiting line is full answers 429 with ``Retry-After``.
``KV_HOST_BLOCKS`` hangs a host spill tier (``runtime.kv_tier``) below
the pool. ``create_app(kv_pool=)`` serves from an injected pool instead
of building one: the fleet's replicas share one (``fleet/harness.py``),
whose geometry and block storage each replica checks against its own
engine.

``AUTO_PLAN_CONTINUOUS=1`` (with ``KV_POOL_BLOCKS``, ``MAX_BATCH > 1``,
``BATCH_MODE=iter``) serves through ``utils.graftwatch``: the paged
branch's engine and one pool back two plans built at start-up, the solo
``PagedKVRunner`` and the pooled ``IterBatchingEngine``, and a
``PlanSwitcher`` routes each admission to the active one, re-scoring the
plans every wave of admissions against the traffic estimate (weights
from ``AUTO_PLAN_JOURNAL`` when given; plans certified against
``AUTO_PLAN_TRAFFIC``'s classes). A request keeps the plan it was
admitted to; its trace carries the plan's label. ``/healthz`` serves
the live ``auto_plan`` block and the batched plan's ``iter_batch_stats``,
``/debug/plan`` the switcher's state, ``app.plan_switcher`` the
switcher.

``AUTO_PLAN=1`` resolves the decode topology, batching and KV knobs at
startup (``resolve_auto_plan``): ``utils.costmodel.plan_for_serving``
ranks the candidates over the process group's ranks (unsharded, then
tp, ep and pp over all of them) against ``AUTO_PLAN_TRAFFIC``, within
the device's own memory, and the chosen row's knobs replace the
configured ones before every guard below runs. ``/healthz``
``auto_plan`` reports the row (merged under the live block with
``AUTO_PLAN_CONTINUOUS``).

``FLEET_ROLE`` makes the app a fleet replica (``fleet/topology.py``):
``/healthz`` reports the role, the replica label of its timeline events
defaults to it, and a ``prefill`` replica serves ``POST /prefill``
{"prompt"} -> {"registered_tokens", "prefix_entries", "chunk"}: the
prompt's chunk-aligned prefill through the prefix store, whose walk
registers the prefix states in the pool's content-keyed registry for
the decode replicas to adopt. A fill the pool cannot host answers 429
with ``Retry-After``, a spent X-Deadline-Ms 503; a wrong role or a
prompt that leaves no room 400.

``PREFIX_CACHE > 0`` puts the prefix store (``runtime.prefix_cache``,
chunk ``PREFIX_CHUNK``, else ``PREFILL_CHUNK``, else 64) in front of the
engine: alone it serves ``/generate``, and it backs the admission
batcher's rounds, the iteration batcher's admissions and, with a pool,
``PagedKVRunner``, whose rows share the store's blocks; ``/healthz``
serves its ``prefix_cache_stats``.

``SPEC_DECODE=K > 0`` builds a ``SpecDecodeEngine`` (``runtime.spec_decode``,
draft depth K) whose unstaged plain engine serves everything else, as in
the JAX app: its verify windows run the int8 matmul kernels and plain
attention. A request speculation can serve (``spec.eligible``) goes to
the spec engine, or with a batcher carries the ``SamplingConfig.spec``
flag into spec-only rounds and batches; with a prefix store the store
decides per request. ``/healthz`` serves ``spec_decode_stats``.

``PP_DECODE``, ``TP_DECODE`` and ``EP_DECODE`` decode over the ranks of
a ``torch.distributed`` process group (``parallel.distributed``; the
JAX app's device count is the group's size here): the pipelined decoder
(``parallel.ppdecode``, one stage a rank, int8 stages and MAX_BATCH
composing), the tensor-parallel engine (dense families) and the
expert-parallel engine (MoE), each ``DecodeEngine(mesh=)``. Every rank
builds the app; rank 0 serves, and ``app.mesh_runner.follow()`` runs
the others until rank 0's ``stop_followers``. The guards and their
messages are the JAX app's (``check_mesh``). ``/healthz`` reports the
three knobs and, with ``GRAFTSHARD=1``, the placement auditor.

Each request draws from its own generator, seeded by its ``seed``, so a
seeded request replays whether it ran alone or in a batch; a batched
request waits at most ``GENERATE_TIMEOUT_S`` and then answers 503.

``DISPATCH=remote`` is the reference's three-role topology: the
coordinator holds no weights and, once per token, POSTs the sequence to
shard A's ``/forward`` and relays the hidden states to shard B's
``/forward_b`` (``SHARD_A_SERVICE``, ``SHARD_B_SERVICE``), then picks the
token on the host: greedy argmax, or one ``numpy`` draw a token from
``sampler_pmf`` on ``np.random.default_rng(seed)``, the JAX app's seed
contract. Every hop goes through ``graftfault.HopPolicy`` (3 attempts,
capped backoff, a per-shard breaker); a failed shard answers a typed 502
naming it, an open breaker or a spent budget 503 with ``Retry-After``,
never a local answer. The relay is fp32 and runs no kernel.

Request headers: ``X-Request-ID`` is echoed on every ``/generate`` reply
(one is minted when it is absent or malformed); ``X-Deadline-Ms`` bounds
the request (400 when malformed, 503 ``deadline_exceeded`` once spent:
refused before any runner, cancelled at a segment boundary by the
iteration batcher, the per-attempt timeout of every shard hop). Every
503 carries ``Retry-After``. ``X-Workload-Profile`` labels the request's
trace.

Every ``/generate`` request builds a ``RequestTrace`` (tokenize, queue
wait, prefill, decode, detokenize spans) that the flight recorder keeps,
failed requests with an ``error`` label; from it the app observes
``ttft_seconds`` (arrival to the end of the prefill) and
``tpot_seconds`` (the decode spans over the steps decoded after the
first), beside ``generate_request_seconds``, and it counts
``generate_requests_total{mode}``, ``generated_tokens_total`` and
``deadline_misses_total``. A typed 503 journals the timeline
(``grafttime.blackbox``). ``create_app(registry=, recorder=)`` takes a
registry and a flight recorder of the caller's.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import re
import secrets
import time
import urllib.error
import urllib.request
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models import (is_partitionable, is_stage_partitionable,
                      is_window_independent)
from ..models.gpt2 import map_params
from ..ops import cuda_build
from ..parallel import distributed
from ..parallel import partition as P_
from ..parallel.pipeline import PipelineRunner
from ..runtime.batcher import BatchingEngine
from ..runtime.engine import (REF_TEMPERATURE, REF_TOP_K, DecodeEngine,
                              SamplingConfig, sampler_pmf)
from ..runtime.iterbatch import IterBatchingEngine
from ..runtime.kv_pool import GraftsanError, KVBlockPool, PagedKVRunner
from ..runtime.kv_tier import HostKVTier
from ..runtime.prefix_cache import PrefixCachingEngine
from ..runtime.spec_decode import SpecDecodeEngine
from ..utils import (graftfault, graftmem, graftscope, graftshard,
                     grafttime, grafttrend, graftwatch, tracing)
from ..utils.config import ServingConfig, from_env
from ..utils.device import DeviceLike, resolve_device
from ..utils.graftnum import regime_of
from ..utils.metrics import REGISTRY
from . import loader
from .http import JSONApp
from .tokenizer import get_tokenizer

log = logging.getLogger(__name__)

# how long a request thread waits for its row in a batch
GENERATE_TIMEOUT_S = 600.0


class UpstreamError(Exception):
    """A shard hop failed (connection, HTTP error, or error body)."""

    def __init__(self, shard: str, url: str, detail: str):
        super().__init__(f"shard {shard} at {url}: {detail}")
        self.shard = shard
        self.url = url
        self.detail = detail


class ShardHTTPError(Exception):
    """A shard answered an HTTP error status (retried, as the JAX
    relay's ``requests.exceptions.HTTPError`` is)."""


# what one hop attempt can raise on the wire: retried under the hop
# policy, then answered as a typed 502
HOP_ERRORS = (ConnectionError, TimeoutError, ShardHTTPError,
              json.JSONDecodeError)


def post_json(url: str, payload: dict, timeout_s: float):
    """POST ``payload`` as JSON and parse the reply, with the failures
    mapped onto ``HOP_ERRORS``: a refused or reset connection is a
    ``ConnectionError``, a socket timeout a ``TimeoutError``, an error
    status a ``ShardHTTPError``."""
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        raise ShardHTTPError(f"{e.code} {e.reason} for url: {url}") from e
    except urllib.error.URLError as e:
        if isinstance(e.reason, TimeoutError):
            raise TimeoutError(f"{e.reason} for url: {url}") from e
        raise ConnectionError(f"{e.reason} for url: {url}") from e
    except http.client.HTTPException as e:
        raise ConnectionError(f"{type(e).__name__}: {e}") from e


_RID_RE = re.compile(r"[A-Za-z0-9._:-]{1,128}")
_PROFILE_RE = re.compile(r"[A-Za-z0-9._:-]{1,64}")
DEADLINE_MS_ERROR = ("X-Deadline-Ms must be an integer millisecond "
                     "budget in [1, 86400000]")


def parse_request_identity(headers: dict) -> Tuple[str, Optional[str]]:
    """``(request id, workload profile label)``: the caller's
    ``X-Request-ID`` or a minted one, and ``X-Workload-Profile`` or None;
    each held to a safe charset, since both are echoed and logged."""
    raw_rid = (headers.get("x-request-id") or "").strip()
    rid = (raw_rid if _RID_RE.fullmatch(raw_rid)
           else tracing.new_request_id())
    raw_prof = (headers.get("x-workload-profile") or "").strip()
    return rid, (raw_prof if _PROFILE_RE.fullmatch(raw_prof) else None)


def parse_deadline_header(headers: dict):
    """``X-Deadline-Ms`` -> ``(deadline, ms, error)``: ``(None, None,
    None)`` when absent, ``(None, None, message)`` when malformed or out
    of range (the caller answers 400)."""
    raw_dl = (headers.get("x-deadline-ms") or "").strip()
    if not raw_dl:
        return None, None, None
    try:
        dl_ms = int(raw_dl)
    except ValueError:
        dl_ms = 0
    if not 1 <= dl_ms <= 86_400_000:
        return None, None, DEADLINE_MS_ERROR
    return graftfault.Deadline.from_ms(dl_ms), dl_ms, None


@dataclasses.dataclass
class InputIDs:
    input_ids: List[int]


@dataclasses.dataclass
class HiddenStates:
    hidden_states: list  # nested [batch, seq, hidden]


@dataclasses.dataclass
class GenerateReq:
    prompt: str
    max_new_tokens: int = 20
    # extensions beyond the reference schema; the defaults reproduce its
    # temperature-0.6 / top-k-40 sampling
    mode: str = "sample"
    temperature: float = REF_TEMPERATURE
    top_k: int = REF_TOP_K
    top_p: float = 1.0
    stop_at_eos: bool = False
    eos_token_id: Optional[int] = None
    # the same (prompt, params, seed) on the same server replays the same
    # stream
    seed: Optional[int] = None


@dataclasses.dataclass
class PrefillReq:
    """The ``/prefill`` body: the prompt alone. The prefill replica fills
    shared pool blocks; block ids never cross the wire."""

    prompt: str


def create_app(cfg: Optional[ServingConfig] = None, model=None,
               tokenizer=None, device: DeviceLike = None, registry=None,
               recorder=None, kv_pool: Optional[KVBlockPool] = None,
               replica: Optional[str] = None) -> JSONApp:
    """Build the app. ``model=(config, params)`` and ``tokenizer`` are
    injectable for tests; by default the model comes from
    ``serving.loader`` (role-aware: a shard with a checkpoint restores
    only its stage, a remote coordinator only the configuration) and the
    tokenizer from the checkpoint's assets, else bytes. ``device`` is
    ``cuda`` unless given. ``registry`` (a ``MetricsRegistry``) and
    ``recorder`` (a ``FlightRecorder``) default to the process's.
    ``kv_pool`` (a ``KVBlockPool`` matching this app's engine) makes the
    app serve from a shared pool instead of building its own: the
    fleet's replicas hand blocks off through one allocator's registry.
    ``replica`` labels the app's timeline events (default: the fleet
    role, else "solo")."""
    cfg = cfg or from_env()
    dev = resolve_device(device)
    reg = registry if registry is not None else REGISTRY
    rec = recorder if recorder is not None else tracing.RECORDER
    replica_label = replica or cfg.fleet_role or "solo"
    # the trend watches over this app's registry, polled on each read
    # of /debug/trend
    trend_reducer = grafttrend.TrendReducer(registry=reg)
    # a remote coordinator relays to the shards, which hold the weights
    remote = cfg.shard_role == "coordinator" and cfg.dispatch == "remote"
    stage_only = None
    if model is not None:
        config, params = model
    else:
        config, params, stage_only = loader.resolve_for_role(cfg, dev)
    tokenizer = tokenizer or get_tokenizer(cfg.model_id,
                                           checkpoint_dir=cfg.checkpoint_dir)
    # the process group's ranks stand where the JAX app counts devices
    world = distributed.world_size()

    # AUTO_PLAN (utils.costmodel): the decode topology, batching and KV
    # knobs resolved at startup by the static planner over the loaded
    # config and the ranks; every candidate passed the planner's gates,
    # and the guards below still run on the resolved values. A pure
    # function of the config and the world size: every rank resolves
    # the same plan. Logged, and reported under /healthz "auto_plan"
    auto_plan_info = None
    if cfg.auto_plan:
        cfg, auto_plan_info = resolve_auto_plan(cfg, config, world, dev)

    n_layer = config.n_layer
    for b in cfg.boundaries:
        if not 1 <= b <= n_layer - 1:
            raise ValueError(
                f"boundary {b} out of range for n_layer={n_layer}")
    # the reference's two-stage wire topology (/forward, /forward_b) is
    # dense GPT-2 only; other families answer /generate alone.
    # ``stageable``: whether the engine can stage the family at all (GPT-2
    # and llama; MoE decodes unstaged)
    partitionable = is_partitionable(config)
    stageable = is_stage_partitionable(config)
    if not partitionable and cfg.dispatch == "remote":
        raise ValueError(
            "DISPATCH=remote requires the dense GPT-2 stage-shard "
            f"topology; {type(config).__name__} models serve with "
            "DISPATCH=local")
    check_batching(cfg, config)
    check_mesh(cfg, config, stageable, world)
    if kv_pool is not None:
        if remote or cfg.shard_role != "coordinator":
            raise ValueError("kv_pool injection applies to the "
                             "coordinator's local decode path only")
        if cfg.kv_pool_blocks == 0:
            raise ValueError("kv_pool injected but KV_POOL_BLOCKS=0 — "
                             "a silently unused pool would misreport "
                             "the serving composition")

    runner = engine = prefix = spec = switcher = None
    # a mesh engine or the pipelined decoder: rank 0 serves, every other
    # rank follows it (``app.mesh_runner.follow``)
    mesh_runner = None
    decode_kernel = None
    decode_stages = len(cfg.boundaries) + 1
    if cfg.shard_role == "coordinator" and not remote:
        pchunk = cfg.prefill_chunk or None
        if cfg.spec_decode > 0:
            # the spec engine decodes unstaged and wraps the plain engine
            # every other request takes (the same weights)
            spec = SpecDecodeEngine(params, config, max_seq=cfg.max_seq,
                                    dtype=cfg.inference_dtype,
                                    draft_len=cfg.spec_decode,
                                    prefill_chunk=pchunk, device=dev)
            engine = spec.plain
            decode_stages = 1
        elif not stageable:
            # MoE's expert tree is not stage-partitionable: the whole
            # model decodes unstaged, in every dtype; EP_DECODE splits the
            # expert stack over an ep axis of the ranks (validated above)
            mesh = None
            if cfg.ep_decode:
                from ..parallel.spmd import make_mesh
                distributed.ensure_initialized(dev)
                ep_size = min(world, config.n_experts)
                mesh = make_mesh({"ep": ep_size}, list(range(ep_size)))
            engine = DecodeEngine(params, config, max_seq=cfg.max_seq,
                                  dtype=cfg.inference_dtype, device=dev,
                                  prefill_chunk=pchunk, mesh=mesh)
            mesh_runner = engine if mesh is not None else None
            decode_stages = 1
        elif cfg.pp_decode:
            # one stage a rank, the activation handed from rank to rank
            # (parallel.ppdecode); int8 stages, uneven BOUNDARIES and
            # MAX_BATCH > 1 (the batcher wraps below) compose
            from ..parallel.ppdecode import PipelinedDecoder
            from ..parallel.spmd import make_mesh
            distributed.ensure_initialized(dev)
            n_st = len(cfg.boundaries) + 1
            engine = PipelinedDecoder(
                params, config, make_mesh({"pp": n_st}, list(range(n_st))),
                max_seq=cfg.max_seq, dtype=cfg.inference_dtype,
                boundaries=list(cfg.boundaries), device=dev)
            mesh_runner = engine
        elif cfg.tp_decode:
            # Megatron slices and a head-sharded KV cache over every
            # rank (runtime.engine._place_tp_params); composes with
            # MAX_BATCH (the batcher wraps below) and PREFILL_CHUNK
            from ..parallel.spmd import make_mesh
            distributed.ensure_initialized(dev)
            engine = DecodeEngine(params, config, max_seq=cfg.max_seq,
                                  dtype=cfg.inference_dtype, device=dev,
                                  prefill_chunk=pchunk,
                                  mesh=make_mesh({"tp": world}))
            mesh_runner = engine
            decode_stages = 1  # unstaged (tensor axis, not stage axis)
        elif cfg.kv_pool_blocks > 0:
            # paged storage gathers and scatters whole-model cache rows,
            # so the engine runs unstaged, on the plain cache; int8 takes
            # its matmul kernels there
            kernels = ({"decode_kernel": "xla", "matmul_kernels": True}
                       if cfg.inference_dtype == "int8" else {})
            engine = DecodeEngine(params, config, max_seq=cfg.max_seq,
                                  dtype=cfg.inference_dtype, device=dev,
                                  **kernels)
            decode_stages = 1
        elif (cfg.inference_dtype != "float32" or cfg.max_batch > 1
                or pchunk or cfg.prefix_cache > 0):
            engine = DecodeEngine(params, config, max_seq=cfg.max_seq,
                                  boundaries=list(cfg.boundaries),
                                  dtype=cfg.inference_dtype, device=dev,
                                  prefill_chunk=pchunk)
        else:
            engine = PipelineRunner(params, config, list(cfg.boundaries),
                                    max_seq=cfg.max_seq, device=dev)
        if kv_pool is not None:
            if cfg.auto_plan_continuous:
                check_continuous_pool(kv_pool, engine)
            check_shared_pool(kv_pool, engine, cfg)
        elif cfg.kv_pool_blocks > 0:
            kv_pool = KVBlockPool.for_engine(
                engine, num_blocks=cfg.kv_pool_blocks,
                block_size=cfg.kv_block_size,
                block_dtype=cfg.kv_pool_dtype or None)
        decode_kernel = engine.decode_kernel_mode
        runner = engine
        if (kv_pool is not None and cfg.kv_host_blocks > 0
                and kv_pool.tier is None):
            # cold prefix entries demote to host memory instead of being
            # evicted, and promote back on a hit (an injected pool may
            # come with its tier: the fleet's replicas share both)
            kv_pool.attach_tier(HostKVTier(cfg.kv_host_blocks))
        if cfg.prefix_cache > 0:
            prefix = PrefixCachingEngine(
                engine, capacity=cfg.prefix_cache,
                chunk=cfg.prefix_chunk or cfg.prefill_chunk or 64,
                spec=spec, pool=kv_pool)
            runner = prefix
        if cfg.auto_plan_continuous:
            # the two plans share the engine and the pool, built here
            # once: a switch only re-routes admissions between them
            switcher = continuous_switcher(cfg, config, engine, kv_pool,
                                           reg, trend_reducer)
            runner = None
        elif cfg.max_batch > 1 and cfg.batch_mode == "iter":
            runner = IterBatchingEngine(engine, max_batch=cfg.max_batch,
                                        max_wait_ms=cfg.batch_wait_ms,
                                        spec=spec, prefix=prefix,
                                        pool=kv_pool, replica=replica_label)
        elif cfg.max_batch > 1:
            runner = BatchingEngine(engine, max_batch=cfg.max_batch,
                                    max_wait_ms=cfg.batch_wait_ms,
                                    prefix=prefix, spec=spec)
        elif kv_pool is not None:
            runner = PagedKVRunner(engine, kv_pool, prefix=prefix)
    decline = {"error": "stage endpoints serve dense GPT-2 only; "
                        f"{type(config).__name__} models generate via "
                        "/generate"}
    compat_specs = P_.make_stage_specs(n_layer, [cfg.split_at])
    compat_params = {}
    for i, role in enumerate(("a", "b")):
        if cfg.shard_role == role and partitionable:
            compat_params[role] = (
                stage_only if stage_only is not None
                else P_.extract_stage_params(
                    map_params(lambda x: x.to(dev), params),
                    compat_specs[i]))

    app = JSONApp(title="llm-sharding-demo-tpu-torch", version="0.1.0")

    @app.get("/metrics")
    def metrics():
        return reg.prometheus()

    def _topology() -> dict:
        """The composition serving /generate: the one header of
        /healthz and of every /debug surface."""
        return {
            "role": cfg.shard_role,
            "model": cfg.model_id,
            "n_stages": decode_stages,
            "dispatch": cfg.dispatch,
            "max_batch": cfg.max_batch,
            "batch_mode": cfg.batch_mode,
            "inference_dtype": cfg.inference_dtype,
            "spec_decode": cfg.spec_decode,
            "prefill_chunk": cfg.prefill_chunk,
            "prefix_cache": cfg.prefix_cache,
            "prefix_chunk": cfg.prefix_chunk,
            "kv_pool_blocks": cfg.kv_pool_blocks,
            "kv_block_size": cfg.kv_block_size,
            "kv_pool_dtype": cfg.kv_pool_dtype,
            "kv_host_blocks": cfg.kv_host_blocks,
            "pp_decode": cfg.pp_decode,
            "ep_decode": cfg.ep_decode,
            "tp_decode": cfg.tp_decode,
            # the fleet role, and the prefix chunk above is the width the
            # router's affinity keys must match
            "fleet_role": cfg.fleet_role,
            "device": str(dev),
            "decode_kernel": decode_kernel,
            # continuous planning: the live plan merged over any start-up
            # row; else how the knobs above were resolved (AUTO_PLAN=1)
            **({"auto_plan": {**(auto_plan_info or {}),
                              **switcher.health_view()}}
               if switcher is not None else
               {"auto_plan": auto_plan_info}
               if auto_plan_info is not None else {}),
        }

    def _pool_stats() -> dict:
        st = kv_pool.stats()
        # the planes' bytes from the ledger, never from shapes
        st["pool_bytes"] = (graftmem.holding_bytes(kv_pool, "data")
                            + graftmem.holding_bytes(kv_pool, "scales"))
        return st

    @app.get("/healthz")
    def healthz():
        live = {}
        if kv_pool is not None:
            st = _pool_stats()
            # every block is free or referenced: drift is an accounting
            # bug, answered 500 rather than a wrong gauge
            if st["blocks_in_use"] + st["blocks_free"] != st["blocks_total"]:
                raise AssertionError(
                    "kv_pool_stats conservation violated: "
                    f"{st['blocks_in_use']} in_use + {st['blocks_free']} "
                    f"free != {st['blocks_total']} total")
            if kv_pool.tier is not None:
                # per-tier conservation: drift answers 500, as above
                kv_pool.tier.graftsan_check("healthz")
            live["kv_pool_stats"] = st
        if prefix is not None:
            live["prefix_cache_stats"] = prefix.stats()
        if switcher is not None:
            # the pooled batcher's stats whichever plan is active
            live["iter_batch_stats"] = switcher.plans["batched"].stats()
        if spec is not None:
            live["spec_decode_stats"] = spec.stats()
        # the ledger's entry table against its running totals: drift
        # answers 500
        mem = graftmem.snapshot()
        if graftmem.enabled() and not mem["conserved"]:
            raise AssertionError(
                "graftmem byte conservation violated: component sum "
                f"{mem['components']} disagrees with ledger total "
                f"{mem['total_bytes']}")
        # the live placement auditor (GRAFTSHARD=1): its counters, and a
        # violation that slipped past the raise path answers 500
        shard_status = graftshard.status()
        if shard_status["enabled"]:
            shard_status["audit"] = graftshard.audit()
            if shard_status["audit"]:
                raise AssertionError(
                    "graftshard placement contract violated: "
                    f"{shard_status['audit']}")
        return {
            "status": "ok",
            "graftshard": shard_status,
            **_topology(),
            "trend": trend_reducer.health_view(),
            "kernel_launches": cuda_build.launch_counts(),
            # the engine's cached forwards by "BATCHxTOKENS"
            "forward_shapes": ({} if engine is None else {
                f"{b}x{t}": n
                for (b, t), n in sorted(engine.forward_shapes().items())}),
            **({"batch_stats": runner.stats()}
               if isinstance(runner, (BatchingEngine, IterBatchingEngine))
               else {}),
            **live,
        }

    @app.get("/debug")
    def debug_index():
        return {
            "serving": _topology(),
            "surfaces": {
                "/debug/requests": (
                    "flight recorder: span trees of the last N requests "
                    "(?n, ?slowest=1, ?errors=1, ?profile=)"),
                "/debug/profile": (
                    "graftscope: per-scope call rings with host and "
                    "CUDA-event stream windows, occupancy series (?n)"),
                "/debug/plan": (
                    "continuous planning: the active plan, each plan's "
                    "score, cost terms and certified forward shapes, "
                    "the weights, the switch journal, the signals (?n); "
                    "mode off without AUTO_PLAN_CONTINUOUS"),
                "/debug/timeline": (
                    "grafttime's causal event stream, one clock over "
                    "spans, calls, faults, admissions and tier moves "
                    "(?rid=, ?since=, ?since_seq=, ?kinds=, ?n=)"),
                "/debug/trend": (
                    "grafttrend: the WATCH_POLICY verdicts, windowed "
                    "series reductions, the alert journal (?eval=0 "
                    "reads without polling or evaluating)"),
                "/debug/memory": (
                    "graftmem: per-component live bytes, peaks, "
                    "per-device attribution beside the CUDA allocator, "
                    "pool geometry, the conservation verdict"),
            },
        }

    @app.get("/debug/requests")
    def debug_requests(query: dict):
        return tracing.debug_requests_payload(rec, query, _topology())

    @app.get("/debug/profile")
    def debug_profile(query: dict):
        try:
            n = int(query.get("n", "32"))
        except ValueError:
            return 422, {"detail": "n must be an integer"}
        return {"serving": _topology(), **graftscope.snapshot(n=n)}

    @app.get("/debug/plan")
    def debug_plan(query: dict):
        # without continuous mode the payload still answers: mode
        # "startup" with the static plan's row (AUTO_PLAN=1), else "off"
        if switcher is None:
            return {"serving": _topology(),
                    "mode": "startup" if auto_plan_info is not None
                    else "off",
                    "auto_plan": auto_plan_info}
        try:
            n = int(query.get("n", "16"))
        except ValueError:
            return 422, {"detail": "n must be an integer"}
        return {"serving": _topology(), **switcher.describe(n=n)}

    @app.get("/debug/memory")
    def debug_memory():
        body = {"serving": _topology(), **graftmem.snapshot()}
        if kv_pool is not None:
            body["pool"] = _pool_stats()
        return body

    @app.get("/debug/timeline")
    def debug_timeline(query: dict):
        return grafttime.debug_timeline_payload(query, _topology())

    @app.get("/debug/trend")
    def debug_trend(query: dict):
        if query.get("eval", "1") != "0":
            trend_reducer.poll()
            trend_reducer.evaluate()
        return {"serving": _topology(), **trend_reducer.describe()}

    @app.post("/prefill")
    def prefill(req: PrefillReq, headers: dict):
        # the replica label rides every timeline event of the request
        with grafttime.use_replica(replica_label):
            return _prefill(req, headers)

    def _prefill(req: PrefillReq, headers: dict):
        """The prefill replica's endpoint: the prompt's chunk-aligned
        prefill through the prefix store, whose walk registers every
        full-chunk prefix state in the pool's content-keyed registry
        (the registry holding its own refs), where the decode replicas
        adopt them zero-copy. Only the prompt crosses the hop, and only
        block ids change hands afterwards (``fleet/topology.py``
        ``HANDOFF_POLICY``)."""
        rid, _profile = parse_request_identity(headers)
        hdrs = {"X-Request-ID": rid}

        def out(body, status=200):
            return status, body, hdrs

        if cfg.fleet_role != "prefill":
            return out({"error": "This instance is not a fleet "
                                 "prefill replica."}, status=400)
        # unreachable through from_env (FLEET_ROLE requires the
        # pool-backed store); a config built by hand may lack it
        if prefix is None or kv_pool is None:
            return out({"error": "prefill replicas need the pool-backed "
                                 "prefix store (KV_POOL_BLOCKS + "
                                 "PREFIX_CACHE)"}, status=400)
        deadline, _dl_ms, dl_err = parse_deadline_header(headers)
        if dl_err:
            return out({"error": dl_err}, status=400)
        trace = tracing.RequestTrace(rid, fleet="prefill")

        def reject(msg: str):
            # a 400, flight-recorded: the router counts a warm by the
            # status, so a 200 with an error body would pass for one
            trace.labels.update(error=msg)
            rec.record(trace)
            return out({"error": msg}, status=400)

        with trace.span("tokenize"):
            prompt_ids = tokenizer.encode(req.prompt)
        if not prompt_ids:
            return reject("prompt tokenized to zero tokens")
        if len(prompt_ids) >= cfg.max_seq:
            return reject(f"prompt ({len(prompt_ids)} tokens) leaves "
                          f"no forward room under max_seq "
                          f"({cfg.max_seq})")
        chunk = prefix.chunk
        m_total = (len(prompt_ids) - 1) // chunk
        alloc = kv_pool.allocator
        # a fill the pool cannot host is shed before the prefill runs.
        # Registered prefixes share blocks, so the gate counts the
        # marginal need: nothing for a registered prompt, the new chunks'
        # blocks past the deepest registered prefix. ``has_prefix`` takes
        # no leases (the walk takes its own)
        need = alloc.blocks_for(m_total * chunk)
        if need:
            arr = np.asarray(prompt_ids, dtype=np.int32)
            if alloc.has_prefix(prefix._key(arr, m_total, chunk)):
                need = 0
            else:
                for m in range(m_total - 1, 0, -1):
                    if alloc.has_prefix(prefix._key(arr, m, chunk)):
                        need -= (m * chunk) // kv_pool.block_size
                        break
        if need > 0 and alloc.available() < need:
            reg.inc("kv_pool_admission_rejections_total")
            hdrs["Retry-After"] = "1"
            trace.labels.update(error="kv_pool_saturated")
            rec.record(trace)
            return out({"error": "kv_pool_saturated",
                        "detail": "pool cannot host this prefix fill; "
                                  "retry after the indicated backoff"},
                       status=429)
        try:
            if deadline is not None:
                deadline.raise_if_expired("prefill")
            with tracing.use_trace(trace):
                _logits, _cache, shared_ids, depth = prefix.prefill_shared(
                    np.asarray(prompt_ids, dtype=np.int32))
            # the walk's caller refs go at once: the registry holds the
            # entry's own, and the hop hands ids off by content key
            alloc.free(shared_ids)
        except graftfault.Unavailable as e:
            hdrs["Retry-After"] = str(max(1, int(round(e.retry_after))))
            if e.code == "deadline_exceeded":
                reg.inc("deadline_misses_total")
            trace.labels.update(error=e.code)
            rec.record(trace)
            grafttime.blackbox(e.code, rid=rid)
            return out({"error": e.code, "detail": str(e)}, status=503)
        except Exception as e:  # noqa: BLE001 - the id is still echoed
            log.exception("prefill failed")
            trace.labels.update(error=f"{type(e).__name__}: {e}")
            rec.record(trace)
            if isinstance(e, GraftsanError):
                grafttime.blackbox(f"graftsan:{type(e).__name__}", rid=rid)
            return out({"detail": f"{type(e).__name__}: {e}"}, status=500)
        trace.labels.update(registered_tokens=depth)
        rec.record(trace)
        return out({"registered_tokens": depth,
                    "prefix_entries": alloc.prefix_len(),
                    "chunk": chunk})

    @app.post("/forward")
    def forward_a(req: InputIDs):
        if cfg.shard_role != "a":
            return {"error": "This instance is not shard A."}
        if not partitionable:
            return decline
        if not req.input_ids or not all(
                0 <= t < config.vocab_size for t in req.input_ids):
            return 422, {"detail": f"input_ids must be a non-empty list of "
                                   f"ids in [0, {config.vocab_size})"}
        ids = torch.tensor([req.input_ids], dtype=torch.int64, device=dev)
        with torch.inference_mode():
            hidden, _ = P_.stage_apply(compat_params["a"], compat_specs[0],
                                       config, ids)
        return {"hidden_states": hidden.float().cpu().tolist()}

    @app.post("/forward_b")
    def forward_b(req: HiddenStates):
        if cfg.shard_role != "b":
            return {"error": "This instance is not shard B."}
        if not partitionable:
            return decline
        try:
            arr = np.asarray(req.hidden_states, dtype=np.float32)
        except (ValueError, TypeError):
            arr = None
        if arr is None or arr.ndim != 3 or arr.shape[-1] != config.n_embd \
                or 0 in arr.shape:
            return 422, {"detail": f"hidden_states must be a non-empty "
                                   f"[batch, seq, {config.n_embd}] array"}
        with torch.inference_mode():
            logits, _ = P_.stage_apply(compat_params["b"], compat_specs[1],
                                       config, torch.from_numpy(arr).to(dev))
        return {"logits": logits.cpu().tolist()}

    # one hop discipline for every coordinator -> shard POST: capped
    # exponential backoff with seeded jitter, 3 attempts, a per-shard
    # breaker; an error body from a live shard (a misroute) is fatal
    hop_policy = graftfault.HopPolicy(
        attempts=3, timeout_s=30.0, base_backoff_s=0.25,
        max_backoff_s=2.0, breaker_threshold=5, breaker_cooldown_s=5.0,
        fatal=(UpstreamError,), registry=reg,
        on_retry=lambda shard, reason: reg.inc(
            "shard_hop_retries_total", stage=shard, reason=reason))

    def _relay(shard: str, url: str, payload: dict, key: str,
               deadline: Optional[graftfault.Deadline] = None):
        """One shard hop through the hop policy: ``body[key]`` of the
        shard's reply. Wire failures are retried, then raised as
        ``UpstreamError`` (502); a 200 without ``key`` (a role guard's
        ``{"error": ...}``) is a fatal ``UpstreamError``; an open breaker
        or a spent budget raises ``graftfault.Unavailable`` (503)."""

        def attempt(timeout_s: float):
            # seeded fault injection lands here, before the wire call,
            # so the whole retry and breaker path replays
            kind = graftfault.inject("serving.shard_hop", "reset",
                                     "timeout", "http_503", "slow")
            if kind == "reset":
                raise ConnectionError("graftfault: injected connection reset")
            if kind == "timeout":
                raise TimeoutError("graftfault: injected hop timeout")
            if kind == "http_503":
                raise ShardHTTPError("graftfault: injected shard 503")
            if kind == "slow":
                time.sleep(min(0.05, timeout_s))
            body = post_json(url, payload, timeout_s)
            if key not in body:
                raise UpstreamError(
                    shard, url,
                    str(body.get("error", f"response missing {key!r}")))
            return body[key]

        try:
            return hop_policy.call(attempt, shard=shard, deadline=deadline)
        except HOP_ERRORS as e:
            raise UpstreamError(shard, url, f"{type(e).__name__}: {e}")

    def _generate_remote(req: GenerateReq, prompt_ids: List[int],
                         eos_id: Optional[int],
                         deadline: Optional[graftfault.Deadline],
                         ) -> List[int]:
        """The reference's decode: per token, the whole sequence to shard
        A, its hidden states to shard B, the token picked on the host
        from the last position's logits. One numpy draw a token from
        ``sampler_pmf`` (the JAX app's seed contract); stops at EOS."""
        ids = list(prompt_ids)
        rng = np.random.default_rng(req.seed)
        sampling = (None if req.mode == "greedy" else
                    SamplingConfig(mode="sample", temperature=req.temperature,
                                   top_k=req.top_k, top_p=req.top_p))
        for _ in range(req.max_new_tokens):
            hidden = _relay("a", f"{cfg.shard_a_url}/forward",
                            {"input_ids": ids}, "hidden_states", deadline)
            logits = np.asarray(_relay(
                "b", f"{cfg.shard_b_url}/forward_b",
                {"hidden_states": hidden}, "logits", deadline))[0, -1]
            if req.mode == "greedy":
                ids.append(int(np.argmax(logits)))
            else:
                probs, top_idx = sampler_pmf(torch.from_numpy(logits),
                                             sampling)
                probs = probs.numpy().astype(np.float64)
                ids.append(int(rng.choice(top_idx.numpy(),
                                          p=probs / probs.sum())))
            if eos_id is not None and ids[-1] == eos_id:
                break
        return ids

    def _generate_local(req: GenerateReq, prompt_ids: List[int],
                        eos_id: Optional[int],
                        deadline: Optional[graftfault.Deadline],
                        ) -> List[int]:
        sampling = (SamplingConfig(mode="greedy") if req.mode == "greedy"
                    else SamplingConfig(mode="sample",
                                        temperature=req.temperature,
                                        top_k=req.top_k, top_p=req.top_p))
        seed = req.seed if req.seed is not None else secrets.randbits(31)
        gen = torch.Generator(device=dev).manual_seed(seed)
        eng = runner
        if switcher is not None:
            # continuous mode: one admission observation a request, a
            # re-plan at wave boundaries, and the plan that serves this
            # request (it keeps it across a switch)
            eng, plan_label = switcher.admit(len(prompt_ids),
                                             req.max_new_tokens)
            tr = tracing.current_trace()
            if tr is not None:
                tr.labels.update(plan=plan_label)
        # the release is in the finally from here on: the deadline check
        # below raises routinely, and a leaked in-flight count would bias
        # every later plan decision wide
        try:
            return _run_local(eng, req, prompt_ids, sampling, gen, eos_id,
                              deadline)
        finally:
            if switcher is not None:
                switcher.release()

    def _run_local(eng, req: GenerateReq, prompt_ids: List[int], sampling,
                   gen, eos_id: Optional[int],
                   deadline: Optional[graftfault.Deadline]) -> List[int]:
        # speculation serves the requests it is exact for (a prompt of at
        # least ngram tokens, draft_len slots of headroom); behind a
        # batcher the spec flag routes them, with a prefix store the
        # store decides, else they go to the spec engine
        batched = isinstance(eng, (BatchingEngine, IterBatchingEngine))
        if spec is not None and spec.eligible(len(prompt_ids),
                                              req.max_new_tokens):
            if batched:
                sampling = dataclasses.replace(sampling, spec=True)
            elif prefix is None:
                eng = spec
        kw = {}
        if batched:
            kw["timeout"] = GENERATE_TIMEOUT_S
        if eos_id is not None and not isinstance(
                eng, (BatchingEngine, PrefixCachingEngine, SpecDecodeEngine)):
            # the engine, the paged runner and the iteration batcher stop
            # at EOS checks; the admission batcher's, the prefix store's
            # and the spec engine's rows are cut by the caller, same reply
            kw["eos_id"] = eos_id
        if deadline is not None:
            # the iteration batcher honours the budget end to end (queue
            # wait, cancellation at a segment boundary with the row's
            # blocks freed); every runner refuses a spent one
            deadline.raise_if_expired("generate")
            if isinstance(eng, IterBatchingEngine):
                kw["deadline"] = deadline
        result = eng.generate(np.asarray(prompt_ids),
                              max_new_tokens=req.max_new_tokens,
                              sampling=sampling, generator=gen, **kw)
        return [int(t) for t in result.row_tokens(0)]

    @app.post("/generate")
    def generate(req: GenerateReq, headers: dict):
        # the replica label rides every timeline event of the request
        with grafttime.use_replica(replica_label):
            return _generate(req, headers)

    def _generate(req: GenerateReq, headers: dict):
        # every reply, errors included, echoes the request id
        rid, profile_label = parse_request_identity(headers)
        hdrs = {"X-Request-ID": rid}

        def out(body, status=200):
            return status, body, hdrs

        if cfg.shard_role != "coordinator":
            return out({"error": "This instance is not coordinator."})
        if req.max_new_tokens < 1:
            return out({"error": "max_new_tokens must be >= 1"})
        deadline, dl_ms, dl_err = parse_deadline_header(headers)
        if dl_err:
            return out({"error": dl_err}, status=400)
        trace = tracing.RequestTrace(rid, mode=req.mode,
                                     dispatch=cfg.dispatch)
        if profile_label is not None:
            trace.labels.update(profile=profile_label)
        if deadline is not None:
            trace.labels.update(deadline_ms=dl_ms)
        with trace.span("tokenize"):
            prompt_ids = tokenizer.encode(req.prompt)
        if not prompt_ids:
            return out({"error": "prompt tokenized to zero tokens"})
        if len(prompt_ids) + req.max_new_tokens > cfg.max_seq:
            return out({"error": f"prompt ({len(prompt_ids)} tokens) + "
                        f"max_new_tokens ({req.max_new_tokens}) exceeds "
                        f"max_seq ({cfg.max_seq})"})
        if req.mode not in ("sample", "greedy"):
            return out({"error": f"unknown mode {req.mode!r}"})
        if req.mode == "sample":
            if req.temperature <= 0:
                return out({"error": "temperature must be > 0"})
            if not 1 <= req.top_k <= config.vocab_size:
                return out(
                    {"error": f"top_k must be in [1, {config.vocab_size}]"})
            if not 0.0 < req.top_p <= 1.0:
                return out({"error": "top_p must be in (0, 1]"})
        eos_id = None
        if req.stop_at_eos or req.eos_token_id is not None:
            eos_id = (req.eos_token_id if req.eos_token_id is not None
                      else getattr(tokenizer, "eos_token_id", None))
            if eos_id is None:
                return out({"error": "stop_at_eos requested but the "
                            "tokenizer has no eos_token_id; pass "
                            "eos_token_id explicitly"})
            if not 0 <= eos_id < config.vocab_size:
                return out(
                    {"error": f"eos_token_id {eos_id} out of vocab range"})
        if kv_pool is not None:
            # a request the pool cannot host, with the waiting line full,
            # is shed with 429 + Retry-After rather than queued without
            # bound; the solo paged runner sheds what the pool could not
            # host right now. Continuous mode gates on the active plan
            # (advisory: the worker's grant is the atomic admit_alloc)
            gate = runner if switcher is None else switcher.peek()
            if isinstance(gate, IterBatchingEngine):
                ok, retry = gate.admission_load(len(prompt_ids),
                                                req.max_new_tokens)
            else:
                need = kv_pool.allocator.blocks_for(
                    len(prompt_ids) + req.max_new_tokens)
                spike = graftfault.inject("serving.admission", "pool_spike")
                ok = (spike is None
                      and kv_pool.allocator.available() >= need)
                retry = 1.0
            if not ok:
                reg.inc("kv_pool_admission_rejections_total")
                hdrs["Retry-After"] = str(max(1, int(round(retry))))
                trace.labels.update(error="kv_pool_saturated")
                rec.record(trace)
                return out({"error": "kv_pool_saturated",
                            "detail": "KV memory pool cannot admit this "
                                      "request; retry after the "
                                      "indicated backoff"}, status=429)
        # the runners record their phases on the ambient trace; a
        # batcher carries it across its queue to its worker
        try:
            with tracing.timed("generate_request_seconds", registry=reg,
                               mode=req.mode, dispatch=cfg.dispatch):
                with tracing.use_trace(trace):
                    if remote:
                        ids = _generate_remote(req, prompt_ids, eos_id,
                                               deadline)
                    else:
                        ids = _generate_local(req, prompt_ids, eos_id,
                                              deadline)
            finish_reason = "length"
            # the steps decoded, counted before the EOS cut: TPOT divides
            # the decode time by the steps the device ran
            n_decoded = len(ids) - len(prompt_ids)
            if eos_id is not None:
                # truncate at the first EOS among the new tokens
                new = ids[len(prompt_ids):]
                if eos_id in new:
                    ids = ids[:len(prompt_ids) + new.index(eos_id)]
                    finish_reason = "stop"
            n_new = len(ids) - len(prompt_ids)
            reg.inc("generate_requests_total", mode=req.mode)
            reg.inc("generated_tokens_total", value=n_new)
            log.info('{"event": "generate", "mode": "%s", '
                     '"request_id": "%s", "prompt_tokens": %d, '
                     '"new_tokens": %d, "finish_reason": "%s"}', req.mode,
                     rid, len(prompt_ids), n_new, finish_reason)
            with trace.span("detokenize"):
                text = tokenizer.decode(ids)
            trace.finish()
            # TTFT: arrival through the prefill (queue wait included),
            # the whole request where no prefill span was recorded;
            # TPOT: the decode spans over the steps after the first
            pre = trace.find("prefill")
            ttft = (pre.t1 - trace.t0) if pre is not None else trace.duration
            reg.observe("ttft_seconds", ttft, mode=req.mode)
            if n_decoded > 1:
                decode_spans = trace.find_all("decode")
                decode_wall = sum(sp.duration for sp in decode_spans)
                if not decode_spans:
                    decode_wall = max(trace.duration - ttft, 0.0)
                reg.observe("tpot_seconds", decode_wall / (n_decoded - 1),
                            mode=req.mode)
            trace.labels.update(prompt_tokens=len(prompt_ids),
                                new_tokens=n_new,
                                finish_reason=finish_reason,
                                ttft_ms=round(ttft * 1e3, 3))
            rec.record(trace)
        except UpstreamError as e:
            # a dead, failing or misrouted shard: typed, never a local
            # answer
            log.warning("upstream failure: %s", e)
            reg.inc("upstream_failures_total", shard=e.shard)
            trace.labels.update(error="upstream_failure", shard=e.shard)
            rec.record(trace)
            return out({"error": "upstream_failure", "shard": e.shard,
                        "upstream": e.url, "detail": e.detail}, status=502)
        except graftfault.Unavailable as e:
            hdrs["Retry-After"] = str(max(1, int(round(e.retry_after))))
            if e.code == "deadline_exceeded":
                # accepted work that died on its budget: the deadline
                # SLO's source series
                reg.inc("deadline_misses_total")
            trace.labels.update(error=e.code)
            rec.record(trace)
            # the events that led here outlive the ring
            grafttime.blackbox(e.code, rid=rid)
            return out({"error": e.code, "detail": str(e)}, status=503)
        except TimeoutError as e:
            hdrs["Retry-After"] = "1"
            trace.labels.update(error="timeout")
            rec.record(trace)
            grafttime.blackbox("timeout", rid=rid)
            return out({"error": "timeout", "detail": str(e)}, status=503)
        except Exception as e:  # noqa: BLE001 - the id is still echoed
            log.exception("generate failed")
            trace.labels.update(error=f"{type(e).__name__}: {e}")
            rec.record(trace)
            if isinstance(e, GraftsanError):
                # a sanitizer trap on the serving path: journal the
                # events that led to it
                grafttime.blackbox(f"graftsan:{type(e).__name__}", rid=rid)
            return out({"detail": f"{type(e).__name__}: {e}"}, status=500)
        body = {"generated": text}
        if eos_id is not None:
            body["finish_reason"] = finish_reason
        return out(body)

    app.trend_reducer = trend_reducer
    # continuous mode's switcher (its plans, certified shapes, journal)
    app.plan_switcher = switcher
    # the static planner's row (AUTO_PLAN=1), None without it
    app.auto_plan = auto_plan_info
    # PP/TP/EP_DECODE: the decoder whose follow loop the other ranks run
    # and whose stop_followers rank 0 calls at shutdown
    app.mesh_runner = mesh_runner
    return app


def resolve_auto_plan(cfg: ServingConfig, config, world: int,
                      device) -> Tuple[ServingConfig, dict]:
    """``(cfg with the planner's chosen knobs, the /healthz auto_plan
    row)``: ``costmodel.plan_for_serving`` over ``world`` ranks, the
    traffic ``AUTO_PLAN_TRAFFIC``, ``MAX_BATCH`` the widest candidate and
    ``KV_POOL_BLOCKS`` the paged ones' pool, the budget the device's own
    memory. The JAX app's refusals and messages."""
    if not (cfg.shard_role == "coordinator" and cfg.dispatch == "local"):
        raise ValueError("AUTO_PLAN applies to the coordinator's local "
                         "decode path only")
    from ..utils import costmodel
    traffic = (costmodel.parse_traffic(cfg.auto_plan_traffic)
               if cfg.auto_plan_traffic else None)
    payload = costmodel.plan_for_serving(
        config, world, max_seq=cfg.max_seq, traffic=traffic,
        max_batch_cap=max(cfg.max_batch, 1),
        kv_pool_blocks=cfg.kv_pool_blocks, kv_block_size=cfg.kv_block_size,
        device=device)
    chosen = payload["chosen"]
    if chosen is None:
        raise ValueError(
            "AUTO_PLAN: no candidate serving config survived the "
            "planner's gates for this model/mesh/traffic")
    c = chosen["config"]
    cfg = dataclasses.replace(
        cfg, batch_mode=c["batch_mode"], max_batch=c["max_batch"],
        kv_pool_blocks=c["kv_pool_blocks"],
        kv_block_size=c["kv_block_size"],
        pp_decode=c["topology"] == "pp", tp_decode=c["topology"] == "tp",
        ep_decode=c["topology"] == "ep",
        boundaries=(tuple(c["boundaries"]) if c["topology"] == "pp"
                    else cfg.boundaries))
    info = {
        "chosen": chosen["label"],
        "mesh": chosen.get("mesh", {}),
        "cost_per_token": chosen["cost_per_token"],
        "comm_bytes_per_token": chosen["comm_bytes_per_token"],
        "hbm_bytes_per_device": chosen["hbm_bytes_per_device"],
        "shapes_exact": chosen["shapes_exact"],
        "candidates": len(payload["plan"]),
        "rejected": payload["rejected"],
    }
    log.info('{"event": "auto_plan", "chosen": "%s", '
             '"cost_per_token": %s, "candidates": %d, "rejected": %d}',
             chosen["label"], chosen["cost_per_token"],
             len(payload["plan"]), payload["rejected"])
    return cfg, info


def check_continuous_pool(kv_pool: KVBlockPool, engine: DecodeEngine
                          ) -> None:
    """The JAX app's checks of a pool injected into a continuous-planning
    app: the engine's cache width, and full-precision blocks (the plans
    are certified over the full-precision movers)."""
    if kv_pool.max_seq != engine._cache_seq:
        raise ValueError(
            f"injected kv_pool spans {kv_pool.max_seq} slots, engine "
            f"cache is {engine._cache_seq} — shared-pool replicas must "
            "agree on geometry")
    if kv_pool.block_dtype is not None:
        raise ValueError(
            f"injected kv_pool stores {kv_pool.block_regime} blocks — "
            "AUTO_PLAN_CONTINUOUS certifies the full-precision mover "
            "programs only")


def continuous_switcher(cfg: ServingConfig, config, engine: DecodeEngine,
                        kv_pool: KVBlockPool, reg, trend_reducer):
    """The plan set over ``engine`` and ``kv_pool`` and its switcher:
    weights fitted from ``AUTO_PLAN_JOURNAL`` (a malformed journal raises
    ``CalibrationError`` at start-up), plans certified against
    ``AUTO_PLAN_TRAFFIC``, the switcher sizing the batched plan from
    ``trend_reducer`` between waves."""
    # (a family that is not window-independent was refused with
    # KV_POOL_BLOCKS by check_batching)
    weights = graftwatch.CostWeights.apriori()
    if cfg.auto_plan_journal:
        with open(cfg.auto_plan_journal, encoding="utf-8") as f:
            weights = graftwatch.fit_cost_weights(json.load(f))
    plans, costs, certified = graftwatch.build_plan_set(
        engine, kv_pool, config, max_seq=cfg.max_seq,
        max_batch=cfg.max_batch, traffic=cfg.auto_plan_traffic or None,
        batch_wait_ms=cfg.batch_wait_ms)
    switcher = graftwatch.PlanSwitcher(
        plans, costs, certified, graftwatch.TelemetryWatcher(registry=reg),
        weights=weights, registry=reg)
    switcher.attach_trend(trend_reducer)
    log.info('{"event": "auto_plan_continuous", "plans": %s, '
             '"active": "%s", "weights": "%s"}', sorted(plans),
             switcher.health_view()["active"], weights.source)
    return switcher


def check_shared_pool(kv_pool: KVBlockPool, engine: DecodeEngine,
                      cfg: ServingConfig) -> None:
    """An injected pool against the engine that will page on it: the
    engine as the paged path takes it (``KVBlockPool.check_engine``), then
    the JAX app's width and block-regime checks, and the geometry, dtype
    and device the port's movers need. One pool serves a whole fleet, so
    every replica's engine must match it."""
    KVBlockPool.check_engine(engine)
    if kv_pool.max_seq != engine._cache_seq:
        raise ValueError(
            f"injected kv_pool spans {kv_pool.max_seq} slots, engine "
            f"cache is {engine._cache_seq} — shared-pool replicas must "
            "agree on geometry")
    c = engine.config
    heads = getattr(c, "n_kv_head", c.n_head)
    layers, _, _, pool_heads, _, head_dim = kv_pool.data.shape
    if (layers, pool_heads, head_dim) != (c.n_layer, heads, c.head_dim):
        raise ValueError(
            f"injected kv_pool holds {layers} layers x {pool_heads} kv "
            f"heads x {head_dim}, the engine {c.n_layer} x {heads} x "
            f"{c.head_dim} — shared-pool replicas must agree on geometry")
    want = regime_of(cfg.kv_pool_dtype) if cfg.kv_pool_dtype else None
    if kv_pool.block_dtype != want:
        raise ValueError(
            f"injected kv_pool stores {kv_pool.block_regime} blocks, "
            f"KV_POOL_DTYPE={cfg.kv_pool_dtype!r} — shared-pool replicas "
            "must agree on block storage")
    if (kv_pool.dtype, kv_pool.device) != (engine.dtype, engine.device):
        raise ValueError(
            f"injected kv_pool holds {kv_pool.dtype} blocks on "
            f"{kv_pool.device}, the engine's cache is {engine.dtype} on "
            f"{engine.device} — shared-pool replicas must agree on block "
            "storage")


def check_mesh(cfg: ServingConfig, config, stageable: bool,
               world: int) -> None:
    """The JAX app's TP_DECODE and PP_DECODE refusals, word for word,
    with the process group's ranks where it counts devices; then the
    port's own: a pipeline or an ep axis spans every rank (a rank
    outside it would neither serve nor follow)."""
    local = cfg.shard_role == "coordinator" and cfg.dispatch == "local"
    if cfg.tp_decode:
        if not local:
            raise ValueError("TP_DECODE applies to the coordinator's local "
                             "decode path only")
        if hasattr(config, "n_experts"):
            raise ValueError(
                "TP_DECODE shards dense-family projections; MoE models "
                "shard their expert axis via EP_DECODE instead")
        if (cfg.pp_decode or cfg.ep_decode or cfg.spec_decode > 0
                or cfg.prefix_cache > 0):
            raise ValueError(
                "TP_DECODE composes with MAX_BATCH and PREFILL_CHUNK "
                "only; PP_DECODE/EP_DECODE/SPEC_DECODE/PREFIX_CACHE own "
                "other decode programs")
        if cfg.inference_dtype == "int8":
            raise ValueError(
                "TP_DECODE runs fp32/bf16 (the int8 streaming matmuls "
                "are unpartitioned Pallas kernels GSPMD cannot split)")
        kv_heads = getattr(config, "n_kv_head", config.n_head)
        if config.n_head % world or kv_heads % world:
            raise ValueError(
                f"TP_DECODE: this pod's {world} devices must divide "
                f"n_head={config.n_head} and n_kv_head={kv_heads} "
                "(attention shards over whole heads)")
    if cfg.pp_decode:
        if not local:
            raise ValueError("PP_DECODE applies to the coordinator's local "
                             "decode path only")
        if not stageable:
            raise ValueError(
                f"PP_DECODE requires a stage-partitionable family; "
                f"{type(config).__name__} models decode unstaged")
        if cfg.spec_decode > 0 or cfg.prefix_cache > 0 or cfg.prefill_chunk > 0:
            raise ValueError(
                "PP_DECODE composes with MAX_BATCH>1 and "
                "INFERENCE_DTYPE=int8; SPEC_DECODE, PREFIX_CACHE, and "
                "PREFILL_CHUNK own the single-device engine's programs")
        n_stages_cfg = len(cfg.boundaries) + 1
        if world < n_stages_cfg:
            raise ValueError(
                f"PP_DECODE needs >= {n_stages_cfg} devices (one per "
                f"stage); this pod sees {world}")
        if world > n_stages_cfg:
            raise ValueError(
                f"PP_DECODE runs one stage a rank: BOUNDARIES give "
                f"{n_stages_cfg} stages, the process group has {world} "
                "ranks")
    if cfg.ep_decode and world > config.n_experts:
        raise ValueError(
            f"EP_DECODE splits n_experts={config.n_experts} over every "
            f"rank; the process group has {world} ranks")


def check_batching(cfg: ServingConfig, config) -> None:
    """The JAX app's startup refusals that concern the dtype, batching,
    chunked-prefill, prefix-cache, paged-pool and speculation knobs: each
    applies to the coordinator's local decode path only."""
    local = cfg.shard_role == "coordinator" and cfg.dispatch == "local"
    if cfg.inference_dtype != "float32" and not local:
        raise ValueError(
            f"INFERENCE_DTYPE={cfg.inference_dtype} applies to the "
            "coordinator's local decode path only; shard/remote roles "
            "serve the fp32 parity endpoints")
    if cfg.spec_decode > 0 and not local:
        raise ValueError(
            f"SPEC_DECODE={cfg.spec_decode} applies to the coordinator's "
            "local decode path only")
    if cfg.prefix_cache > 0 and not local:
        raise ValueError(
            f"PREFIX_CACHE={cfg.prefix_cache} applies to the "
            "coordinator's local decode path only")
    if cfg.ep_decode:
        if not local:
            raise ValueError("EP_DECODE applies to the coordinator's local "
                             "decode path only")
        if not hasattr(config, "n_experts"):
            raise ValueError(
                f"EP_DECODE shards MoE expert weights; "
                f"{type(config).__name__} models have no expert axis")
        if cfg.pp_decode or cfg.spec_decode > 0 or cfg.prefix_cache > 0:
            raise ValueError(
                "EP_DECODE composes with MAX_BATCH only; PP_DECODE, "
                "SPEC_DECODE, and PREFIX_CACHE own other decode programs "
                "(and MoE prefills monolithically — no PREFILL_CHUNK)")
        ep_size = min(distributed.world_size(), config.n_experts)
        if config.n_experts % ep_size:
            raise ValueError(
                f"EP_DECODE: n_experts={config.n_experts} not divisible "
                f"by the {ep_size}-device ep axis")
    if cfg.kv_pool_blocks > 0:
        if not local:
            raise ValueError("KV_POOL_BLOCKS applies to the coordinator's "
                             "local decode path only")
        if cfg.pp_decode or cfg.ep_decode or cfg.tp_decode:
            raise ValueError(
                "KV_POOL_BLOCKS drives the single-device engine's paged "
                "storage; PP/EP/TP_DECODE keep contiguous caches")
        if cfg.prefill_chunk > 0:
            raise ValueError(
                "KV_POOL_BLOCKS prefills monolithically (one block "
                "scatter per admission); PREFILL_CHUNK owns another "
                "prefill program structure")
        if cfg.spec_decode > 0 and cfg.batch_mode != "iter":
            raise ValueError(
                "KV_POOL_BLOCKS composes with SPEC_DECODE through "
                "BATCH_MODE=iter (paged draft-verify segments); the "
                "solo paged runner decodes one token per forward")
        if cfg.max_batch > 1 and cfg.batch_mode != "iter":
            raise ValueError(
                "KV_POOL_BLOCKS batches through BATCH_MODE=iter "
                "(watermark admission + preemption live at segment "
                "boundaries); the admission batcher keeps contiguous "
                "round caches")
        if not is_window_independent(config):
            raise ValueError(
                "KV_POOL_BLOCKS requires window-independent routing "
                f"(dense families); {type(config).__name__} serves "
                "unpaged")
    if cfg.batch_mode == "iter":
        if cfg.max_batch <= 1:
            raise ValueError("BATCH_MODE=iter requires MAX_BATCH > 1 "
                             "(iteration-level scheduling is a batching "
                             "policy)")
        if not local:
            raise ValueError("BATCH_MODE=iter applies to the coordinator's "
                             "local decode path only")
        if (cfg.prefill_chunk > 0 or cfg.pp_decode
                or cfg.ep_decode or cfg.tp_decode):
            raise ValueError(
                "BATCH_MODE=iter drives the single-device engine's "
                "segment loop; PREFILL_CHUNK/PP/EP/TP_DECODE use "
                "BATCH_MODE=admission")
        if not is_window_independent(config):
            raise ValueError(
                "BATCH_MODE=iter requires window-independent routing "
                f"(dense families); {type(config).__name__} batches via "
                "BATCH_MODE=admission")
    # the JAX app accepts these on a shard or a remote coordinator and
    # ignores them; refused here, as a knob ignored in silence would be
    for knob, value, on in (("MAX_BATCH", cfg.max_batch, cfg.max_batch > 1),
                            ("PREFILL_CHUNK", cfg.prefill_chunk,
                             cfg.prefill_chunk > 0)):
        if on and not local:
            raise ValueError(f"{knob}={value} applies to the "
                             "coordinator's local decode path only")
