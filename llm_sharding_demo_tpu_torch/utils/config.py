"""Typed serving configuration with env-var overrides.

The same env names as the JAX package's ``utils/config.py``, parsed into
one validated dataclass. The port honours ``MODEL_ID``, ``SHARD_ROLE``,
``SPLIT_AT``/``BOUNDARIES``, ``SHARD_PORT``, ``MAX_SEQ``,
``INFERENCE_DTYPE``, ``DISPATCH`` (``local``, or ``remote``: the
coordinator relays each token through the shards named by
``SHARD_A_SERVICE`` and ``SHARD_B_SERVICE``), the batching knobs
``MAX_BATCH``, ``BATCH_MODE`` and ``BATCH_WAIT_MS``, ``PREFILL_CHUNK``,
the paged pool's ``KV_POOL_BLOCKS``, ``KV_BLOCK_SIZE`` and
``KV_POOL_DTYPE``, and the prefix store's ``PREFIX_CACHE`` and
``PREFIX_CHUNK`` with the host tier's ``KV_HOST_BLOCKS``, and
``SPEC_DECODE`` (speculative decoding's draft depth),
``CHECKPOINT_DIR`` (a checkpoint written by ``utils.checkpoint``: the
model, its config and its tokenizer assets), and ``FLEET_ROLE`` (a fleet
replica's role: ``prefill`` serves ``/prefill``, ``decode`` serves
``/generate``; both need the pool-backed prefix store), and continuous
planning's ``AUTO_PLAN_CONTINUOUS`` (switch between the solo paged plan
and the pooled iteration batcher between request waves,
``utils.graftwatch``), ``AUTO_PLAN_TRAFFIC`` (the traffic classes its
plans are certified against, and the static planner's traffic mix) and
``AUTO_PLAN_JOURNAL`` (a bench journal whose rows calibrate its byte
weights), the static planner's ``AUTO_PLAN`` (the decode topology,
batching and KV knobs resolved at startup by ``utils.costmodel``'s
planner over the port's own engines and the process group's ranks),
and multi-device decode's ``PP_DECODE`` (one pipeline stage a rank,
``parallel.ppdecode``), ``TP_DECODE`` (dense families, tensor-parallel)
and ``EP_DECODE`` (MoE, expert-parallel), with the JAX package's guards;
a multi-rank server is one process a rank, joined by
``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``
(``parallel.distributed``). A knob of the JAX package that the port
does not serve would be listed in ``REFUSED_KNOBS`` and refuse at
startup when set to anything but its default, naming the ROADMAP item
that ports it (a knob ignored in silence would let a deployment believe
it runs a configuration it does not); every knob is served now, and the
table is empty.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional, Tuple

VALID_ROLES = ("coordinator", "a", "b")
VALID_DTYPES = ("float32", "bfloat16", "int8")


# knob -> (the ROADMAP item that ports it, "is this value the default?")
REFUSED_KNOBS: Dict[str, Tuple[str, Callable[[str], bool]]] = {}


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Everything the serving process needs, resolved once at startup."""

    model_id: str = "sshleifer/tiny-gpt2"
    # a utils.checkpoint directory: the model and its config come from it
    checkpoint_dir: Optional[str] = None
    shard_role: str = "coordinator"
    boundaries: tuple = (1,)
    # the shards a DISPATCH=remote coordinator posts to: a host (the port
    # is SHARD_PORT) or "host:port"
    shard_a_service: str = "llm-shard-a"
    shard_b_service: str = "llm-shard-b"
    shard_port: int = 5000
    max_seq: int = 512
    # "float32" (greedy-parity mode), "bfloat16", or "int8" (weight-only
    # int8, bf16 activations; served by the staged DecodeEngine)
    inference_dtype: str = "float32"
    # "local": this process decodes; "remote": the coordinator relays
    # /forward -> /forward_b through the shards, once per token
    dispatch: str = "local"
    # concurrent /generate requests share batched decodes when > 1
    max_batch: int = 1
    # "admission" (runtime.batcher: gather, run a round to its end) or
    # "iter" (runtime.iterbatch: joins and retirements between segments)
    batch_mode: str = "admission"
    # how long a round waits to gather peers
    batch_wait_ms: float = 5.0
    # 0: monolithic prefill; > 0: prompts prefill in chunks of this width
    prefill_chunk: int = 0
    # > 0: the paged KV pool's block count (runtime.kv_pool); a block is
    # n_layer * 2 * n_kv_head * KV_BLOCK_SIZE * head_dim elements
    kv_pool_blocks: int = 0
    kv_block_size: int = 16
    # "": blocks in the engine dtype; "int8" or "fp8": quantized blocks
    # (ops.kv_quant). Requires KV_POOL_BLOCKS > 0.
    kv_pool_dtype: str = ""
    # > 0: the prefix store's resident-entry capacity
    # (runtime.prefix_cache); 0: off
    prefix_cache: int = 0
    # > 0: the prefix store's chunk width (default: PREFILL_CHUNK, else
    # 64). Requires PREFIX_CACHE > 0.
    prefix_chunk: int = 0
    # > 0: the host spill tier's block budget below the pool
    # (runtime.kv_tier). Requires KV_POOL_BLOCKS > 0.
    kv_host_blocks: int = 0
    # > 0: prompt-lookup speculative decoding (runtime.spec_decode) with
    # this draft depth; 0: off
    spec_decode: int = 0
    # the fleet role (llm_sharding_demo_tpu_torch/fleet): "" serves
    # standalone; "prefill" serves /prefill (fills shared pool blocks
    # through the content-keyed prefix registry); "decode" serves
    # /generate, adopting registered blocks zero-copy. Both need the
    # pool-backed prefix store (KV_POOL_BLOCKS + PREFIX_CACHE): the
    # registry is the handoff medium.
    fleet_role: str = ""
    # the static planner (utils.costmodel.plan_for_serving): resolve the
    # decode topology, batching and KV knobs at startup from the cost
    # model over the loaded config and the process group's ranks; the
    # chosen row overrides BATCH_MODE / MAX_BATCH / PP|TP|EP_DECODE /
    # BOUNDARIES / KV_POOL_BLOCKS / KV_BLOCK_SIZE (MAX_BATCH caps the
    # candidates' width, KV_POOL_BLOCKS sizes the paged ones), and
    # /healthz "auto_plan" reports it. Coordinator + local dispatch only
    auto_plan: bool = False
    # the traffic classes continuous planning certifies its plans'
    # forward shapes against, and the static planner scores against, as
    # 'prompt/new[xcount],...' (e.g. "16/64x8,256/32"); empty: one
    # 16-token prompt decoding 32
    auto_plan_traffic: str = ""
    # continuous planning (utils/graftwatch): the solo paged runner and
    # the pooled iteration batcher, built once over one engine and one
    # pool, and a switch between them every wave of admissions from the
    # watcher's traffic estimate. Requires KV_POOL_BLOCKS > 0, MAX_BATCH
    # > 1 and BATCH_MODE=iter; excludes SPEC_DECODE, PREFIX_CACHE,
    # PREFILL_CHUNK and KV_POOL_DTYPE. GET /debug/plan serves its state,
    # /healthz "auto_plan" the live plan.
    auto_plan_continuous: bool = False
    # a bench journal whose graftscope_attribution and
    # ici_byte_weight_calibration rows calibrate the planner's byte
    # weights at start-up (graftwatch.fit_cost_weights); empty: a-priori
    auto_plan_journal: str = ""
    # pipelined decode (parallel.ppdecode): one stage a rank of the
    # process group (len(BOUNDARIES) + 1 ranks), the activation handed
    # from rank to rank; composes with MAX_BATCH > 1 and int8 stages
    pp_decode: bool = False
    # tensor-parallel decode (dense families): Megatron slices of every
    # block and a head-sharded KV cache over all ranks, the row-parallel
    # products summed over them; the world must divide n_head and
    # n_kv_head; fp32/bf16
    tp_decode: bool = False
    # expert-parallel decode (MoE): E / world experts a rank, the router
    # whole, the experts' outputs summed over the ranks
    ep_decode: bool = False

    def __post_init__(self):
        if self.shard_role not in VALID_ROLES:
            raise ValueError(
                f"SHARD_ROLE={self.shard_role!r} not in {VALID_ROLES}")
        if self.dispatch not in ("local", "remote"):
            raise ValueError(f"DISPATCH={self.dispatch!r} not local|remote")
        if not 1 <= self.shard_port <= 65535:
            raise ValueError(f"SHARD_PORT={self.shard_port} out of range")
        if not self.boundaries or list(self.boundaries) != sorted(
                set(self.boundaries)):
            raise ValueError(
                f"boundaries {self.boundaries!r} must be non-empty, "
                "strictly increasing (single source of truth for ALL roles)")
        if self.max_seq < 2:
            raise ValueError(f"max_seq={self.max_seq} too small")
        if self.max_batch < 1:
            raise ValueError(f"MAX_BATCH={self.max_batch} must be >= 1")
        if self.batch_wait_ms < 0:
            raise ValueError(
                f"BATCH_WAIT_MS={self.batch_wait_ms} must be >= 0")
        if self.batch_mode not in ("admission", "iter"):
            raise ValueError(
                f"BATCH_MODE={self.batch_mode!r} not admission|iter")
        if self.inference_dtype not in VALID_DTYPES:
            raise ValueError(
                f"INFERENCE_DTYPE={self.inference_dtype!r} not "
                "float32|bfloat16|int8")
        if self.spec_decode < 0:
            raise ValueError(
                f"SPEC_DECODE={self.spec_decode} must be >= 0 "
                "(0 disables, >0 is the speculation draft depth)")
        if self.prefill_chunk < 0:
            raise ValueError(
                f"PREFILL_CHUNK={self.prefill_chunk} must be >= 0 "
                "(0 disables, >0 is the chunk width in tokens)")
        if self.prefix_cache < 0:
            raise ValueError(
                f"PREFIX_CACHE={self.prefix_cache} must be >= 0 "
                "(0 disables, >0 is the resident-entry capacity)")
        if self.kv_pool_blocks < 0:
            raise ValueError(
                f"KV_POOL_BLOCKS={self.kv_pool_blocks} must be >= 0 "
                "(0 disables paging, >0 is the pool's block count)")
        if self.kv_block_size < 1:
            raise ValueError(
                f"KV_BLOCK_SIZE={self.kv_block_size} must be >= 1")
        if self.kv_pool_dtype:
            if self.kv_pool_blocks == 0:
                raise ValueError(
                    "KV_POOL_DTYPE selects the paged pool's block "
                    "storage; it needs KV_POOL_BLOCKS > 0 (a silently "
                    "ignored knob would misreport the serving "
                    "composition)")
            from .graftnum import GraftnumError, regime_of
            try:
                regime = regime_of(self.kv_pool_dtype)
            except GraftnumError as e:
                raise ValueError(
                    f"KV_POOL_DTYPE={self.kv_pool_dtype!r}: {e}") from e
            if regime not in ("int8", "fp8"):
                raise ValueError(
                    f"KV_POOL_DTYPE={self.kv_pool_dtype!r} names the "
                    f"full-precision regime {regime!r} — the pool "
                    "already stores full-precision blocks by default; "
                    "quantized storage takes 'int8' or 'fp8'")
        if self.kv_host_blocks < 0:
            raise ValueError(
                f"KV_HOST_BLOCKS={self.kv_host_blocks} must be >= 0 "
                "(0 disables the host tier, >0 is its block budget)")
        if self.kv_host_blocks > 0 and self.kv_pool_blocks == 0:
            raise ValueError(
                "KV_HOST_BLOCKS sizes the host spill tier below the "
                "paged pool; it needs KV_POOL_BLOCKS > 0 (a silently "
                "ignored knob would misreport the serving composition)")
        if self.prefix_chunk < 0:
            raise ValueError(
                f"PREFIX_CHUNK={self.prefix_chunk} must be >= 0 "
                "(0: default alignment, >0: the store's chunk width)")
        if self.prefix_chunk > 0 and self.prefix_cache == 0:
            raise ValueError(
                "PREFIX_CHUNK tunes the prefix store's alignment; it "
                "needs PREFIX_CACHE > 0 (a silently ignored knob would "
                "misreport the serving composition)")
        if self.fleet_role not in ("", "prefill", "decode"):
            raise ValueError(
                f"FLEET_ROLE={self.fleet_role!r} not ''|prefill|decode")
        if self.fleet_role:
            if not (self.shard_role == "coordinator"
                    and self.dispatch == "local"):
                raise ValueError(
                    "FLEET_ROLE applies to coordinator + local dispatch "
                    "replicas (the fleet router fronts whole replicas, "
                    "not stage shards)")
            if self.kv_pool_blocks == 0 or self.prefix_cache == 0:
                raise ValueError(
                    f"FLEET_ROLE={self.fleet_role!r} requires the "
                    "pool-backed prefix store (KV_POOL_BLOCKS > 0 and "
                    "PREFIX_CACHE > 0): the content-keyed registry is "
                    "the prefill->decode block-handoff medium")
        if self.auto_plan_continuous:
            if (self.kv_pool_blocks <= 0 or self.max_batch <= 1
                    or self.batch_mode != "iter"):
                raise ValueError(
                    "AUTO_PLAN_CONTINUOUS switches between the certified "
                    "pooled plans (solo paged admission <-> iteration "
                    "scheduling); it requires KV_POOL_BLOCKS > 0, "
                    "MAX_BATCH > 1 and BATCH_MODE=iter")
            if (self.spec_decode > 0 or self.prefix_cache > 0
                    or self.prefill_chunk > 0 or self.pp_decode
                    or self.tp_decode or self.ep_decode
                    or self.kv_pool_dtype):
                raise ValueError(
                    "AUTO_PLAN_CONTINUOUS certifies exactly the "
                    "solo-paged and pooled-iter program sets; "
                    "SPEC_DECODE/PREFIX_CACHE/PREFILL_CHUNK/PP|TP|"
                    "EP_DECODE/KV_POOL_DTYPE own other compile spaces "
                    "and would let a switch reach uncertified programs")
        if self.auto_plan_journal and not self.auto_plan_continuous:
            raise ValueError(
                "AUTO_PLAN_JOURNAL calibrates the continuous planner's "
                "byte weights; it needs AUTO_PLAN_CONTINUOUS=1 (a "
                "silently ignored knob would misreport the serving "
                "composition)")
        if self.kv_pool_blocks > 0 and self.max_seq % self.kv_block_size:
            raise ValueError(
                f"MAX_SEQ={self.max_seq} must be a multiple of "
                f"KV_BLOCK_SIZE={self.kv_block_size}: the paged decode "
                "path gathers whole-block rows at exactly the compiled "
                "programs' cache width")

    @property
    def split_at(self) -> int:
        """Two-stage compat view (the reference's SPLIT_AT)."""
        return self.boundaries[0]

    def _service_url(self, service: str) -> str:
        # a service that carries its port ("127.0.0.1:5001") wins over
        # SHARD_PORT
        if ":" not in service:
            service = f"{service}:{self.shard_port}"
        return f"http://{service}"

    @property
    def shard_a_url(self) -> str:
        return self._service_url(self.shard_a_service)

    @property
    def shard_b_url(self) -> str:
        return self._service_url(self.shard_b_service)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError as e:
        raise ValueError(f"{name}={raw!r} is not an integer") from e


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError as e:
        raise ValueError(f"{name}={raw!r} is not a number") from e


def _env_bool(name: str) -> bool:
    """A boolean knob: unknown spellings raise at startup rather than
    turning the knob off in silence."""
    raw = os.environ.get(name, "").strip().lower()
    if raw in ("", "0", "false", "no", "off"):
        return False
    if raw in ("1", "true", "yes", "on"):
        return True
    raise ValueError(f"{name}={os.environ[name]!r} is not a boolean "
                     "(use 1/0, true/false, yes/no, on/off)")


def refuse_unported_knobs(environ=None) -> None:
    """Raise on any env knob of the JAX package this slice does not serve
    (set to a value other than its default)."""
    env = os.environ if environ is None else environ
    bad = [(name, env[name], item)
           for name, (item, is_default) in REFUSED_KNOBS.items()
           if name in env and not is_default(env[name])]
    if bad:
        lines = "; ".join(f"{n}={v!r} waits for {item}"
                          for n, v, item in bad)
        raise ValueError(f"unsupported serving knobs in the PyTorch port: "
                         f"{lines}")


def from_env() -> ServingConfig:
    """Read the env contract into a config, refusing unported knobs.

    ``BOUNDARIES`` (comma-separated block indices, e.g. ``"3,6,9"``)
    generalizes ``SPLIT_AT`` to N stages; if unset, ``SPLIT_AT`` (default
    1) defines the single two-stage split used by every role.
    """
    refuse_unported_knobs()
    raw_bounds = os.environ.get("BOUNDARIES", "").strip()
    if raw_bounds:
        try:
            boundaries = tuple(int(x) for x in raw_bounds.split(","))
        except ValueError as e:
            raise ValueError(f"BOUNDARIES={raw_bounds!r} must be "
                             "comma-separated integers") from e
    else:
        boundaries = (_env_int("SPLIT_AT", 1),)
    return ServingConfig(
        model_id=os.environ.get("MODEL_ID", "sshleifer/tiny-gpt2"),
        checkpoint_dir=os.environ.get("CHECKPOINT_DIR") or None,
        shard_role=os.environ.get("SHARD_ROLE", "coordinator"),
        boundaries=boundaries,
        shard_a_service=os.environ.get("SHARD_A_SERVICE", "llm-shard-a"),
        shard_b_service=os.environ.get("SHARD_B_SERVICE", "llm-shard-b"),
        shard_port=_env_int("SHARD_PORT", 5000),
        max_seq=_env_int("MAX_SEQ", 512),
        inference_dtype=os.environ.get("INFERENCE_DTYPE", "float32"),
        dispatch=os.environ.get("DISPATCH", "local") or "local",
        max_batch=_env_int("MAX_BATCH", 1),
        batch_mode=os.environ.get("BATCH_MODE", "admission") or "admission",
        batch_wait_ms=_env_float("BATCH_WAIT_MS", 5.0),
        prefill_chunk=_env_int("PREFILL_CHUNK", 0),
        kv_pool_blocks=_env_int("KV_POOL_BLOCKS", 0),
        kv_block_size=_env_int("KV_BLOCK_SIZE", 16),
        kv_pool_dtype=os.environ.get("KV_POOL_DTYPE", ""),
        prefix_cache=_env_int("PREFIX_CACHE", 0),
        prefix_chunk=_env_int("PREFIX_CHUNK", 0),
        kv_host_blocks=_env_int("KV_HOST_BLOCKS", 0),
        spec_decode=_env_int("SPEC_DECODE", 0),
        fleet_role=os.environ.get("FLEET_ROLE", ""),
        auto_plan=_env_bool("AUTO_PLAN"),
        auto_plan_traffic=os.environ.get("AUTO_PLAN_TRAFFIC", ""),
        auto_plan_continuous=_env_bool("AUTO_PLAN_CONTINUOUS"),
        auto_plan_journal=os.environ.get("AUTO_PLAN_JOURNAL", ""),
        pp_decode=_env_bool("PP_DECODE"),
        tp_decode=_env_bool("TP_DECODE"),
        ep_decode=_env_bool("EP_DECODE"),
    )
