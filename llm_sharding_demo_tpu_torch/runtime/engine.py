"""Decode engine: prefill, then a cached single-token loop, sampling on
the device.

Counterpart of ``llm_sharding_demo_tpu/runtime/engine.py``. The JAX
engine compiles the decode loop into windowed ``lax.scan`` segments keyed
by static shapes; PyTorch runs eagerly, so this engine reproduces those
segments' outputs, not their keying: one Python loop of cached forwards
whose attention reads only the written prefix of the cache. Nothing
syncs with the host inside the loop except at the EOS checks (same
doubling schedule as the JAX engine). The cache is written in place and
the cache length is a Python int.

Token selection mirrors the reference sampler: greedy argmax, or
temperature + top-k (+ optional top-p) drawn from a seeded
``torch.Generator`` (streams cannot match JAX's PRNG; the distribution,
``sampler_pmf``, does). A batch draws either once jointly from one
generator or once per row from a list of per-row generators, the form
the batchers (``runtime.batcher``, ``runtime.iterbatch``) use so that a
row's stream is its solo stream.

``prefill_chunk=C`` prefills a prompt as C-wide cached forwards into
one cache (the JAX engine's compile-count bound; here it caps the rows a
prefill forward carries). The alignment pad rides the ragged-batch
machinery, so tokens are those of the monolithic prefill.

``mesh=`` (a ``DeviceMesh``, ``parallel.spmd.make_mesh``) decodes over
several ranks, each a process bound to one device: tensor parallelism
for the dense families over a ``tp`` axis, expert parallelism for MoE
over an ``ep`` axis. Every rank runs the same forwards on its slices;
rank 0 leads (its ``generate`` announces each request to the followers,
which serve it from ``follow``), picks each token and broadcasts it.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models import (family_module, gpt2, is_stage_partitionable,
                      is_window_independent, llama)
from ..models.gpt2 import Params, map_params, unstack_params
from ..ops.attention import create_fused_cache
from ..ops import decode_layer as DL
from ..ops.decode_attention import BLOCK_S, KERNEL_HEAD_DIM, eligible
from ..ops.flash_attention import flash_eligible, flash_profitable
from ..ops.quant import quantize_params
from ..parallel import distributed
from ..utils import graftmem, graftscope, graftshard, tracing
from ..utils.device import DeviceLike, regime_of, resolve_device, torch_dtype
from ..utils.metrics import REGISTRY, kv_block_gauges

# Reference sampler constants.
REF_TEMPERATURE = 0.6
REF_TOP_K = 40

# EOS-armed decodes check for a stop after 32, 64, 128, 256, 256, ...
# steps (the JAX engine's doubling schedule): each check is a host sync.
EOS_SEGMENT = 32
_EOS_CAP_MAX = 256

DECODE_KERNEL_MODES = ("auto", "xla", "layer", "mega")

# Placement contract (utils/graftshard): a mesh engine's weights, split
# over its axis (the replicated leaves beside them satisfy it too), and a
# tp engine's KV cache, split over heads
PLACEMENT_CONTRACT = {
    "mesh_axes": ("tp", "ep"),
    "holding:tp_params": "tp",
    "holding:ep_params": "ep",
    "holding:tp_cache": "tp",
}


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Token-selection policy for one generate call. ``top_p`` restricts
    the top-k survivors to the smallest prefix whose cumulative
    probability reaches it; 1.0 disables it."""

    mode: str = "greedy"  # "greedy" | "sample"
    temperature: float = REF_TEMPERATURE
    top_k: int = REF_TOP_K
    top_p: float = 1.0
    # routing metadata for the batchers: a policy with ``spec`` batches
    # only with itself and decodes through the speculative engine
    # (``runtime.spec_decode``), which normalizes the flag away; it never
    # changes the sampler's math
    spec: bool = False

    def __post_init__(self):
        if self.mode not in ("greedy", "sample"):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.mode == "sample":
            if self.temperature <= 0:
                raise ValueError("temperature must be > 0 for sampling")
            if self.top_k < 1:
                raise ValueError("top_k must be >= 1")
            if not 0.0 < self.top_p <= 1.0:
                raise ValueError("top_p must be in (0, 1]")


def sampler_pmf(logits: torch.Tensor, sampling: SamplingConfig,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., vocab] logits -> ``(probs, idx)`` each ``[..., k]``: the
    sampler's distribution over the top-k survivors, descending."""
    scaled = logits.float() / sampling.temperature
    top_vals, top_idx = torch.topk(scaled, sampling.top_k, dim=-1)
    probs = torch.softmax(top_vals, dim=-1)
    if sampling.top_p < 1.0:
        cum_before = torch.cumsum(probs, dim=-1) - probs
        probs = torch.where(cum_before < sampling.top_p, probs,
                            torch.zeros_like(probs))
        probs = probs / probs.sum(dim=-1, keepdim=True)
    return probs, top_idx


# one generator (a joint draw over the batch) or one per row (None: the
# row draws nothing)
Generators = Union[None, torch.Generator,
                   Sequence[Optional[torch.Generator]]]


def select_token(logits: torch.Tensor, sampling: SamplingConfig,
                 generator: Generators) -> torch.Tensor:
    """[B, vocab] last-position logits -> [B] int64 next tokens, on the
    logits' device (no host sync).

    ``generator`` is one ``torch.Generator`` (one joint draw over the
    batch) or a list of B, one per row: row i then draws alone, one
    ``[1, k]`` multinomial on its own generator, so its t-th draw depends
    only on that generator and t, never on the other rows, the batch
    width or steps past its own budget. A row whose entry is None (a
    batcher's dummy or ghost row) draws nothing and takes its top
    survivor. At B = 1 the two forms draw the same bits."""
    if sampling.mode == "greedy":
        return torch.argmax(logits, dim=-1)
    probs, top_idx = sampler_pmf(logits, sampling)
    if isinstance(generator, (list, tuple)):
        if len(generator) != probs.shape[0]:
            raise ValueError(f"{len(generator)} generators for "
                             f"{probs.shape[0]} rows")
        top = torch.zeros((1, 1), dtype=torch.int64, device=probs.device)
        choice = torch.cat([
            top if g is None else torch.multinomial(probs[i:i + 1], 1,
                                                    generator=g)
            for i, g in enumerate(generator)])
    else:
        choice = torch.multinomial(probs, 1, generator=generator)
    return top_idx.gather(-1, choice)[:, 0]


def left_pad(prompts, pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged prompt list -> (ids [B, S_max] left-padded, pad [B])."""
    rows = [np.asarray(p, dtype=np.int64).reshape(-1) for p in prompts]
    if any(len(r) < 1 for r in rows):
        raise ValueError("every prompt must be non-empty")
    s_max = max(len(r) for r in rows)
    ids = np.full((len(rows), s_max), pad_id, dtype=np.int64)
    pad = np.zeros((len(rows),), dtype=np.int32)
    for i, r in enumerate(rows):
        ids[i, s_max - len(r):] = r
        pad[i] = s_max - len(r)
    return ids, pad


def prepare_generate(prompt_ids, max_new_tokens: int, max_seq: int,
                     sampling: SamplingConfig, generator: Generators,
                     allow_ragged: bool = True,
                     pad: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, int, int, np.ndarray]:
    """Shared validation for every ``generate`` front end. Returns
    ``(ids [B,S], batch, prompt_len, pad [B])``; ragged input is
    left-padded. Refuses a prompt + budget past ``max_seq`` (the cache
    would overflow) and sample mode without a generator."""
    if pad is not None:
        ids = np.asarray(prompt_ids, dtype=np.int64)
        if ids.ndim != 2 or len(pad) != ids.shape[0]:
            raise ValueError("explicit pad requires [B, S] ids with one "
                             "pad entry per row")
        pad = np.asarray(pad, dtype=np.int32)
    elif (isinstance(prompt_ids, (list, tuple)) and prompt_ids
            and not np.isscalar(prompt_ids[0])
            and len({len(np.asarray(p).reshape(-1)) for p in prompt_ids}) > 1):
        if not allow_ragged:
            raise NotImplementedError(
                "this generate front end requires equal-length prompts; "
                "ragged batches go through runtime.engine.DecodeEngine")
        ids, pad = left_pad(prompt_ids)
    else:
        ids = np.asarray(prompt_ids, dtype=np.int64)
        if ids.ndim == 1:
            ids = ids[None, :]
        pad = np.zeros((ids.shape[0],), dtype=np.int32)
    batch, prompt_len = ids.shape
    if prompt_len < 1:
        raise ValueError("prompt must be non-empty")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    total = prompt_len + max_new_tokens
    if total > max_seq:
        raise ValueError(
            f"prompt_len={prompt_len} + max_new_tokens={max_new_tokens} "
            f"= {total} exceeds max_seq={max_seq}")
    if sampling.mode == "sample" and generator is None:
        raise ValueError("sample mode requires an explicit torch.Generator")
    if isinstance(generator, (list, tuple)) and len(generator) != batch:
        raise ValueError(f"{len(generator)} per-row generators for a "
                         f"batch of {batch}")
    return ids, batch, prompt_len, pad


@dataclasses.dataclass
class GenerateResult:
    """Tokens plus timing. ``decode_seconds`` times ``decode_steps`` =
    ``new_tokens - 1`` cached single-token forwards (the first new token
    comes from the prefill logits)."""

    tokens: np.ndarray           # [B, prompt_len + new_tokens]
    prompt_len: int
    prefill_seconds: float
    decode_seconds: float
    new_tokens: int
    decode_steps: int
    pad: Optional[np.ndarray] = None  # [B] left-pad prefix lengths (ragged)
    # speculative decoding only (``runtime.spec_decode``): verify forwards
    verify_steps: Optional[int] = None

    def row_tokens(self, i: int) -> np.ndarray:
        """Row i's tokens with its left-pad prefix stripped."""
        start = int(self.pad[i]) if self.pad is not None else 0
        return self.tokens[i, start:]

    @property
    def per_token_latency(self) -> float:
        if self.decode_steps == 0:
            return float("nan")
        return self.decode_seconds / self.decode_steps


def eos_chunks(steps: int) -> List[int]:
    """Split ``steps`` decode forwards into EOS-check chunks of 32, 64,
    128, 256, 256, ... steps."""
    out, cap = [], EOS_SEGMENT
    while steps > 0:
        take = min(cap, steps)
        out.append(take)
        steps -= take
        cap = min(cap * 2, _EOS_CAP_MAX)
    return out


def _rows_tokens_key(ids, *args, **kwargs) -> tuple:
    """graftscope key of a prefill: (rows, tokens)."""
    return tuple(ids.shape[:2])


def _seg_key(token, cache, pad, n, *args, **kwargs) -> tuple:
    """graftscope key of a decode segment: (rows, steps)."""
    return (token.shape[0], n)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_decode_kernel(decode_kernel: str) -> None:
    """Refuse the JAX package's kernel modes that have no GPU meaning
    (interpret mode) and unknown names."""
    if decode_kernel.endswith("interpret"):
        raise ValueError(
            f"decode_kernel={decode_kernel!r}: interpret mode runs Pallas "
            "kernels on a TPU-less host; the port's CUDA kernels have their "
            "plain PyTorch versions instead, taken for CPU tensors "
            "(use 'layer' or 'mega' with device='cpu')")
    if decode_kernel not in DECODE_KERNEL_MODES:
        raise ValueError(f"decode_kernel={decode_kernel!r} not one of "
                         f"{DECODE_KERNEL_MODES}")


def resolve_decode_kernel(decode_kernel: str, config, max_seq: int,
                          regime: str, on_cuda: bool,
                          ) -> Tuple[Optional[str], int]:
    """``(mode, cache_seq)``: the kernel mode an engine runs ("mega",
    "layer", or None for the plain path) and its cache length.

    "auto" engages kernels only on CUDA and only for bf16/int8 (fp32 is
    the kernel-free parity mode), and picks the whole-stack megakernel
    wherever its geometry rule holds, the per-layer kernels elsewhere.
    An explicit "layer" or "mega" on an ineligible geometry raises, as
    does "mega" with fp32 on CUDA (the kernel takes bf16 activations);
    on the CPU both run the kernels' plain versions. Kernel modes round
    the cache up to whole 256-slot blocks, capped at ``n_positions``.
    The megakernel's rule is the family's: ``decode_layer.eligible`` for
    GPT-2, ``decode_layer.llama_eligible`` for llama; MoE has none, so
    "auto" gives it "layer"."""
    check_decode_kernel(decode_kernel)
    want = decode_kernel in ("layer", "mega") or (
        decode_kernel == "auto" and on_cuda and regime != "float32")
    if not want:
        return None, max_seq
    rounded = min(-(-max_seq // BLOCK_S) * BLOCK_S, config.n_positions)
    # the CUDA kernels are built for GPT-2's head_dim only; the megakernel's
    # rule is the per-layer kernel's plus a 128-aligned width
    layer_ok = eligible(rounded, config.head_dim, 1) and (
        not on_cuda or config.head_dim == KERNEL_HEAD_DIM)
    # the megakernel rule keys on the family module: MoE subclasses the
    # GPT-2 config but has no whole-stack kernel
    model = family_module(config)
    mega_ok = ((model is gpt2 and DL.eligible(config, rounded))
               or (model is llama and DL.llama_eligible(config, rounded)))
    if decode_kernel == "mega":
        if model not in (gpt2, llama):
            raise ValueError(
                "decode_kernel='mega' requested but the megakernel is "
                f"ineligible here: it needs a GPT-2/llama engine, and "
                f"{type(config).__name__} has no whole-stack kernel "
                "('layer' runs its per-layer kernels)")
        if not mega_ok:
            raise ValueError(
                f"decode_kernel='mega' requested but the megakernel is "
                f"ineligible here (n_embd={config.n_embd}, head_dim="
                f"{config.head_dim}, cache={rounded}): it needs "
                f"head_dim == {KERNEL_HEAD_DIM}, n_embd % 128 == 0 (llama: "
                f"also kv width and intermediate_size % 128 == 0, at most "
                f"{DL.LLAMA_MAX_G} query heads per kv head) and a "
                f"whole-{BLOCK_S}-block cache. Note: even an eligible mega "
                f"engine takes the per-layer kernels past {DL.MAX_BATCH} "
                "batch rows")
        if on_cuda and regime == "float32":
            raise ValueError(
                "decode_kernel='mega' with float32 on CUDA: the megakernel "
                "takes bf16 activations (the bfloat16 and int8 regimes); "
                "float32 is the kernel-free parity mode ('auto' or 'xla')")
    if not layer_ok:
        if decode_kernel == "layer":
            raise ValueError(
                f"decode_kernel='layer' requested but the geometry is "
                f"ineligible (head_dim={config.head_dim}, cache="
                f"{rounded}): needs 2*head_dim % 128 == 0 (on CUDA, "
                f"head_dim == {KERNEL_HEAD_DIM}) and a whole-"
                f"{BLOCK_S}-block cache; use 'auto' or 'xla'")
        return None, max_seq
    return ("mega" if mega_ok and decode_kernel != "layer" else "layer",
            rounded)


def _place_ep_params(params: Params, config, mesh) -> Params:
    """Expert-parallel placement (``parallel.spmd.moe_param_pspecs`` on
    an ``ep`` mesh): this rank's ``E / ep`` experts of every stacked
    expert leaf ``[L, E, ...]`` (int8 codes and scales together), every
    other leaf whole. Validates the mesh/family contract."""
    from ..parallel import spmd
    if "ep" not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no 'ep' axis: {mesh.mesh_dim_names}")
    ep = spmd.axis_size(mesh, "ep")
    if config.n_experts % ep:
        raise ValueError(
            f"n_experts={config.n_experts} not divisible by ep={ep}")
    return spmd.shard_params(params, mesh, spmd.moe_param_pspecs(mesh))


def _place_tp_params(params: Params, config, mesh) -> Params:
    """Megatron tensor-parallel placement for dense-family decode (the
    family's ``parallel.spmd`` layout table): this rank's column slices
    of q/k/v (its own heads' columns of GPT-2's fused ``c_attn``) and of
    the MLP's up projections, its row slices of the attention-out and
    down projections, embeddings and norms whole. The KV cache holds the
    rank's heads (``DecodeEngine._fresh_cache``)."""
    from ..parallel import spmd
    if "tp" not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no 'tp' axis: {mesh.mesh_dim_names}")
    tp = spmd.axis_size(mesh, "tp")
    kv_heads = getattr(config, "n_kv_head", config.n_head)
    if config.n_head % tp or kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_head={config.n_head} and "
            f"n_kv_head={kv_heads}: the KV cache and attention shard "
            "over whole heads")
    specs = (spmd.llama_param_pspecs(mesh)
             if isinstance(config, llama.LlamaConfig)
             else spmd.param_pspecs(mesh))
    return spmd.shard_params(params, mesh, specs)


class DecodeEngine:
    """Single-model decode engine for every ported family (``config`` a
    ``GPT2Config``, ``LlamaConfig`` or ``MoEConfig``;
    ``models.family_module`` picks the model functions). MoE decodes
    unstaged, prefills monolithically and has no whole-stack kernel.

    ``dtype`` is the inference regime: ``float32`` (the greedy-parity
    mode), ``bfloat16``, or ``int8`` (weight-only int8 with per-channel
    scales, bf16 activations and KV cache). ``boundaries`` switches on
    staged mode: params are partitioned into validated pipeline stages
    (``parallel.partition``) composed one after another on this device.

    ``decode_kernel``: ``"xla"`` is the plain PyTorch path (the name kept
    so configurations carry over); ``"layer"`` runs single-token steps
    through the per-layer kernels (decode attention, and the int8
    matmuls in the int8 regime); ``"mega"`` runs them through the
    whole-stack kernel, one launch per stage and step, and takes the
    per-layer kernels past 16 batch rows; ``"auto"`` picks ``"mega"`` on
    CUDA for bf16/int8 where its geometry rule holds, else ``"layer"``,
    and the plain path for fp32 (the parity mode) or on the CPU
    (``resolve_decode_kernel``). Kernel modes allocate the fused cache
    and round its length up to a whole number of 256-slot blocks, capped
    at ``n_positions``, as the JAX engine does. On the CPU the kernels'
    plain versions run.

    ``prefill_chunk=C`` prefills prompts longer than C as C-wide cached
    forwards (``_align_chunks``, ``_prefill_chunked``), byte-equal to the
    monolithic prefill.

    ``matmul_kernels`` lets the plain path's int8 matmuls take their
    kernels (``ops.quant``: the linear at every projection and the tied
    head, at <= 16 rows) while attention stays plain on the plain cache:
    the JAX package's int8 matmuls pick their Pallas kernel by backend
    and row count alone, so its speculative engine, pinned to "xla",
    runs them on every verify window (``runtime.spec_decode``). It does
    nothing for fp32 and bf16 weights, and a kernel mode runs those
    kernels already; ``decode_kernel`` keeps its meaning.

    ``mesh`` (a ``DeviceMesh``; exclusive with ``boundaries``): a dense
    family decodes tensor-parallel over the mesh's ``tp`` axis
    (``_place_tp_params``: each rank's heads and MLP slices, a KV cache
    of its heads, the row-parallel products summed over the axis), MoE
    expert-parallel over its ``ep`` axis (``_place_ep_params``; the dense
    dispatch, ``routed_mlp=False``). Under a mesh "auto" resolves to the
    plain path and an explicit kernel mode raises; int8 (MoE only: int8
    refuses tp, as in the JAX package) runs its matmuls on the int8
    linear and head kernels. Every rank builds the engine the same way;
    rank 0's ``generate`` announces the request to the others, which
    serve it from ``follow`` until ``stop_followers``.
    """

    def __init__(self, params: Params, config, max_seq: int,
                 dtype="float32", boundaries: Optional[Sequence[int]] = None,
                 decode_kernel: str = "auto", device: DeviceLike = None,
                 prefill_chunk: Optional[int] = None,
                 matmul_kernels: bool = False, mesh=None):
        if max_seq > config.n_positions:
            raise ValueError(
                f"max_seq={max_seq} exceeds n_positions={config.n_positions}")
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise ValueError(
                    f"prefill_chunk={prefill_chunk} must be >= 1")
            if not is_window_independent(config):
                # a window-dependent router would route C-token windows
                # differently from the monolithic prefill
                raise NotImplementedError(
                    "prefill_chunk requires window-independent routing; "
                    "MoE models prefill monolithically")
        self.prefill_chunk = prefill_chunk
        check_decode_kernel(decode_kernel)
        self._model = family_module(config)
        if boundaries is not None and not is_stage_partitionable(config):
            raise NotImplementedError(
                "pipeline stage partitioning (boundaries) covers the "
                "dense GPT-2 and llama param trees; "
                f"{type(config).__name__} models decode unstaged")
        self.device = resolve_device(device)
        self.regime = regime_of(dtype)
        self.dtype = torch_dtype(self.regime)
        dev = self.device
        moe_family = hasattr(config, "n_experts")
        if self.regime == "int8" and mesh is not None and not moe_family:
            # refused before any weight work
            raise NotImplementedError(
                "int8 does not compose with tp decode: the int8 "
                "streaming matmuls are unpartitioned Pallas kernels "
                "GSPMD cannot split; tp decode runs fp32/bf16")
        if self.regime == "int8":
            # quantize straight from the checkpoint dtype (a bf16 pre-cast
            # would round mantissas before rounding to int8 codes)
            params = quantize_params(map_params(lambda x: x.to(dev), params),
                                     self.dtype)
        else:
            params = map_params(
                lambda x: x.to(dev, self.dtype) if x.is_floating_point()
                else x.to(dev), params)
        self.config = config
        self.max_seq = max_seq
        self._mesh_mode: Optional[str] = None
        self._group = None
        # the config the cache and the blocks run with (a tp rank's heads)
        self._cache_config = config
        if mesh is not None:
            if boundaries is not None:
                raise ValueError("mesh decode (ep/tp) and stage "
                                 "partitioning are mutually exclusive")
            if moe_family:
                self._mesh_mode = "ep"
                params = _place_ep_params(params, config, mesh)
                self._group = mesh.get_group("ep")
            else:
                self._mesh_mode = "tp"
                params = _place_tp_params(params, config, mesh)
                self._group = mesh.get_group("tp")
                self._cache_config = gpt2.tp_config(config, self._group)
            if decode_kernel not in ("auto", "xla"):
                raise ValueError(
                    f"decode_kernel={decode_kernel!r} does not compose "
                    "with a mesh (the Pallas decode kernels are "
                    "unpartitioned); use 'auto' or 'xla'")
            decode_kernel = "xla"
            # the JAX package's int8 matmuls take their kernels under a
            # mesh too (they pick them by backend and rows alone)
            matmul_kernels = matmul_kernels or self.regime == "int8"
        # leader-side: one request's collectives at a time
        self._mesh_lock = threading.Lock()
        # the per-layer views are built once here, not in every step
        if boundaries is None:
            self.specs = None
            self.params = unstack_params(params)
            self.stage_params = None
        else:
            from ..parallel import partition as P
            self.specs = P.make_stage_specs(config.n_layer, boundaries)
            self.stage_params = [unstack_params(sp) for sp in
                                 P.partition_params(params, self.specs)]
            self.params = None

        self.decode_kernel, self._cache_seq = resolve_decode_kernel(
            decode_kernel, config, max_seq, self.regime, dev.type == "cuda")
        self.matmul_kernels = matmul_kernels
        # the mode the model functions take: "matmul" routes the int8
        # matmuls through their kernels and leaves attention plain
        self._model_kernel = self.decode_kernel or (
            "matmul" if matmul_kernels else None)
        # (batch, tokens) -> cached forwards run: which rows each forward
        # carried decides which kernels it launches (a single token at
        # <= 16 rows: the megakernels; past 16: the per-layer kernels; a
        # window of <= 16 rows: the int8 linear), so a caller can derive
        # the launch counts a run must show. Unlocked: exact when one
        # thread drives the engine, as a batcher's worker does
        self._forward_shapes: collections.Counter = collections.Counter()
        # the weights as the forwards read them, in the memory ledger (a
        # mesh engine's under the holding its placement contract names)
        graftmem.track(self, f"{self._mesh_mode}_params" if mesh is not None
                       else "params", "params",
                       self.params if self.params is not None
                       else self.stage_params)

    def forward_shapes(self) -> dict:
        """``{(batch, tokens): cached forwards run}`` so far."""
        return dict(self._forward_shapes)

    @property
    def decode_kernel_mode(self) -> str:
        """The resolved mode: "mega", "layer" or "xla" (the plain path)."""
        return self.decode_kernel or "xla"

    def _fresh_cache(self, batch: int):
        from ..parallel import partition as P
        cfg, dev = self.config, self.device
        if self.decode_kernel is not None:
            # kernel modes: the fused cache, at kv-head width
            n_kv = P.kv_heads(cfg)
            if self.specs is None:
                return create_fused_cache(cfg.n_layer, batch, n_kv,
                                          self._cache_seq, cfg.head_dim,
                                          self.dtype, dev)
            return [create_fused_cache(s.n_blocks, batch, n_kv,
                                       self._cache_seq, cfg.head_dim,
                                       self.dtype, dev) for s in self.specs]
        if self.specs is None:
            cache = self._model.make_cache(self._cache_config, batch,
                                           self._cache_seq, self.dtype, dev)
            if self._mesh_mode == "tp":
                # [L, B, H, S, hd]: this rank's heads of the global cache
                heads = P.kv_heads(cfg)
                for t in (cache.k, cache.v):
                    shape = list(t.shape)
                    shape[2] = heads
                    graftshard.place(t, shape, [(2, "tp", t.shape[2])])
            return cache
        return [P.make_stage_cache(s, cfg, batch, self._cache_seq,
                                   self.dtype, dev) for s in self.specs]

    def _forward_cached(self, x: torch.Tensor, cache, pad,
                        flash_prefill: bool = False):
        """One cached forward: the whole model, or the stages in order
        (the staged path ignores ``flash_prefill``, as the JAX engine's
        does)."""
        self._forward_shapes[tuple(x.shape[:2])] += 1
        if self.specs is None:
            kw = {}
            if self._mesh_mode == "tp":
                kw["tp_group"] = self._group
            elif self._mesh_mode == "ep":
                kw.update(routed_mlp=False, ep_group=self._group)
            return self._model.forward_with_cache(
                self.params, x, self.config, cache, pad,
                decode_kernel=self._model_kernel,
                flash_prefill=flash_prefill, **kw)
        from ..parallel import partition as P
        new_caches = []
        for sp, spec, c in zip(self.stage_params, self.specs, cache):
            x, c = P.stage_apply(sp, spec, self.config, x, c, pad,
                                 decode_kernel=self._model_kernel)
            new_caches.append(c)
        return x, new_caches

    def _flash_prefill(self, seq_len: int, pad) -> bool:
        """The JAX engine's fresh-cache flash-prefill gate: a prefill at
        offset 0 with no pad is plain causal attention over the new K/V,
        so with ``attention_impl="pallas"`` the unstaged engine runs it
        through the flash kernel where the kernel tiles the length and
        pays (``flash_eligible``, ``flash_profitable``)."""
        return (self.config.attention_impl == "pallas" and pad is None
                and seq_len > 1 and self.specs is None
                and flash_eligible(seq_len) and flash_profitable(seq_len))

    def _prefill_impl(self, ids: torch.Tensor, pad: Optional[torch.Tensor]):
        """``(logits [B, S, vocab], cache)`` of a prompt into a fresh
        cache."""
        cache = self._fresh_cache(ids.shape[0])
        return self._forward_cached(
            ids, cache, pad, self._flash_prefill(ids.shape[1], pad))

    # each prefill timed into its graftscope ring: the host window and,
    # on the card, the stream window
    _prefill = graftscope.instrument(_prefill_impl, "engine._prefill",
                                     key_fn=_rows_tokens_key)

    def _prefill_chunked_impl(self, ids: torch.Tensor,
                              pad: Optional[torch.Tensor], chunk: int):
        """``(last logits [B, vocab], cache)``: ``ids`` [B, n*chunk]
        (left-pad aligned by ``_align_chunks``; ``pad`` includes the
        alignment pad) as one ``chunk``-wide cached forward per chunk into
        a fresh cache. Never the flash prefill: after the first chunk
        the cache is not fresh."""
        cache = self._fresh_cache(ids.shape[0])
        for c0 in range(0, ids.shape[1], chunk):
            logits, cache = self._forward_cached(ids[:, c0:c0 + chunk],
                                                 cache, pad)
        return logits[:, -1], cache

    _prefill_chunked = graftscope.instrument(
        _prefill_chunked_impl, "engine._prefill_chunked",
        key_fn=_rows_tokens_key)

    def _align_chunks(self, ids: np.ndarray, pad: np.ndarray,
                      prompt_len: int, reserve: int):
        """Left-pad ``ids`` to a whole number of ``prefill_chunk`` chunks
        when chunked prefill applies. Returns ``(ids, pad, prompt_len,
        chunk or None)``; None means the monolithic prefill: chunking
        off, a prompt within one chunk, or no room for the alignment pad
        before ``reserve`` more tokens. The room is counted against
        ``max_seq``, as the JAX engine does, not against a kernel
        engine's cache rounded up to whole 256-slot blocks: the two
        engines then take the same path, and the padded prompt always
        fits the cache, which is at least ``max_seq`` long."""
        chunk = self.prefill_chunk
        if not chunk or prompt_len <= chunk:
            return ids, pad, prompt_len, None
        n_chunks = -(-prompt_len // chunk)
        if n_chunks * chunk + reserve > self.max_seq:
            return ids, pad, prompt_len, None
        extra = n_chunks * chunk - prompt_len
        if extra:
            ids = np.concatenate(
                [np.zeros((ids.shape[0], extra), ids.dtype), ids], axis=1)
            pad = pad + extra
        return ids, pad, n_chunks * chunk, chunk

    def _prefill_last(self, ids: np.ndarray, pad: Optional[torch.Tensor],
                      chunk: Optional[int]):
        """``(last logits [B, vocab], cache)`` of an (aligned) prompt:
        chunked where ``_align_chunks`` chose a chunk, else monolithic."""
        if chunk:
            return self._prefill_chunked(self._ids(ids), pad, chunk)
        logits, cache = self._prefill(self._ids(ids), pad)
        return logits[:, -1], cache

    def _decode_seg_impl(self, token: torch.Tensor, cache,
                         pad: Optional[torch.Tensor], n: int,
                         sampling: SamplingConfig, generator: Generators):
        """``n`` cached single-token steps from ``token`` [B]: returns
        ``(tokens [B, n] on the device, cache)``. The one decode loop:
        ``generate`` and both batchers run every decode step through it.
        With per-row generators each row draws once a step, so a row's
        draws continue across segments from wherever its generator
        stands. The caller holds ``torch.inference_mode``."""
        out = torch.empty((token.shape[0], n), dtype=torch.int64,
                          device=self.device)
        for i in range(n):
            logits, cache = self._forward_cached(token[:, None], cache, pad)
            token = self._select(logits[:, -1], sampling, generator)
            out[:, i] = token
        return out, cache

    def _select(self, logits: torch.Tensor, sampling: SamplingConfig,
                generator: Generators) -> torch.Tensor:
        """``select_token``; under a mesh rank 0 picks (with the
        request's generators, which only it holds) and broadcasts, so the
        ranks never part."""
        if self._group is None:
            return select_token(logits, sampling, generator)
        if distributed.rank() == 0:
            token = select_token(logits, sampling, generator)
        else:
            token = torch.empty(logits.shape[0], dtype=torch.int64,
                                device=logits.device)
        return distributed.broadcast(token, 0, self._group)

    # each segment timed into its graftscope ring, as the JAX package
    # times its compiled segment: a step's stream window is the
    # segment's over its steps
    _decode_seg = graftscope.instrument(_decode_seg_impl, "engine._decode_seg",
                                        key_fn=_seg_key)

    def _ids(self, ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, dtype=np.int64),
                               device=self.device)

    def _pad(self, pad: np.ndarray) -> Optional[torch.Tensor]:
        # rectangular batches skip the per-row mask entirely
        if not pad.any():
            return None
        return torch.as_tensor(pad, dtype=torch.int32, device=self.device)

    @torch.inference_mode()
    def generate(self, prompt_ids, max_new_tokens: int,
                 sampling: SamplingConfig = SamplingConfig(),
                 generator: Generators = None,
                 pad: Optional[np.ndarray] = None,
                 eos_id: Optional[int] = None) -> GenerateResult:
        """[B, S] (or [S], or a ragged list) prompt ids -> GenerateResult
        with [B, S+N] tokens. ``generator`` is one ``torch.Generator`` or
        a list of one per row (``select_token``). ``eos_id`` stops at the
        first EOS check (32, 64, 128, 256, ... steps) where every row has
        emitted it; the tokens returned are then an exact prefix of the
        unstopped stream. With chunked prefill the returned ids carry the
        alignment pad and ``pad`` counts it (``row_tokens`` strips it).
        """
        ids, batch, prompt_len, pad = prepare_generate(
            prompt_ids, max_new_tokens, self.max_seq, sampling, generator,
            pad=pad)
        ids, pad, prompt_len, chunk = self._align_chunks(
            ids, pad, prompt_len, reserve=max_new_tokens)
        if self._group is None:
            return self._generate_prepared(ids, pad, prompt_len, chunk,
                                           max_new_tokens, sampling,
                                           generator, eos_id)
        with self._mesh_lock:
            if distributed.world_size() > 1:
                distributed.announce({
                    "op": "generate", "ids": ids, "pad": pad,
                    "prompt_len": prompt_len, "chunk": chunk,
                    "steps": max_new_tokens, "sampling": sampling,
                    "eos_id": eos_id})
            return self._generate_prepared(ids, pad, prompt_len, chunk,
                                           max_new_tokens, sampling,
                                           generator, eos_id)

    @torch.inference_mode()
    def follow(self) -> int:
        """A follower rank's loop under a mesh: serve each request rank
        0 announces, with the same calls, until its stop header. Returns
        the requests served."""
        served = 0
        while True:
            hdr = distributed.await_header()
            if hdr["op"] == "stop":
                return served
            self._generate_prepared(hdr["ids"], hdr["pad"],
                                    hdr["prompt_len"], hdr["chunk"],
                                    hdr["steps"], hdr["sampling"], None,
                                    hdr["eos_id"])
            served += 1

    def stop_followers(self) -> None:
        """Rank 0: end the followers' ``follow`` loops."""
        if self._group is not None and distributed.world_size() > 1:
            with self._mesh_lock:
                distributed.announce({"op": "stop"}, wait_s=30.0)

    def _generate_prepared(self, ids: np.ndarray, pad: np.ndarray,
                           prompt_len: int, chunk: Optional[int],
                           max_new_tokens: int, sampling: SamplingConfig,
                           generator: Generators,
                           eos_id: Optional[int]) -> GenerateResult:
        """``generate`` past its validation and chunk alignment: what a
        follower rank runs from rank 0's header."""
        batch = ids.shape[0]
        pad_t = self._pad(pad)
        t0 = time.perf_counter()
        last, cache = self._prefill_last(ids, pad_t, chunk)
        token = self._select(last, sampling, generator)
        _sync(self.device)
        t1 = time.perf_counter()
        tracing.record("prefill", t0, t1, batch=batch,
                       prompt_len=prompt_len, chunked=bool(chunk))
        kv_block_gauges("engine", batch * (prompt_len + max_new_tokens),
                        batch * self._cache_seq)
        return self._decode_and_pack(ids, pad, pad_t, token, cache,
                                     max_new_tokens, sampling, generator,
                                     prompt_len, t1 - t0, eos_id=eos_id)

    def _decode_and_pack(self, ids: np.ndarray, pad: np.ndarray,
                         pad_t: Optional[torch.Tensor], token: torch.Tensor,
                         cache, max_new_tokens: int,
                         sampling: SamplingConfig, generator: Generators,
                         prompt_len: int, prefill_seconds: float,
                         eos_id: Optional[int] = None) -> GenerateResult:
        """The decode loop off a prepared ``(first token [B], cache)``
        state, and the ``GenerateResult``: shared by ``generate``, the
        prefix-cache front end (``runtime.prefix_cache``) and the
        admission batcher's prefix rounds, which prepare the prefill
        state their own way. Writes ``cache`` in place. ``eos_id``
        stops at the first EOS check (32, 64, 128, 256, ... steps) where
        every row has emitted it."""
        t1 = time.perf_counter()
        batch = ids.shape[0]
        # the cache is this call's for the whole decode
        mem_h = graftmem.track(
            self, "tp_cache" if self._mesh_mode == "tp" else "cache",
            "engine_cache", cache)
        parts = [token[:, None]]
        segments = 0
        done = None if eos_id is None else (token == eos_id)
        if done is None or not bool(done.all()):
            for take in eos_chunks(max_new_tokens - 1):
                segments += 1
                out, cache = self._decode_seg(token, cache, pad_t, take,
                                              sampling, generator)
                token = out[:, -1]
                parts.append(out)
                if done is not None:
                    done |= (out == eos_id).any(dim=1)
                    if bool(done.all()):
                        break
        # an owning host copy: nothing later writes these tokens
        new = torch.cat(parts, dim=1).cpu().numpy().copy()
        t2 = time.perf_counter()
        graftmem.release(mem_h)
        n = new.shape[1]
        tracing.record("decode", t1, t2, batch=batch, steps=n,
                       segments=segments,
                       step_ms=round((t2 - t1) / max(n - 1, 1) * 1e3, 3))
        if n > 1:
            # a decode step's time, the device's included: the window
            # ends after the tokens' copy to the host
            REGISTRY.observe("decode_step_seconds", (t2 - t1) / (n - 1),
                             component="engine")
        kv_block_gauges("engine", 0, batch * self._cache_seq)
        return GenerateResult(tokens=np.concatenate([ids, new], axis=1),
                              prompt_len=prompt_len,
                              prefill_seconds=prefill_seconds,
                              decode_seconds=t2 - t1, new_tokens=n,
                              decode_steps=n - 1,
                              pad=pad if pad.any() else None)
