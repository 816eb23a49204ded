"""HTTP serving surface, wire-compatible with the JAX package's app.

Counterpart of the core of ``llm_sharding_demo_tpu/serving/app.py``
``create_app``:

- ``POST /generate``  {"prompt", "max_new_tokens", ...} -> {"generated": str}
- ``POST /forward``   {"input_ids": [int]}       -> {"hidden_states": [[[f]]]}
- ``POST /forward_b`` {"hidden_states": [[[f]]]} -> {"logits": [[[f]]]}
- ``GET /healthz``    readiness, the serving composition, the device, the
  resolved decode kernel mode and the kernels' launch counts.

Role guards answer HTTP 200 with ``{"error": ...}`` as the reference does.
Runner choice: ``INFERENCE_DTYPE=int8`` or ``bfloat16`` -> the staged
``DecodeEngine``, which runs the per-layer CUDA kernels on the GPU;
float32 -> the kernel-free ``PipelineRunner``, the fp32 parity path.
(The JAX app serves single-stream bf16 through its ``PipelineRunner``;
here bf16 takes the engine so that its decode steps run the kernels.)
"""

from __future__ import annotations

import dataclasses
import logging
import secrets
from typing import List, Optional

import numpy as np
import torch

from ..models import is_partitionable
from ..models.gpt2 import map_params
from ..ops import cuda_build
from ..parallel import partition as P_
from ..parallel.pipeline import PipelineRunner
from ..runtime.engine import (REF_TEMPERATURE, REF_TOP_K, DecodeEngine,
                              SamplingConfig)
from ..utils.config import ServingConfig, from_env
from ..utils.device import DeviceLike, resolve_device
from . import loader
from .http import JSONApp
from .tokenizer import get_tokenizer

log = logging.getLogger(__name__)


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


def create_app(cfg: Optional[ServingConfig] = None, model=None,
               tokenizer=None, device: DeviceLike = None) -> JSONApp:
    """Build the app. ``model=(config, params)`` and ``tokenizer`` are
    injectable for tests; by default the model comes from
    ``serving.loader`` and the byte tokenizer serves. ``device`` is
    ``cuda`` unless given."""
    cfg = cfg or from_env()
    dev = resolve_device(device)
    if model is not None:
        config, params = model
    else:
        config, params = loader.resolve_model(cfg, dev)
    tokenizer = tokenizer or get_tokenizer(cfg.model_id)

    n_layer = config.n_layer
    for b in cfg.boundaries:
        if not 1 <= b <= n_layer - 1:
            raise ValueError(
                f"boundary {b} out of range for n_layer={n_layer}")
    if cfg.inference_dtype != "float32" and cfg.shard_role != "coordinator":
        raise ValueError(
            f"INFERENCE_DTYPE={cfg.inference_dtype} applies to the "
            "coordinator's decode path only; shard roles serve the fp32 "
            "parity endpoints")

    runner = None
    decode_kernel = None
    if cfg.shard_role == "coordinator":
        if cfg.inference_dtype == "float32":
            runner = PipelineRunner(params, config, list(cfg.boundaries),
                                    max_seq=cfg.max_seq, device=dev)
        else:
            runner = DecodeEngine(params, config, max_seq=cfg.max_seq,
                                  boundaries=list(cfg.boundaries),
                                  dtype=cfg.inference_dtype, device=dev)
        decode_kernel = runner.decode_kernel_mode
    # the reference's two-stage wire topology (/forward, /forward_b) is
    # dense GPT-2 only; other families answer /generate alone
    partitionable = is_partitionable(config)
    decline = {"error": "stage endpoints serve dense GPT-2 only; "
                        f"{type(config).__name__} models generate via "
                        "/generate"}
    compat_specs = P_.make_stage_specs(n_layer, [cfg.split_at])
    compat_params = {}
    for i, role in enumerate(("a", "b")):
        if cfg.shard_role == role and partitionable:
            compat_params[role] = P_.extract_stage_params(
                map_params(lambda x: x.to(dev), params), compat_specs[i])

    app = JSONApp(title="llm-sharding-demo-tpu-torch", version="0.1.0")

    @app.get("/healthz")
    def healthz():
        return {
            "status": "ok",
            "role": cfg.shard_role,
            "model": cfg.model_id,
            "n_stages": len(cfg.boundaries) + 1,
            "dispatch": cfg.dispatch,
            "max_batch": 1,
            "inference_dtype": cfg.inference_dtype,
            "device": str(dev),
            "decode_kernel": decode_kernel,
            "kernel_launches": cuda_build.launch_counts(),
        }

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

    @app.post("/generate")
    def generate(req: GenerateReq):
        if cfg.shard_role != "coordinator":
            return {"error": "This instance is not coordinator."}
        if req.max_new_tokens < 1:
            return {"error": "max_new_tokens must be >= 1"}
        prompt_ids = tokenizer.encode(req.prompt)
        if not prompt_ids:
            return {"error": "prompt tokenized to zero tokens"}
        if len(prompt_ids) + req.max_new_tokens > cfg.max_seq:
            return {"error": f"prompt ({len(prompt_ids)} tokens) + "
                             f"max_new_tokens ({req.max_new_tokens}) exceeds "
                             f"max_seq ({cfg.max_seq})"}
        if req.mode not in ("sample", "greedy"):
            return {"error": f"unknown mode {req.mode!r}"}
        if req.mode == "sample":
            if req.temperature <= 0:
                return {"error": "temperature must be > 0"}
            if not 1 <= req.top_k <= config.vocab_size:
                return {"error": f"top_k must be in [1, {config.vocab_size}]"}
            if not 0.0 < req.top_p <= 1.0:
                return {"error": "top_p must be in (0, 1]"}
        eos_id = None
        if req.stop_at_eos or req.eos_token_id is not None:
            eos_id = (req.eos_token_id if req.eos_token_id is not None
                      else getattr(tokenizer, "eos_token_id", None))
            if eos_id is None:
                return {"error": "stop_at_eos requested but the tokenizer "
                                 "has no eos_token_id; pass eos_token_id "
                                 "explicitly"}
            if not 0 <= eos_id < config.vocab_size:
                return {"error": f"eos_token_id {eos_id} out of vocab range"}
        sampling = (SamplingConfig(mode="greedy") if req.mode == "greedy"
                    else SamplingConfig(mode="sample",
                                        temperature=req.temperature,
                                        top_k=req.top_k, top_p=req.top_p))
        seed = req.seed if req.seed is not None else secrets.randbits(31)
        gen = torch.Generator(device=runner.device).manual_seed(seed)
        result = runner.generate(np.asarray(prompt_ids),
                                 max_new_tokens=req.max_new_tokens,
                                 sampling=sampling, generator=gen,
                                 eos_id=eos_id)
        ids = [int(t) for t in result.row_tokens(0)]
        finish_reason = "length"
        if eos_id is not None:
            # truncate at the first EOS among the new tokens
            new = ids[len(prompt_ids):]
            if eos_id in new:
                ids = ids[:len(prompt_ids) + new.index(eos_id)]
                finish_reason = "stop"
        log.info('{"event": "generate", "mode": "%s", "prompt_tokens": %d, '
                 '"new_tokens": %d, "finish_reason": "%s"}', req.mode,
                 len(prompt_ids), len(ids) - len(prompt_ids), finish_reason)
        body = {"generated": tokenizer.decode(ids)}
        if eos_id is not None:
            body["finish_reason"] = finish_reason
        return body

    return app
