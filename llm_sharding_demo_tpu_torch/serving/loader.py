"""Model resolution for serving: checkpoint -> local HF model -> random
init.

Counterpart of ``llm_sharding_demo_tpu/serving/loader.py``. The order:

1. ``CHECKPOINT_DIR`` set: ``utils.checkpoint`` restores it. A set
   directory that fails to load is an error, never a random init;
2. ``MODEL_ID`` is the path of a local HF model directory:
   ``models.hf_convert`` converts it;
3. otherwise the named architecture (``FALLBACK_CONFIGS``) with seeded
   random weights, logged loudly: the output is untrained noise.

There is no hub probe and no download (the JAX package probes the hub):
a model the machine does not hold resolves to step 3 or fails.
``MODEL_ID=gpt2`` gives the full GPT-2 124M width, ``MODEL_ID=llama-124m``
the llama family's 124M geometry.

``resolve_for_role`` loads what a role serves: a shard ``a``/``b`` with a
checkpoint of a partitionable model reads only its two-stage compat
subset (``checkpoint.load_stage_params``), a non-partitionable model's
shard only the config, and a ``DISPATCH=remote`` coordinator only the
config (its shards hold the weights).
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import torch

from ..models import family_module, gpt2, is_partitionable, llama
from ..models.gpt2 import Params, map_params
from ..models.hf_convert import (config_from_hf_dir, convert_hf_dir,
                                 find_hf_dir)
from ..utils import checkpoint as ckpt
from ..utils.config import ServingConfig

log = logging.getLogger(__name__)

FALLBACK_CONFIGS = {
    "sshleifer/tiny-gpt2": gpt2.CONFIGS["tiny-gpt2"],
    "gpt2": gpt2.CONFIGS["gpt2"],
    "gpt2-medium": gpt2.CONFIGS["gpt2-medium"],
    "llama-tiny": llama.CONFIGS["llama-tiny"],
    "llama-124m": llama.CONFIGS["llama-124m"],
}


def _on(device: torch.device, params: Params) -> Params:
    return map_params(lambda x: x.to(device), params)


def resolve_config(cfg: ServingConfig):
    """The configuration alone: the checkpoint's, a local HF model's, or
    the registered architecture's."""
    if cfg.checkpoint_dir:
        return ckpt.load_config(cfg.checkpoint_dir)
    src = find_hf_dir(cfg.model_id)
    if src is not None:
        return config_from_hf_dir(src)
    if cfg.model_id not in FALLBACK_CONFIGS:
        raise RuntimeError(
            f"cannot load {cfg.model_id!r}: no checkpoint dir, no local HF "
            "model of that name, and no architecture registered under it "
            f"(known: {sorted(FALLBACK_CONFIGS)})")
    return FALLBACK_CONFIGS[cfg.model_id]


def resolve_model(cfg: ServingConfig, device: torch.device,
                  seed: int = 0) -> Tuple[object, Params]:
    """``(config, params on device)`` in the module's order."""
    if cfg.checkpoint_dir:
        log.info("loading checkpoint from %s", cfg.checkpoint_dir)
        config, params = ckpt.load(cfg.checkpoint_dir)
        return config, _on(device, params)
    src = find_hf_dir(cfg.model_id)
    if src is not None:
        log.info("converting the local HF model %s (%s)", cfg.model_id, src)
        config, params = convert_hf_dir(src)
        return config, _on(device, params)
    config = resolve_config(cfg)
    log.warning("no checkpoint for %s; using RANDOM-INIT %s weights "
                "(seed %d) — output will be untrained noise",
                cfg.model_id, config, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    return config, family_module(config).init_params(config, gen)


def resolve_for_role(cfg: ServingConfig, device: torch.device,
                     ) -> Tuple[object, Optional[Params], Optional[Params]]:
    """``(config, full params, stage params)``, loading only what the role
    serves (see the module docstring); the params are on ``device``."""
    if cfg.checkpoint_dir and cfg.shard_role in ("a", "b"):
        config = ckpt.load_config(cfg.checkpoint_dir)
        if not is_partitionable(config):
            # its stage endpoints decline every request: no weights
            return config, None, None
        from ..parallel import partition as P_
        spec = P_.make_stage_specs(config.n_layer, [cfg.split_at])[
            0 if cfg.shard_role == "a" else 1]
        log.info("partial-restoring stage %s (blocks [%d, %d)) from %s",
                 cfg.shard_role, spec.start, spec.end, cfg.checkpoint_dir)
        _, stage = ckpt.load_stage_params(cfg.checkpoint_dir, spec)
        return config, None, _on(device, stage)
    if cfg.shard_role == "coordinator" and cfg.dispatch == "remote":
        log.info("remote-dispatch coordinator: the configuration only")
        return resolve_config(cfg), None, None
    config, params = resolve_model(cfg, device)
    return config, params, None
