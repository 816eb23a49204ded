"""Model resolution for serving: random init from the named architecture.

Counterpart of ``llm_sharding_demo_tpu/serving/loader.py``. Checkpoints
(``CHECKPOINT_DIR``) and Hugging Face downloads are not ported, so the
server always builds the named architecture with seeded random weights
and logs loudly that its output is untrained noise. ``MODEL_ID=gpt2``
gives the full GPT-2 124M width, ``MODEL_ID=llama-124m`` the llama
family's 124M geometry (12 layers, 12 query and 4 kv heads, 4096
positions). A ``DISPATCH=remote`` coordinator takes the configuration
alone (``resolve_config``): its shards hold the weights.
"""

from __future__ import annotations

import logging
from typing import Tuple

import torch

from ..models import family_module, gpt2, llama
from ..models.gpt2 import Params
from ..utils.config import ServingConfig

log = logging.getLogger(__name__)

FALLBACK_CONFIGS = {
    "sshleifer/tiny-gpt2": gpt2.CONFIGS["tiny-gpt2"],
    "gpt2": gpt2.CONFIGS["gpt2"],
    "gpt2-medium": gpt2.CONFIGS["gpt2-medium"],
    "llama-tiny": llama.CONFIGS["llama-tiny"],
    "llama-124m": llama.CONFIGS["llama-124m"],
}


def resolve_config(cfg: ServingConfig):
    """``MODEL_ID`` -> its architecture's configuration, no weights."""
    if cfg.model_id not in FALLBACK_CONFIGS:
        raise RuntimeError(
            f"cannot load {cfg.model_id!r}: checkpoints and hub downloads "
            "are not ported, and no architecture is registered under that "
            f"name (known: {sorted(FALLBACK_CONFIGS)})")
    return FALLBACK_CONFIGS[cfg.model_id]


def resolve_model(cfg: ServingConfig, device: torch.device,
                  seed: int = 0) -> Tuple[object, Params]:
    """``MODEL_ID`` -> (config, params drawn on ``device`` from ``seed``)."""
    config = resolve_config(cfg)
    log.warning("no checkpoint for %s; using RANDOM-INIT %s weights "
                "(seed %d) — output will be untrained noise",
                cfg.model_id, config, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    return config, family_module(config).init_params(config, gen)
