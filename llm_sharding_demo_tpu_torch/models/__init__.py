"""Model families and the family registry.

GPT-2 and the llama family are ported; the JAX package's MoE family
waits for the MoE half of ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

MOE_ITEM = "ROADMAP Queue 1 item 12 (its MoE half: models/moe.py)"


def family_module(config):
    """Config dataclass -> the model module implementing it."""
    from . import gpt2, llama
    if isinstance(config, llama.LlamaConfig):
        return llama
    if isinstance(config, gpt2.GPT2Config):
        return gpt2
    raise NotImplementedError(
        f"model family {type(config).__name__} is not ported to PyTorch "
        f"yet; it waits for {MOE_ITEM}")


def is_partitionable(config) -> bool:
    """Whether the reference's GPT-2 stage-shard wire topology applies
    (``/forward`` + ``/forward_b``, remote dispatch): dense GPT-2 only,
    by design."""
    from . import gpt2
    return isinstance(config, gpt2.GPT2Config)


def is_stage_partitionable(config) -> bool:
    """Whether ``parallel.partition`` can stage this family's tree (the
    one staging predicate): GPT-2 and llama."""
    from . import llama
    return is_partitionable(config) or isinstance(config, llama.LlamaConfig)


def is_window_independent(config) -> bool:
    """Whether a token's logits do not depend on which other tokens share
    its forward window: the property behind every exactness contract
    that replays tokens in other window shapes (chunked prefill, a
    batcher's joins). The dense families are; the JAX package's MoE
    family, whose capacity routing makes tokens compete within a window,
    is not, and ``family_module`` refuses it."""
    family_module(config)
    return True
