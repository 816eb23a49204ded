"""Model families and the family registry.

Every family module exposes ``init_params`` / ``forward`` /
``forward_with_cache`` / ``make_cache`` over a stacked-block parameter
dict, so the runtime dispatches on the config object alone
(``family_module``). GPT-2, the llama family and GPT-2-MoE are ported.
"""

from __future__ import annotations


def family_module(config):
    """Config dataclass -> the model module implementing it. MoEConfig
    subclasses GPT2Config, so it is tested first."""
    from . import gpt2, llama, moe
    if isinstance(config, moe.MoEConfig):
        return moe
    if isinstance(config, llama.LlamaConfig):
        return llama
    if isinstance(config, gpt2.GPT2Config):
        return gpt2
    raise TypeError(f"unknown model config type {type(config).__name__}")


def is_moe(config) -> bool:
    from . import moe
    return isinstance(config, moe.MoEConfig)


def is_partitionable(config) -> bool:
    """Whether the reference's GPT-2 stage-shard wire topology applies
    (``/forward`` + ``/forward_b``, remote dispatch, a shard's partial
    restore): dense GPT-2 only, by design."""
    from . import gpt2
    return isinstance(config, gpt2.GPT2Config) and not is_moe(config)


def is_stage_partitionable(config) -> bool:
    """Whether ``parallel.partition`` can stage this family's tree (the
    one staging predicate): GPT-2 and llama; MoE decodes unstaged."""
    from . import llama
    return is_partitionable(config) or isinstance(config, llama.LlamaConfig)


def is_window_independent(config) -> bool:
    """Whether a token's logits do not depend on which other tokens share
    its forward window: the property behind every exactness contract
    that replays tokens in other window shapes (chunked prefill,
    speculation, the prefix store, a batcher's joins). The dense
    families are; MoE's capacity routing makes tokens compete within a
    window, so it is not."""
    family_module(config)
    return not is_moe(config)
