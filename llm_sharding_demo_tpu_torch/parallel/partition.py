"""N-stage pipeline partitioner over a GPT-2 or llama parameter dict.

Counterpart of ``llm_sharding_demo_tpu/parallel/partition.py``: stages
are contiguous block ranges, validated disjoint and exhaustive before any
stage exists; stage parameters are slices of the stacked blocks (views,
no copies); the first stage carries the embeddings, the last the final
norm and the head (GPT-2's tied ``wte_out``, llama's ``lm_head``).

The JAX package's pipeline training stacks the blocks stage-major
(``[S, per, ...]``, zero-padded to the largest stage with a
``stage_valid_mask`` where stages are uneven, or ``[S, v, per_chunk,
...]`` for interleaved 1F1B); each rank of the port holds only its own
stage's blocks. ``stack_stage_params``, ``stack_stage_params_padded``,
``stack_virtual_chunks`` and their inverses carry weights and gradients
between the two layouts (``[L, ...]`` <-> stacked), ``stage_blocks`` and
``virtual_chunks`` cut a rank's blocks from ``[L, ...]``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..models import llama
from ..models.gpt2 import (GPT2Config, Params, embed, final_logits,
                           layer_params, run_blocks)
from ..ops.attention import KVCache

Config = Union[GPT2Config, llama.LlamaConfig]


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One pipeline stage: blocks ``[start, end)`` of ``n_layer`` total."""

    index: int
    n_stages: int
    start: int
    end: int

    @property
    def is_first(self) -> bool:
        return self.index == 0

    @property
    def is_last(self) -> bool:
        return self.index == self.n_stages - 1

    @property
    def n_blocks(self) -> int:
        return self.end - self.start


def balanced_boundaries(n_layer: int, n_stages: int) -> List[int]:
    """Split points giving each stage ``n_layer // n_stages`` (+-1)
    blocks, the earlier stages taking the remainder: 12 layers over 4
    stages -> [3, 6, 9]."""
    if not 1 <= n_stages <= n_layer:
        raise ValueError(
            f"n_stages={n_stages} must be in [1, n_layer={n_layer}]")
    base, rem = divmod(n_layer, n_stages)
    bounds, acc = [], 0
    for i in range(n_stages - 1):
        acc += base + (1 if i < rem else 0)
        bounds.append(acc)
    return bounds


def make_stage_specs(n_layer: int, boundaries: Sequence[int],
                     ) -> List[StageSpec]:
    """Interior boundaries -> validated StageSpecs (strictly increasing, in
    range, no empty stage: disjoint and exhaustive block coverage)."""
    bounds = list(boundaries)
    cuts = [0] + bounds + [n_layer]
    for a, b in zip(cuts, cuts[1:]):
        if not a < b:
            raise ValueError(
                f"invalid partition {bounds!r} of {n_layer} layers: stage "
                f"[{a},{b}) is empty or out of order (partition must be "
                "disjoint and exhaustive)")
    n_stages = len(cuts) - 1
    return [StageSpec(index=i, n_stages=n_stages, start=cuts[i],
                      end=cuts[i + 1]) for i in range(n_stages)]


def validate_specs(specs: Sequence[StageSpec], n_layer: int) -> None:
    """Re-check an externally supplied stage list, in composition order:
    stages tile ``[0, n_layer)`` in list order and ``index``/``n_stages``
    are consistent, so exactly the first stage embeds and exactly the last
    applies the head."""
    pos = 0
    for i, s in enumerate(specs):
        if s.index != i or s.n_stages != len(specs):
            raise ValueError(
                f"spec at position {i} has index={s.index}, "
                f"n_stages={s.n_stages}; expected index={i}, "
                f"n_stages={len(specs)} (is_first/is_last would misfire)")
        if s.start != pos or s.end <= s.start:
            raise ValueError(
                f"stages {[(t.start, t.end) for t in specs]} do not tile "
                f"[0,{n_layer}) in order: gap/overlap at block {pos}")
        pos = s.end
    if pos != n_layer:
        raise ValueError(
            f"stages cover [0,{pos}) but model has {n_layer} layers")


def extract_stage_params(params: Params, spec: StageSpec) -> Params:
    """The parameter subset one stage needs: embeddings on the first
    stage, its blocks, and ln_f plus the head on the last. The family is
    read from the tree: llama's carries an untied ``lm_head`` and no
    ``wpe``; GPT-2 ties its head to ``wte``."""
    out: Params = {"blocks": layer_params(params["blocks"],
                                          slice(spec.start, spec.end))}
    llama_tree = "lm_head" in params
    if spec.is_first:
        out["wte"] = params["wte"]
        if not llama_tree:
            out["wpe"] = params["wpe"]
    if spec.is_last:
        out["ln_f"] = params["ln_f"]
        if llama_tree:
            out["lm_head"] = params["lm_head"]
        else:
            out["wte_out"] = params["wte"]  # tied LM head
    return out


def partition_params(params: Params, specs: Sequence[StageSpec],
                     ) -> List[Params]:
    """All stages' parameter subsets."""
    return [extract_stage_params(params, s) for s in specs]


def stage_apply(stage_params: Params, spec: StageSpec, config: Config,
                x: torch.Tensor, cache: Optional[KVCache] = None,
                pad: Optional[torch.Tensor] = None,
                decode_kernel: Optional[str] = None,
                ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run one stage. The first stage takes ``[B,S]`` ids, others
    ``[B,S,D]`` hidden states; the last returns ``[B,S,vocab]`` f32
    logits. The position offset derives from ``cache.length`` (0 without
    a cache), never from the caller, so the position embedding (GPT-2)
    or the rotary angles (llama) cannot disagree with the cache-write
    position. On a mega engine a single-token input runs the stage's
    blocks in one whole-stack launch (the family's ``mega_step``)."""
    if isinstance(config, llama.LlamaConfig):
        return _stage_apply_llama(stage_params, spec, config, x, cache, pad,
                                  decode_kernel)
    position_offset = cache.length if cache is not None else 0
    if pad is not None:
        position_offset = position_offset - pad[:, None]
    h = embed(stage_params, x, position_offset) if spec.is_first else x
    h, cache = run_blocks(stage_params, h, config, cache, pad, decode_kernel)
    if spec.is_last:
        head = {"ln_f": stage_params["ln_f"], "wte": stage_params["wte_out"]}
        h = final_logits(head, h, config.layer_norm_epsilon,
                         kernels=decode_kernel is not None)
    return h, cache


def _stage_apply_llama(stage_params: Params, spec: StageSpec,
                       config: llama.LlamaConfig, x: torch.Tensor,
                       cache: Optional[KVCache], pad: Optional[torch.Tensor],
                       decode_kernel: Optional[str],
                       ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """A llama stage: the rotary angles derive from the stage cache's
    length (the same offset in every stage); embedding on the first
    stage, RMSNorm and the untied head on the last."""
    offset = cache.length if cache is not None else 0
    cos, sin = llama.angles(config, x.shape[1], offset, pad, x.device)
    h = llama.embed(stage_params, x) if spec.is_first else x
    h, cache = llama.run_blocks(stage_params, h, config, cos, sin, cache, pad,
                                decode_kernel)
    if spec.is_last:
        h = llama.final_logits(stage_params, h, config,
                               kernels=decode_kernel is not None)
    return h, cache


def make_stage_cache(spec: StageSpec, config: Config, batch: int,
                     max_seq: int, dtype=torch.float32,
                     device=None) -> KVCache:
    """A KV cache sized for one stage's block count, at kv-head width for
    a grouped-query family."""
    if max_seq > config.n_positions:
        raise ValueError(
            f"max_seq={max_seq} exceeds n_positions={config.n_positions}")
    return KVCache.create(spec.n_blocks, batch, kv_heads(config), max_seq,
                          config.head_dim, dtype, device)


def kv_heads(config: Config) -> int:
    """The KV cache's head count: ``n_kv_head`` where the family has
    one, else ``n_head``."""
    return getattr(config, "n_kv_head", config.n_head)


# -- the JAX package's stage-major layouts ------------------------------------


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _zip(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _zip(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_stage_params(params: Params, specs: Sequence[StageSpec]) -> Params:
    """``params["blocks"]`` ``[L, ...]`` -> ``[S, per, ...]`` for equal
    stages (the JAX package's ``stack_stage_params``)."""
    sizes = {s.n_blocks for s in specs}
    if len(sizes) != 1:
        raise ValueError(
            f"stage-major stacking needs equal stage sizes, got "
            f"{[s.n_blocks for s in specs]}")
    per = sizes.pop()
    return _map(lambda x: x.reshape((len(specs), per) + tuple(x.shape[1:])),
                params["blocks"])


def unstack_stage_params(stacked: Params) -> Params:
    """``[S, per, ...]`` -> ``[L, ...]``."""
    return _map(lambda x: x.reshape((x.shape[0] * x.shape[1],)
                                    + tuple(x.shape[2:])), stacked)


def stage_valid_mask(specs: Sequence[StageSpec]) -> torch.Tensor:
    """``[S, per_max]`` bool: True where a stacked row is a real layer,
    False where it is padding."""
    per_max = max(s.n_blocks for s in specs)
    return torch.tensor([[i < s.n_blocks for i in range(per_max)]
                         for s in specs])


def stack_stage_params_padded(params: Params, specs: Sequence[StageSpec],
                              ) -> Tuple[Params, torch.Tensor]:
    """``[L, ...]`` -> ``([S, per_max, ...], stage_valid_mask)``: each
    stage's blocks, zero-padded to the largest stage's count."""
    per_max = max(s.n_blocks for s in specs)

    def pad_stack(x):
        out = x.new_zeros((len(specs), per_max) + tuple(x.shape[1:]))
        for s in specs:
            out[s.index, :s.n_blocks] = x[s.start:s.end]
        return out

    return _map(pad_stack, params["blocks"]), stage_valid_mask(specs)


def unstack_stage_params_padded(stacked: Params,
                                specs: Sequence[StageSpec]) -> Params:
    """``[S, per_max, ...]`` -> ``[L, ...]``, padding rows dropped."""
    return _map(lambda x: torch.cat([x[s.index, :s.n_blocks]
                                     for s in specs]), stacked)


def stack_virtual_chunks(params: Params, n_stages: int,
                         n_virtual: int) -> Params:
    """``[L, ...]`` -> ``[S, v, per_chunk, ...]``: virtual chunk ``g = j *
    S + d`` at ``[d, j]``, so stage d owns every S-th chunk (the Megatron
    interleaved assignment). ``L`` must divide by ``S * v``."""
    def reshape(x):
        total = n_stages * n_virtual
        if x.shape[0] % total:
            raise ValueError(
                f"interleaved stacking needs n_layer divisible by "
                f"pp * virtual_stages = {total}, got {x.shape[0]}")
        per = x.shape[0] // total
        return x.reshape((n_virtual, n_stages, per) + tuple(x.shape[1:])
                         ).transpose(0, 1)

    return _map(reshape, params["blocks"])


def unstack_virtual_chunks(stacked: Params) -> Params:
    """``[S, v, per_chunk, ...]`` -> ``[L, ...]``."""
    return _map(lambda x: x.transpose(0, 1).reshape(
        (-1,) + tuple(x.shape[3:])), stacked)


def stage_blocks(blocks: Params, spec: StageSpec) -> Params:
    """Stage ``spec``'s blocks of a ``[L, ...]`` tree (contiguous
    copies)."""
    return _map(lambda x: x[spec.start:spec.end].contiguous(), blocks)


def virtual_chunks(blocks: Params, n_stages: int, n_virtual: int,
                   stage: int) -> Params:
    """Stage ``stage``'s ``[v, per_chunk, ...]`` chunks of a ``[L, ...]``
    tree (contiguous copies)."""
    return _map(lambda x: x[stage].contiguous(),
                stack_virtual_chunks({"blocks": blocks}, n_stages,
                                     n_virtual))


def blocks_from_stages(stages: Sequence[Params],
                       n_virtual: int = 1) -> Params:
    """Every stage's blocks (``stage_blocks``, or ``virtual_chunks`` when
    ``n_virtual > 1``), in stage order -> the ``[L, ...]`` tree."""
    if n_virtual > 1:
        return unstack_virtual_chunks(
            _zip(lambda *xs: torch.stack(xs), *stages))
    return _zip(lambda *xs: torch.cat(xs), *stages)
