"""Pipelined decode across ranks: one pipeline stage per process.

Counterpart of ``llm_sharding_demo_tpu/parallel/ppdecode.py``. The JAX
package compiles the whole generation into two SPMD programs whose
activation crosses the stage ring by ``ppermute``; here each stage is one
process bound to one device (``parallel.distributed``), and the hand-off
is an explicit send/recv:

- rank s holds stage s's blocks and the KV cache of those blocks; the
  embeddings, the final norm and the head are whole on every rank;
- for the prompt and then for every decode token, stage 0 embeds, each
  stage runs its blocks and hands ``h`` on (``distributed.hop``), the
  last stage applies the head and picks the token, and the token is
  broadcast to every rank;
- a sampled stream is drawn on the last stage from the request's own
  generators: rank 0 sends their states with the request and takes them
  back at its end, so a generator continues from where its draws left
  it, exactly as on one device.

Rank 0 leads: its ``generate`` announces each request to the other ranks
(``distributed.announce``), whose ``follow`` loops make the same calls,
so a batcher in front of rank 0 works unchanged. Ragged left-padded
batches ride per-row ``pad`` masks and position offsets; int8 stages
quantize as the single-device engine does and run the int8 linear and
head kernels. Uneven ``boundaries`` need no padded stacking: each rank
holds only its own blocks.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..models.gpt2 import Params, map_params, unstack_params
from ..ops.quant import quantize_params
from ..runtime.engine import (GenerateResult, Generators, SamplingConfig,
                              eos_chunks, prepare_generate, select_token)
from ..utils import graftmem, graftshard, tracing
from ..utils.device import DeviceLike, regime_of, resolve_device, torch_dtype
from . import distributed
from . import partition as P
from .spmd import axis_rank, axis_size

# Placement contract (utils/graftshard): each rank's stage blocks, split
# over ``pp`` along the layer axis, and the embed/head leaves every stage
# may read, whole on every rank
PLACEMENT_CONTRACT = {
    "mesh_axes": ("pp",),
    "holding:blocks": "pp",
    "holding:shared": "replicated",
}

_SHARED = ("wte", "wpe", "ln_f", "lm_head")


def stage_ring_permutation(n_stages: int) -> list:
    """The (src, dst) stage pairs of one hop along the ring:
    ``[(0, 1), (1, 2), ..., (n_stages - 2, n_stages - 1)]``. A partial
    bijection: the last stage sends nowhere, stage 0 receives nothing."""
    return [(j, j + 1) for j in range(n_stages - 1)]


def _gen_states(generator: Generators):
    """The request's generators as picklable ``(device type, state)``
    pairs (one, or a list with None for rows that draw nothing)."""
    def one(g):
        return None if g is None else (g.device.type, g.get_state())
    if isinstance(generator, (list, tuple)):
        return [one(g) for g in generator]
    return one(generator)


def _rebuild(states, dev: torch.device) -> Generators:
    def one(st):
        if st is None:
            return None
        g = torch.Generator(device=dev if st[0] == "cuda" else "cpu")
        g.set_state(st[1])
        return g
    if isinstance(states, list):
        return [one(st) for st in states]
    return one(states)


def _restore(generator: Generators, states) -> None:
    """Set the caller's generators to the states the last stage left."""
    if isinstance(generator, (list, tuple)):
        for g, st in zip(generator, states):
            if g is not None:
                g.set_state(st[1])
    elif generator is not None:
        generator.set_state(states[1])


class PipelinedDecoder:
    """N-stage pipelined generate, one stage per rank of ``mesh``'s
    ``pp`` axis. Every rank builds it with the same arguments; it keeps
    its own stage. ``dtype`` "float32", "bfloat16" or "int8" (weight-only
    int8 through ``ops.quant``, as in ``runtime.engine``, with the int8
    linear and head kernels on). ``boundaries`` default to balanced
    stages (``partition.balanced_boundaries``)."""

    def __init__(self, params: Params, config, mesh, max_seq: int,
                 dtype="float32", boundaries=None,
                 device: DeviceLike = None):
        if "pp" not in mesh.mesh_dim_names:
            raise ValueError(f"mesh has no 'pp' axis: {mesh.mesh_dim_names}")
        if max_seq > config.n_positions:
            raise ValueError(
                f"max_seq={max_seq} exceeds n_positions={config.n_positions}")
        self.config = config
        self.mesh = mesh
        self.max_seq = max_seq
        # the cache width: the attribute the batcher's gauges read off any
        # engine
        self._cache_seq = max_seq
        self.n_stages = axis_size(mesh, "pp")
        from ..models import is_stage_partitionable
        if not is_stage_partitionable(config):
            raise NotImplementedError(
                f"PipelinedDecoder covers the dense GPT-2 and llama "
                f"families; {type(config).__name__} decodes unstaged")
        self.device = resolve_device(device)
        self.regime = regime_of(dtype)
        self.dtype = torch_dtype(self.regime)
        dev = self.device
        params = map_params(lambda x: x.to(dev), params)
        if self.regime == "int8":
            params = quantize_params(params, self.dtype)
        else:
            params = map_params(lambda x: x.to(self.dtype)
                                if x.is_floating_point() else x, params)
        bounds = (list(boundaries) if boundaries is not None
                  else P.balanced_boundaries(config.n_layer, self.n_stages))
        specs = P.make_stage_specs(config.n_layer, bounds)
        if len(specs) != self.n_stages:
            raise ValueError(
                f"boundaries {bounds} give {len(specs)} stages; the "
                f"mesh's pp axis has {self.n_stages} devices")
        self.specs = specs
        self.stage = axis_rank(mesh, "pp")
        self.spec = specs[self.stage]
        self._group = mesh.get_group("pp")

        # this stage's blocks, copied out of the stack so that the other
        # stages' layers are freed with it
        def own(t):
            out = t[self.spec.start:self.spec.end].clone()
            return graftshard.place(out, t.shape,
                                    [(0, "pp", self.spec.n_blocks)])

        blocks = _map_leaves(own, params["blocks"])
        self.shared = graftshard.replicate(
            {k: params[k] for k in _SHARED if k in params})
        # the stage's parameter view in ``partition.extract_stage_params``
        # form, over the whole shared leaves
        stage = unstack_params({"blocks": blocks})
        if self.spec.is_first:
            stage.update({k: self.shared[k] for k in ("wte", "wpe")
                          if k in self.shared})
        if self.spec.is_last:
            stage["ln_f"] = self.shared["ln_f"]
            if "lm_head" in self.shared:
                stage["lm_head"] = self.shared["lm_head"]
            else:
                stage["wte_out"] = self.shared["wte"]
        self.stage_params = stage
        # int8 stages run the int8 linear and head kernels (plain
        # attention on the plain cache), as the JAX package's int8
        # matmuls take their kernels
        self._model_kernel = "matmul" if self.regime == "int8" else None
        self._lock = threading.Lock()
        self._forward_shapes: collections.Counter = collections.Counter()
        graftmem.track(self, "blocks", "params", blocks)
        graftmem.track(self, "shared", "params", self.shared)

    @property
    def decode_kernel_mode(self) -> str:
        return "xla"

    def forward_shapes(self) -> dict:
        return dict(self._forward_shapes)

    # -- one pipelined forward -------------------------------------------

    def _forward(self, ids: torch.Tensor, cache,
                 pad: Optional[torch.Tensor]):
        """The ids ``[B, S]`` through every stage: returns ``(f32 logits
        [B, S, vocab] on the last stage, None elsewhere; this stage's
        cache one window longer)``."""
        b, s = ids.shape
        self._forward_shapes[(b, s)] += 1
        x = ids
        if not self.spec.is_first:
            x = distributed.hop(None, self.stage - 1, self.stage,
                                (b, s, self.config.n_embd), self.dtype,
                                self.device, self._group)
        y, cache = P.stage_apply(self.stage_params, self.spec, self.config,
                                 x, cache, pad,
                                 decode_kernel=self._model_kernel)
        if self.spec.is_last:
            return y, cache
        distributed.hop(y, self.stage, self.stage + 1, y.shape, self.dtype,
                        self.device, self._group)
        return None, cache

    def _step(self, ids: torch.Tensor, cache, pad: Optional[torch.Tensor],
              sampling: SamplingConfig, generator: Generators):
        """One forward and its token: ``(token [B] on every rank, this
        stage's cache one window longer)``."""
        logits, cache = self._forward(ids, cache, pad)
        if logits is not None:
            token = select_token(logits[:, -1], sampling, generator)
        else:
            token = torch.empty(ids.shape[0], dtype=torch.int64,
                                device=self.device)
        if self.n_stages > 1:
            distributed.broadcast(token, self.n_stages - 1, self._group)
        return token, cache

    @torch.inference_mode()
    def logits(self, prompt_ids, pad: Optional[np.ndarray] = None,
               ) -> Optional[torch.Tensor]:
        """A prompt's f32 logits ``[B, S, vocab]`` through a fresh cache,
        on the last stage (None on the others). Every rank calls it: no
        header is announced (teacher-forced checks)."""
        ids, batch, _, pad = prepare_generate(
            prompt_ids, 1, self.max_seq, SamplingConfig(), None, pad=pad)
        dev = self.device
        cache = P.make_stage_cache(self.spec, self.config, batch,
                                   self._cache_seq, self.dtype, dev)
        pad_t = (torch.as_tensor(pad, dtype=torch.int32, device=dev)
                 if pad.any() else None)
        logits, _ = self._forward(
            torch.as_tensor(ids, dtype=torch.int64, device=dev), cache, pad_t)
        return logits

    # -- generate ----------------------------------------------------------

    @torch.inference_mode()
    def generate(self, prompt_ids, max_new_tokens: int,
                 sampling: SamplingConfig = SamplingConfig(),
                 generator: Generators = None,
                 pad: Optional[np.ndarray] = None,
                 eos_id: Optional[int] = None) -> GenerateResult:
        """The engine's ``generate`` contract, on rank 0: announces the
        request to the other stages and runs its own. ``eos_id`` stops at
        the engine's EOS checks."""
        ids, batch, prompt_len, pad = prepare_generate(
            prompt_ids, max_new_tokens, self.max_seq, sampling, generator,
            pad=pad)
        with self._lock:
            states = (_gen_states(generator)
                      if sampling.mode == "sample" else None)
            if self.n_stages > 1:
                distributed.announce({
                    "op": "generate", "ids": ids, "pad": pad,
                    "steps": max_new_tokens, "sampling": sampling,
                    "states": states, "eos_id": eos_id})
            return self._run(ids, pad, max_new_tokens, sampling, generator,
                             states, eos_id)

    @torch.inference_mode()
    def follow(self) -> int:
        """A follower stage's loop: serve each request rank 0 announces
        until its stop header. Returns the requests served."""
        served = 0
        while True:
            hdr = distributed.await_header()
            if hdr["op"] == "stop":
                return served
            self._run(hdr["ids"], hdr["pad"], hdr["steps"], hdr["sampling"],
                      None, hdr["states"], hdr["eos_id"])
            served += 1

    def stop_followers(self) -> None:
        """Rank 0: end the other stages' ``follow`` loops."""
        if self.n_stages > 1:
            with self._lock:
                distributed.announce({"op": "stop"}, wait_s=30.0)

    def _run(self, ids: np.ndarray, pad: np.ndarray, max_new_tokens: int,
             sampling: SamplingConfig, generator: Generators, states,
             eos_id: Optional[int]) -> GenerateResult:
        dev = self.device
        batch, prompt_len = ids.shape
        last = self.n_stages - 1
        gens = None
        if sampling.mode == "sample" and self.spec.is_last:
            gens = generator if self.stage == 0 else _rebuild(states, dev)
        ids_t = torch.as_tensor(ids, dtype=torch.int64, device=dev)
        pad_t = (torch.as_tensor(pad, dtype=torch.int32, device=dev)
                 if pad.any() else None)
        cache = P.make_stage_cache(self.spec, self.config, batch,
                                   self._cache_seq, self.dtype, dev)
        t0 = time.perf_counter()
        token, cache = self._step(ids_t, cache, pad_t, sampling, gens)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        tracing.record("prefill", t0, t1, batch=batch,
                       prompt_len=prompt_len, stages=self.n_stages)
        parts: List[torch.Tensor] = [token[:, None]]
        done = None if eos_id is None else (token == eos_id)
        if done is None or not bool(done.all()):
            for take in eos_chunks(max_new_tokens - 1):
                for _ in range(take):
                    token, cache = self._step(token[:, None], cache, pad_t,
                                              sampling, gens)
                    parts.append(token[:, None])
                if done is not None:
                    done |= (torch.cat(parts[-take:], dim=1)
                             == eos_id).any(dim=1)
                    if bool(done.all()):
                        break
        new = torch.cat(parts, dim=1).cpu().numpy().copy()
        t2 = time.perf_counter()
        n = new.shape[1]
        tracing.record("decode", t1, t2, batch=batch, steps=n,
                       stages=self.n_stages)
        if (sampling.mode == "sample" and self.n_stages > 1
                and last != 0):
            # the last stage's generator states back to rank 0's caller
            final = distributed.broadcast_object(
                _gen_states(gens) if self.spec.is_last else None, last,
                self._group)
            if self.stage == 0:
                _restore(generator, final)
        return GenerateResult(tokens=np.concatenate([ids, new], axis=1),
                              prompt_len=prompt_len, prefill_seconds=t1 - t0,
                              decode_seconds=t2 - t1, new_tokens=n,
                              decode_steps=n - 1,
                              pad=pad if pad.any() else None)


def _map_leaves(fn, tree):
    """``fn`` over every tensor of a block tree (an int8 leaf's codes and
    scale alike)."""
    from ..ops.quant import QuantizedTensor
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.q), fn(tree.scale), tree.rows)
    return fn(tree)
