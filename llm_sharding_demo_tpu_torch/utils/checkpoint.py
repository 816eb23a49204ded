"""Checkpoint save and restore: the port's own on-disk form.

Counterpart of ``llm_sharding_demo_tpu/utils/checkpoint.py``, with the
same layout idea but ``torch.save`` files in place of Orbax::

    <dir>/config.json          # the family tag, then the config fields
    <dir>/params/wte.pt        # one file per top-level leaf group
    <dir>/params/wpe.pt        #   (wte, wpe, ln_f, lm_head: whichever
    <dir>/params/ln_f.pt       #   the family has)
    <dir>/params/blocks/<i>.pt # one file per layer
    <dir>/train_state/state.pt # save_train_state

``config.json`` is byte-identical to what the JAX package writes for the
same config. In memory the blocks are stacked ``[L, ...]`` leaves; on
disk each layer is its own file, so a pipeline stage reads only its own
layers (``load_stage_params``). Files are read with
``torch.load(weights_only=True, map_location="cpu")`` and leaves keep
their dtype (bf16 stays bf16).

The two packages cannot read each other's checkpoints (Orbax against
``torch.save``); numpy weights are the interchange. The JAX package's
fallback for its legacy stacked Orbax layout has no counterpart: the
port's format has never had a stacked form.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Any, Dict, List, Tuple

import torch

from ..models.gpt2 import GPT2Config, Params, map_params, n_stacked

log = logging.getLogger(__name__)

CONFIG_FILE = "config.json"
PARAMS_DIR = "params"
BLOCKS_DIR = "blocks"
TRAIN_DIR = "train_state"
TRAIN_FILE = "state.pt"
# what a checkpoint directory may hold (``tokenizer``: the assets that
# ``tools.convert_hf`` copies beside the weights)
CHECKPOINT_ENTRIES = {CONFIG_FILE, PARAMS_DIR, TRAIN_DIR, "tokenizer"}


def _config_family(config) -> str:
    """The family tag written before the config fields."""
    from ..models import llama, moe
    if isinstance(config, moe.MoEConfig):
        return "moe"
    if isinstance(config, llama.LlamaConfig):
        return "llama"
    return "gpt2"


def _read(path: str):
    """Every file this module reads goes through here."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _write(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(obj, path)


def _owned(tree):
    """Each tensor leaf with storage of its own: ``torch.save`` writes a
    view's whole underlying storage."""
    return map_params(lambda x: x.detach().cpu().clone(), tree)


def _refuse_foreign(directory: str) -> None:
    """Raise unless ``directory`` is missing, empty or a checkpoint: a
    ``config.json`` and nothing outside ``CHECKPOINT_ENTRIES``."""
    if not os.path.isdir(directory):
        return
    entries = set(os.listdir(directory))
    if entries and (CONFIG_FILE not in entries
                    or entries - CHECKPOINT_ENTRIES):
        raise ValueError(
            f"{directory} is not empty and not a checkpoint (it holds "
            f"{sorted(entries)}); refusing to overwrite it")


def save(directory: str, params: Params, config) -> None:
    """Write the config and the params (one file per leaf group and per
    layer). Overwrites an existing checkpoint, and refuses a non-empty
    directory that is not one before writing anything."""
    directory = os.path.abspath(directory)
    _refuse_foreign(directory)
    os.makedirs(directory, exist_ok=True)
    payload = {"family": _config_family(config), **dataclasses.asdict(config)}
    with open(os.path.join(directory, CONFIG_FILE), "w") as f:
        json.dump(payload, f, indent=2)
    pdir = os.path.join(directory, PARAMS_DIR)
    # an earlier checkpoint's files would otherwise outlive it here
    shutil.rmtree(pdir, ignore_errors=True)
    for name, group in params.items():
        if name != "blocks":
            _write(_owned(group), os.path.join(pdir, f"{name}.pt"))
    blocks = params["blocks"]
    for i in range(n_stacked(blocks)):
        _write(map_params(lambda x, i=i: x[i].detach().cpu().clone(), blocks),
               os.path.join(pdir, BLOCKS_DIR, f"{i}.pt"))


def load_config(directory: str):
    """The config of a checkpoint, of the family its tag names."""
    with open(os.path.join(os.path.abspath(directory), CONFIG_FILE)) as f:
        fields = json.load(f)
    family = fields.pop("family", "gpt2")
    if family == "moe":
        from ..models.moe import MoEConfig
        return MoEConfig(**fields)
    if family == "llama":
        from ..models.llama import LlamaConfig
        return LlamaConfig(**fields)
    if family != "gpt2":
        raise ValueError(f"unknown checkpoint model family {family!r}")
    return GPT2Config(**fields)


def _stack_blocks(paths: List[str]) -> Params:
    """Per-layer files -> stacked ``[L, ...]`` leaves, copied layer by
    layer into preallocated output (peak host memory ~1x the stack plus
    one layer)."""
    first = _read(paths[0])
    out = map_params(lambda x: torch.empty((len(paths),) + tuple(x.shape),
                                           dtype=x.dtype), first)

    def put(i, layer):
        def walk(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    walk(dst[k], src[k])
            else:
                dst[i].copy_(src)
        walk(out, layer)

    put(0, first)
    del first
    for i, path in enumerate(paths[1:], start=1):
        put(i, _read(path))
    return out


def _layer_paths(directory: str, layers) -> List[str]:
    return [os.path.join(directory, PARAMS_DIR, BLOCKS_DIR, f"{i}.pt")
            for i in layers]


_ORDER = ["wte", "wpe", "blocks", "ln_f", "lm_head"]


def _groups(directory: str) -> List[str]:
    """The top-level leaf groups on disk besides the blocks."""
    pdir = os.path.join(directory, PARAMS_DIR)
    names = sorted(f[:-3] for f in os.listdir(pdir) if f.endswith(".pt"))
    unknown = [n for n in names if n not in _ORDER]
    if unknown:
        raise ValueError(f"unknown parameter groups {unknown} in {pdir}")
    return names


def load(directory: str) -> Tuple[Any, Params]:
    """``(config, params)`` with the blocks restacked into ``[L, ...]``
    leaves, on the CPU."""
    directory = os.path.abspath(directory)
    config = load_config(directory)
    params: Params = {}
    # the families' own key order: embeddings, blocks, then the head side
    for name in sorted(_groups(directory) + ["blocks"], key=_ORDER.index):
        params[name] = (
            _stack_blocks(_layer_paths(directory, range(config.n_layer)))
            if name == "blocks"
            else _read(os.path.join(directory, PARAMS_DIR, f"{name}.pt")))
    return config, params


def load_stage_params(directory: str, spec) -> Tuple[Any, Params]:
    """One pipeline stage's parameter subset, reading only its files: its
    layers, plus ``wte`` (and GPT-2's ``wpe``) on the first stage, and
    ``ln_f`` with the head (llama's ``lm_head``, else the tied table as
    ``wte_out``) on the last. The family is read from the files present,
    as ``parallel.partition.extract_stage_params`` reads the tree."""
    directory = os.path.abspath(directory)
    config = load_config(directory)
    groups = _groups(directory)
    llama_tree = "lm_head" in groups
    layers = _layer_paths(directory, range(spec.start, spec.end))
    read = list(layers)

    def group(name):
        path = os.path.join(directory, PARAMS_DIR, f"{name}.pt")
        read.append(path)
        return _read(path)

    out: Params = {"blocks": _stack_blocks(layers)}
    if spec.is_first:
        out["wte"] = group("wte")
        if not llama_tree:
            out["wpe"] = group("wpe")
    if spec.is_last:
        out["ln_f"] = group("ln_f")
        if llama_tree:
            out["lm_head"] = group("lm_head")
        else:
            out["wte_out"] = out["wte"] if spec.is_first else group("wte")
    log.info("stage %d of %d (blocks [%d, %d)) read files %s", spec.index,
             spec.n_stages, spec.start, spec.end,
             json.dumps([os.path.relpath(p, directory) for p in read]))
    return config, out


def save_train_state(directory: str, params: Params,
                     opt_state: Dict[str, Any], step: int) -> None:
    """A mid-training snapshot: params, the optimizer state (``count``,
    ``mu``, ``nu`` of ``training.train.AdamW``) and the caller's step
    counter, under ``<dir>/train_state``. A resumed job continues
    bit-exactly: the moments and the schedule position are part of the
    trajectory."""
    payload = {"params": _owned(params),
               "opt_state": {"count": int(opt_state["count"]),
                             "mu": _owned(opt_state["mu"]),
                             "nu": _owned(opt_state["nu"])},
               "step": int(step)}
    _write(payload, os.path.join(os.path.abspath(directory), TRAIN_DIR,
                                 TRAIN_FILE))


def _onto(template, loaded, where: str):
    """``loaded`` leaves moved onto the template leaves' devices, after
    checking the two trees agree in structure, shape and dtype."""
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(template) != set(loaded):
            raise ValueError(f"train state {where}: keys differ from the "
                             "template")
        return {k: _onto(template[k], loaded[k], f"{where}.{k}")
                for k in template}
    if (tuple(template.shape) != tuple(loaded.shape)
            or template.dtype != loaded.dtype):
        raise ValueError(
            f"train state {where}: {loaded.dtype} {tuple(loaded.shape)} on "
            f"disk, template {template.dtype} {tuple(template.shape)}")
    return loaded.to(template.device)


def load_train_state(directory: str, params_template: Params,
                     opt_state_template: Dict[str, Any],
                     ) -> Tuple[Params, Dict[str, Any], int]:
    """Restore a ``save_train_state`` snapshot as ``(params, opt_state,
    step)``, each leaf on the device of the template's leaf (typically a
    fresh ``TrainStep.init(...)`` result)."""
    got = _read(os.path.join(os.path.abspath(directory), TRAIN_DIR,
                             TRAIN_FILE))
    params = _onto(params_template, got["params"], "params")
    opt = got["opt_state"]
    opt_state = {"count": int(opt["count"]),
                 "mu": _onto(opt_state_template["mu"], opt["mu"], "mu"),
                 "nu": _onto(opt_state_template["nu"], opt["nu"], "nu")}
    return params, opt_state, int(got["step"])
