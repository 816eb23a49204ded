"""Hugging Face GPT-2 / llama weights -> the port's parameter dicts.

Counterpart of ``llm_sharding_demo_tpu/models/hf_convert.py``: the
functions take torch state dicts (or dicts of numpy arrays) and an HF
config object, and return port configs and params; a config or weight
semantics the port's forward does not implement is refused, with the
JAX package's text.

GPT-2's ``Conv1D`` stores its weight ``[in, out]``, the port's kernel
layout, so those copy as they are; llama's ``nn.Linear`` weights are
``[out, in]`` and are transposed. GPT-2's head is tied to ``wte``.

``read_hf_dir`` reads a local HF model directory (``config.json`` and
one ``model.safetensors``, as ``save_pretrained`` writes a small model)
without ``transformers``; ``find_hf_dir`` accepts a path to such a
directory. Nothing is downloaded.
"""

from __future__ import annotations

import json
import os
import struct
import types
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .gpt2 import GPT2Config, Params


def _tensor(t) -> torch.Tensor:
    return t.detach().cpu() if torch.is_tensor(t) else torch.from_numpy(
        np.asarray(t))


def config_from_hf(hf_config: Any) -> GPT2Config:
    """An HF ``GPT2Config`` -> the port's, refusing semantics the forward
    does not implement."""
    if not getattr(hf_config, "tie_word_embeddings", True):
        raise ValueError(
            "untied lm_head is not supported: final_logits ties the head to "
            "wte (GPT-2's actual weight sharing)")
    act = getattr(hf_config, "activation_function", "gelu_new")
    if act != "gelu_new":
        raise ValueError(
            f"activation_function={act!r} not supported; forward hard-wires "
            "gelu_new (ops.layers.gelu_new)")
    if not getattr(hf_config, "scale_attn_weights", True):
        raise ValueError("scale_attn_weights=False not supported: "
                         "causal_attention always scales by 1/sqrt(head_dim)")
    if getattr(hf_config, "scale_attn_by_inverse_layer_idx", False):
        raise ValueError("scale_attn_by_inverse_layer_idx=True not supported")
    if getattr(hf_config, "reorder_and_upcast_attn", False):
        raise ValueError("reorder_and_upcast_attn=True not supported")
    return GPT2Config(
        vocab_size=hf_config.vocab_size,
        n_positions=hf_config.n_positions,
        n_embd=hf_config.n_embd,
        n_layer=hf_config.n_layer,
        n_head=hf_config.n_head,
        layer_norm_epsilon=hf_config.layer_norm_epsilon,
    )


def params_from_state_dict(state_dict: Dict[str, Any], config: GPT2Config,
                           dtype=torch.float32) -> Params:
    """A ``GPT2LMHeadModel.state_dict()`` -> port params, blocks stacked
    on a leading layer axis. Buffers (HF's ``attn.bias`` mask) are
    ignored: the port computes its mask."""

    def get(name: str) -> torch.Tensor:
        return _tensor(state_dict[name]).to(dtype)

    def stack(fmt: str) -> torch.Tensor:
        return torch.stack([get(fmt.format(i))
                            for i in range(config.n_layer)])

    h = "transformer.h.{}."
    return {
        "wte": get("transformer.wte.weight"),
        "wpe": get("transformer.wpe.weight"),
        "blocks": {
            "ln_1": {"scale": stack(h + "ln_1.weight"),
                     "bias": stack(h + "ln_1.bias")},
            "attn": {
                "c_attn": {"kernel": stack(h + "attn.c_attn.weight"),
                           "bias": stack(h + "attn.c_attn.bias")},
                "c_proj": {"kernel": stack(h + "attn.c_proj.weight"),
                           "bias": stack(h + "attn.c_proj.bias")},
            },
            "ln_2": {"scale": stack(h + "ln_2.weight"),
                     "bias": stack(h + "ln_2.bias")},
            "mlp": {
                "c_fc": {"kernel": stack(h + "mlp.c_fc.weight"),
                         "bias": stack(h + "mlp.c_fc.bias")},
                "c_proj": {"kernel": stack(h + "mlp.c_proj.weight"),
                           "bias": stack(h + "mlp.c_proj.bias")},
            },
        },
        "ln_f": {"scale": get("transformer.ln_f.weight"),
                 "bias": get("transformer.ln_f.bias")},
    }


def params_from_hf_model(model: Any, dtype=torch.float32):
    """A torch ``GPT2LMHeadModel`` -> ``(config, params)``."""
    config = config_from_hf(model.config)
    return config, params_from_state_dict(model.state_dict(), config, dtype)


def llama_config_from_hf(hf_config: Any):
    """An HF ``LlamaConfig`` -> the port's; refuses what the llama forward
    does not implement."""
    from .llama import LlamaConfig

    if getattr(hf_config, "tie_word_embeddings", False):
        raise ValueError("tied llama embeddings not supported: the family "
                         "converts a separate lm_head tensor")
    act = getattr(hf_config, "hidden_act", "silu")
    if act != "silu":
        raise ValueError(f"hidden_act={act!r} not supported; the SwiGLU MLP "
                         "hard-wires silu")
    if getattr(hf_config, "rope_scaling", None):
        raise ValueError("rope_scaling not supported: ops.rope implements "
                         "plain RoPE only")
    if getattr(hf_config, "attention_bias", False):
        raise ValueError("attention_bias=True not supported: llama kernels "
                         "are bias-free")
    hd = getattr(hf_config, "head_dim", None)
    derived = hf_config.hidden_size // hf_config.num_attention_heads
    if hd is not None and hd != derived:
        raise ValueError(f"explicit head_dim={hd} != hidden/heads={derived} "
                         "not supported")
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        n_positions=hf_config.max_position_embeddings,
        n_embd=hf_config.hidden_size,
        n_layer=hf_config.num_hidden_layers,
        n_head=hf_config.num_attention_heads,
        n_kv_head=getattr(hf_config, "num_key_value_heads", None)
        or hf_config.num_attention_heads,
        intermediate_size=hf_config.intermediate_size,
        rms_norm_eps=hf_config.rms_norm_eps,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
    )


def llama_params_from_state_dict(state_dict: Dict[str, Any], config,
                                 dtype=torch.float32) -> Params:
    """A ``LlamaForCausalLM.state_dict()`` -> port params (every matmul
    weight transposed to ``[in, out]``)."""

    def get(name: str) -> torch.Tensor:
        return _tensor(state_dict[name]).to(dtype)

    def stack(fmt: str, t: bool = True) -> torch.Tensor:
        return torch.stack([get(fmt.format(i)).t() if t
                            else get(fmt.format(i))
                            for i in range(config.n_layer)]).contiguous()

    L = "model.layers.{}."
    return {
        "wte": get("model.embed_tokens.weight"),
        "blocks": {
            "ln_attn": {"scale": stack(L + "input_layernorm.weight", False)},
            "attn": {
                "wq": {"kernel": stack(L + "self_attn.q_proj.weight")},
                "wk": {"kernel": stack(L + "self_attn.k_proj.weight")},
                "wv": {"kernel": stack(L + "self_attn.v_proj.weight")},
                "wo": {"kernel": stack(L + "self_attn.o_proj.weight")},
            },
            "ln_mlp": {"scale": stack(L + "post_attention_layernorm.weight",
                                      False)},
            "mlp": {
                "gate": {"kernel": stack(L + "mlp.gate_proj.weight")},
                "up": {"kernel": stack(L + "mlp.up_proj.weight")},
                "down": {"kernel": stack(L + "mlp.down_proj.weight")},
            },
        },
        "ln_f": {"scale": get("model.norm.weight")},
        "lm_head": {"kernel": get("lm_head.weight").t().contiguous()},
    }


def llama_params_from_hf_model(model: Any, dtype=torch.float32):
    """A torch ``LlamaForCausalLM`` -> ``(config, params)``."""
    config = llama_config_from_hf(model.config)
    return config, llama_params_from_state_dict(model.state_dict(), config,
                                                dtype)


# -- local HF directories -----------------------------------------------------

_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file as ``{name: tensor}`` (the format is an
    8-byte little-endian header length, a JSON header of dtypes, shapes
    and byte offsets, then the raw tensor bytes)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        begin, end = meta["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[meta["dtype"]]
        flat = (torch.frombuffer(data, dtype=dtype, count=(end - begin)
                                 // torch.empty((), dtype=dtype).element_size(),
                                 offset=begin)
                if end > begin else torch.empty((0,), dtype=dtype))
        out[name] = flat.reshape(meta["shape"]).clone()
    return out


def _read_weights(directory: str) -> Dict[str, torch.Tensor]:
    single = os.path.join(directory, "model.safetensors")
    if not os.path.exists(single):
        raise FileNotFoundError(f"{directory}: no model.safetensors")
    return read_safetensors(single)


def _is_llama(hf_config) -> bool:
    return getattr(hf_config, "model_type", "gpt2") == "llama"


def read_hf_config(directory: str):
    """A local HF directory's ``config.json`` as an attribute namespace
    (what the ``config_from_hf`` functions read)."""
    with open(os.path.join(directory, "config.json")) as f:
        return types.SimpleNamespace(**json.load(f))


def config_from_hf_dir(directory: str):
    """The port config of a local HF GPT-2 or llama directory."""
    hf_config = read_hf_config(directory)
    return (llama_config_from_hf(hf_config) if _is_llama(hf_config)
            else config_from_hf(hf_config))


def read_hf_dir(directory: str) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """A local HF model directory -> ``(config object, state dict)``;
    state-dict names get the ``transformer.`` (GPT-2) or ``model.``
    (llama) prefix that a bare base-model file lacks."""
    hf_config = read_hf_config(directory)
    sd = _read_weights(directory)
    prefix = "model." if _is_llama(hf_config) else "transformer."
    sd = {(k if k.startswith(prefix) or k == "lm_head.weight"
           else prefix + k): v for k, v in sd.items()}
    return hf_config, sd


def convert_hf_dir(directory: str, dtype=torch.float32):
    """A local HF GPT-2 or llama directory -> ``(config, params)``."""
    hf_config, sd = read_hf_dir(directory)
    if _is_llama(hf_config):
        config = llama_config_from_hf(hf_config)
        return config, llama_params_from_state_dict(sd, config, dtype)
    config = config_from_hf(hf_config)
    return config, params_from_state_dict(sd, config, dtype)


def find_hf_dir(model_id: str) -> Optional[str]:
    """``model_id`` when it is a local HF model directory (it holds a
    ``config.json``), else None."""
    if os.path.isfile(os.path.join(model_id, "config.json")):
        return model_id
    return None
