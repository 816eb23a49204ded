"""Device and dtype resolution shared by every entry point.

Entry points run on ``cuda`` unless the caller asks for the CPU
explicitly (``device="cpu"``, as the tests do). Without a GPU and
without that request they raise: nothing quietly carries on on the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]

# engine compute regimes (the JAX package's graftnum vocabulary minus
# fp8, which is a KV-block storage regime there)
_REGIMES = {
    "float32": "float32", "fp32": "float32", "f32": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "int8": "int8",
}
_TORCH_REGIMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                  torch.int8: "int8"}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a GPU); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def regime_of(dtype) -> str:
    """Collapse a dtype spelling (str or torch dtype) to its regime name;
    anything outside float32/bfloat16/int8 raises."""
    if isinstance(dtype, torch.dtype):
        regime: Optional[str] = _TORCH_REGIMES.get(dtype)
    else:
        regime = _REGIMES.get(str(dtype))
    if regime is None:
        raise ValueError(
            f"dtype {dtype!r} is outside the engine regimes "
            "float32|bfloat16|int8")
    return regime


def torch_dtype(regime: str) -> torch.dtype:
    """Activation/cache dtype of a regime (int8 weights run bf16
    activations and a bf16 KV cache)."""
    return torch.float32 if regime == "float32" else torch.bfloat16


def device_scope(device: torch.device):
    """A context making ``device`` current on this thread (a CUDA
    device's index; nothing on the CPU): what a worker thread that owns
    an engine's device work enters."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
