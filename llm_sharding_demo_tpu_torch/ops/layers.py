"""Elementwise / normalization primitives for the GPT-2 compute path.

Counterpart of ``llm_sharding_demo_tpu/ops/layers.py``: LayerNorm with
float32 statistics, GPT-2's tanh GELU, and the ``[in, out]`` affine map
that dispatches on a weight-only int8 kernel.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .quant import QuantizedTensor, quant_matmul


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing axis: statistics in float32 whatever
    the activation dtype, result cast back to the input dtype. (One
    PyTorch op on the upcast input: the eager decode step runs 25 of
    these, and each separate op costs a launch.)"""
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                        eps).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the trailing axis (the llama family's normalizer):
    statistics in float32, the normalized value cast to the activation
    dtype BEFORE the scale multiply (HF ``LlamaRMSNorm`` order), so a
    bf16 activation is rounded twice."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * scale.to(x.dtype)


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """GPT-2's tanh-approximated GELU (HF ``gelu_new``):
    0.5 * x * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3)))."""
    return F.gelu(x, approximate="tanh")


def linear(x: torch.Tensor, kernel, bias: Optional[torch.Tensor] = None,
           kernels: bool = False) -> torch.Tensor:
    """Affine map with an ``[in, out]`` kernel (HF ``Conv1D`` layout).

    ``kernel`` may be a weight-only int8 ``QuantizedTensor``; ``kernels``
    lets its matmul take the hand-written int8 kernel where it applies
    (``ops.quant.quant_matmul``)."""
    if isinstance(kernel, QuantizedTensor):
        y = quant_matmul(x, kernel, kernels=kernels)
    else:
        y = x @ kernel
    if bias is not None:
        y = y + bias
    return y


def row_linear(x: torch.Tensor, kernel, bias: Optional[torch.Tensor],
               kernels: bool = False, group=None) -> torch.Tensor:
    """``linear`` with a row-parallel kernel (tensor parallelism): ``x``
    and ``kernel`` hold this rank's slice of the contraction, the partial
    products sum over ``group`` (``distributed.reduce_from``: in place
    off the autograd graph, the identity backward in training), and the
    bias, whole on every rank, is added once after the sum. Without a
    group it is ``linear``."""
    if group is None:
        return linear(x, kernel, bias, kernels)
    from ..parallel.distributed import reduce_from
    y = reduce_from(linear(x, kernel, None, kernels), group)
    return y if bias is None else y + bias
