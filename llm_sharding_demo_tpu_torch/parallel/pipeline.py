"""Pipeline runner: the stages run one after another, handing the hidden
state on.

Counterpart of ``llm_sharding_demo_tpu/parallel/pipeline.py`` and, as
there, the default fp32 single-stream ``/generate`` runner. It is the
staged ``DecodeEngine`` on its plain path: it runs no hand-written
kernel, as the JAX runner runs no Pallas kernel. Every stage lives on
one device here; ``parallel.ppdecode`` places one stage on each rank of
a process group (``PP_DECODE``), and ``parallel.gpipe`` and
``parallel.pipeline_1f1b`` train one.
"""

from __future__ import annotations

from typing import Sequence

from ..models.gpt2 import Params
from .partition import Config
from ..runtime.engine import DecodeEngine
from ..utils.device import DeviceLike, regime_of


class PipelineRunner(DecodeEngine):
    """N pipeline stages, composed in order on ``device``."""

    def __init__(self, params: Params, config: Config,
                 boundaries: Sequence[int], max_seq: int,
                 dtype="float32", device: DeviceLike = None):
        if regime_of(dtype) == "int8":
            raise ValueError(
                "weight-only int8 quantization lives in runtime.engine."
                "DecodeEngine (a cast here would truncate floats to "
                "garbage integers, not quantize)")
        super().__init__(params, config, max_seq, dtype=dtype,
                         boundaries=list(boundaries), decode_kernel="xla",
                         device=device)
