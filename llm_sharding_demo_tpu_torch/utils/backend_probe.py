"""Bounded CUDA probe, in a child process.

Counterpart of ``llm_sharding_demo_tpu/utils/backend_probe.py``, whose
probe asks JAX for its default platform. Here a child process under a
hard timeout asks torch for a CUDA device and its name, so that a CUDA
stack that hangs at initialization becomes a reason to report
instead of a hung caller, and the caller's own process touches CUDA only
after a card has answered. There is no CPU fallback: finding no card is
a failure with its reason, never a success on another platform.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Optional, Tuple

_PROBE_CODE = """
import sys
import torch
if not torch.cuda.is_available():
    print("NO_CUDA torch " + torch.__version__ + ", cuda "
          + str(torch.version.cuda))
    sys.exit(3)
print("CUDA_DEVICE=" + torch.cuda.get_device_name(0))
"""


def probe_default_backend(timeout_s: float, attempts: int = 1,
                          backoff_s: float = 0.0,
                          env: Optional[dict] = None,
                          ) -> Tuple[Optional[str], Optional[str]]:
    """``("cuda", device name)`` if a child process finds a CUDA device
    within ``timeout_s``, else ``(None, reason)``: the child hung, exited
    nonzero, or found no device. ``attempts`` / ``backoff_s`` retry with
    a linear backoff (``backoff_s * attempt`` between tries)."""
    env = dict(os.environ if env is None else env)
    reason = "unknown"
    for attempt in range(attempts):
        if attempt:
            time.sleep(backoff_s * attempt)
        tries = f"attempt {attempt + 1}/{attempts}"
        try:
            r = subprocess.run([sys.executable, "-c", _PROBE_CODE],
                               capture_output=True, text=True, env=env,
                               timeout=timeout_s)
        except subprocess.TimeoutExpired:
            reason = f"CUDA probe hung >{timeout_s:g}s ({tries})"
            continue
        out = r.stdout or ""
        if r.returncode == 0 and "CUDA_DEVICE=" in out:
            return "cuda", out.rsplit("CUDA_DEVICE=", 1)[1].strip()
        if "NO_CUDA" in out:
            reason = (f"no CUDA device ({tries}): "
                      + out.rsplit("NO_CUDA", 1)[1].strip())
        else:
            reason = (f"CUDA probe rc={r.returncode} ({tries}): "
                      + (r.stderr or "").strip()[-200:])
    return None, reason
