"""Declared quality budgets for the approximate decode paths.

Counterpart of the part of ``llm_sharding_demo_tpu/utils/graftnum.py``
this slice needs: the ``decode.bf16``, ``decode.int8``, ``kv.int8`` and
``kv.fp8`` entries of ``TOLERANCE_POLICY`` (same numbers), the
teacher-forced comparison behind them, and ``regime_of``, the dtype
vocabulary the paged pool's ``block_dtype`` (``KV_POOL_DTYPE``) is
validated against. ``logit_mse`` caps the mean over scored positions of the
per-position MSE over the vocab (f32 logits); ``top1_agreement`` floors
the fraction of positions whose argmax matches the exact side.

``STACK_POLICY`` and ``compare_stack`` hold the whole-stack decode
kernel (``ops.decode_layer``) against its plain version on the same
inputs; ``FLASH_POLICY`` and ``compare_flash`` the flash-attention
kernels (``ops.flash_attention``) against theirs.
"""

from __future__ import annotations

from typing import Optional

import torch

TOLERANCE_POLICY = {
    # weight-only int8 decode (ops.quant)
    "decode.int8": {"logit_mse": 2e-4, "top1_agreement": 0.90},
    # bf16 decode (matmul operand rounding; LN stats, softmax, logits f32)
    "decode.bf16": {"logit_mse": 5e-5, "top1_agreement": 0.95},
    # quantized KV blocks (runtime.kv_pool block_dtype, ops.kv_quant)
    "kv.int8": {"logit_mse": 2e-6, "top1_agreement": 0.90},
    "kv.fp8": {"logit_mse": 3e-5, "top1_agreement": 0.90},
}

# the declared dtype regimes and their spellings; ``fp8`` is a KV-block
# storage regime only (e4m3fn, ``ops.kv_quant.STORAGE_DTYPES``)
REGIMES = ("f32", "bf16", "int8", "fp8")
_REGIME_ALIASES = {
    "float32": "f32", "f32": "f32",
    "bfloat16": "bf16", "bf16": "bf16",
    "int8": "int8",
    "fp8": "fp8", "float8_e4m3fn": "fp8", "float8_e5m2": "fp8",
}


class GraftnumError(Exception):
    """A tolerance budget was breached; ``report`` holds the numbers."""

    def __init__(self, message: str, report: dict):
        super().__init__(message)
        self.report = report


def regime_of(spelling: str) -> str:
    """A dtype spelling -> its regime token; anything outside the
    vocabulary raises ``GraftnumError``."""
    regime = _REGIME_ALIASES.get(str(spelling))
    if regime is None:
        raise GraftnumError(
            f"dtype {spelling!r} is outside the declared regime vocabulary "
            f"{REGIMES} (spellings: float32/bfloat16/int8/fp8)",
            {"dtype": str(spelling)})
    return regime


def compare(path: str, approx: torch.Tensor, exact: torch.Tensor) -> dict:
    """Score ``approx`` against ``exact`` (both ``[positions, vocab]``
    logits of the same teacher-forced positions) under ``path``'s budget.
    Returns the report; raises ``GraftnumError`` on a breach."""
    policy = TOLERANCE_POLICY[path]
    a, e = approx.float().cpu(), exact.float().cpu()
    if a.shape != e.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(e.shape)}")
    mse = float(((a - e) ** 2).mean(dim=-1).mean())
    agree = float((a.argmax(-1) == e.argmax(-1)).float().mean())
    report = {"path": path, "n_positions": int(a.shape[0]),
              "logit_mse": mse, "top1_agreement": agree,
              "policy": dict(policy)}
    if mse > policy["logit_mse"]:
        raise GraftnumError(f"{path}: logit_mse {mse:.3e} exceeds the cap "
                            f"{policy['logit_mse']:.3e}", report)
    if agree < policy["top1_agreement"]:
        raise GraftnumError(f"{path}: top1_agreement {agree:.4f} below the "
                            f"floor {policy['top1_agreement']:.4f}", report)
    return report


# The whole-stack kernel against its plain version: both round every
# activation to bf16 after f32 sums taken in different orders, so a
# rounding may flip and the flip grows through the layers. ``max_abs``
# caps the largest error relative to the largest output value (four bf16
# ulps). The residual stream carries the input h through unchanged and
# dwarfs one layer's attention branch, so ``rel_rms`` caps, per batch
# row, the RMS error relative to the RMS of what the stack added to h
# (out - h): a wrong attention span or mask shows there. On an H100 80GB
# HBM3 the sound kernel reads up to 1.3% at GPT-2 124M's width, a copy
# with one span state dropped or the pad mask ignored 70% and more
# (tests/test_torch_cuda.py, chip_smoke.py).
STACK_POLICY = {"max_abs": 2.0 ** -5, "rel_rms": 2.0 ** -5}


def compare_stack(out: torch.Tensor, ref: torch.Tensor, h: torch.Tensor,
                  row: Optional[torch.Tensor] = None,
                  row_ref: Optional[torch.Tensor] = None) -> dict:
    """Score a whole-stack output ``out`` against ``ref`` (the plain
    version's), both ``[B, 1, D]`` from input ``h``, under
    ``STACK_POLICY``. With ``row``/``row_ref`` (the cache rows each side
    wrote at the step's offset) the rows are held to the same
    ``max_abs`` bound, relative to their own largest value: a row written
    wrong (say, k without its rotation) only shows in later steps'
    outputs. Returns the report; raises ``GraftnumError`` on a breach or
    a non-finite output."""
    o, r, x = (t.float().reshape(t.shape[0], -1).cpu()
               for t in (out, ref, h))
    err = o - r
    added = (r - x).norm(dim=-1)
    rel = err.norm(dim=-1) / added.clamp_min(torch.finfo(torch.float32).tiny)
    report = {"max_abs_err": float(err.abs().max()),
              "max_abs_limit": STACK_POLICY["max_abs"] * float(r.abs().max()),
              "rel_rms_err": float(rel.max()),
              "rel_rms_limit": STACK_POLICY["rel_rms"],
              "policy": dict(STACK_POLICY)}
    if row is not None:
        rw, rr = row.float().cpu(), row_ref.float().cpu()
        report["row_err"] = float((rw - rr).abs().max())
        report["row_limit"] = STACK_POLICY["max_abs"] * float(rr.abs().max())
    if not bool(torch.isfinite(o).all()):
        raise GraftnumError("stack: non-finite output", report)
    if report["max_abs_err"] > report["max_abs_limit"]:
        raise GraftnumError(
            f"stack: max abs err {report['max_abs_err']:.3e} exceeds "
            f"{report['max_abs_limit']:.3e}", report)
    if report["rel_rms_err"] > STACK_POLICY["rel_rms"]:
        raise GraftnumError(
            f"stack: rms err {report['rel_rms_err']:.3e} of the stack's "
            f"contribution exceeds {STACK_POLICY['rel_rms']:.3e}", report)
    if row is not None and not report["row_err"] <= report["row_limit"]:
        raise GraftnumError(
            f"stack: written cache row err {report['row_err']:.3e} exceeds "
            f"{report['row_limit']:.3e}", report)
    return report


# The flash-attention kernels against their plain versions (out, lse,
# dq, dk, dv), by input dtype: ``max_rel`` caps the largest error
# relative to the largest reference value, ``rms_rel`` the RMS error
# relative to the reference's RMS. float32: the same f32 arithmetic
# summed in another order (up to 4096 terms a sum). bfloat16: besides
# the bf16 inputs and outputs, the kernels round P to bf16 before P.V
# and dS before dS.K and dS^T.Q, as FlashAttention-2 does (2^-9 relative
# a term), where the plain versions keep f32. On an H100 80GB HBM3 the
# sound bf16 kernels read at most 0.61% / 0.27% at llama-124m's shapes,
# copies with the diagonal dropped or D left out of dS 35-177%, the f32
# kernels 7e-7 (tests/test_torch_cuda.py, chip_smoke.py).
FLASH_POLICY = {"float32": {"max_rel": 1e-4, "rms_rel": 1e-5},
                "bfloat16": {"max_rel": 2.0 ** -6, "rms_rel": 2.0 ** -8}}


def compare_flash(name: str, got: torch.Tensor, want: torch.Tensor,
                  dtype: torch.dtype) -> dict:
    """Score one flash-kernel output against its plain version's under
    ``FLASH_POLICY[dtype]``. Returns the report; raises ``GraftnumError``
    on a breach, a shape mismatch or a non-finite value."""
    policy = FLASH_POLICY[str(dtype).replace("torch.", "")]
    g, w = got.detach().float(), want.detach().float()
    if g.shape != w.shape:
        raise GraftnumError(f"{name}: shape {tuple(g.shape)} vs "
                            f"{tuple(w.shape)}", {"name": name})
    err = g - w
    tiny = torch.finfo(torch.float32).tiny
    report = {"name": name,
              "max_abs_err": float(err.abs().max()),
              "max_rel_err": float(err.abs().max()
                                   / w.abs().max().clamp_min(tiny)),
              "rms_rel_err": float(err.pow(2).mean().sqrt()
                                   / w.pow(2).mean().sqrt().clamp_min(tiny)),
              "policy": dict(policy)}
    if not bool(torch.isfinite(g).all()):
        raise GraftnumError(f"{name}: non-finite values", report)
    if not report["max_rel_err"] <= policy["max_rel"]:
        raise GraftnumError(f"{name}: max err {report['max_rel_err']:.3e} of "
                            f"the largest value exceeds {policy['max_rel']:.3e}",
                            report)
    if not report["rms_rel_err"] <= policy["rms_rel"]:
        raise GraftnumError(f"{name}: rms err {report['rms_rel_err']:.3e} "
                            f"exceeds {policy['rms_rel']:.3e}", report)
    return report
