"""The cost-model terms continuous planning reads.

Trimmed counterpart of ``tools/graftcheck/costmodel.py``: what
``utils.graftwatch`` needs to price its plans and to calibrate their
weights, and nothing of the static planner (no tracing, no candidate
enumeration, no verifier):

- ``ICI_BYTE_WEIGHT``, the a-priori cost of one interconnect byte
  against one streamed HBM byte, and ``PAGED_SEG_STEPS``, the iteration
  batcher's segment width (a paged row pays one gather and one scatter
  of its cache a segment);
- the traffic mix: ``TrafficRow``, ``DEFAULT_TRAFFIC`` and
  ``parse_traffic`` (``"16/32x8,64/16"``: 8 concurrent 16-token prompts
  decoding 32, and one 64-token prompt decoding 16);
- ``param_bytes``: the bytes of a family's f32 ``init_params`` tree. The
  JAX package measures the same tree through ``jax.eval_shape``; here the
  port's own ``init_params`` runs under ``FakeTensorMode``, which builds
  shapes and allocates nothing. Both packages score plans with the same
  parameter bytes, whatever dtype the server runs;
- ``kv_cache_bytes``: the ``[L, B, Hkv, max_seq, hd]`` k/v pair of a
  contiguous cache, 4 bytes an element;
- ``CalibrationError`` and ``calibrate``: the interconnect weight a
  bench journal's ``ici_byte_weight_calibration`` row measured (None for
  an absent or skipped row, a typed error for a malformed one).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

# relative cost of one interconnect byte against one streamed HBM byte
ICI_BYTE_WEIGHT = 4.0
# the iteration batcher's segment width: a paged row pays one gather and
# one scatter of its cache a segment
PAGED_SEG_STEPS = 32


@dataclasses.dataclass(frozen=True)
class TrafficRow:
    """One request class: ``count`` concurrent requests of ``prompt_len``
    prompt tokens decoding ``max_new``."""

    prompt_len: int
    max_new: int
    count: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


DEFAULT_TRAFFIC: Tuple[TrafficRow, ...] = (TrafficRow(16, 32, 1),)


def parse_traffic(spec: str) -> Tuple[TrafficRow, ...]:
    """``"16/32x8,64/16"`` -> the rows it names. Elements are
    ``prompt/new[xcount]``, comma-separated."""
    rows: List[TrafficRow] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        shape, _, cnt = part.partition("x")
        p, sep, n = shape.partition("/")
        try:
            row = TrafficRow(int(p), int(n) if sep else 0,
                             int(cnt) if cnt else 1)
        except ValueError as e:
            raise ValueError(
                f"bad traffic element {part!r}: want prompt/new[xcount], "
                f"e.g. 16/32x8") from e
        if row.prompt_len < 1 or row.max_new < 1 or row.count < 1:
            raise ValueError(
                f"bad traffic element {part!r}: prompt/new/count must "
                "all be >= 1")
        rows.append(row)
    if not rows:
        raise ValueError(f"traffic spec {spec!r} names no request shapes")
    return tuple(rows)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


@functools.lru_cache(maxsize=64)
def param_bytes(config) -> int:
    """Bytes of the family's f32 ``init_params`` tree, from its shapes
    alone (``FakeTensorMode``: no storage is allocated)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import family_module
    module = family_module(config)
    with FakeTensorMode():
        tree = module.init_params(config, torch.Generator().manual_seed(0))
        return sum(t.numel() * t.element_size() for t in _leaves(tree))


def kv_cache_bytes(config, batch: int, max_seq: int,
                   dtype_bytes: int = 4) -> int:
    """A contiguous cache's ``[L, B, Hkv, max_seq, hd]`` k/v pair."""
    heads = getattr(config, "n_kv_head", config.n_head)
    return (2 * config.n_layer * batch * heads * max_seq
            * config.head_dim * dtype_bytes)


class CalibrationError(ValueError):
    """A calibration row is present in the journal but unparsable. A
    skipped row (off the card, say) calibrates nothing and is no error;
    a malformed one must not fall back to the a-priori weight in
    silence."""


def config_row(journal, name: str) -> Optional[dict]:
    """The config row ``name`` of a bench journal: a raw payload, one
    wrapped under ``parsed``, or the row itself."""
    doc = journal
    if isinstance(doc, dict) and "parsed" in doc:
        doc = doc.get("parsed")
    if not isinstance(doc, dict):
        return None
    if doc.get("name") == name:
        return doc
    for cfg in doc.get("configs") or ():
        if isinstance(cfg, dict) and cfg.get("name") == name:
            return cfg
    return None


def calibrate(journal) -> Optional[float]:
    """The interconnect byte weight a journal's
    ``ici_byte_weight_calibration`` row measured: the weight it was
    measured against (``ici_byte_weight``, the a-priori one when the row
    omits it) times ``measured_over_modeled``. None when the row is
    absent, skipped or errored; ``CalibrationError`` when it is present
    but malformed."""
    row = config_row(journal, "ici_byte_weight_calibration")
    if row is None or row.get("skipped") or row.get("error"):
        return None
    ratio = row.get("measured_over_modeled")
    if not isinstance(ratio, (int, float)) or isinstance(ratio, bool) \
            or ratio <= 0:
        raise CalibrationError(
            "ici_byte_weight_calibration row is present but its "
            f"measured_over_modeled={ratio!r} is not a positive number "
            "— refusing to fall back silently on a malformed row "
            "(skipped rows calibrate nothing; malformed rows fail "
            "loudly)")
    base = row.get("ici_byte_weight")
    if base is None:
        base = ICI_BYTE_WEIGHT        # older rows omit the base weight
    elif not isinstance(base, (int, float)) or isinstance(base, bool) \
            or base <= 0:
        raise CalibrationError(
            "ici_byte_weight_calibration row is present but its "
            f"ici_byte_weight={base!r} is not a positive number — "
            "the row does not say what weight it was measured against")
    return float(base) * float(ratio)
