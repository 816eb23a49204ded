"""The declared SLO contracts of the load profiles.

Trimmed counterpart of ``llm_sharding_demo_tpu/loadgen/profiles.py``:
the SLO metric vocabulary, the series each metric is computed from
(``SLO_SOURCE_METRICS``) and each profile's targets (``SLO_POLICY``,
``{metric: (target, percentile)}``; ``deadline_miss`` is a fraction
with its percentile fixed at 100). The trend reducer
(``utils.grafttrend``) burns its SLO watches against them. The profiles
themselves, the schedule and the load generator wait for ROADMAP Queue 1
item 15b.
"""

from __future__ import annotations

SLO_METRICS = ("ttft", "tpot", "e2e", "deadline_miss")

SLO_SOURCE_METRICS = {
    "ttft": "ttft_seconds",
    "tpot": "tpot_seconds",
    "e2e": "generate_request_seconds",
    "deadline_miss": "deadline_misses_total",
}

# seconds (a fraction for deadline_miss), set against the JAX package's
# tiny CPU test model: the contract is which metrics and percentiles
SLO_POLICY = {
    "bursty_chat": {"ttft": (5.0, 95), "tpot": (1.0, 95),
                    "e2e": (60.0, 99)},
    "long_context": {"ttft": (20.0, 95), "e2e": (120.0, 99)},
    "agentic": {"ttft": (2.5, 95), "tpot": (1.0, 95),
                "e2e": (30.0, 99)},
    "abandonment": {"e2e": (60.0, 99), "deadline_miss": (0.05, 100)},
    "cache_buster": {"ttft": (10.0, 95), "e2e": (90.0, 99)},
}


def slo_for(name: str) -> dict:
    """The declared SLO policy of a profile."""
    return SLO_POLICY[name]
