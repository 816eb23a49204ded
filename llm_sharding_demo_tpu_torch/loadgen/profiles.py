"""Workload profiles and their declared SLO contracts.

Counterpart of ``llm_sharding_demo_tpu/loadgen/profiles.py``. A profile
describes one traffic shape: how requests arrive (an open-loop rate
process), what they look like (prompt length, shared-prefix structure,
decode budget) and how callers behave (deadline budgets, walk-aways).
The schedule drawn from a profile is a pure function of ``(seed,
profile, k)`` (``loadgen.schedule``).

Each profile declares its SLOs in ``SLO_POLICY`` as ``{metric: (target,
percentile)}`` over ``SLO_METRICS``: ``ttft`` (time to first token),
``tpot`` (time per output token) and ``e2e`` (whole request), in seconds
at the declared percentile of completed requests, and ``deadline_miss``,
the largest tolerated fraction of demanded requests that die on their
deadline (percentile fixed at 100). ``SLO_SOURCE_METRICS`` names the
series each is computed from. Typed sheds (429, 503) are not SLO
misses: ``loadgen.driver`` counts them apart. The trend reducer
(``utils.grafttrend``) burns its SLO watches against the same policy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

SLO_METRICS = ("ttft", "tpot", "e2e", "deadline_miss")

SLO_SOURCE_METRICS = {
    "ttft": "ttft_seconds",
    "tpot": "tpot_seconds",
    "e2e": "generate_request_seconds",
    "deadline_miss": "deadline_misses_total",
}


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    """One declared traffic shape. All rates are at scale 1.0 against
    the tiny bench/test model; drivers scale with ``rate_scale``."""

    name: str
    description: str
    # arrival process: "poisson" (memoryless open loop) or "bursty"
    # (burst-start gaps at rate/burst, near-zero intra-burst gaps —
    # the arrival clumping that makes closed-loop generators lie)
    arrival: str = "poisson"
    rate_rps: float = 4.0
    burst: int = 1                     # mean burst size (bursty only)
    prompt_len: Tuple[int, int] = (8, 24)
    max_new: Tuple[int, int] = (8, 16)
    # shared-prefix structure: each request's prompt starts with one of
    # ``prefix_pool`` deterministic shared prefixes of
    # ``shared_prefix_len`` chars (0 = no shared structure). Deep
    # shared prefixes exercise the prefix store + CoW machinery.
    shared_prefix_len: int = 0
    prefix_pool: int = 1
    # prefix depth: > 0 overrides prefix_pool as the count of distinct
    # deterministic shared prefixes the schedule draws from — the
    # grafttier driver, letting a run touch a prefix population deeper
    # than the device pool can hold so cold entries demote to the host
    # tier. 0 keeps the prefix_pool draw: schedules are byte-identical
    # to before the knob existed (replay purity pin).
    prefix_depth: int = 0
    # cache busting: every request gets a UNIQUE leading prefix, so any
    # content-keyed reuse (prefix store) whiffs by construction
    cache_busting: bool = False
    # caller behavior: an optional X-Deadline-Ms budget on every
    # request, and a fraction of requests that "walk away" mid-stream
    # by carrying ``abandon_after_ms`` as their budget instead (the
    # graftfault deadline-cancellation boundary: the row is cancelled
    # at the next segment boundary with its blocks freed)
    deadline_ms: Optional[int] = None
    abandon_rate: float = 0.0
    abandon_after_ms: int = 40
    mode: str = "greedy"               # greedy keeps replay byte-exact


# the registered profiles
PROFILES = {
    "bursty_chat": WorkloadProfile(
        name="bursty_chat",
        description="chat bursts over deep shared system prompts "
                    "(prefix store + CoW exercise; arrival clumping)",
        arrival="bursty", rate_rps=6.0, burst=4,
        prompt_len=(24, 48), max_new=(8, 16),
        shared_prefix_len=20, prefix_pool=3),
    "long_context": WorkloadProfile(
        name="long_context",
        description="long-context summarization: big prompts, short "
                    "answers (prefill-dominated, pool-block heavy)",
        arrival="poisson", rate_rps=1.5,
        prompt_len=(96, 160), max_new=(4, 8),
        shared_prefix_len=32, prefix_pool=2),
    "agentic": WorkloadProfile(
        name="agentic",
        description="agent loops: many short turns at high rate "
                    "(queueing + admission churn)",
        arrival="poisson", rate_rps=10.0,
        prompt_len=(4, 12), max_new=(4, 8),
        shared_prefix_len=8, prefix_pool=2),
    "abandonment": WorkloadProfile(
        name="abandonment",
        description="mid-stream abandonment: a slice of callers walk "
                    "away on a short deadline budget (segment-boundary "
                    "cancellation + block reclamation under load)",
        arrival="poisson", rate_rps=5.0,
        prompt_len=(12, 32), max_new=(12, 24),
        deadline_ms=60_000, abandon_rate=0.3, abandon_after_ms=40),
    "cache_buster": WorkloadProfile(
        name="cache_buster",
        description="adversarial cache-busting prompts: unique "
                    "prefixes defeat content-keyed reuse, every "
                    "request pays a cold prefill",
        arrival="poisson", rate_rps=4.0,
        prompt_len=(16, 40), max_new=(8, 16),
        cache_busting=True),
}

# seconds (a fraction for deadline_miss), set against the tiny CPU demo
# model: the contract is which metrics and percentiles
SLO_POLICY = {
    "bursty_chat": {"ttft": (5.0, 95), "tpot": (1.0, 95),
                    "e2e": (60.0, 99)},
    "long_context": {"ttft": (20.0, 95), "e2e": (120.0, 99)},
    "agentic": {"ttft": (2.5, 95), "tpot": (1.0, 95),
                "e2e": (30.0, 99)},
    "abandonment": {"e2e": (60.0, 99), "deadline_miss": (0.05, 100)},
    "cache_buster": {"ttft": (10.0, 95), "e2e": (90.0, 99)},
}


def profile(name: str) -> WorkloadProfile:
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown workload profile {name!r}; registered: "
                       f"{sorted(PROFILES)}") from None


def slo_for(name: str) -> dict:
    """The declared SLO policy of a profile."""
    return SLO_POLICY[name]
