"""Seeded open-loop load generation and the declared SLO contracts.

Counterpart of ``llm_sharding_demo_tpu/loadgen``: workload profiles and
their SLOs (``profiles``), schedules that are pure functions of
``(seed, profile, k)`` (``schedule``), and the driver that fires them at
an in-process app and reduces the outcomes (``driver``).
"""

from .driver import (Outcome, occupancy_summary, pareto_row,  # noqa: F401
                     run_load, slo_row, summarize, traffic_mix_row)
from .profiles import (PROFILES, SLO_METRICS, SLO_POLICY,  # noqa: F401
                       SLO_SOURCE_METRICS, WorkloadProfile, profile,
                       slo_for)
from .schedule import (Arrival, arrival_fields, schedule,  # noqa: F401
                       schedule_bytes, shared_prefix)

__all__ = [
    "Arrival", "Outcome", "PROFILES", "SLO_METRICS", "SLO_POLICY",
    "SLO_SOURCE_METRICS", "WorkloadProfile", "arrival_fields",
    "occupancy_summary", "pareto_row", "profile", "run_load",
    "schedule", "schedule_bytes", "shared_prefix", "slo_for",
    "slo_row", "summarize", "traffic_mix_row",
]
