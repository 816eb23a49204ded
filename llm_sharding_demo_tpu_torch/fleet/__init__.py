"""The replica fleet: declared topology contracts
(:mod:`fleet.topology`), placement by the prefix registry's own keys
(:mod:`fleet.affinity`) and the seeded shared-pool harness
(:mod:`fleet.harness`) behind ``serving/router.py``. Counterpart of
``llm_sharding_demo_tpu/fleet``."""

from .affinity import AFFINITY_KEY_SOURCE, HashRing, affinity_key
from .harness import FleetHarness, build_fleet, build_single
from .topology import (FLEET_ROLES, HANDOFF_POLICY, FleetTopology,
                       ReplicaHandle)

__all__ = [
    "AFFINITY_KEY_SOURCE", "FLEET_ROLES", "FleetHarness",
    "FleetTopology", "HANDOFF_POLICY", "HashRing", "ReplicaHandle",
    "affinity_key", "build_fleet", "build_single",
]
