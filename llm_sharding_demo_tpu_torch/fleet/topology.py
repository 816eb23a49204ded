"""The fleet's declared replica roles and hop contracts.

Counterpart of ``llm_sharding_demo_tpu/fleet/topology.py``. A fleet is a
router in front of replicas split by phase:

- **prefill replicas** run prompt prefills and fill pool blocks: the
  chunk-aligned prefix states land in the shared pool's content-keyed
  prefix registry (``BlockAllocator.register_prefix`` through
  ``PrefixCachingEngine``), where the entries hold their own refs;
- **decode replicas** adopt those blocks zero-copy: a ``/generate``
  whose prompt prefix is registered references the registry's blocks in
  its own table (``prefill_shared``) and copies only the partly filled
  frontier block on write;
- the **router** (``serving/router.py``) routes by prefix-cache
  affinity over the registry's own content keys (``fleet/affinity.py``),
  sheds per replica through the 429/503 + Retry-After paths, and
  carries X-Deadline-Ms across the extra hop.

``FLEET_ROLES`` is the role vocabulary; ``HANDOFF_POLICY`` has one entry
per cross-replica hop, ``{hop: (from_role, to_role, what crosses and who
owns the blocks)}``, and every router dispatch names one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

FLEET_ROLES = {
    "router": "fleet front end: affinity routing, per-replica "
              "breakers/shedding, deadline propagation, trace stitching",
    "prefill": "runs prompt prefills and fills shared pool blocks via "
               "the content-keyed prefix registry (/prefill)",
    "decode": "serves /generate, adopting registered prefix blocks "
              "zero-copy via prefill_shared (block handoff, no copy)",
}

HANDOFF_POLICY = {
    "router->prefill": (
        "router", "prefill",
        "only the prompt crosses; the prefill replica fills pool "
        "blocks and the registry takes its OWN refs (register_prefix) "
        "— the replica's transient caller refs are released before "
        "the response, so the hop hands off zero live leases"),
    "router->decode": (
        "router", "decode",
        "only the request crosses; the decode replica adopts "
        "registered blocks by reference (lookup_prefix caller refs in "
        "its own table, frontier block CoW'd before first write) and "
        "frees them at retirement — block handoff, never tensor copy"),
}


@dataclasses.dataclass
class ReplicaHandle:
    """One fleet member as the router sees it: a name (the breaker,
    metric and trace target label), a declared role, a client speaking
    the serving wire (``serving/http.py`` ``TestClient`` in process),
    and, in process, the replica's flight recorder, from which the
    router stitches the replica's span tree into the request's own."""

    name: str
    role: str
    client: object
    recorder: Optional[object] = None
    # the replica's own app (harness and test introspection; the router
    # never touches it)
    app: Optional[object] = None


class FleetTopology:
    """Validated replica set: at least one decode replica, unique
    names, every role registered in ``FLEET_ROLES``."""

    def __init__(self, replicas: List[ReplicaHandle]):
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {sorted(names)}")
        for r in replicas:
            if r.role not in FLEET_ROLES:
                raise ValueError(
                    f"replica {r.name!r} carries unregistered role "
                    f"{r.role!r} (FLEET_ROLES: {sorted(FLEET_ROLES)})")
            if r.role == "router":
                raise ValueError(
                    "the router fronts the topology; it is not a "
                    "member replica")
        self.replicas = list(replicas)
        if not self.decode_replicas:
            raise ValueError("a fleet needs at least one decode replica "
                             "(who would serve /generate?)")

    @property
    def decode_replicas(self) -> List[ReplicaHandle]:
        return [r for r in self.replicas if r.role == "decode"]

    @property
    def prefill_replicas(self) -> List[ReplicaHandle]:
        return [r for r in self.replicas if r.role == "prefill"]

    def by_name(self, name: str) -> ReplicaHandle:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(name)

    def describe(self) -> dict:
        """The ``/healthz`` topology block: names by role."""
        return {
            "decode": [r.name for r in self.decode_replicas],
            "prefill": [r.name for r in self.prefill_replicas],
        }
