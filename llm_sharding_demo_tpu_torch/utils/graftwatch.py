"""Queue-depth ordering of replicas, for the fleet router.

Trimmed counterpart of ``llm_sharding_demo_tpu/utils/graftwatch.py``:
only ``order_by_queue_depth``, which the router's prefill fan-out
calls (``serving/router.py`` ``FleetRouter.prefill_order``). The rest of
the module (the traffic watcher, continuous re-planning, the plan-set
certifier and ``/debug/plan``) waits for ROADMAP Queue 1 item 15c.
"""

from __future__ import annotations

from typing import Dict, List


def order_by_queue_depth(candidates: List[str],
                         depth_of: Dict[str, int]) -> List[str]:
    """Replica names by their queue-depth estimate, ascending. The sort
    is stable: callers pass the candidates in their deterministic
    fallback order (the consistent-hash ring walk), so an idle fleet
    keeps the ring's placement while a backed-up replica drops behind
    its peers."""
    return sorted(candidates, key=lambda name: depth_of.get(name, 0))
