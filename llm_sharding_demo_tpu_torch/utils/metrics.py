"""Process-wide counters, gauges and latency histograms.

Trimmed counterpart of ``llm_sharding_demo_tpu/utils/metrics.py``: the
registry calls the batchers make (``REGISTRY.inc``, ``gauge``,
``observe``) and ``kv_block_gauges``, which states a contiguous KV arena
in the paged pool's block denomination. The Prometheus exposition
(``/metrics``) and the compile watch wait for ROADMAP Queue 1 item 15;
``snapshot`` lets a caller read the series meanwhile.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from . import graftsched

DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# block width in which contiguous (non-pooled) KV arenas are reported
DEFAULT_KV_BLOCK_SIZE = 16

_Key = Tuple[str, Tuple[Tuple[str, str], ...]]


class MetricsRegistry:
    def __init__(self):
        self._lock = graftsched.lock("metrics.MetricsRegistry._lock")
        self._counters: Dict[_Key, float] = {}
        self._gauges: Dict[_Key, float] = {}
        self._histograms: Dict[_Key, List] = {}

    @staticmethod
    def _key(name: str, labels: Dict[str, str]) -> _Key:
        return name, tuple(sorted((k, str(v)) for k, v in labels.items()))

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set a gauge to its current value (last write wins)."""
        key = self._key(name, labels)
        with self._lock:
            self._gauges[key] = float(value)

    def observe(self, name: str, seconds: float, **labels) -> None:
        key = self._key(name, labels)
        with self._lock:
            hist = self._histograms.setdefault(
                key, [[0] * (len(DEFAULT_BUCKETS) + 1), 0.0, 0])
            hist[0][bisect.bisect_left(DEFAULT_BUCKETS, seconds)] += 1
            hist[1] += seconds
            hist[2] += 1

    def snapshot(self) -> Dict[str, Dict[_Key, object]]:
        """Copies of every series: counters and gauges by key, histograms
        as ``(bucket counts, sum, count)``."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "histograms": {k: (list(v[0]), v[1], v[2])
                                   for k, v in self._histograms.items()}}


REGISTRY = MetricsRegistry()


def kv_block_gauges(component: str, used_slots: int, total_slots: int,
                    block_size: int = DEFAULT_KV_BLOCK_SIZE,
                    registry: MetricsRegistry = None) -> None:
    """Set the ``kv_cache_blocks_*`` gauge pair of a component that holds
    contiguous slot arenas (solo engine, admission batcher, iteration
    batcher on contiguous caches): slots converted to blocks, rounded
    up."""
    reg = registry or REGISTRY
    reg.gauge("kv_cache_blocks_in_use",
              -(-int(used_slots) // block_size) if used_slots > 0 else 0,
              component=component)
    reg.gauge("kv_cache_blocks_total",
              -(-int(total_slots) // block_size) if total_slots > 0 else 0,
              component=component)
