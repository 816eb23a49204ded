"""Process-wide counters, gauges and latency histograms, exposed as
Prometheus text.

Counterpart of ``llm_sharding_demo_tpu/utils/metrics.py``: the registry
calls the runtime makes (``REGISTRY.inc``, ``gauge``, ``observe``), the
``GET /metrics`` exposition (``prometheus``, with the JAX package's
label escaping), the raw histogram buckets the trend reducer burns
against (``histogram_buckets``), ``dump_state``/``restore_state`` for
test isolation, and ``kv_block_gauges``, which states a contiguous KV
arena in the paged pool's block denomination. ``snapshot`` returns the
series by key for callers that read them in process.

``METRIC_CATALOG`` lists every name the port emits with its instrument
kind; each entry is also in the JAX package's catalog. The JAX
package's ``CompileWatch`` and ``jit_program_cache_size`` count jitted
programs; eager PyTorch builds no program per shape, so they have no
counterpart here.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from . import graftsched

# latency buckets (seconds): 1 ms .. 60 s, roughly log-spaced
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# name -> instrument kind: every name the port passes to inc / gauge /
# observe (a test holds the call sites and the JAX catalog to it)
METRIC_CATALOG: Dict[str, str] = {
    # serving (serving/app.py)
    "generate_requests_total": "counter",
    "generated_tokens_total": "counter",
    "upstream_failures_total": "counter",
    "generate_request_seconds": "histogram",
    # the request's latency split, from its span tree: time to first
    # token, and time per decoded token after the first
    "ttft_seconds": "histogram",
    "tpot_seconds": "histogram",
    # graftscope: the host window of every instrumented call, labelled
    # scope; and each decode front end's time a decode step
    "dispatch_seconds": "histogram",
    "decode_step_seconds": "histogram",
    # admission batcher (runtime/batcher.py)
    "decode_batches_total": "counter",
    "batched_requests_total": "counter",
    "batched_rows_padded_total": "counter",
    # iteration batcher (runtime/iterbatch.py)
    "iter_batches_total": "counter",
    "iter_joins_total": "counter",
    "iter_segments_total": "counter",
    "iter_spec_segments_total": "counter",
    "iter_grows_total": "counter",
    "iter_eos_retires_total": "counter",
    "iter_rows_total": "counter",
    "iter_fault_parks_total": "counter",
    # speculation (runtime/spec_decode.py)
    "spec_verify_steps_total": "counter",
    "spec_emitted_tokens_total": "counter",
    "spec_acceptance_rate": "gauge",
    # prefix store (runtime/prefix_cache.py)
    "prefix_cache_hits_total": "counter",
    "prefix_cache_misses_total": "counter",
    "prefix_cache_reused_tokens_total": "counter",
    # paged pool (runtime/kv_pool.py) and its admission gate
    "kv_pool_evictions_total": "counter",
    "kv_pool_cow_copies_total": "counter",
    "kv_pool_preemptions_total": "counter",
    "kv_pool_resumes_total": "counter",
    "kv_pool_admission_rejections_total": "counter",
    # remote dispatch's shard hops and the fleet router's replica hops
    # (graftfault.HopPolicy); the breaker gauge is labelled by target
    "shard_hop_retries_total": "counter",
    "hop_breaker_open": "gauge",
    # the fleet router (serving/router.py): routes per target and role,
    # affinity accounting (ring-owner routes vs fallback placements),
    # typed per-replica sheds met walking the candidates, and prefill
    # hops that degraded to a cold decode-side prefill
    "fleet_requests_total": "counter",
    "fleet_affinity_hits_total": "counter",
    "fleet_affinity_fallbacks_total": "counter",
    "fleet_sheds_total": "counter",
    "fleet_prefill_degraded_total": "counter",
    # accepted requests that died on their X-Deadline-Ms budget (503
    # deadline_exceeded): the source series of the deadline SLO
    "deadline_misses_total": "counter",
    # live state
    "queue_depth": "gauge",
    "batch_occupancy": "gauge",
    "iter_live_rows": "gauge",
    # KV memory in blocks, labelled by the writing component (a pool's
    # pair also by block_dtype), and a pool block's bytes
    "kv_cache_blocks_in_use": "gauge",
    "kv_cache_blocks_total": "gauge",
    "kv_pool_bytes_per_block": "gauge",
    # the host tier (runtime/kv_tier.py), in the same block denomination
    "tier_demotions_total": "counter",
    "tier_promotions_total": "counter",
    "kv_host_blocks_in_use": "gauge",
    "kv_host_blocks_total": "gauge",
    # the memory ledger (utils/graftmem.py): live registered bytes by
    # component, and "total"
    "hbm_bytes": "gauge",
    # the trend reducer (utils/grafttrend.py): one a watch trip; the
    # interconnect byte weight plan scoring uses (grafttrend.refit)
    "trend_alerts_total": "counter",
    "costmodel_byte_weight": "gauge",
    # continuous planning (utils/graftwatch.py): one a live plan switch,
    # labelled from and to; 1 on the active plan's label, 0 on the others
    "plan_switches_total": "counter",
    "auto_plan_active": "gauge",
}

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

    def histogram_buckets(self) -> Dict[str, tuple]:
        """``{name{k=v,...}: (bucket counts, sum, count)}``: bucket ``i``
        spans ``(DEFAULT_BUCKETS[i-1], DEFAULT_BUCKETS[i]]``, the last
        one +Inf. The trend reducer counts the observations past an SLO
        target from these."""
        with self._lock:
            return {_fmt_name(name, labels): (list(c), total, n)
                    for (name, labels), (c, total, n)
                    in self._histograms.items()}

    def dump_state(self) -> tuple:
        with self._lock:
            return (dict(self._counters), dict(self._gauges),
                    {k: [list(v[0]), v[1], v[2]]
                     for k, v in self._histograms.items()})

    def restore_state(self, state: tuple) -> None:
        counters, gauges, histograms = state
        with self._lock:
            self._counters = dict(counters)
            self._gauges = dict(gauges)
            self._histograms = {k: [list(v[0]), v[1], v[2]]
                                for k, v in histograms.items()}

    def prometheus(self) -> str:
        """Prometheus text exposition: one ``# TYPE`` line a name, its
        label sets under it (a repeated TYPE line makes a scraper drop
        the page)."""
        lines: List[str] = []
        seen = set()

        def type_line(name, kind):
            if name not in seen:
                seen.add(name)
                lines.append(f"# TYPE {name} {kind}")

        with self._lock:
            for (name, labels), v in sorted(self._counters.items()):
                type_line(name, "counter")
                lines.append(f"{name}{_prom_labels(labels)} {v}")
            for (name, labels), v in sorted(self._gauges.items()):
                type_line(name, "gauge")
                lines.append(f"{name}{_prom_labels(labels)} {v}")
            for (name, labels), (counts, total, n) in sorted(
                    self._histograms.items()):
                type_line(name, "histogram")
                acc = 0
                for bound, c in zip(DEFAULT_BUCKETS, counts):
                    acc += c
                    lines.append(f"{name}_bucket"
                                 f"{_prom_labels(labels, le=bound)} {acc}")
                acc += counts[-1]
                lines.append(f"{name}_bucket"
                             f"{_prom_labels(labels, le='+Inf')} {acc}")
                lines.append(f"{name}_sum{_prom_labels(labels)} {total}")
                lines.append(f"{name}_count{_prom_labels(labels)} {n}")
        return "\n".join(lines) + "\n"


def _fmt_name(name: str, labels) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _escape_label_value(v) -> str:
    """Backslash, double quote and line feed escaped, as the text format
    requires (an unescaped one invalidates the whole page)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels, le=None) -> str:
    items = list(labels)
    if le is not None:
        items.append(("le", le))
    if not items:
        return ""
    return "{" + ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in items) + "}"


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
