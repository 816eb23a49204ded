"""The fleet router: a prefix-affinity front end for a replica fleet.

Counterpart of ``llm_sharding_demo_tpu/serving/router.py``. The router
fronts replicas split by phase (``fleet/topology.py``): prefill replicas
fill shared pool blocks, decode replicas adopt them zero-copy through
the pool's content-keyed prefix registry. For each request it:

1. **routes by prefix-cache affinity**: the prompt's first-chunk content
   key, the registry's own (``fleet/affinity.py``), picks a decode
   replica off a consistent-hash ring, so requests that share a cached
   prefix land where its blocks are warm; a prompt with no key goes to
   the least loaded replica;
2. **warms the registry** through a prefill replica (``/prefill``) where
   the fleet has one. A failed prefill hop degrades: the decode replica
   prefills cold, and the request does not fail;
3. **sheds per replica**: a 429 or 503 from the chosen replica is typed
   backpressure, so the router falls over to the least loaded other
   decode replica and returns the shed (Retry-After kept) only when
   every candidate refused. Transport failures go through a per-target
   ``graftfault.HopPolicy`` breaker (``hop_breaker_open{target=...}``);
4. **carries X-Deadline-Ms across the hop**: each attempt forwards what
   remains of the budget, so the replica's own deadline checks keep
   enforcing it;
5. **stitches traces**: the replica's span tree (from its flight
   recorder, by the propagated X-Request-ID) is grafted under the
   router's hop span, so ``/debug/requests`` shows one tree a request.

Every cross-replica dispatch goes through ``FleetRouter._hop``, naming a
``HANDOFF_POLICY`` entry; only ``FleetRouter._attempt`` speaks the
replica wire. ``router.replica_hop`` is the seeded fault site of each
attempt (``reset``, ``timeout``, ``http_503``, ``slow``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

from ..fleet.affinity import HashRing, affinity_key
from ..fleet.topology import FleetTopology, ReplicaHandle
from ..utils import graftfault, graftsched, grafttime, graftwatch, tracing
from ..utils.metrics import REGISTRY
from .app import GenerateReq, parse_deadline_header, parse_request_identity
from .http import JSONApp

log = logging.getLogger(__name__)


class _InjectedShed:
    """What an injected ``http_503`` returns: the shape of a real replica
    shed, so the caller's typed shed and fallback path runs (Retry-After
    honoured, breaker untouched), not the transport-retry path a real 503
    never takes."""

    status_code = 503
    text = '{"error": "graftfault_injected_503"}'

    def __init__(self):
        self.headers = {"Retry-After": "1"}

    def json(self):
        return {"error": "graftfault_injected_503",
                "detail": "graftfault: injected replica 503"}


class ReplicaError(RuntimeError):
    """A replica hop failed at the transport level (an exception, or a
    5xx that is not typed backpressure): retried under the hop policy and
    counted against the target's breaker."""

    def __init__(self, target: str, detail: str):
        super().__init__(f"replica {target}: {detail}")
        self.target = target
        self.detail = detail


class FleetRouter:
    """Routing, shedding and stitching state for one fleet topology. The
    per-replica in-flight counts and the affinity accounting are read and
    bumped under one lock; hops run outside it."""

    def __init__(self, topology: FleetTopology, tokenizer,
                 chunk: int = 64, registry=None, recorder=None,
                 hop_policy: Optional[graftfault.HopPolicy] = None):
        if chunk < 1:
            raise ValueError("chunk must be >= 1 (the prefix registry's "
                             "alignment width)")
        self.topology = topology
        self.tokenizer = tokenizer
        self.chunk = chunk
        self.registry = registry if registry is not None else REGISTRY
        self.recorder = (recorder if recorder is not None
                         else tracing.RECORDER)
        self.ring = HashRing([r.name for r in topology.decode_replicas])
        # warm traffic spreads over the prefill replicas by the same
        # consistent hash (a raw byte of the key would not: the keys are
        # little-endian int32 token bytes, so fixed positions are 0)
        self.prefill_ring = (
            HashRing([p.name for p in topology.prefill_replicas])
            if topology.prefill_replicas else None)
        # one policy, a breaker per target (HopPolicy keys its breakers
        # by the shard= label: the replica name, which is also the
        # hop_breaker_open{target=...} label)
        self.policy = hop_policy or graftfault.HopPolicy(
            attempts=2, timeout_s=30.0, base_backoff_s=0.05,
            max_backoff_s=0.5, breaker_threshold=4,
            breaker_cooldown_s=2.0,
            on_retry=lambda target, reason: self.registry.inc(
                "shard_hop_retries_total", stage=target, reason=reason))
        if self.policy.registry is None:
            # the breaker gauges land where this router's /metrics reads,
            # for a caller's policy too
            self.policy.registry = self.registry
        self._lock = graftsched.lock("router.FleetRouter._lock")
        self._inflight: Dict[str, int] = {
            r.name: 0 for r in topology.replicas}
        self.affinity_hits = 0
        self.affinity_fallbacks = 0
        self.sheds = 0

    # -- load accounting ------------------------------------------------------

    def _note_start(self, name: str) -> None:
        with self._lock:
            self._inflight[name] += 1

    def _note_done(self, name: str) -> None:
        with self._lock:
            self._inflight[name] -= 1

    def inflight(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._inflight)

    def _note_affinity(self, hit: bool) -> None:
        with self._lock:
            if hit:
                self.affinity_hits += 1
            else:
                self.affinity_fallbacks += 1

    def _note_shed(self) -> None:
        with self._lock:
            self.sheds += 1

    def affinity_stats(self) -> dict:
        with self._lock:
            return {"hits": self.affinity_hits,
                    "fallbacks": self.affinity_fallbacks,
                    "sheds": self.sheds}

    # -- the hop --------------------------------------------------------------

    def _attempt(self, replica: ReplicaHandle, path: str, payload: dict,
                 headers: Dict[str, str], timeout_s: float):
        """The one wire call: one POST to one replica. In process the
        client ignores ``timeout_s`` (the call is synchronous and the
        in-band X-Deadline-Ms is the bound)."""
        resp = replica.client.post(path, json=payload, headers=headers,
                                   timeout_s=timeout_s)
        if resp.status_code in (500, 502, 504):
            # an untyped replica failure is a transport-class fault:
            # retried and breaker-counted. Typed backpressure (429/503)
            # and request errors (4xx) go back to the caller
            raise ReplicaError(replica.name,
                               f"HTTP {resp.status_code}: {resp.text[:120]}")
        return resp

    def _hop(self, hop: str, replica: ReplicaHandle, path: str,
             payload: dict, headers: Dict[str, str],
             deadline: Optional[graftfault.Deadline]):
        """One declared cross-replica dispatch (``hop`` names its
        ``HANDOFF_POLICY`` entry) through the target's breaker. The
        seeded fault site ``router.replica_hop`` fires before the wire
        call, so the retry and fallback path replays."""
        del hop  # the declaration key
        fwd = dict(headers)

        def attempt(timeout_s: float):
            if deadline is not None:
                # the budget travels in band, recomputed each attempt: a
                # retry after a spent first attempt and a backoff
                # forwards what is left
                fwd["X-Deadline-Ms"] = str(
                    max(1, int(deadline.remaining() * 1e3)))
            kind = graftfault.inject("router.replica_hop", "reset",
                                     "timeout", "http_503", "slow")
            if kind in ("reset", "timeout"):
                raise ReplicaError(replica.name,
                                   f"graftfault: injected hop {kind}")
            if kind == "http_503":
                # typed backpressure, returned as a response: the shed
                # and fallback accounting replays what a real 503 drives
                return _InjectedShed()
            if kind == "slow":
                time.sleep(min(0.02, timeout_s))
            return self._attempt(replica, path, payload, fwd, timeout_s)

        return self.policy.call(attempt, shard=replica.name,
                                deadline=deadline)

    # -- placement ------------------------------------------------------------

    def decode_order(self, key: Optional[bytes]) -> List[ReplicaHandle]:
        """Candidate decode replicas, best first: the ring owner of
        ``key`` (when the prompt has one), then the rest by ascending
        in-flight load, ties broken by name."""
        reps = self.topology.decode_replicas
        load = self.inflight()
        by_load = sorted(reps, key=lambda r: (load.get(r.name, 0), r.name))
        if key is None:
            return by_load
        primary = self.ring.pick(key)
        return ([r for r in reps if r.name == primary]
                + [r for r in by_load if r.name != primary])

    def prefill_order(self, key: Optional[bytes]) -> List[ReplicaHandle]:
        """Candidate prefill replicas, best first: the ring walk from the
        key's owner, reordered (stably) by the router's in-flight counts,
        its view of each replica's backlog
        (``graftwatch.order_by_queue_depth``): an idle fleet keeps the
        ring's placement, a backed-up replica drops behind its peers."""
        prefills = self.topology.prefill_replicas
        if not prefills or self.prefill_ring is None:
            return list(prefills)
        if key is None:
            names = [p.name for p in prefills]
        else:
            primary = self.prefill_ring.pick(key)
            start = next(i for i, p in enumerate(prefills)
                         if p.name == primary)
            names = [p.name for p in prefills[start:] + prefills[:start]]
        ordered = graftwatch.order_by_queue_depth(names, self.inflight())
        by_name = {p.name: p for p in prefills}
        return [by_name[n] for n in ordered]


def create_router_app(topology: FleetTopology, tokenizer,
                      chunk: int = 64, registry=None, recorder=None,
                      hop_policy=None) -> JSONApp:
    """The router's serving surface. ``tokenizer`` must be the replicas'
    (affinity keys are token-content keys) and ``chunk`` their prefix
    stores' width."""
    router = FleetRouter(topology, tokenizer, chunk=chunk,
                         registry=registry, recorder=recorder,
                         hop_policy=hop_policy)
    reg = router.registry
    rec = router.recorder
    app = JSONApp(title="llm-sharding-demo-tpu-torch-router",
                  version="0.1.0")
    app.router = router  # harness and test introspection
    identity = {"role": "router", "replicas": topology.describe()}

    @app.get("/metrics")
    def metrics():
        return reg.prometheus()

    @app.get("/healthz")
    def healthz():
        return {
            "status": "ok",
            "role": "router",
            "replicas": topology.describe(),
            "chunk": router.chunk,
            "inflight": router.inflight(),
            "breakers": {r.name: router.policy.breaker_state(r.name)
                         for r in topology.replicas},
            "affinity": router.affinity_stats(),
        }

    @app.get("/debug/requests")
    def debug_requests(query: dict):
        """One joined tree a request: the router's spans and the
        replica's grafted subtree (the replica view's filters)."""
        return tracing.debug_requests_payload(rec, query, identity)

    @app.get("/debug")
    def debug_index():
        return {
            "serving": identity,
            "surfaces": {
                "/debug/requests": (
                    "joined router+replica span trees per request "
                    "(?n, ?slowest=1, ?errors=1, ?profile=)"),
                "/debug/timeline": (
                    "grafttime unified causal event stream "
                    "(?rid=, ?since=, ?kinds=, ?n=)"),
            },
        }

    @app.get("/debug/timeline")
    def debug_timeline(query: dict):
        """The timeline at the router. In process the router and every
        replica share one bus, so one clock: ``clock_alignment`` reports
        offset 0 (a wire deployment would rebase each replica's stream
        by its hop's start, ``grafttime.rebase``)."""
        payload = grafttime.debug_timeline_payload(query, identity)
        if isinstance(payload, dict):
            payload["clock_alignment"] = {
                "mode": "shared-process-clock", "offset_ms": 0.0}
        return payload

    @app.post("/generate")
    def generate(req: GenerateReq, headers: dict):
        # the router's label on every event of the request
        with grafttime.use_replica("router"):
            return _generate(req, headers)

    def _prefill_hop(req: GenerateReq, key: bytes, fwd: dict,
                     deadline, trace: tracing.RequestTrace,
                     rid: str) -> None:
        """Warm the registry (router->prefill). A dead replica falls over
        to the next prefill replica (the registry is shared, so any can
        warm); a typed shed does not (the pool is shared, so every
        replica sees the same saturation). No warm counts one degraded
        request: the decode replica prefills cold."""
        for p in router.prefill_order(key):
            t0 = time.perf_counter()
            try:
                router._note_start(p.name)
                try:
                    resp = router._hop("router->prefill", p, "/prefill",
                                       {"prompt": req.prompt}, fwd,
                                       deadline)
                finally:
                    router._note_done(p.name)
            except graftfault.DeadlineExceeded:
                raise
            except (ReplicaError, graftfault.Unavailable) as e:
                log.warning("prefill hop failed on %s: %s", p.name, e)
                trace.add_span("prefill_hop", t0, time.perf_counter(),
                               target=p.name, degraded=str(e)[:120])
                continue
            if resp.status_code != 200:
                # a typed shed or a request error is not a warm
                trace.add_span("prefill_hop", t0, time.perf_counter(),
                               target=p.name,
                               degraded=f"http_{resp.status_code}")
                break
            reg.inc("fleet_requests_total", target=p.name, role="prefill")
            _graft_replica(trace, "prefill_hop", p, rid, resp, t0,
                           time.perf_counter())
            return
        reg.inc("fleet_prefill_degraded_total")

    def _generate(req: GenerateReq, headers: dict):
        rid, profile_label = parse_request_identity(headers)
        fwd = {"X-Request-ID": rid}
        if profile_label is not None:
            fwd["X-Workload-Profile"] = profile_label
        hdrs = {"X-Request-ID": rid}

        def out(body, status=200):
            return status, body, hdrs

        deadline, _dl_ms, dl_err = parse_deadline_header(headers)
        if dl_err:
            return out({"error": dl_err}, status=400)

        trace = tracing.RequestTrace(rid, fleet="router", mode=req.mode)
        if profile_label is not None:
            trace.labels.update(profile=profile_label)

        with trace.span("tokenize"):
            prompt_ids = tokenizer.encode(req.prompt)
        if not prompt_ids:
            # the reference's 200 with an error, flight-recorded
            trace.labels.update(error="prompt tokenized to zero tokens")
            rec.record(trace)
            return out({"error": "prompt tokenized to zero tokens"})
        key = affinity_key(prompt_ids, router.chunk)
        body = dataclasses.asdict(req)

        try:
            if topology.prefill_replicas and key is not None:
                _prefill_hop(req, key, fwd, deadline, trace, rid)

            # router->decode: the affinity owner first, the least loaded
            # next on a typed shed or an open breaker
            last_shed = None          # (status, body, Retry-After)
            last_unavailable = None
            resp = None
            target = None
            for i, r in enumerate(router.decode_order(key)):
                if deadline is not None:
                    deadline.raise_if_expired("route to decode replica")
                t0 = time.perf_counter()
                router._note_start(r.name)
                try:
                    resp = router._hop("router->decode", r, "/generate",
                                       body, fwd, deadline)
                except graftfault.DeadlineExceeded:
                    raise
                except (ReplicaError, graftfault.Unavailable) as e:
                    last_unavailable = e
                    trace.add_span("decode_hop", t0, time.perf_counter(),
                                   target=r.name, failed=str(e)[:120])
                    resp = None
                    continue
                finally:
                    router._note_done(r.name)
                if resp.status_code in (429, 503):
                    shed_body = resp.json()
                    if shed_body.get("error") == "deadline_exceeded":
                        # the request's own budget died on the replica:
                        # no other replica can save it
                        hdrs["Retry-After"] = (
                            resp.headers.get("Retry-After") or "1")
                        trace.add_span("decode_hop", t0,
                                       time.perf_counter(),
                                       target=r.name,
                                       deadline_exceeded=True)
                        trace.labels.update(error="deadline_exceeded")
                        rec.record(trace)
                        return out(shed_body, status=resp.status_code)
                    router._note_shed()
                    reg.inc("fleet_sheds_total", target=r.name,
                            code=str(resp.status_code))
                    last_shed = (resp.status_code, shed_body,
                                 resp.headers.get("Retry-After"))
                    trace.add_span("decode_hop", t0, time.perf_counter(),
                                   target=r.name, shed=resp.status_code)
                    resp = None
                    continue
                target = r
                reg.inc("fleet_requests_total", target=r.name,
                        role="decode")
                rep_tree = _graft_replica(trace, "decode_hop", r, rid,
                                          resp, t0, time.perf_counter())
                # a 4xx or the reference's 200 with an error completed
                # the route but served nothing: out of the affinity
                # accounting, labelled on the trace
                err = (resp.json().get("error")
                       if resp.status_code != 200
                       or "error" in resp.json() else None)
                if err is not None:
                    trace.labels.update(error=str(err)[:120])
                else:
                    # the replica's summary labels on the router's trace
                    # (the load driver joins by this recorder), TTFT on
                    # the router's clock: its time before the hop plus
                    # the replica's first-token latency
                    rl = (rep_tree or {}).get("labels", {})
                    if "ttft_ms" in rl:
                        trace.labels.update(ttft_ms=round(
                            (t0 - trace.t0) * 1e3
                            + float(rl["ttft_ms"]), 3))
                    for lk in ("new_tokens", "prompt_tokens",
                               "finish_reason"):
                        if lk in rl:
                            trace.labels.setdefault(lk, rl[lk])
                    hit = key is not None and i == 0
                    router._note_affinity(hit)
                    if hit:
                        reg.inc("fleet_affinity_hits_total")
                    else:
                        reg.inc("fleet_affinity_fallbacks_total",
                                reason="no_key" if key is None
                                else "fallback")
                break

            if resp is None:
                # every decode replica refused: the typed shed, with its
                # Retry-After (a saturated fleet is backpressure)
                if last_shed is not None:
                    status, payload, retry = last_shed
                    hdrs["Retry-After"] = retry or "1"
                    trace.labels.update(error=payload.get(
                        "error", f"shed_{status}"))
                    rec.record(trace)
                    return out(payload, status=status)
                e = last_unavailable
                retry = getattr(e, "retry_after", 1.0)
                hdrs["Retry-After"] = str(max(1, int(round(retry))))
                trace.labels.update(error="fleet_unavailable")
                rec.record(trace)
                return out({"error": "fleet_unavailable",
                            "detail": str(e)}, status=503)
        except graftfault.Unavailable as e:
            hdrs["Retry-After"] = str(max(1, int(round(e.retry_after))))
            if e.code == "deadline_exceeded":
                reg.inc("deadline_misses_total")
            trace.labels.update(error=e.code)
            rec.record(trace)
            # the events that led here outlive the ring
            grafttime.blackbox(e.code, rid=rid)
            return out({"error": e.code, "detail": str(e)}, status=503)

        trace.labels.update(target=target.name, status=resp.status_code)
        trace.finish()
        rec.record(trace)
        if "Retry-After" in resp.headers:
            hdrs["Retry-After"] = resp.headers["Retry-After"]
        return out(resp.json(), status=resp.status_code)

    return app


def _graft_replica(trace: tracing.RequestTrace, name: str,
                   replica: ReplicaHandle, rid: str, resp,
                   t0: float, t1: float) -> Optional[dict]:
    """Stitch the replica's span tree under a hop span (in process the
    replica's flight recorder is on its handle); a missing recorder or an
    evicted entry leaves a bare hop span. Returns the replica's trace, so
    the caller can lift its summary labels."""
    payload = None
    if replica.recorder is not None:
        payload = replica.recorder.find(rid)
    trace.graft(name, payload, t0, t1, target=replica.name,
                status=resp.status_code)
    return payload
