"""The port's fleet against the JAX package's, on the same weights.

One JAX fleet and one port fleet (router, one prefill replica, two
decode replicas over one shared pool; the port's on the CPU, fp32, with
the JAX ``demo_model`` weights through numpy) are built once for the
module and driven with the same serial ``bursty_chat`` schedule (seed 6,
10 requests) under the same in-process fault plan (seed 9, rate 0.08 at
``serving.admission`` and ``router.replica_hop``) installed in each
package. Held equal: each request's status, error code and ``generated``
text, the plan's injections, the router's affinity accounting, its
``/healthz`` topology, breaker and affinity blocks, its counters, and
the stitched span trees; then ``/prefill`` answers (wrong role, empty,
short and overlong prompts, a spent deadline, a saturated pool).

Also: the topology's validation errors, affinity keys and ring owners,
``FLEET_ROLE`` validation and the injected pool's refusals, each beside
the JAX package's; and on port fleets of their own: a breaker opening
per target, a dead prefill replica degrading to a 200, and the pool's
conservation after an open-loop run under ``GRAFTSAN=1``.
"""

import re
import time

import jax
import numpy as np
import pytest

from llm_sharding_demo_tpu import loadgen as jloadgen
from llm_sharding_demo_tpu.fleet import harness as jharness
from llm_sharding_demo_tpu.fleet import topology as jtopology
from llm_sharding_demo_tpu.fleet.affinity import HashRing as JHashRing
from llm_sharding_demo_tpu.fleet.affinity import affinity_key as jaffinity_key
from llm_sharding_demo_tpu.runtime.kv_pool import KVBlockPool as JKVBlockPool
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils import graftfault as jgraftfault
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu.utils.metrics import (
    METRIC_CATALOG as JMETRIC_CATALOG)
from llm_sharding_demo_tpu_torch import loadgen
from llm_sharding_demo_tpu_torch.fleet import (AFFINITY_KEY_SOURCE,
                                               FLEET_ROLES, HANDOFF_POLICY,
                                               FleetTopology, HashRing,
                                               ReplicaHandle, affinity_key,
                                               build_fleet, harness)
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime import kv_pool
from llm_sharding_demo_tpu_torch.runtime.kv_pool import KVBlockPool
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.router import ReplicaError
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import graftfault, metrics
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_grafttime import port_state_isolation  # noqa: F401
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies)

MAX_SEQ = 128
SITES = ("serving.admission", "router.replica_hop")
N_RUN = 10


def flat_counters(registry) -> dict:
    """The port registry's counters and gauges by ``name{k=v}``, the JAX
    registry's snapshot keys."""
    snap = registry.snapshot()
    return {metrics._fmt_name(name, labels): v
            for part in ("counters", "gauges")
            for (name, labels), v in snap[part].items()}


def span_names(spans) -> list:
    return [(s["name"], span_names(s.get("spans", ()))) for s in spans]


@pytest.fixture(scope="module")
def fleets():
    """``(jax fleet, port fleet, runs)``: both built once, then the
    pinned serial drive under each package's plan; ``runs[side]`` holds
    what the drive left (the report, the plan's injections, the router's
    accounting, ``/healthz`` and counters), read before any other test
    touches the fleets."""
    jcfg, jparams = jharness.demo_model(MAX_SEQ)
    tcfg = gpt2.GPT2Config(vocab_size=jcfg.vocab_size,
                           n_positions=jcfg.n_positions, n_embd=jcfg.n_embd,
                           n_layer=jcfg.n_layer, n_head=jcfg.n_head)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    sides = {"jax": (jharness.build_fleet(n_decode=2, n_prefill=1),
                     jloadgen, jgraftfault),
             "port": (build_fleet(n_decode=2, n_prefill=1,
                                  model=(tcfg, tparams), device="cpu"),
                      loadgen, graftfault)}
    runs = {}
    for side, (f, lg, gf) in sides.items():
        plan = gf.FaultPlan(seed=9, rate=0.08, sites=SITES)
        with gf.use(plan):
            rep = lg.run_load(f.client, lg.profile("bursty_chat"), seed=6,
                              n=N_RUN, mode="serial", recorder=f.recorder)
        runs[side] = {
            "report": rep,
            "injections": [(i.site, i.kind, i.seq)
                           for i in plan.injections],
            "affinity": f.app.router.affinity_stats(),
            "prefix_len": f.pool.allocator.prefix_len(),
            "healthz": f.client.get("/healthz").json(),
        }
    runs["jax"]["counters"] = sides["jax"][0].registry.snapshot()
    runs["port"]["counters"] = flat_counters(sides["port"][0].registry)
    return sides["jax"][0], sides["port"][0], runs


# -- the pinned serial drive ---------------------------------------------------


def test_serial_bursty_chat_under_fault_plan_equals_jax(fleets):
    """Request for request, the port fleet answers as the JAX fleet does
    under the same pinned plan, which fires at the same calls."""
    _, _, runs = fleets
    got = {side: [(o.status, o.code, o.generated)
                  for o in runs[side]["report"]["outcomes"]]
           for side in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert runs["port"]["injections"] == runs["jax"]["injections"]
    assert runs["port"]["injections"], "the pinned plan fired nothing"
    assert sum(s == 200 for s, _, _ in got["port"]) >= N_RUN // 2
    for side in ("jax", "port"):
        assert runs[side]["report"]["errors"] == 0
    assert runs["port"]["affinity"] == runs["jax"]["affinity"]
    assert runs["port"]["prefix_len"] == runs["jax"]["prefix_len"] > 0


def test_router_healthz_topology_and_affinity_equal_jax(fleets):
    _, _, runs = fleets
    assert runs["port"]["healthz"] == runs["jax"]["healthz"]
    assert runs["port"]["healthz"]["replicas"] == {
        "decode": ["decode0", "decode1"], "prefill": ["prefill0"]}


def test_router_counters_equal_jax_and_lie_in_its_catalog(fleets):
    """The router's counters after the drive, names, labels and values,
    and every fleet series the port's catalog lists is JAX's."""
    _, _, runs = fleets
    assert runs["port"]["counters"] == runs["jax"]["counters"]
    names = {k.split("{")[0] for k in runs["port"]["counters"]}
    assert {"fleet_requests_total", "fleet_affinity_hits_total"} <= names
    assert names <= set(JMETRIC_CATALOG)
    fleet_series = {n: k for n, k in metrics.METRIC_CATALOG.items()
                    if n.startswith("fleet_")}
    assert len(fleet_series) == 5
    assert fleet_series == {n: JMETRIC_CATALOG[n] for n in fleet_series}


def test_stitched_trees_equal_jax(fleets):
    """The router records one tree a request, the replica's spans
    grafted under each hop, with the same span names as JAX's."""
    jf, pf, runs = fleets
    seen = 0
    for o in runs["port"]["report"]["outcomes"]:
        if o.status != 200:
            continue
        jt, pt = jf.recorder.find(o.request_id), pf.recorder.find(
            o.request_id)
        assert span_names(pt["spans"]) == span_names(jt["spans"])
        hops = [s for s in pt["spans"] if s["name"].endswith("_hop")]
        assert {"prefill_hop", "decode_hop"} <= {s["name"] for s in hops}
        for hop in hops:
            assert hop["labels"]["replica_request_id"] == o.request_id
            assert hop.get("spans"), hop
        assert set(pt["labels"]) == set(jt["labels"])
        seen += 1
    assert seen


def _post_prefill(f, client, case: str):
    """One /prefill call of ``case`` on fleet ``f`` -> ``(status, body,
    Retry-After)``."""
    tok = f.app.router.tokenizer
    body = {"prompt": "prefill probe: a fresh prompt, long enough to "
                      "fill four chunks of the registry" + case}
    headers = {"X-Request-ID": f"prefill-{case}"}
    held = []
    if case == "empty":
        body["prompt"] = ""
    elif case == "short":
        body["prompt"] = "hi"
    elif case == "overlong":
        body["prompt"] = "x" * MAX_SEQ
    elif case == "deadline":
        # a slowed tokenizer spends the 1 ms budget before the walk
        def slow(text, _encode=type(tok).encode):
            time.sleep(0.005)
            return _encode(tok, text)
        tok.encode = slow
        headers["X-Deadline-Ms"] = "1"
    elif case == "saturated":
        held = f.pool.allocator.alloc(f.pool.allocator.available())
    try:
        r = client.post("/prefill", json=body, headers=headers)
    finally:
        tok.__dict__.pop("encode", None)
        f.pool.allocator.free(held)
    out = r.json()
    if "detail" in out:
        out["detail"] = re.sub(r"\d+ms past", "Nms past", out["detail"])
    return r.status_code, out, r.headers.get("Retry-After")


@pytest.mark.parametrize("case", ["role", "empty", "short", "overlong",
                                  "deadline", "saturated"])
def test_prefill_answers_equal_jax(fleets, case):
    jf, pf, _ = fleets
    got = {}
    for side, f in (("jax", jf), ("port", pf)):
        name = "decode0" if case == "role" else "prefill0"
        got[side] = _post_prefill(f, f.topology.by_name(name).client, case)
    assert got["port"] == got["jax"]
    status = got["port"][0]
    want = {"role": 400, "empty": 400, "short": 200, "overlong": 400,
            "deadline": 503, "saturated": 429}[case]
    assert status == want, got["port"]
    if status in (429, 503):
        assert int(got["port"][2]) >= 1


# -- pure parts beside the JAX package's ---------------------------------------


@pytest.mark.parametrize("members", [
    [("a", "decode"), ("a", "decode")],
    [("a", "warmup")],
    [("a", "router")],
    [("a", "prefill")],
], ids=["duplicate", "unregistered", "router", "no_decode"])
def test_topology_validation_errors_equal_jax(members):
    errors = {}
    for side, (handle, topo) in {
            "jax": (jtopology.ReplicaHandle, jtopology.FleetTopology),
            "port": (ReplicaHandle, FleetTopology)}.items():
        with pytest.raises(ValueError) as e:
            topo([handle(name=n, role=r, client=object())
                  for n, r in members])
        errors[side] = str(e.value)
    assert errors["port"] == errors["jax"]


def test_topology_vocabulary_equals_jax():
    assert FLEET_ROLES == jtopology.FLEET_ROLES
    assert HANDOFF_POLICY == jtopology.HANDOFF_POLICY
    topo = FleetTopology([ReplicaHandle("p0", "prefill", object()),
                          ReplicaHandle("d0", "decode", object()),
                          ReplicaHandle("d1", "decode", object())])
    assert topo.describe() == {"decode": ["d0", "d1"], "prefill": ["p0"]}
    assert AFFINITY_KEY_SOURCE.startswith(
        "llm_sharding_demo_tpu_torch/runtime/prefix_cache.py")


def test_affinity_keys_and_ring_owners_equal_jax():
    rng = np.random.default_rng(17)
    names = [f"decode{i}" for i in range(5)]
    rings = (HashRing(names), JHashRing(names))
    small = (HashRing(names[:2]), JHashRing(names[:2]))
    for n in (1, 8, 16, 17, 40, 97):
        for chunk in (8, 16):
            ids = rng.integers(0, 256, n).tolist()
            key = affinity_key(ids, chunk)
            assert key == jaffinity_key(ids, chunk)
            assert (key is None) == ((n - 1) // chunk < 1)
            if key is not None:
                assert rings[0].pick(key) == rings[1].pick(key)
                assert small[0].pick(key) == small[1].pick(key)
    for i in range(200):
        key = f"key-{i}".encode()
        assert rings[0].pick(key) == rings[1].pick(key)


@pytest.mark.parametrize("kw", [
    dict(fleet_role="warmup", kv_pool_blocks=8, prefix_cache=4),
    dict(fleet_role="prefill"),
    dict(fleet_role="decode", kv_pool_blocks=8),
    dict(fleet_role="decode", prefix_cache=4),
    dict(fleet_role="decode", shard_role="a", kv_pool_blocks=8,
         prefix_cache=4),
    dict(fleet_role="prefill", dispatch="remote", kv_pool_blocks=8,
         prefix_cache=4),
    dict(fleet_role="decode", kv_pool_blocks=8, prefix_cache=4,
         prefix_chunk=16),
], ids=["role", "no_pool", "no_store", "no_pool_store", "shard",
        "remote", "ok"])
def test_fleet_role_validation_matches_jax(kw):
    outcomes = {}
    for side, cls in (("jax", JServingConfig), ("port", ServingConfig)):
        try:
            c = cls(model_id="m", max_seq=128, **kw)
            outcomes[side] = ("ok", c.fleet_role)
        except ValueError as e:
            outcomes[side] = ("error", str(e))
    assert outcomes["port"] == outcomes["jax"]


@pytest.mark.parametrize("case", ["blocks_off", "width", "regime"])
def test_injected_pool_refusals_equal_jax(case):
    """``create_app(kv_pool=)`` refuses a pool with KV_POOL_BLOCKS=0, of
    another width or another block regime, as the JAX app does."""
    jcfg, jparams = jharness.demo_model(64)
    tcfg, tparams = harness.demo_model(64, device="cpu")
    # blocks_off: a chunked-prefill engine, a runner the JAX app builds
    # without compiling before its check
    kw = (dict(model_id="m", max_seq=64, prefill_chunk=8)
          if case == "blocks_off" else
          dict(model_id="m", max_seq=64, kv_pool_blocks=16,
               kv_block_size=16))
    pool_kw = dict(block_dtype="int8" if case == "regime" else None)
    seq = 32 if case == "width" else 64
    errors = {}
    for side, pool_cls, app, cls, model, tok, extra in (
            ("jax", JKVBlockPool, jcreate_app, JServingConfig,
             (jcfg, jparams), JByteTokenizer(), {}),
            ("port", KVBlockPool, create_app, ServingConfig,
             (tcfg, tparams), ByteTokenizer(), {"device": "cpu"})):
        pool = pool_cls(2, 16, 4, 16, 8, seq, **pool_kw, **extra)
        with pytest.raises(ValueError) as e:
            app(cls(**kw), model=model, tokenizer=tok, kv_pool=pool,
                **extra)
        errors[side] = str(e.value)
    assert errors["port"] == errors["jax"]


# -- port fleets of their own --------------------------------------------------


def test_breaker_opens_per_target_with_labelled_gauge():
    """Transport faults at every replica hop open each decode replica's
    own breaker, in the router's registry and at its /healthz."""
    f = build_fleet(
        n_decode=2, n_prefill=0, device="cpu",
        hop_policy=graftfault.HopPolicy(
            attempts=1, timeout_s=5.0, base_backoff_s=0.001,
            max_backoff_s=0.002, breaker_threshold=2,
            breaker_cooldown_s=60.0))
    plan = graftfault.FaultPlan(seed=2, rate=1.0,
                                sites={"router.replica_hop"},
                                kinds={"reset"})
    with graftfault.use(plan):
        for _ in range(3):
            r = f.client.post("/generate", json={
                "prompt": "system: breaker storm prompt prefix.",
                "max_new_tokens": 4, "mode": "greedy"})
            assert r.status_code == 503
            assert int(r.headers["Retry-After"]) >= 1
    assert {f.app.router.policy.breaker_state(n)
            for n in ("decode0", "decode1")} == {"open"}
    counters = flat_counters(f.registry)
    for name in ("decode0", "decode1"):
        assert counters[f"hop_breaker_open{{target={name}}}"] == 1.0
    assert f.client.get("/healthz").json()["breakers"] == {
        "decode0": "open", "decode1": "open"}


def test_dead_prefill_replica_degrades_and_answers_200():
    """A prefill replica that is down costs the warm, once a request,
    and the decode replica prefills cold: the request still answers
    200, equal to the single-replica path."""
    f = build_fleet(n_decode=1, n_prefill=1, device="cpu")
    single, _, _ = harness.build_single(device="cpu")
    (p0,) = f.topology.prefill_replicas

    class _Dead:
        def post(self, *a, **k):
            raise ReplicaError(p0.name, "replica down (test)")

    p0.client = _Dead()
    body = {"prompt": "system: prefill failover test prompt, long enough!!",
            "max_new_tokens": 6, "mode": "greedy"}
    r = f.client.post("/generate", json=body,
                      headers={"X-Request-ID": "fleet-dead-prefill"})
    assert r.status_code == 200
    assert r.json() == single.post("/generate", json=body).json()
    assert flat_counters(f.registry)["fleet_prefill_degraded_total"] == 1.0
    tree = f.recorder.find("fleet-dead-prefill")
    hops = [s for s in tree["spans"] if s["name"] == "prefill_hop"]
    assert len(hops) == 1 and "degraded" in hops[0]["labels"]
    assert f.pool.allocator.prefix_len() == 1   # the decode replica's walk


def test_pool_conserved_after_open_loop_run(monkeypatch):
    """Concurrent arrivals through the router under GRAFTSAN=1: every
    outcome typed, every block free or referenced after the run, no
    caller ref leaked, and the shared registry warmed."""
    monkeypatch.setenv("GRAFTSAN", "1")
    f = build_fleet(n_decode=2, n_prefill=1, kv_pool_blocks=64,
                    device="cpu")
    assert f.pool.allocator.sanitize
    rep = loadgen.run_load(f.client, loadgen.profile("bursty_chat"), seed=3,
                           n=8, rate_scale=2.0, mode="open",
                           recorder=f.recorder)
    assert rep["errors"] == 0, rep["error_codes"]
    for o in rep["outcomes"]:
        assert o.status in (200, 429, 503), (o.status, o.code)
        assert o.status == 200 or o.code
    st = f.pool.allocator.stats()
    assert st.blocks_in_use + st.blocks_free == st.blocks_total
    kv_pool.graftsan_sweep(timeout=10.0)
    assert f.pool.allocator.prefix_len() > 0
    assert 0.0 <= rep["goodput_fraction"] <= 1.0
