"""The port's observability surfaces against the JAX app's.

Both apps serve the same seeded weights and run the same request script
(``TestClient``, one request at a time): a plain int8 engine (both
packages serve it through their ``DecodeEngine``), the admission
batcher, the iteration batcher with speculation, and the prefix store
(the second prompt a hit). Held equal: the metric names, label sets and
counter values on ``/metrics`` (the app's registry and the process's),
``/debug/requests`` span trees with their label keys, the timeline's
events other than dispatch events in ``grafttime.replay_view`` (the
JAX package's projection), and the trend reducer's alerts after a
deadline burst. Declared differences: ``JAX_ONLY_METRICS``,
``JAX_ONLY_HBM`` and the dispatch scopes (``SCOPES``). The fp32
single-stream runner differs by design and is not compared: the port's
``PipelineRunner`` is the staged engine on its plain path and records
prefill and decode spans, the JAX package's records none.

Also: the ``/debug`` index carries the ``/healthz`` topology, bad
queries answer 422 as in the JAX app, ``/debug/plan`` answers "off",
the tiered pool server's timeline carries its tier moves, the ledger's
pool and host bytes, every metric name the port emits is in the JAX
catalog, and TPOT counts decoded steps.
"""

import ast
import gc
import json
import os
import re
import time
import weakref

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils import grafttime as jgrafttime
from llm_sharding_demo_tpu.utils import metrics as jmetrics
from llm_sharding_demo_tpu.utils import tracing as jtracing
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
import llm_sharding_demo_tpu_torch as port
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import (graftmem, graftscope,
                                               grafttime, metrics, tracing)
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_grafttime import port_state_isolation  # noqa: F401
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

DIMS = dict(vocab_size=211, n_positions=64, n_embd=64, n_layer=2,
            n_head=2)
MAX_SEQ = 64
NEW = 4
# equal lengths: one prefill program a JAX engine; the second shares the
# first's 8-token chunk (a prefix hit)
PROMPTS = ["Hello there, A.", "Hello there, B.", "Quite different"]
CONFIGS = {
    "plain": dict(inference_dtype="int8"),
    "admission": dict(max_batch=4, batch_mode="admission"),
    "iter_spec": dict(max_batch=4, batch_mode="iter", spec_decode=3),
    "prefix": dict(prefix_cache=4, prefix_chunk=8),
}
# the JAX package's CompileWatch counts jitted programs; eager PyTorch
# builds none per shape
JAX_ONLY_METRICS = {"compile_events_total", "jit_program_cache_size"}
# the JAX spec engine's device token buffers; the port drafts on the host
JAX_ONLY_HBM = {"spec_buffers"}
# the dispatch scopes of each script: (JAX, port). Both packages time
# each prefill and each decode segment; the port has no donation to
# avoid (no _extend_keep)
SCOPES = {
    "plain": ({"engine._prefill", "engine._decode_seg"},
              {"engine._prefill", "engine._decode_seg"}),
    "admission": ({"engine._prefill", "engine._decode_seg"},
                  {"engine._prefill", "engine._decode_seg"}),
    "iter_spec": ({"engine._prefill", "spec_decode._seg_b"},
                  {"engine._prefill", "spec_decode._seg_b"}),
    "prefix": ({"prefix_cache._extend", "prefix_cache._extend_keep",
                "engine._decode_seg"},
               {"prefix_cache._extend", "engine._decode_seg"}),
}
DISPATCH_KINDS = ("dispatch_begin", "dispatch_end")


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params(seed=13, dims=DIMS)
    return ((jgpt2.GPT2Config(**DIMS), jax.tree.map(jnp.asarray, tree)),
            (gpt2.GPT2Config(**DIMS), params_from_numpy(tree, device="cpu")))


class _Tok:
    """A byte tokenizer whose encode can be slowed: 5 ms spends an
    X-Deadline-Ms of 1 before any runner sees the request."""

    def __init__(self, tok):
        self.tok = tok
        self.delay = 0.0

    def encode(self, text):
        if self.delay:
            time.sleep(self.delay)
        return self.tok.encode(text)

    def __getattr__(self, name):
        return getattr(self.tok, name)


def apps(weights, sides=("jax", "port"), **kw):
    """``{"jax": (client, registry, recorder, tokenizer, app), "port":
    ...}`` of one configuration (the apps of ``sides`` only), each with
    its own registry and recorder."""
    (jcfg, jp), (tcfg, tp) = weights
    out = {}
    if "jax" in sides:
        jreg, jrec = jmetrics.MetricsRegistry(), jtracing.FlightRecorder()
        jtok = _Tok(JByteTokenizer())
        japp = jcreate_app(
            JServingConfig(model_id="test", max_seq=MAX_SEQ, **kw),
            model=(jcfg, jp), tokenizer=jtok, registry=jreg, recorder=jrec)
        out["jax"] = (JTestClient(japp), jreg, jrec, jtok, japp)
    if "port" in sides:
        treg, trec = metrics.MetricsRegistry(), tracing.FlightRecorder()
        ttok = _Tok(ByteTokenizer())
        tapp = create_app(
            ServingConfig(model_id="test", max_seq=MAX_SEQ, **kw),
            model=(tcfg, tp), tokenizer=ttok, device="cpu", registry=treg,
            recorder=trec)
        out["port"] = (TestClient(tapp), treg, trec, ttok, tapp)
    return out


def prom(text: str) -> dict:
    """Prometheus text -> ``{(name, labels without le): value}`` (the
    largest bucket value stands for a histogram's buckets); asserts
    every line parses."""
    line_re = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
    label_re = re.compile(r'([a-zA-Z_]+)="((?:[^"\\]|\\.)*)"')
    out = {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            assert len(line.split()) == 4, line
            continue
        m = line_re.match(line)
        assert m, line
        labels = tuple(sorted((k, v) for k, v in label_re.findall(
            m.group(3) or "") if k != "le"))
        key = (m.group(1), labels)
        out[key] = max(out.get(key, float("-inf")), float(m.group(4)))
    return out


def _clean_globals():
    gc.collect()
    graftmem.component_bytes()          # drain collected owners' releases
    for reg in (metrics.REGISTRY, jmetrics.REGISTRY):
        reg.restore_state(({}, {}, {}))
    grafttime.clear()
    jgrafttime.clear()
    graftscope.clear()


def run_script(pair, name):
    """The request script on both apps, one package after the other;
    returns what each served and recorded."""
    out = {}
    for side in ("jax", "port"):
        client, reg, rec, _, _ = pair[side]
        _clean_globals()
        bus = jgrafttime if side == "jax" else grafttime
        greg = jmetrics.REGISTRY if side == "jax" else metrics.REGISTRY
        replies = []
        for i, p in enumerate(PROMPTS):
            r = client.post("/generate",
                            json={"prompt": p, "max_new_tokens": NEW,
                                  "mode": "greedy"},
                            headers={"X-Request-ID": f"{name}-{i}"})
            assert r.status_code == 200, r.json()
            replies.append(r.json())
        events = bus.events()
        out[side] = {
            "replies": replies,
            "requests": client.get("/debug/requests").json(),
            "app_metrics": prom(reg.prometheus()),
            "metrics_text": client.get("/metrics").text,
            "process_metrics": prom(greg.prometheus()),
            "events": events,
            "scopes": {e["scope"] for e in events
                       if e["kind"] == "dispatch_end"},
        }
    return out


@pytest.fixture(scope="module")
def scripted_pairs(weights):
    """Each configuration's apps, after the script ran on them, and what
    the script saw: ``(pairs, runs)``. Later tests reuse the apps (the
    JAX package compiles once a configuration)."""
    pairs, runs = {}, {}
    for name, kw in CONFIGS.items():
        pairs[name] = apps(weights, **kw)
        runs[name] = run_script(pairs[name], name)
    return pairs, runs


@pytest.fixture(scope="module")
def scripted(scripted_pairs):
    return scripted_pairs[1]


def _tree(spans):
    return [(s["name"], sorted(s.get("labels", {})), _tree(s.get("spans", [])))
            for s in spans]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_replies_equal(scripted, name):
    run = scripted[name]
    assert run["port"]["replies"] == run["jax"]["replies"]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_span_trees_and_label_keys_equal(scripted, name):
    run = scripted[name]
    trees = {side: {t["request_id"]: (sorted(t.get("labels", {})),
                                      _tree(t["spans"]))
                    for t in run[side]["requests"]["requests"]}
             for side in ("jax", "port")}
    assert trees["port"] == trees["jax"]
    assert len(trees["port"]) == len(PROMPTS)
    if name == "prefix":
        hit = [s for s in run["port"]["requests"]["requests"]
               if s["request_id"] == "prefix-1"][0]
        pre = [s for s in hit["spans"] if s["name"] == "prefill"][0]
        assert pre["labels"]["prefix_hit"] is True
        assert pre["labels"]["reused_tokens"] == 8


@pytest.mark.parametrize("name", list(CONFIGS))
def test_spans_lie_inside_the_request(scripted, name):
    for t in scripted[name]["port"]["requests"]["requests"]:
        def walk(spans):
            for s in spans:
                assert -1e-3 <= s["start_ms"]
                assert (s["start_ms"] + s["duration_ms"]
                        <= t["duration_ms"] + 1e-3), (t["request_id"], s)
                walk(s.get("spans", []))
        walk(t["spans"])


def _names(series):
    return {k for k in series if k[0] not in JAX_ONLY_METRICS}


@pytest.mark.parametrize("where", ["app_metrics", "process_metrics"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_metric_names_labels_and_counters_equal(scripted, name, where):
    j, t = scripted[name]["jax"][where], scripted[name]["port"][where]

    def comparable(series):
        return {k for k in _names(series)
                if not k[0].startswith("dispatch_seconds")
                and not (k[0] == "hbm_bytes"
                         and dict(k[1]).get("component") in JAX_ONLY_HBM)}

    assert comparable(t) == comparable(j)
    kinds = jmetrics.METRIC_CATALOG
    for key in comparable(t):
        base = re.sub(r"_(bucket|sum|count)$", "", key[0])
        if kinds.get(key[0]) == "counter":
            assert t[key] == j[key], key
        elif kinds.get(base) == "histogram" and key[0].endswith("_count"):
            assert t[key] == j[key], key
    # dispatch_seconds: one label set a scope the script ran
    jscopes, tscopes = SCOPES[name]
    for series, want in ((j, jscopes), (t, tscopes)):
        got = {dict(k[1])["scope"] for k in series
               if k[0] == "dispatch_seconds_count"}
        assert got == (want if where == "process_metrics" else set())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dispatch_scopes_are_declared(scripted, name):
    jscopes, tscopes = SCOPES[name]
    assert scripted[name]["jax"]["scopes"] == jscopes
    assert scripted[name]["port"]["scopes"] == tscopes


@pytest.mark.parametrize("name", list(CONFIGS))
def test_timeline_replay_view_equal(scripted, name):
    views = {side: jgrafttime.replay_view(
        [e for e in scripted[name][side]["events"]
         if e["kind"] not in DISPATCH_KINDS])
        for side in ("jax", "port")}
    assert set(views["port"]) == {f"{name}-{i}" for i in range(len(PROMPTS))}
    assert json.dumps(views["port"], sort_keys=True) == json.dumps(
        views["jax"], sort_keys=True)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_metrics_text_parses_and_matches_the_registry(scripted, name):
    run = scripted[name]["port"]
    assert prom(run["metrics_text"]) == run["app_metrics"]
    assert run["app_metrics"][("generate_requests_total",
                               (("mode", "greedy"),))] == len(PROMPTS)
    assert run["app_metrics"][("generated_tokens_total", ())] == \
        len(PROMPTS) * NEW
    for hist in ("ttft_seconds", "tpot_seconds"):
        assert run["app_metrics"][(hist + "_count",
                                   (("mode", "greedy"),))] == len(PROMPTS)


def test_deadline_burst_trips_the_burn_watch_once(scripted_pairs):
    """The admission apps after the script: five more answered requests
    and three spent budgets; both apps' trend reducers trip
    ``slo_deadline_burn`` on the same numbers, once; the second scrape
    raises nothing new; ``/healthz`` shows the latch."""
    pair = scripted_pairs[0]["admission"]
    alerts, dumps = {}, {}
    for side in ("jax", "port"):
        client, reg, rec, tok, app = pair[side]
        _clean_globals()
        grafttime.clear_blackbox()
        jgrafttime.clear_blackbox()
        before = client.get("/debug/trend").json()
        assert before["alerts"] == []
        for i in range(5):
            assert client.post("/generate", json={
                "prompt": PROMPTS[0], "max_new_tokens": NEW,
                "mode": "greedy"}).status_code == 200
        tok.delay = 0.005
        for i in range(3):
            r = client.post("/generate", json={
                "prompt": PROMPTS[1], "max_new_tokens": NEW,
                "mode": "greedy"},
                headers={"X-Deadline-Ms": "1", "X-Request-ID": f"dl-{i}"})
            assert r.status_code == 503, r.json()
            assert r.json()["error"] == "deadline_exceeded"
        tok.delay = 0.0
        first = client.get("/debug/trend").json()
        second = client.get("/debug/trend").json()
        assert [a["watch"] for a in first["alerts"]] == ["slo_deadline_burn"]
        assert second["alerts"] == first["alerts"]
        assert second["watches"]["slo_deadline_burn"]["latched"]
        # ?eval=0 reads without polling or evaluating
        assert client.get("/debug/trend?eval=0").json()[
            "evaluations"] == second["evaluations"]
        assert client.get("/healthz").json()["trend"]["latched"] == [
            "slo_deadline_burn"]
        text = prom(client.get("/metrics").text)
        assert text[("deadline_misses_total", ())] == 3
        assert text[("trend_alerts_total", (("severity", "page"),
                                            ("watch",
                                             "slo_deadline_burn")))] == 1
        errs = client.get("/debug/requests?errors=1").json()["requests"]
        assert sorted(t["request_id"] for t in errs) == [
            "dl-0", "dl-1", "dl-2"]
        alerts[side] = app.trend_reducer.alerts(strip_time=True)
        bus = jgrafttime if side == "jax" else grafttime
        dumps[side] = [d["reason"] for d in bus.blackbox_dumps()]
    assert json.dumps(alerts["port"]) == json.dumps(alerts["jax"])
    # three typed 503s and the trip, each a black-box dump
    assert dumps["port"] == dumps["jax"] == (
        ["deadline_exceeded"] * 3 + ["trend_alert:slo_deadline_burn"])


def test_typed_503_writes_a_blackbox_file(weights, tmp_path, monkeypatch):
    monkeypatch.setenv("GRAFTTIME_DIR", str(tmp_path))
    client, _, rec, tok, _ = apps(weights, sides=("port",))["port"]
    grafttime.clear_blackbox()
    tok.delay = 0.005
    r = client.post("/generate", json={"prompt": "hi", "max_new_tokens": 2,
                                       "mode": "greedy"},
                    headers={"X-Deadline-Ms": "1", "X-Request-ID": "bb-1"})
    assert r.status_code == 503 and r.headers["X-Request-ID"] == "bb-1"
    dumps = grafttime.blackbox_dumps()
    assert [(d["reason"], d["rid"]) for d in dumps] == [
        ("deadline_exceeded", "bb-1")]
    files = os.listdir(tmp_path)
    assert len(files) == 1 and "deadline_exceeded" in files[0]
    assert rec.snapshot(errors_only=True)[0]["labels"]["error"] == \
        "deadline_exceeded"


def test_debug_index_pinned_to_healthz_topology(scripted_pairs):
    pair = scripted_pairs[0]["admission"]
    hz = pair["port"][0].get("/healthz").json()
    idx = pair["port"][0].get("/debug").json()
    assert idx["serving"] == {k: hz[k] for k in idx["serving"]}
    jidx = pair["jax"][0].get("/debug").json()
    assert set(idx["surfaces"]) == set(jidx["surfaces"])
    for path in list(idx["surfaces"]) + ["/debug/requests?n=2"]:
        body = pair["port"][0].get(path).json()
        assert body["serving"] == idx["serving"], path
    plan = {side: {k: v for k, v in pair[side][0].get("/debug/plan")
                   .json().items() if k != "serving"}
            for side in ("jax", "port")}
    assert plan["port"] == plan["jax"] == {"mode": "off", "auto_plan": None}


@pytest.fixture(scope="module")
def default_pair(weights):
    return apps(weights)


@pytest.mark.parametrize("path", [
    "/debug/requests?n=abc", "/debug/profile?n=x",
    "/debug/timeline?since=soon", "/debug/timeline?since_seq=1.5",
    "/debug/timeline?kinds=span_open,bogus", "/debug/timeline?n=many"])
def test_bad_queries_answer_422_as_jax(default_pair, path):
    pair = default_pair
    j = pair["jax"][0].get(path)
    t = pair["port"][0].get(path)
    assert t.status_code == j.status_code == 422
    if "kinds" in path:
        assert t.json()["detail"].startswith("unknown kinds ['bogus']")
    else:
        assert t.json() == j.json()


def test_debug_views_of_a_served_request(weights):
    client = apps(weights, sides=("port",), **CONFIGS["plain"])["port"][0]
    _clean_globals()
    client.post("/generate", json={"prompt": PROMPTS[0],
                                   "max_new_tokens": NEW, "mode": "greedy"},
                headers={"X-Request-ID": "v-0"})
    prof = client.get("/debug/profile?n=8").json()
    seg = prof["dispatch"]["engine._decode_seg"]
    # the NEW - 1 decode steps in one segment
    assert seg["calls"] == 1 and seg["ring"][0]["key"] == repr((1, NEW - 1))
    # CPU tensors: host windows only, no event pair
    assert seg["stream"] == {"resolved": 0, "pending": 0,
                             "none": 1, "ms_total": 0.0}
    assert "stream window" in prof["truth"]
    mem = client.get("/debug/memory").json()
    assert mem["conserved"] and mem["allocator"] == {}
    assert mem["components"]["params"]["devices"] == {
        "cpu": mem["components"]["params"]["bytes"]}
    tl = client.get("/debug/timeline?rid=v-0&kinds=span_close").json()
    assert [e["name"] for e in tl["events"]] == [
        "tokenize", "prefill", "decode", "detokenize", "request"]
    cur = tl["cursor"]
    assert client.get(f"/debug/timeline?since_seq={cur}").json()[
        "events"] == []
    found = client.get("/debug/requests?n=1&slowest=1").json()
    assert found["order"] == "slowest" and len(found["requests"]) == 1


@pytest.mark.parametrize("config", ["plain", "prefix"])
def test_ledger_finalizers_stay_flat_over_requests(weights, config):
    """Each decode tracks its cache and each store insert its copy, on
    owners that live as long as the server: a release detaches the
    holding's finalizer, so their number does not grow with requests."""
    client = apps(weights, sides=("port",), **CONFIGS[config])["port"][0]

    def serve(i):
        r = client.post("/generate", json={
            "prompt": f"prompt {i:03d}, a distinct one", "max_new_tokens": NEW,
            "mode": "greedy"})
        assert r.status_code == 200

    for i in range(5):          # the store fills and starts to evict
        serve(i)
    gc.collect()
    before = len(weakref.finalize._registry)
    for i in range(5, 9):
        serve(i)
    gc.collect()
    assert len(weakref.finalize._registry) == before


# the solo paged runner: its prefills go through the store (the
# iteration batcher's seed prefills do not; its joins need concurrency)
TIER = dict(kv_pool_blocks=10, kv_block_size=8, prefix_cache=8,
            prefix_chunk=8, kv_host_blocks=3)


def test_tiered_pool_timeline_and_ledger(weights):
    """A pool of 10 8-slot blocks and a host tier of 3 under prompts of
    24, 40, 40, 24 tokens and the first again: the first entry (2
    blocks) demotes, a 4-block entry (past the host budget) is evicted,
    and the first promotes back. The timeline's eviction and tier events
    match the pool's counts and the JAX app's (replay view); the ledger
    holds the pool planes as /healthz reports them and the host bytes on
    the CPU."""
    rng = np.random.default_rng(3)

    def text(n):
        return "".join(chr(int(c)) for c in rng.integers(97, 123, n))

    first = text(24)
    prompts = [first, text(40), text(40), text(24), first]
    pair = apps(weights, **TIER)
    views = {}
    for side in ("jax", "port"):
        client = pair[side][0]
        _clean_globals()
        bus = jgrafttime if side == "jax" else grafttime
        for i, p in enumerate(prompts):
            r = client.post("/generate", json={
                "prompt": p, "max_new_tokens": NEW, "mode": "greedy"},
                headers={"X-Request-ID": f"t-{i}"})
            assert r.status_code == 200, r.json()
        evs = bus.events()
        views[side] = jgrafttime.replay_view(
            [e for e in evs if e["kind"] not in DISPATCH_KINDS])
        if side == "port":
            kinds = [e["kind"] for e in evs]
            tier = client.get("/healthz").json()["kv_pool_stats"]["tier"]
            pool_st = client.get("/healthz").json()["kv_pool_stats"]
            assert tier["demotions"] == tier["promotions"] == 1
            assert pool_st["evictions"] == 1
            assert kinds.count("tier_demote") == tier["demotions"]
            assert kinds.count("tier_promote") == tier["promotions"]
            assert kinds.count("eviction") == pool_st["evictions"]
            assert {"span_open", "span_close"} <= set(kinds)
            chrome = jgrafttime.export_chrome(evs)
            assert jgrafttime.validate_chrome(chrome) == []
            mem = client.get("/debug/memory").json()
            assert mem["conserved"]
            # [L, N + 1, 2, Hkv, block, head_dim] f32; the component
            # total is process-wide, the holding this pool's
            planes = (DIMS["n_layer"] * (TIER["kv_pool_blocks"] + 1) * 2
                      * DIMS["n_head"] * TIER["kv_block_size"]
                      * DIMS["n_embd"] // DIMS["n_head"] * 4)
            assert mem["pool"]["pool_bytes"] == planes
            assert {"component": "pool_codes", "holding": "data",
                    "owner": "KVBlockPool", "bytes": planes,
                    "devices": {"cpu": planes}} in mem["holdings"]
            host = mem["components"].get("host_spill", {"devices": {}})
            assert set(host["devices"]) <= {"cpu"}
    assert json.dumps(views["port"], sort_keys=True) == json.dumps(
        views["jax"], sort_keys=True)


def test_fault_park_resume_events_equal_jax(weights):
    """A transient decode fault at the first segment: both packages'
    timelines carry the injection, the park budget's breaker, the park
    and the resume by recompute for the request, equal in the replay
    view (JAX's ``fault_inject`` also names its call site, ``where``)."""
    from llm_sharding_demo_tpu.utils import graftfault as jgraftfault
    from llm_sharding_demo_tpu_torch.utils import graftfault
    pair = apps(weights, max_batch=2, batch_mode="iter")
    views = {}
    for side, gf in (("jax", jgraftfault), ("port", graftfault)):
        client = pair[side][0]
        _clean_globals()
        plan = gf.FaultPlan(seed=0, rate=1.0, max_injections=1,
                            sites={"iterbatch.decode_seg"},
                            kinds={"decode_transient"})
        with gf.use(plan):
            r = client.post("/generate", json={
                "prompt": PROMPTS[0], "max_new_tokens": 8,
                "mode": "greedy"}, headers={"X-Request-ID": "fault-0"})
        assert r.status_code == 200, r.json()
        bus = jgrafttime if side == "jax" else grafttime
        views[side] = jgrafttime.replay_view(
            [{k: v for k, v in e.items() if k != "where"}
             for e in bus.events() if e["kind"] not in DISPATCH_KINDS])
    kinds = [e["kind"] for e in views["port"]["fault-0"]]
    for kind in ("admission", "fault_inject", "breaker", "park", "resume"):
        assert kind in kinds, kinds
    assert json.dumps(views["port"], sort_keys=True) == json.dumps(
        views["jax"], sort_keys=True)


def test_hop_breaker_transitions_on_the_timeline():
    from llm_sharding_demo_tpu_torch.utils import graftfault
    _clean_globals()
    reg = metrics.MetricsRegistry()
    policy = graftfault.HopPolicy(attempts=1, breaker_threshold=1,
                                  breaker_cooldown_s=0.0, registry=reg,
                                  sleep=lambda s: None)

    def fail(timeout_s):
        raise ConnectionError("down")

    with pytest.raises(graftfault.CircuitOpenError):
        policy.call(fail, shard="b")
    policy.call(lambda timeout_s: "ok", shard="b")   # the probe closes it
    assert [(e["state"], e["target"]) for e in grafttime.events(
        kinds=["breaker"])] == [("open", "b"), ("closed", "b")]
    gauges = reg.snapshot()["gauges"]
    assert gauges[("hop_breaker_open", (("target", "b"),))] == 0.0
    assert [p[1] for p in graftscope.series("hop_breaker_open")] == [1.0,
                                                                      0.0]


def _emitted_names():
    """``{name: kind}`` of every literal metric name the port passes to
    ``inc``/``gauge``/``observe``, ``graftscope.sample`` or
    ``tracing.timed``."""
    kinds = {"inc": "counter", "gauge": "gauge", "observe": "histogram",
             "sample": "gauge", "timed": "histogram"}
    out = {}
    root = os.path.dirname(port.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                fn = node.func
                attr = (fn.attr if isinstance(fn, ast.Attribute)
                        else getattr(fn, "id", None))
                if attr not in kinds or not (
                        attr in ("sample", "timed")
                        or "REGISTRY" in ast.dump(fn)
                        or "reg" in ast.dump(fn)):
                    continue
                arg = node.args[0]
                names = ([arg.body, arg.orelse]
                         if isinstance(arg, ast.IfExp) else [arg])
                for a in names:
                    if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                  str):
                        out[a.value] = kinds[attr]
    return out


def test_every_emitted_name_is_in_both_catalogs():
    emitted = _emitted_names()
    assert {"generate_requests_total", "hbm_bytes", "dispatch_seconds",
            "trend_alerts_total", "iter_joins_total"} <= set(emitted)
    for name, kind in emitted.items():
        assert metrics.METRIC_CATALOG.get(name) == kind, name
    for name, kind in metrics.METRIC_CATALOG.items():
        assert jmetrics.METRIC_CATALOG.get(name) == kind, name


def test_tpot_counts_decoded_steps_not_truncated(weights):
    """EOS keeps one token of a 6-token decode: TPOT still divides by the
    steps decoded (the JAX app's test)."""
    client, reg, _, _, _ = apps(weights, sides=("port",),
                                **CONFIGS["plain"])["port"]
    full = client.post("/generate", json={
        "prompt": "abc", "max_new_tokens": 6,
        "mode": "greedy"}).json()["generated"]
    # the first new character unlike the first new one, past it: an
    # EOS the engine's stop check (after 32 steps) does not see
    cut = next(i for i in range(4, len(full)) if full[i] != full[3])
    eos = ord(full[cut])
    r = client.post("/generate", json={"prompt": "abc", "max_new_tokens": 6,
                                       "mode": "greedy", "eos_token_id": eos})
    assert r.json()["finish_reason"] == "stop"
    snap = reg.snapshot()["histograms"]
    assert snap[("tpot_seconds", (("mode", "greedy"),))][2] == 2


def test_failed_generate_recorded_and_id_echoed(weights, monkeypatch):
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    client, _, rec, _, _ = apps(weights, sides=("port",),
                               **CONFIGS["plain"])["port"]

    def boom(self, *a, **k):
        raise RuntimeError("synthetic device loss")

    monkeypatch.setattr(DecodeEngine, "generate", boom)
    r = client.post("/generate", json={"prompt": "hi", "max_new_tokens": 2,
                                       "mode": "greedy"},
                    headers={"X-Request-ID": "fail-1"})
    assert r.status_code == 500 and r.headers["X-Request-ID"] == "fail-1"
    t = rec.snapshot(errors_only=True)[0]
    assert t["request_id"] == "fail-1"
    assert "synthetic device loss" in t["labels"]["error"]
    assert [s["name"] for s in t["spans"]] == ["tokenize"]
