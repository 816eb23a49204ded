"""The pure parts of the port's observability layer against the JAX
package's.

grafttime: the vocabulary, the Chrome export (each kind, checked by the
JAX package's ``validate_chrome``), the replay projection, rebasing, the
``/debug/timeline`` query errors, a bus bounded under a flood, the
ambient correlation and the black-box ring. grafttrend: the policy, its
refusals, the windowed reductions and the reducer's alerts on seeded
sample streams, byte-identical JSON to the JAX package's, and ``poll``
on the same registry contents. metrics: the Prometheus text, byte-equal
to the JAX registry's for the same series. tracing: trees, grafting and
the flight recorder's filters. graftscope: the key-overflow bucket,
bounded rings, and the CUDA event pairs (with stand-in events: never
waited on, pending until complete, none while capturing). graftmem:
storage-deduplicated bytes by device, peaks, the holdings bound,
conservation, its events, and owners' releases deferred to the next
call.
"""

import gc
import json
import random

import pytest
import torch

from llm_sharding_demo_tpu.utils import grafttime as J
from llm_sharding_demo_tpu.utils import grafttrend as JT
from llm_sharding_demo_tpu.utils import metrics as JM
from llm_sharding_demo_tpu.utils import tracing as JTR
from llm_sharding_demo_tpu_torch.loadgen import profiles
from llm_sharding_demo_tpu_torch.utils import (graftmem, graftscope,
                                               grafttime, grafttrend,
                                               metrics, tracing)


@pytest.fixture(autouse=True)
def port_state_isolation():
    """The port's process-wide observability state, saved and restored
    around every test."""
    saved = (metrics.REGISTRY.dump_state(), graftscope.dump_state(),
             grafttime.dump_state(), graftmem.dump_state(),
             grafttrend.dump_state(), grafttime.blackbox_dumps(),
             graftscope.enabled(), grafttime.enabled(), graftmem.enabled())
    with tracing.RECORDER._lock:
        traces = list(tracing.RECORDER._traces)
    yield
    reg, scope, bus, mem, trend, dumps, scope_on, time_on, mem_on = saved
    metrics.REGISTRY.restore_state(reg)
    graftscope.restore_state(scope)
    graftscope.set_enabled(scope_on)
    grafttime.restore_state(bus)
    grafttime.set_enabled(time_on)
    graftmem.restore_state(mem)
    graftmem.set_enabled(mem_on)
    grafttrend.restore_state(trend)
    grafttime.clear_blackbox()
    with grafttime._DUMPS_LOCK:
        grafttime._DUMPS.extend(dumps)
    with tracing.RECORDER._lock:
        tracing.RECORDER._traces.clear()
        tracing.RECORDER._traces.extend(traces)


def js(x) -> str:
    return json.dumps(x, sort_keys=True)


# -- grafttime ---------------------------------------------------------------


def test_vocabulary_equals_jax():
    assert grafttime.EVENT_KINDS == J.EVENT_KINDS
    assert grafttime.KIND_FIELDS == J.KIND_FIELDS
    assert grafttime.REPLAY_EXEMPT_FIELDS == J.REPLAY_EXEMPT_FIELDS
    assert grafttime.REPLAY_EXEMPT_KINDS == J.REPLAY_EXEMPT_KINDS
    assert grafttime.RING_CAPACITY == J.RING_CAPACITY


@pytest.mark.parametrize("kind", sorted(J.EVENT_KINDS))
def test_chrome_export_of_each_kind_equals_jax(kind):
    ev = J.sample_event(kind)
    got = grafttime.export_chrome([ev], meta={"k": 1})
    assert js(got) == js(J.export_chrome([ev], meta={"k": 1}))
    assert J.validate_chrome(got) == []


def _stream(seed: int, n: int = 60) -> list:
    rng = random.Random(seed)
    kinds = sorted(J.EVENT_KINDS)
    evs = []
    for i in range(n):
        ev = J.sample_event(rng.choice(kinds))
        ev.update(seq=i + 1, ts=round(rng.uniform(0, 50), 3),
                  tid=rng.randrange(3), replica=rng.choice(["a", "b", None]))
        if rng.random() < 0.3:
            ev.pop("rid", None)
            ev["rids"] = rng.sample(["r0", "r1", "r2"], 2)
        if ev["replica"] is None:
            del ev["replica"]
        evs.append(ev)
    return evs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replay_view_export_and_rebase_equal_jax(seed):
    evs = _stream(seed)
    assert js(grafttime.replay_view(evs)) == js(J.replay_view(evs))
    assert js(grafttime.rebase(evs, 12.5)) == js(J.rebase(evs, 12.5))
    chrome = grafttime.export_chrome(evs)
    assert js(chrome) == js(J.export_chrome(evs))
    assert J.validate_chrome(chrome) == []


@pytest.mark.parametrize("payload", [
    None, {}, {"traceEvents": [1]},
    {"traceEvents": [{"name": "", "ph": "Q", "ts": -1, "pid": "1",
                      "tid": 1.5}]},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 1, "pid": 1,
                      "tid": 1}]},
    {"traceEvents": [{"name": "x", "ph": "i", "ts": 1, "pid": 1, "tid": 1,
                      "s": "z"}]}])
def test_validate_chrome_finds_what_jax_finds(payload):
    assert grafttime.validate_chrome(payload) == J.validate_chrome(payload)
    assert grafttime.validate_chrome(payload)


@pytest.mark.parametrize("query", [
    {"since": "soon"}, {"since_seq": "1.5"}, {"n": "x"},
    {"kinds": "span_open,bogus"}, {"kinds": "nope"}])
def test_timeline_query_errors_equal_jax(query):
    got = grafttime.debug_timeline_payload(query, {})
    assert got[0] == 422
    assert got == J.debug_timeline_payload(query, {})


def test_bus_stays_bounded_under_a_flood():
    bus = grafttime.TimelineBus(capacity=64)
    for i in range(10_000):
        bus.emit("occupancy", name="queue_depth", value=float(i))
    snap = bus.snapshot()
    assert len(snap["events"]) == 64
    assert snap["emitted_total"] == snap["cursor"] == 10_000
    assert snap["dropped"] == 10_000 - 64
    assert snap["events"][-1]["value"] == 9999.0
    assert bus.events(since_seq=9_990)[0]["seq"] == 9_991
    assert bus.events(n=0) == [] and len(bus.events(n=5)) == 5
    bus.emit("occupancy", name="queue_depth", value=1.0, t=bus.t0)
    assert bus.events(since_seq=10_000)[0]["ts"] == 0.0   # dated back


def test_ambient_correlation():
    grafttime.clear()
    tr = tracing.RequestTrace("req-1")
    with tracing.use_trace(tr), grafttime.use_replica("solo"):
        grafttime.emit("admission", mode="seed")
        with grafttime.correlate(["a", None, "b"]):
            grafttime.emit("dispatch_end", scope="s", key="k")
        with grafttime.correlate(["c"]):
            grafttime.emit("park", reason="fault")
    grafttime.emit("eviction", blocks=2)
    evs = grafttime.events()
    assert [(e.get("rid"), e.get("rids"), e.get("replica")) for e in evs] == [
        ("req-1", None, "solo"), (None, ["a", "b"], "solo"),
        ("c", None, "solo"), (None, None, None)]
    prev = grafttime.set_enabled(False)
    grafttime.emit("eviction", blocks=3)
    grafttime.set_enabled(prev)
    assert len(grafttime.events()) == 4


def test_blackbox_ring_is_bounded_and_files_never_reused(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("GRAFTTIME_DIR", str(tmp_path))
    grafttime.clear_blackbox()
    for i in range(grafttime.BLACKBOX_CAPACITY + 3):
        grafttime.blackbox(f"r/{i}", rid=f"x{i}")
    dumps = grafttime.blackbox_dumps()
    assert len(dumps) == grafttime.BLACKBOX_CAPACITY
    assert dumps[-1]["reason"] == f"r/{grafttime.BLACKBOX_CAPACITY + 2}"
    assert len(list(tmp_path.iterdir())) == grafttime.BLACKBOX_CAPACITY + 3


# -- grafttrend ---------------------------------------------------------------


def test_policy_and_modes_equal_jax():
    assert grafttrend.WATCH_POLICY == JT.WATCH_POLICY
    assert grafttrend.DERIVED_SERIES == JT.DERIVED_SERIES
    assert grafttrend.SEVERITIES == JT.SEVERITIES
    from llm_sharding_demo_tpu.loadgen import profiles as jprofiles
    assert profiles.SLO_SOURCE_METRICS == jprofiles.SLO_SOURCE_METRICS
    assert profiles.SLO_POLICY == jprofiles.SLO_POLICY
    for series, *_ in grafttrend.WATCH_POLICY.values():
        assert grafttrend.watch_mode(series) == JT.watch_mode(series)
        if grafttrend.watch_mode(series) == "burn":
            assert grafttrend.slo_budget(series) == JT.slo_budget(series)


@pytest.mark.parametrize("policy", [
    {}, {"w": ("ttft_seconds", (1.0, 2.0), 2.0)},
    {"w": ("", 1.0, 1.0, "page")},
    {"w": ("queue_depth", 1.0, 1.0, "pager")},
    {"w": ("queue_depth", 1.0, 0, "page")},
    {"w": ("queue_depth", (1.0, 2.0), 1.0, "page")},
    {"w": ("ttft_seconds", (2.0, 1.0), 2.0, "page")},
    {"w": ("queue_depth", -5.0, 1.0, "page")},
    {"w": ("iter_rows_total", (1.0, 2.0), 1.0, "page")}])
def test_malformed_policies_refused_as_jax(policy):
    with pytest.raises(JT.WatchPolicyError) as want:
        JT.validate_policy(policy)
    with pytest.raises(grafttrend.WatchPolicyError) as got:
        grafttrend.validate_policy(policy)
    assert str(got.value) == str(want.value)


def _samples(seed: int, n: int = 80) -> list:
    rng = random.Random(seed)
    t = 0.0
    out = []
    for _ in range(n):
        t += rng.uniform(50.0, 2000.0)
        w = float(rng.randrange(1, 9))
        out.append((round(t, 3), float(rng.randrange(0, int(w) + 1)), w))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_reductions_equal_jax(seed):
    s = _samples(seed)
    now = s[-1][0] + 10.0
    for win in (5_000.0, 30_000.0, 1e9):
        assert grafttrend.burn_rate(s, now, win, 0.05) == \
            JT.burn_rate(s, now, win, 0.05)
        assert grafttrend.windowed_mean(s, now, win) == \
            JT.windowed_mean(s, now, win)
        assert grafttrend.ewma_drift(s, now, win) == \
            JT.ewma_drift(s, now, win)
        assert js(grafttrend.percentile_sketch(s, now, win)) == \
            js(JT.percentile_sketch(s, now, win))
    assert grafttrend.burn_rate([], now, 1.0, 0.05) is None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alerts_on_seeded_streams_equal_jax(seed):
    """The same samples and evaluation instants into both reducers:
    trips, latches and re-trips byte-identical (alerts without their
    wall-clock field), and the describe payloads equal."""
    rng = random.Random(seed)
    reds = (grafttrend.TrendReducer(registry=metrics.MetricsRegistry(),
                                    blackbox=False),
            JT.TrendReducer(registry=JM.MetricsRegistry(), blackbox=False))
    series = sorted({e[0] for e in JT.WATCH_POLICY.values()})
    t = 0.0
    trips = ([], [])
    for step in range(120):
        t += rng.uniform(100.0, 3000.0)
        name = rng.choice(series)
        burst = (step // 30) % 2 == 1      # alternating calm and burn
        w = float(rng.randrange(1, 6))
        v = (w if burst else 0.0) if JT.watch_mode(name) == "burn" else (
            rng.uniform(0, 40) if burst else rng.uniform(0, 0.05))
        for red in reds:
            red.observe(name, v, weight=w, t_ms=t)
        if step % 7 == 0:
            for red, got in zip(reds, trips):
                got.append(red.evaluate(now_ms=t))
    assert js(trips[0]) == js(trips[1])
    assert js(reds[0].alerts(strip_time=True)) == js(
        reds[1].alerts(strip_time=True))
    assert reds[0].alerts(strip_time=True), "the stream must trip"
    want = reds[1].describe(now_ms=t)
    want.pop("sizing")                       # waits for the planner
    assert js(reds[0].describe(now_ms=t)) == js(want)
    assert reds[0].health_view() == reds[1].health_view()


def test_poll_reads_the_registry_as_jax():
    """The same observations into both registries, two polls each: the
    same samples (burn deltas past the loosest target, the deadline
    counter against requests, gauge levels)."""
    regs = (metrics.MetricsRegistry(), JM.MetricsRegistry())
    reds = (grafttrend.TrendReducer(registry=regs[0], blackbox=False),
            JT.TrendReducer(registry=regs[1], blackbox=False))
    for red in reds:
        red.poll(now_ms=0.0)
    rng = random.Random(5)
    for _ in range(40):
        secs = rng.choice([0.003, 0.2, 3.0, 12.0, 40.0])
        mode = rng.choice(["greedy", "sample"])
        for reg in regs:
            reg.observe("ttft_seconds", secs, mode=mode)
            reg.observe("generate_request_seconds", secs * 3, mode=mode,
                        dispatch="local")
            reg.inc("generate_requests_total", mode=mode)
    for reg in regs:
        reg.inc("deadline_misses_total", value=7)
        reg.gauge("queue_depth", 5, scheduler="iter")
        reg.gauge("queue_depth", 19, scheduler="admission")
        reg.gauge("hop_breaker_open", 1.0, target="b")
    got = [red.poll(now_ms=1000.0) for red in reds]
    assert got[0] == got[1] == 5
    assert js(reds[0].dump_state()[0]) == js(reds[1].dump_state()[0])


# -- metrics -----------------------------------------------------------------


def test_prometheus_text_equals_jax():
    regs = (metrics.MetricsRegistry(), JM.MetricsRegistry())
    for reg in regs:
        reg.inc("generate_requests_total", mode="greedy")
        reg.inc("upstream_failures_total", value=2, shard='b"\\\nx')
        reg.gauge("queue_depth", 3, scheduler="iter")
        for v in (0.0005, 0.02, 7.0, 90.0):
            reg.observe("ttft_seconds", v, mode="sample")
    assert regs[0].prometheus() == regs[1].prometheus()
    assert regs[0].histogram_buckets() == regs[1].histogram_buckets()
    assert metrics.DEFAULT_BUCKETS == JM.DEFAULT_BUCKETS
    state = regs[0].dump_state()
    fresh = metrics.MetricsRegistry()
    fresh.restore_state(state)
    assert fresh.prometheus() == regs[0].prometheus()


# -- tracing -----------------------------------------------------------------


def _traces(mod):
    out = []
    for i in range(5):
        t = mod.RequestTrace(f"r{i}", mode="greedy")
        t.t0 = 100.0
        t.add_span("queue_wait", 100.0, 100.001 * (i + 1), scheduler="iter")
        payload = {"request_id": "down", "spans": [
            {"name": "prefill", "start_ms": 1.0, "duration_ms": 2.0,
             "spans": [{"name": "x", "start_ms": 1.5, "duration_ms": 0.5}]}]}
        t.graft("hop", payload, 100.0, 100.01, target="b")
        if i % 2:
            t.labels.update(error="deadline_exceeded")
        if i == 3:
            t.labels.update(profile="chat")
        t.t1 = 100.0 + 0.01 * (i + 1)
        out.append(t)
    return out


@pytest.mark.parametrize("kw", [{}, {"n": 2}, {"slowest": True},
                                {"errors_only": True},
                                {"profile": "chat"}])
def test_flight_recorder_views_equal_jax(kw):
    recs = (tracing.FlightRecorder(capacity=4), JTR.FlightRecorder(capacity=4))
    for rec, mod in zip(recs, (tracing, JTR)):
        for t in _traces(mod):
            rec.record(t)

    def strip(rows):
        return [{k: v for k, v in r.items() if k != "started_unix"}
                for r in rows]
    assert strip(recs[0].snapshot(**kw)) == strip(recs[1].snapshot(**kw))
    assert recs[0].find("r3") is not None and recs[0].find("r0") is None
    bad = tracing.debug_requests_payload(recs[0], {"n": "x"}, {})
    assert bad == JTR.debug_requests_payload(recs[1], {"n": "x"}, {})


def test_nested_spans_and_events_on_the_timeline():
    grafttime.clear()
    tr = tracing.RequestTrace("n-1")
    with tracing.use_trace(tr):
        with tracing.span("prefill", prefix=True):
            tracing.annotate_span(prefix_hit=False)
            with tracing.span("inner"):
                pass
    assert [s.name for s in tr.spans] == ["prefill"]
    assert tr.spans[0].labels == {"prefix": True, "prefix_hit": False}
    assert tr.find("inner") is tr.spans[0].children[0]
    tr.finish()
    assert [(e["kind"], e["name"]) for e in grafttime.events(rid="n-1")] == [
        ("span_open", "prefill"), ("span_open", "inner"),
        ("span_close", "inner"), ("span_close", "prefill"),
        ("span_close", "request")]


def test_profiler_trace_and_annotation(tmp_path):
    with tracing.trace(str(tmp_path)):
        with tracing.annotate("step"):
            torch.ones(8).add_(1)
    files = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert files and "step" in files[0].read_text()


def test_timed_observes_with_and_without_sync():
    reg = metrics.MetricsRegistry()
    with tracing.timed("dispatch_seconds", registry=reg, sync=True,
                       scope="s") as h:
        h.sync(torch.ones(2))
    with pytest.raises(ValueError):
        with tracing.timed("dispatch_seconds", registry=reg, scope="s"):
            raise ValueError("body")
    assert reg.snapshot()["histograms"][
        ("dispatch_seconds", (("scope", "s"),))][2] == 2


# -- graftscope --------------------------------------------------------------


def test_rings_are_bounded_and_keys_overflow(monkeypatch):
    monkeypatch.setattr(graftscope, "KEY_CAPACITY", 4)
    st = graftscope.ScopeState()
    for i in range(graftscope.RING_CAPACITY + 50):
        st.record("s", (i % 7,), 0.001)
        st.sample("queue_depth", i, scheduler="iter")
    assert len(st.calls("s")) == graftscope.RING_CAPACITY
    keys = st.program_keys("s")
    assert len(keys) == 5 and graftscope._OVERFLOW in keys
    assert sum(c for c, _ in keys.values()) == graftscope.RING_CAPACITY + 50
    snap = st.snapshot(n=3)
    assert len(snap["dispatch"]["s"]["ring"]) == 3
    assert len(snap["series"]["queue_depth{scheduler=iter}"]) == 3
    n = graftscope.RING_CAPACITY + 50
    kept = min(n, graftscope.SERIES_CAPACITY)
    assert snap["series_totals"]["queue_depth{scheduler=iter}"] == {
        "points": kept, "last": n - 1.0, "max": n - 1.0,
        "min": float(n - kept)}
    fresh = graftscope.ScopeState()
    fresh.restore_state(st.dump_state())
    assert fresh.program_keys("s") == keys


class _Event:
    """Stands in for ``torch.cuda.Event``: completes when told."""

    log = []

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done = False
        self.t = None

    def record(self, stream=None):
        self.t = len(_Event.log)
        _Event.log.append(("record", stream))

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert end.done
        return 2.5

    def synchronize(self):
        raise AssertionError("graftscope must never wait on an event")


def test_cuda_event_pairs_resolve_at_read_time(monkeypatch):
    """A call on a CUDA tensor (stood in for here) is bracketed by two
    events on the current stream; the snapshot reports the pair pending
    until its end completes, then its elapsed time, and never waits.
    While capturing, no pair is recorded."""
    _Event.log = []
    capturing = [False]
    monkeypatch.setattr(graftscope, "_cuda_device",
                        lambda values: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index: f"stream{index}")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    graftscope.clear()
    fn = graftscope.instrument(lambda x: x + 1, "engine._decode_seg",
                               key_fn=lambda x: (1,))
    assert fn(1) == 2
    assert _Event.log == [("record", "stream0"), ("record", "stream0")]
    snap = graftscope.snapshot()["dispatch"]["engine._decode_seg"]
    assert snap["stream"]["pending"] == 1 and snap["ring"][0][
        "stream_ms"] == "pending"
    ring = graftscope.STATE._rings["engine._decode_seg"]["samples"]
    for ev in ring[0][3]:
        ev.done = True
    snap = graftscope.snapshot()["dispatch"]["engine._decode_seg"]
    assert snap["stream"] == {"resolved": 1, "pending": 0, "none": 0,
                              "ms_total": 2.5}
    ring = graftscope.snapshot()["dispatch"]["engine._decode_seg"]["ring"]
    assert [(r["key"], r["stream_ms"]) for r in ring] == [("(1,)", 2.5)]
    capturing[0] = True
    fn(1)
    assert len(_Event.log) == 2          # no pair inside a capture
    ring = graftscope.snapshot()["dispatch"]["engine._decode_seg"]["ring"]
    assert ring[-1]["stream_ms"] is None
    kinds = [e["kind"] for e in grafttime.events(
        kinds=["dispatch_begin", "dispatch_end"])]
    assert kinds[-4:] == ["dispatch_begin", "dispatch_end"] * 2


def test_disabled_scope_records_nothing():
    graftscope.clear()
    graftscope.set_enabled(False)
    fn = graftscope.instrument(lambda: 3, "s")
    assert fn() == 3
    graftscope.sample("queue_depth", 1)
    graftscope.set_enabled(True)
    assert graftscope.snapshot()["dispatch"] == {}
    assert graftscope.series("queue_depth") == []


# -- graftmem ----------------------------------------------------------------


class _Owner:
    pass


def test_ledger_bytes_devices_peaks_and_events():
    led = graftmem.MemoryLedger()
    grafttime.clear()
    base = torch.zeros(4, 8)
    views = {"stacked": base, "layers": [base[0], base[1]]}
    o = _Owner()
    h = led.track(o, "params", "params", views)
    assert led.holding_bytes(o, "params") == base.nelement() * 4
    h2 = led.track(o, "cache", "engine_cache", [torch.zeros(16)])
    led.update(h2, [torch.zeros(64)])
    led.release(h2)
    snap = led.snapshot()
    assert snap["conserved"] and snap["allocator"] == {}
    assert snap["devices"] == {"cpu": 128}
    assert snap["components"]["params"]["devices"] == {"cpu": 128}
    assert snap["peaks"]["engine_cache"]["bytes"] == 256
    assert snap["peak_bytes"] == 128 + 256
    evs = [(e["kind"], e["component"], e["bytes"], e["total"])
           for e in grafttime.events(kinds=["mem_alloc", "mem_free"])]
    assert evs == [("mem_alloc", "params", 128, 128),
                   ("mem_alloc", "engine_cache", 64, 64),
                   ("mem_alloc", "engine_cache", 192, 256),
                   ("mem_free", "engine_cache", 256, 0)]
    led.release(h)
    with pytest.raises(ValueError):
        led.track(o, "x", "nowhere", base)


def test_ledger_reaches_quantized_weights():
    from llm_sharding_demo_tpu_torch.ops.quant import quantize_array
    w = quantize_array(torch.randn(3, 64, 32))
    tree = {"stacked": w, "layers": [w[0], w[1], w[2]]}
    assert graftmem.measure(tree) == (w.q.nelement()
                                      + 2 * w.scale.nelement())


def test_holdings_are_bounded_and_marked():
    led = graftmem.MemoryLedger()
    o = _Owner()
    for i in range(graftmem.HOLDINGS_CAPACITY + 2):
        led.track(o, f"h{i}", "prefix_store", torch.zeros(i + 1))
    snap = led.snapshot()
    assert len(snap["holdings"]) == graftmem.HOLDINGS_CAPACITY
    assert snap["holdings_truncated"]
    assert snap["holdings"][0]["bytes"] == 4 * (graftmem.HOLDINGS_CAPACITY
                                                + 2)


def test_collected_owner_released_at_the_next_call():
    """The owner's finalizer only queues its handle (a collection inside
    a lock of the package takes no lock); the next call releases it."""
    led = graftmem.MemoryLedger()
    o = _Owner()
    o.self_ref = o                        # only the cyclic collector frees it
    led.track(o, "cache", "engine_cache", torch.zeros(10))
    del o
    with led._lock:
        gc.collect()                      # a collection under the lock
    assert len(led._collected) == 1
    assert led.component_bytes() == {"engine_cache": 0}
    snap = led.snapshot()
    assert snap["conserved"] and snap["entries"] == 0


def test_disabled_ledger_hands_out_the_null_handle():
    graftmem.set_enabled(False)
    assert graftmem.track(_Owner(), "x", "params", torch.zeros(2)) == 0
    graftmem.update(0, torch.zeros(3))
    graftmem.release(0)
    graftmem.set_enabled(True)
    assert not graftmem.snapshot()["enabled"] or graftmem.snapshot()[
        "conserved"]
