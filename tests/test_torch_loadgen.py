"""The port's load generator against the JAX package's.

Held equal: every profile's schedule bytes at two seeds and two rates,
the arrival draws, ``PROFILES``, ``SLO_POLICY`` and the SLO vocabulary;
the reductions (``summarize``, ``pareto_row``, ``slo_row``,
``traffic_mix_row``, ``occupancy_summary`` over a window) on the same
inputs; and ``run_load`` in its serial, closed and open modes against
one scripted client: the requests each package puts on the wire, the
outcomes it records and the counts it reports. Each fired request is an
``arrival`` event on the timeline with the JAX package's fields, and a
serial run through the port's fleet joins the router's trace labels.
"""

import dataclasses
import threading

import pytest

from llm_sharding_demo_tpu import loadgen as jloadgen
from llm_sharding_demo_tpu.utils import graftscope as jgraftscope
from llm_sharding_demo_tpu.utils import grafttime as jgrafttime
from llm_sharding_demo_tpu_torch import loadgen
from llm_sharding_demo_tpu_torch.fleet import build_fleet
from llm_sharding_demo_tpu_torch.utils import graftscope, grafttime
from test_torch_grafttime import port_state_isolation  # noqa: F401

PACKAGES = {"jax": (jloadgen, jgraftscope, jgrafttime),
            "port": (loadgen, graftscope, grafttime)}
# the report fields a clock does not decide
COUNTS = ("profile", "seed", "mode", "width", "rate_scale", "offered",
          "completed", "abandoned", "shed_429", "shed_503",
          "deadline_misses", "errors", "error_codes")


@pytest.fixture(autouse=True)
def jax_state_isolation():
    """The JAX package's timeline and occupancy rings, saved and restored
    around every test (the port's: ``port_state_isolation``)."""
    saved = jgrafttime.dump_state(), jgraftscope.dump_state()
    yield
    jgrafttime.restore_state(saved[0])
    jgraftscope.restore_state(saved[1])


@pytest.mark.parametrize("name", sorted(jloadgen.PROFILES))
def test_schedule_bytes_equal_jax(name):
    prof, jprof = loadgen.profile(name), jloadgen.profile(name)
    for seed in (7, 8):
        for rate in (1.0, 2.0):
            got = loadgen.schedule_bytes(prof, seed, 32, rate)
            assert got == jloadgen.schedule_bytes(jprof, seed, 32, rate)
    assert got != loadgen.schedule_bytes(prof, 7, 32, 2.0)
    for k in (0, 5, 31):
        assert (loadgen.arrival_fields(prof, 3, k)
                == jloadgen.arrival_fields(jprof, 3, k))
    for i in range(max(prof.prefix_pool, 1)):
        assert (loadgen.shared_prefix(prof, i)
                == jloadgen.shared_prefix(jprof, i))


def test_profiles_and_slo_policy_equal_jax():
    assert sorted(loadgen.PROFILES) == sorted(jloadgen.PROFILES)
    for name, prof in loadgen.PROFILES.items():
        assert (dataclasses.asdict(prof)
                == dataclasses.asdict(jloadgen.PROFILES[name]))
    assert loadgen.SLO_POLICY == jloadgen.SLO_POLICY
    assert loadgen.SLO_METRICS == jloadgen.SLO_METRICS
    assert loadgen.SLO_SOURCE_METRICS == jloadgen.SLO_SOURCE_METRICS
    assert sorted(loadgen.__all__) == sorted(jloadgen.__all__)
    errors = []
    for lg in (loadgen, jloadgen):
        with pytest.raises(KeyError) as e:
            lg.profile("nope")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _outcomes(lg):
    O = lg.Outcome
    return [
        O(k=0, request_id="a", status=200, latency_s=1.0, new_tokens=8,
          ttft_s=0.2, tpot_s=0.05, generated="x"),
        O(k=1, request_id="b", status=200, latency_s=70.0, new_tokens=8,
          ttft_s=6.0, tpot_s=1.5),
        O(k=2, request_id="c", status=429, code="kv_pool_saturated"),
        O(k=3, request_id="d", status=503, code="circuit_open"),
        O(k=4, request_id="e", status=503, code="deadline_exceeded"),
        O(k=5, request_id="f", status=503, code="deadline_exceeded",
          abandoned=True),
        O(k=6, request_id="g", status=200, latency_s=2.0, new_tokens=1,
          ttft_s=1.0),
        O(k=7, request_id="h", status=-1, code="RuntimeError: down"),
    ]


def _plain(report: dict) -> dict:
    out = dict(report)
    out["outcomes"] = [dataclasses.asdict(o) for o in report["outcomes"]]
    return out


@pytest.mark.parametrize("name", ["bursty_chat", "abandonment",
                                  "long_context"])
def test_reductions_equal_jax(name):
    reps = {}
    for side, (lg, _, _) in PACKAGES.items():
        rep = lg.summarize(lg.profile(name), _outcomes(lg), wall_s=10.0,
                           seed=4, rate_scale=2.0, mode="open", width=4,
                           horizon_s=3.5)
        rep["occupancy"] = {"queue_depth": {"points": 3, "max": 2.0,
                                            "mean": 1.0},
                            "batch_occupancy": {"points": 3, "max": 1.0,
                                                "mean": 0.5}}
        reps[side] = (rep, lg.pareto_row(rep), lg.slo_row(rep),
                      lg.traffic_mix_row([rep, rep]))
    port, jax_ = reps["port"], reps["jax"]
    assert _plain(port[0]) == _plain(jax_[0])
    assert port[1:] == jax_[1:]
    assert port[0]["shed_429"] == 1 and port[0]["errors"] == 1


def test_occupancy_summary_windows_equal_jax():
    """Points sampled before ``now_ms`` fall outside the window."""
    got = {}
    for side, (lg, scope, _) in PACKAGES.items():
        scope.sample("queue_depth", 9.0, scheduler="w")
        since = scope.now_ms()
        for v in (1.0, 3.0, 2.0):
            scope.sample("queue_depth", v, scheduler="w")
        scope.sample("hop_breaker_open", 1.0, target="decode0")
        got[side] = {k: v for k, v in
                     lg.occupancy_summary(since_ms=since).items()
                     if k.startswith(("queue_depth", "hop_breaker_open"))}
    assert got["port"] == got["jax"]
    (depth,) = [v for k, v in got["port"].items()
                if k.startswith("queue_depth")]
    assert depth == {"points": 3, "max": 3.0, "mean": 2.0}


class ScriptedClient:
    """Answers by the request alone: a 429 for every fourth arrival, a
    typed 503 for a deadline of at most 40 ms, a 200 with an error for
    arrival 1, 6, 11, ..., else the prompt reversed. Records what it was
    sent."""

    def __init__(self):
        self.sent = []
        self._lock = threading.Lock()

    def post(self, path, json=None, headers=None):  # noqa: A002
        with self._lock:
            self.sent.append((path, json, dict(headers)))
        k = int(headers["X-Request-ID"].rsplit("-", 1)[1])
        dl = headers.get("X-Deadline-Ms")
        if k % 4 == 3:
            return _Resp(429, {"error": "kv_pool_saturated"})
        if dl is not None and int(dl) <= 40:
            return _Resp(503, {"error": "deadline_exceeded"})
        if k % 5 == 1:
            return _Resp(200, {"error": "unknown mode 'beam'"})
        return _Resp(200, {"generated": json["prompt"][::-1]})


@dataclasses.dataclass
class _Resp:
    status_code: int
    body: dict

    def json(self):
        return self.body


def _outcome_fields(o) -> tuple:
    return (o.k, o.request_id, o.status, o.code, o.abandoned, o.generated)


@pytest.mark.parametrize("mode", ["serial", "closed", "open"])
def test_run_load_equals_jax_on_a_scripted_client(mode):
    """The same wire requests, outcomes and counts in both packages, and
    one ``arrival`` event a request with the JAX package's fields."""
    got = {}
    for side, (lg, _, gt) in PACKAGES.items():
        client = ScriptedClient()
        since = gt.now_ms()
        rep = lg.run_load(client, lg.profile("abandonment"), seed=5, n=16,
                          rate_scale=40.0, mode=mode, width=3)
        arrivals = [e for e in gt.events(kinds=["arrival"])
                    if e["ts"] >= since]
        got[side] = (sorted(client.sent, key=lambda s: s[2]["X-Request-ID"]),
                     [_outcome_fields(o) for o in rep["outcomes"]],
                     {k: rep[k] for k in COUNTS},
                     sorted((e["rid"], e["k"], e["profile"], e["sched_t"])
                            for e in arrivals),
                     {frozenset(e) - {"where"} for e in arrivals})
    assert got["port"] == got["jax"]
    sent, outcomes, counts, arrivals, keys = got["port"]
    assert len(sent) == len(arrivals) == 16
    assert {o[2] for o in outcomes} == {200, 400, 429, 503}
    assert counts["abandoned"] > 0 and counts["shed_429"] == 4
    assert keys == {frozenset({"kind", "ts", "tid", "seq", "rid", "k",
                               "profile", "sched_t"})}


def test_serial_run_through_the_fleet_joins_router_labels():
    """A serial run at the port's router: the arrivals on the timeline,
    TTFT and tokens joined from the router's trace labels, nonzero
    throughput."""
    f = build_fleet(n_decode=2, n_prefill=1, device="cpu")
    since = grafttime.now_ms()
    rep = loadgen.run_load(f.client, loadgen.profile("bursty_chat"),
                           seed=11, n=3, mode="serial", recorder=f.recorder)
    assert rep["completed"] == 3, rep["error_codes"]
    assert rep["throughput_tokens_per_sec"] > 0 and rep["p99_ttft_ms"] > 0
    assert all(o.new_tokens > 0 and o.ttft_s > 0 for o in rep["outcomes"])
    evs = [e for e in grafttime.events(kinds=["arrival"]) if e["ts"] >= since]
    assert [e["rid"] for e in evs] == [o.request_id for o in rep["outcomes"]]
    # each arrival precedes its request's router spans on the one clock
    for e in evs:
        spans = [s for s in grafttime.events(rid=e["rid"])
                 if s["kind"] == "span_close"]
        assert spans and min(s["ts"] for s in spans) >= e["ts"]
    row = loadgen.traffic_mix_row([rep])["workloads"][0]
    assert row["workload"] == "bursty_chat_x1" and row["completed"] == 3
