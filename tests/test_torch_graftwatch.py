"""Continuous planning in the port against the JAX package's.

The pure parts, on seeded inputs, equal to the JAX package's: the
watcher's estimates, ``score_plans`` and ``decide_plan``, ``plan_costs``
(the tiny GPT-2 and llama configs and GPT-2 124M, shapes only),
``calibrate`` and ``fit_cost_weights`` (weights, and the same typed
errors on malformed journals), and a scripted admit/release sequence
through both packages' ``PlanSwitcher`` (equal event journals). The
port's certified forward shapes: exact for the solo plan, a bound that
holds what the batched plan runs.

The apps: the port's ``AUTO_PLAN_CONTINUOUS`` app and the JAX package's
(the same ``demo_model`` weights, through numpy) answer a serial
``agentic`` run byte for byte, with equal switch journals, ``/healthz``
``auto_plan`` blocks and ``/debug/plan`` shapes. Under an open burst the
port's app switches both ways, its replies equal the serial run's and
both static plans', and every forward shape it ran lies in the certified
set. Then the config guards and the injected-pool checks with the JAX
messages, a malformed journal refused at start-up, an expired deadline
releasing the in-flight count, and ``grafttrend.refit`` and
``poll(plan_row=)`` beside the JAX package's.
"""

import dataclasses
import json
import random

import jax
import numpy as np
import pytest

from llm_sharding_demo_tpu import loadgen as jloadgen
from llm_sharding_demo_tpu.fleet import harness as jharness
from llm_sharding_demo_tpu.models import family_module as jfamily
from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.runtime.engine import DecodeEngine as JDecodeEngine
from llm_sharding_demo_tpu.utils import graftmem as jgraftmem
from llm_sharding_demo_tpu.utils import grafttrend as jgrafttrend
from llm_sharding_demo_tpu.utils import graftwatch as jgw
from llm_sharding_demo_tpu.utils.config import ServingConfig as JConfig
from llm_sharding_demo_tpu.utils.metrics import MetricsRegistry as JRegistry
from llm_sharding_demo_tpu_torch import loadgen
from llm_sharding_demo_tpu_torch.models import gpt2, llama
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime import kv_pool
from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
from llm_sharding_demo_tpu_torch.runtime.kv_pool import KVBlockPool
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import (costmodel, graftfault,
                                               graftmem, grafttrend,
                                               graftwatch)
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from llm_sharding_demo_tpu_torch.utils.metrics import MetricsRegistry
from llm_sharding_demo_tpu_torch.utils.tracing import FlightRecorder
from test_torch_grafttime import port_state_isolation  # noqa: F401
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies)
from tools.graftcheck import costmodel as JC
from tools.graftload import build_demo_app

MAX_SEQ = 64
MAX_BATCH = 3
SEED, N = 7, 10


def js(x) -> str:
    return json.dumps(x, sort_keys=True)


def agentic_traffic() -> str:
    """The schedule's own (prompt bytes, max_new) classes, as the JAX
    package's acceptance run declares them."""
    sched = loadgen.schedule(loadgen.profile("agentic"), SEED, N)
    classes = sorted({(len(a.prompt.encode("utf-8")), a.max_new)
                      for a in sched})
    return ",".join(f"{p}/{n}" for p, n in classes)


# -- the pure decision core ----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watcher_estimates_equal_jax(seed):
    """Seeded observation streams through windows of several sizes: the
    same estimate after every observation, and in any order."""
    rng = random.Random(seed)
    window = rng.choice([1, 4, 16])
    obs = [(rng.randrange(1, 200), rng.randrange(1, 64), rng.randrange(0, 9))
           for _ in range(40)]
    port = graftwatch.TelemetryWatcher(window=window,
                                       registry=MetricsRegistry())
    ref = jgw.TelemetryWatcher(window=window, registry=JRegistry())
    for p, n, pend in obs:
        assert port.observe(p, n, pend) == ref.observe(p, n, pend)
        assert port.estimate().to_dict() == ref.estimate().to_dict()
    tail = obs[-window:]
    shuffled = graftwatch.TelemetryWatcher(window=window,
                                           registry=MetricsRegistry())
    for p, n, pend in rng.sample(tail, len(tail)):
        shuffled.observe(p, n, pend)
    assert shuffled.estimate() == port.estimate()
    assert graftwatch.TelemetryWatcher(
        registry=MetricsRegistry()).estimate().to_dict() == \
        jgw.TrafficEstimate().to_dict()


CONFIG_PAIRS = {
    "gpt2-demo": (gpt2.GPT2Config(vocab_size=256, n_positions=64, n_embd=32,
                                  n_layer=2, n_head=4),
                  jgpt2.GPT2Config(vocab_size=256, n_positions=64, n_embd=32,
                                   n_layer=2, n_head=4)),
    "llama-tiny": (llama.CONFIGS["llama-tiny"], jllama.CONFIGS["llama-tiny"]),
    "gpt2-124m": (gpt2.CONFIGS["gpt2"], jgpt2.GPT2Config()),
}


@pytest.mark.parametrize("name", sorted(CONFIG_PAIRS))
def test_plan_costs_equal_jax(name):
    """The plans' cost terms from the port's own init shapes equal the
    JAX package's from its f32 init tree (``jax.eval_shape``)."""
    tcfg, jcfg = CONFIG_PAIRS[name]
    max_seq = min(tcfg.n_positions, 1024)
    port = graftwatch.plan_costs(tcfg, max_seq, 8)
    ref = jgw.plan_costs(jcfg, max_seq, 8)
    assert {k: v.to_dict() for k, v in port.items()} == \
        {k: v.to_dict() for k, v in ref.items()}
    assert costmodel.param_bytes(tcfg) == JC.tree_bytes(
        JC.param_avals(jfamily(jcfg), jcfg))
    assert costmodel.kv_cache_bytes(tcfg, 3, max_seq) == \
        JC.kv_cache_bytes(jcfg, 3, max_seq)


def _cost_pairs():
    mk = lambda cls, label, mode, mb, param, kv, comm=0: cls(  # noqa: E731
        label=label, batch_mode=mode, max_batch=mb, param_bytes=param,
        kv_bytes_per_row=kv, paged_overhead=0.0, comm_bytes=comm)
    synth = [{"solo": mk(cls, "solo", "admission", 1, 1000, 100),
              "batched": mk(cls, "batched", "iter", 4, 1000, 100, 7)}
             for cls in (graftwatch.PlanCost, jgw.PlanCost)]
    tcfg, jcfg = CONFIG_PAIRS["gpt2-demo"]
    real = [graftwatch.plan_costs(tcfg, MAX_SEQ, MAX_BATCH),
            jgw.plan_costs(jcfg, MAX_SEQ, MAX_BATCH)]
    return [synth, real]


@pytest.mark.parametrize("which", [0, 1], ids=["synthetic", "gpt2-demo"])
def test_score_and_decide_equal_jax(which):
    """Seeded estimates, weights and current plans: the same scores and
    the same decision (hysteresis and the switch back included)."""
    port_costs, ref_costs = _cost_pairs()[which]
    rng = random.Random(which)
    decisions = set()
    for _ in range(200):
        fields = dict(requests=rng.randrange(0, 17),
                      prompt_p50=rng.randrange(0, 64),
                      max_new_p50=rng.randrange(0, 32),
                      concurrency=rng.randrange(1, 9))
        w = rng.choice([None, 1.0, 4.0, 9.5])
        current = rng.choice(["solo", "batched"])
        margin = rng.choice([0.0, 0.1, 0.5])
        got = graftwatch.decide_plan(
            graftwatch.TrafficEstimate(**fields), port_costs,
            graftwatch.CostWeights(ici_byte_weight=w), current, margin)
        want = jgw.decide_plan(
            jgw.TrafficEstimate(**fields), ref_costs,
            jgw.CostWeights(ici_byte_weight=w), current, margin)
        assert got == want
        decisions.add((current, got[0]))
    # both directions and both stays occur in the sample
    assert decisions == {("solo", "solo"), ("solo", "batched"),
                         ("batched", "batched"), ("batched", "solo")}


def _switchers(costs_pair, wave=8, window=16):
    out = []
    for gw, reg_cls, costs in ((graftwatch, MetricsRegistry, costs_pair[0]),
                               (jgw, JRegistry, costs_pair[1])):
        reg = reg_cls()
        certified = {lb: {"certified": lb} for lb in costs}
        out.append(gw.PlanSwitcher(
            {lb: object() for lb in costs}, costs, certified,
            gw.TelemetryWatcher(window=window, registry=reg),
            weights=gw.CostWeights(ici_byte_weight=4.0), wave=wave,
            registry=reg))
    return out


@pytest.mark.parametrize("which", [0, 1], ids=["synthetic", "gpt2-demo"])
def test_scripted_admissions_give_jax_events(which):
    """A scripted admit/release sequence, no threads (serial, a held
    burst, serial again), through both packages' switchers: the same
    event journal, the same health view, both directions switched."""
    sched = loadgen.schedule(loadgen.profile("agentic"), SEED, 16)
    sws = _switchers(_cost_pairs()[which])
    for sw in sws:
        assert sw.health_view()["active"] == "solo"
        for a in sched:
            sw.admit(len(a.prompt.encode("utf-8")), a.max_new)
            sw.release()
        for a in sched[:8]:
            sw.admit(len(a.prompt.encode("utf-8")), a.max_new)
        for _ in range(8):
            sw.release()
        for a in sched:
            sw.admit(len(a.prompt.encode("utf-8")), a.max_new)
            sw.release()
    port, ref = sws
    assert js(port.events(strip_time=True)) == js(ref.events(strip_time=True))
    assert port.health_view() == ref.health_view()
    flips = [(e["from"], e["to"]) for e in port.events() if e["switched"]]
    assert ("solo", "batched") in flips and ("batched", "solo") in flips
    assert [e["switched"] for e in port.switch_history()] == [True] * len(
        flips)


def test_switcher_typed_errors():
    costs = _cost_pairs()[0][0]
    reg = MetricsRegistry()
    watcher = graftwatch.TelemetryWatcher(registry=reg)
    plans = {lb: object() for lb in costs}
    certified = {lb: {} for lb in costs}
    with pytest.raises(graftwatch.UncertifiedPlanError,
                       match="priced AND certified"):
        graftwatch.PlanSwitcher(plans, costs, {"solo": {}}, watcher,
                                registry=reg)
    rogue = {"solo": object(), "rogue": object()}
    rcosts = {"solo": costs["solo"],
              "rogue": dataclasses.replace(costs["batched"], label="rogue")}
    with pytest.raises(graftwatch.UncertifiedPlanError, match="PLAN_SET"):
        graftwatch.PlanSwitcher(rogue, rcosts, {lb: {} for lb in rogue},
                                watcher, registry=reg)
    with pytest.raises(graftwatch.UncertifiedPlanError, match="initial"):
        graftwatch.PlanSwitcher(plans, costs, certified, watcher,
                                initial="ghost", registry=reg)
    with pytest.raises(KeyError, match="unknown plan signal"):
        graftwatch.signal_series("ghost_signal")
    assert graftwatch.PLAN_SET == jgw.PLAN_SET
    assert graftwatch.SIGNALS == jgw.SIGNALS
    assert graftwatch.PLAN_SIGNALS == jgw.PLAN_SIGNALS


def test_certified_shapes_exact_for_solo_and_a_bound_for_batched():
    """The solo plan's certified set is what the paged runner runs for
    the declared traffic, shape for shape; the batched plan's holds a
    pooled iteration batcher's whole run over the same traffic (joins,
    growth and seeds of several widths). Payload fields count shapes."""
    tcfg, _ = CONFIG_PAIRS["gpt2-demo"]
    cert = graftwatch.certify_plan_set(tcfg, MAX_SEQ, MAX_BATCH, 12, 16,
                                       traffic="16/8,5/3")
    assert set(cert) == set(graftwatch.PLAN_SET)
    for label, row in cert.items():
        assert set(row) == {"forward_shapes", "shape_total", "shapes_exact",
                            "candidate"}
        assert row["shape_total"] == len(row["forward_shapes"]) > 0
        assert row["candidate"]["batch_mode"] == (
            "admission" if label == "solo" else "iter")
    assert cert["solo"]["shapes_exact"] is True
    assert cert["batched"]["shapes_exact"] is False
    assert cert["solo"]["forward_shapes"] == ["1x1", "1x5", "1x16"]
    assert set(cert["solo"]["forward_shapes"]) <= set(
        cert["batched"]["forward_shapes"])

    _, params = jharness.demo_model(MAX_SEQ)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params),
                                device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, n).tolist() for n in (16, 5, 16, 5, 16)]
    for label in ("solo", "batched"):
        eng = DecodeEngine(tparams, tcfg, max_seq=MAX_SEQ, device="cpu")
        pool = KVBlockPool.for_engine(eng, num_blocks=12, block_size=16)
        plans, _, certified = graftwatch.build_plan_set(
            eng, pool, tcfg, MAX_SEQ, MAX_BATCH, traffic="16/8,5/3")
        assert certified == cert
        runner = plans[label]
        if label == "solo":
            for p in prompts:
                runner.generate(np.asarray(p), 8 if len(p) == 16 else 3)
            seen = {graftwatch.shape_key(s) for s in eng.forward_shapes()}
            assert seen == set(cert["solo"]["forward_shapes"])
        else:
            import threading
            outs = []
            threads = [threading.Thread(target=lambda p=p: outs.append(
                runner.generate(np.asarray(p), 8 if len(p) == 16 else 3,
                                timeout=60.0))) for p in prompts]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
            assert len(outs) == len(prompts)
            seen = {graftwatch.shape_key(s) for s in eng.forward_shapes()}
            assert seen <= set(cert["batched"]["forward_shapes"]), seen
        assert pool.allocator.stats().blocks_in_use == 0


# -- calibration -----------------------------------------------------------------


def _attribution(workloads):
    return {"configs": [{"name": "graftscope_attribution",
                         "workloads": workloads}]}


GOOD_JOURNALS = {
    "empty": {},
    "no-configs": {"configs": []},
    "skipped": {"configs": [{"name": "graftscope_attribution",
                             "skipped": "tunnel down"}]},
    "unmeasured": _attribution([
        {"workload": "w", "measured_decode_seconds_per_token": None,
         "modeled_cost_bytes_per_token": 1e6}]),
    "hbm-only": _attribution([
        {"workload": "solo", "measured_decode_seconds_per_token": 2e-3,
         "modeled_cost_bytes_per_token": 1e6,
         "modeled_comm_bytes_per_token": 0,
         "entry_points": {"engine._decode_seg": {"seconds_total": 1.5},
                          "kv_pool._gather": {"seconds_total": 0.5}}},
        {"workload": "batch2", "measured_decode_seconds_per_token": 4e-3,
         "modeled_cost_bytes_per_token": 2e6,
         "modeled_comm_bytes_per_token": 0}]),
    "with-comm": _attribution([
        {"workload": "solo", "measured_decode_seconds_per_token": 2e-3,
         "modeled_cost_bytes_per_token": 1e6,
         "modeled_comm_bytes_per_token": 0},
        {"workload": "pp2", "measured_decode_seconds_per_token": 4e-3,
         "modeled_cost_bytes_per_token": 1.6e6 + 4.0 * 1e5,
         "modeled_comm_bytes_per_token": 1e5}]),
    "ici-row": {"configs": [{"name": "ici_byte_weight_calibration",
                             "measured_over_modeled": 2.0,
                             "ici_byte_weight": 4.0}]},
    "ici-legacy": {"parsed": {"configs": [
        {"name": "ici_byte_weight_calibration",
         "measured_over_modeled": 2.0}]}},
    "ici-bare-row": {"name": "ici_byte_weight_calibration",
                     "measured_over_modeled": 1.5, "ici_byte_weight": 3.0},
    "ici-error": {"configs": [{"name": "ici_byte_weight_calibration",
                               "error": "IndexError: ..."}]},
}

BAD_JOURNALS = {
    "workloads-not-list": {"configs": [{"name": "graftscope_attribution",
                                        "workloads": "oops"}]},
    "row-not-object": _attribution(["oops"]),
    "negative": _attribution([
        {"workload": "w", "measured_decode_seconds_per_token": -1.0,
         "modeled_cost_bytes_per_token": 1e6}]),
    "modeled-missing": _attribution([
        {"workload": "w", "measured_decode_seconds_per_token": 1e-3}]),
    "bool": _attribution([
        {"workload": "w", "measured_decode_seconds_per_token": True,
         "modeled_cost_bytes_per_token": 1e6}]),
    "inconsistent": _attribution([
        {"workload": "w", "measured_decode_seconds_per_token": 1e-3,
         "modeled_cost_bytes_per_token": 1e3,
         "modeled_comm_bytes_per_token": 1e6}]),
    "ici-ratio-string": {"configs": [{"name": "ici_byte_weight_calibration",
                                      "measured_over_modeled": "2.0"}]},
    "ici-base-negative": {"configs": [
        {"name": "ici_byte_weight_calibration",
         "measured_over_modeled": 2.0, "ici_byte_weight": -1.0}]},
}


@pytest.mark.parametrize("name", sorted(GOOD_JOURNALS))
def test_calibrate_and_fit_equal_jax(name):
    journal = GOOD_JOURNALS[name]
    assert costmodel.calibrate(journal) == JC.calibrate(journal)
    assert graftwatch.fit_cost_weights(journal).to_dict() == \
        jgw.fit_cost_weights(journal).to_dict()


@pytest.mark.parametrize("name", sorted(BAD_JOURNALS))
def test_malformed_journals_raise_jax_errors(name):
    journal = BAD_JOURNALS[name]
    with pytest.raises(costmodel.CalibrationError) as got:
        graftwatch.fit_cost_weights(journal)
    with pytest.raises(JC.CalibrationError) as want:
        jgw.fit_cost_weights(journal)
    assert str(got.value) == str(want.value)


def test_traffic_parsing_equal_jax():
    for spec in ("16/32x8,64/16", " 9/4 , 12/8x2 ", "7/1"):
        assert [r.to_dict() for r in costmodel.parse_traffic(spec)] == \
            [r.to_dict() for r in JC.parse_traffic(spec)]
    for bad in ("", "16", "a/b", "0/4", "4/4x0"):
        with pytest.raises(ValueError) as got:
            costmodel.parse_traffic(bad)
        with pytest.raises(ValueError) as want:
            JC.parse_traffic(bad)
        assert str(got.value) == str(want.value)
    assert costmodel.ICI_BYTE_WEIGHT == JC.ICI_BYTE_WEIGHT
    assert costmodel.PAGED_SEG_STEPS == JC.PAGED_SEG_STEPS
    assert [r.to_dict() for r in costmodel.DEFAULT_TRAFFIC] == \
        [r.to_dict() for r in JC.DEFAULT_TRAFFIC]


# -- the apps --------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights():
    jcfg, jparams = jharness.demo_model(MAX_SEQ)
    tcfg = gpt2.GPT2Config(vocab_size=jcfg.vocab_size,
                           n_positions=jcfg.n_positions, n_embd=jcfg.n_embd,
                           n_layer=jcfg.n_layer, n_head=jcfg.n_head)
    return tcfg, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                   device="cpu")


def port_app(weights, max_batch=MAX_BATCH, continuous=True, traffic=None,
             kv_pool_blocks=0, **cfg_kw):
    """The port's counterpart of the JAX ``build_demo_app``: (client,
    recorder, registry)."""
    tcfg, tparams = weights
    if kv_pool_blocks <= 0:
        kv_pool_blocks = max(max_batch, 2) * (-(-MAX_SEQ // 16))
    cfg = ServingConfig(
        model_id="graftload-demo", shard_role="coordinator", max_seq=MAX_SEQ,
        boundaries=(1,), max_batch=max_batch,
        batch_mode="iter" if max_batch > 1 else "admission",
        batch_wait_ms=10.0, kv_pool_blocks=kv_pool_blocks,
        kv_block_size=16, auto_plan_continuous=continuous,
        auto_plan_traffic=(traffic if traffic is not None
                           else agentic_traffic()) if continuous else "",
        **cfg_kw)
    recorder = FlightRecorder(capacity=256)
    registry = MetricsRegistry()
    app = create_app(cfg, model=(tcfg, tparams), tokenizer=ByteTokenizer(),
                     device="cpu", registry=registry, recorder=recorder)
    return TestClient(app), recorder, registry


def drive(client, recorder, lg, mode="serial", rate=1.0):
    rep = lg.run_load(client, lg.profile("agentic"), seed=SEED, n=N,
                      mode=mode, rate_scale=rate, recorder=recorder)
    assert rep["completed"] == N, rep["error_codes"]
    return [(o.status, o.generated) for o in rep["outcomes"]]


@pytest.fixture(scope="module")
def serial_pair(weights):
    """Both packages' continuous apps after the same serial agentic run
    (three times over, past a wave boundary): ``{side: (client,
    replies)}``."""
    out = {}
    jc, jr, _ = build_demo_app(max_seq=MAX_SEQ, max_batch=MAX_BATCH,
                               recorder_capacity=256, continuous=True,
                               auto_plan_traffic=agentic_traffic())
    out["jax"] = (jc, [r for _ in range(3)
                       for r in drive(jc, jr, jloadgen)])
    tc, tr, _ = port_app(weights)
    out["port"] = (tc, [r for _ in range(3) for r in drive(tc, tr, loadgen)])
    return out


def test_serial_agentic_equals_jax(serial_pair):
    """Byte for byte, with the same switch journal and health block."""
    (jc, jrep), (tc, trep) = serial_pair["jax"], serial_pair["port"]
    assert trep == jrep
    assert all(s == 200 for s, _ in trep)
    jsw, tsw = jc.app.plan_switcher, tc.app.plan_switcher
    assert js(tsw.events(strip_time=True)) == js(jsw.events(strip_time=True))
    assert len(tsw.events()) == 3 * N // tsw.wave
    th, jh = tc.get("/healthz").json(), jc.get("/healthz").json()
    assert th["auto_plan"] == jh["auto_plan"]
    assert th["auto_plan"]["mode"] == "continuous"
    assert th["iter_batch_stats"].keys() >= {"segments", "joins"} or \
        th["iter_batch_stats"]
    st = th["kv_pool_stats"]
    assert st["blocks_in_use"] + st["blocks_free"] == st["blocks_total"]


def test_debug_plan_has_the_jax_shape(serial_pair):
    (jc, _), (tc, _) = serial_pair["jax"], serial_pair["port"]
    tp, jp = tc.get("/debug/plan?n=4").json(), jc.get("/debug/plan?n=4").json()
    assert set(tp) == set(jp)
    for key in ("mode", "active", "switches", "wave", "margin", "admitted",
                "estimate", "calibrated_weights", "events", "signals"):
        assert js(tp[key] if key != "events" else
                  [{k: v for k, v in e.items() if k != "t_ms"}
                   for e in tp[key]]) == js(
            jp[key] if key != "events" else
            [{k: v for k, v in e.items() if k != "t_ms"} for e in jp[key]])
    assert set(tp["signal_values"]) == set(jp["signal_values"])
    for sig, val in tp["signal_values"].items():
        assert val["series"] == graftwatch.PLAN_SIGNALS[sig]
        assert val["kind"] == jp["signal_values"][sig]["kind"]
    # plan rows: the JAX package's fields, with the certified shapes in
    # place of its program counts (by design)
    for trow, jrow in zip(tp["plans"], jp["plans"]):
        assert set(trow) == set(jrow)
        for key in ("label", "active", "batch_mode", "max_batch",
                    "cost_terms", "score_bytes_per_token"):
            assert trow[key] == jrow[key]
        assert set(jrow["certified"]) == {"programs", "program_total",
                                          "programs_exact", "candidate"}
        assert set(trow["certified"]) == {"forward_shapes", "shape_total",
                                          "shapes_exact", "candidate"}
        assert trow["certified"]["shapes_exact"] == \
            jrow["certified"]["programs_exact"]
        assert trow["certified"]["candidate"] == {
            k: jrow["certified"]["candidate"][k]
            for k in trow["certified"]["candidate"]}
    assert tc.get("/debug/plan?n=x").status_code == 422
    assert tc.get("/debug/plan?n=x").json() == \
        jc.get("/debug/plan?n=x").json()
    assert "/debug/plan" in tc.get("/debug").json()["surfaces"]


def test_open_burst_switches_both_ways_within_the_certified_set(weights):
    """The acceptance run on the CPU: serial, an open burst at 60x the
    profile's rate, serial; then the whole mix again. Switches both ways;
    every reply 200 and byte-equal across phases and to each static plan
    (solo paged, pooled iter); every forward shape the engine ran, first
    run and replay, inside the certified set, and the replay adds no
    single-row shape; the counters, the health block and the pool's
    conservation agree; no block leaked."""
    client, recorder, reg = port_app(weights)
    sw = client.app.plan_switcher
    assert sw.health_view()["active"] == "solo"
    eng = sw.plans["solo"].engine
    assert sw.plans["batched"].engine is eng
    phases = [drive(client, recorder, loadgen),
              drive(client, recorder, loadgen, "open", 60.0),
              drive(client, recorder, loadgen)]
    first = dict(eng.forward_shapes())
    phases += [drive(client, recorder, loadgen),
               drive(client, recorder, loadgen, "open", 60.0),
               drive(client, recorder, loadgen)]
    flips = [(e["from"], e["to"]) for e in sw.events() if e["switched"]]
    assert ("solo", "batched") in flips and ("batched", "solo") in flips
    assert all(p == phases[0] for p in phases)
    assert all(s == 200 for s, _ in phases[0])
    for static_batch in (1, MAX_BATCH):
        c2, r2, _ = port_app(weights, max_batch=static_batch,
                             continuous=False)
        assert c2.app.plan_switcher is None
        assert drive(c2, r2, loadgen) == phases[0], static_batch
    shapes = eng.forward_shapes()
    assert sw.uncertified_shapes(first) == []
    assert sw.uncertified_shapes(shapes) == []
    # the replay adds no shape of one row: what it may add is a seed of
    # more rows, whose width the burst's arrival timing decides
    assert {s for s in shapes if s not in first and s[0] == 1} == set()
    switch_total = sum(v for (name, _), v in reg.snapshot()["counters"]
                       .items() if name == "plan_switches_total")
    assert switch_total == sw.health_view()["switches"] == len(flips)
    active = {dict(labels)["plan"]: v for (name, labels), v
              in reg.snapshot()["gauges"].items()
              if name == "auto_plan_active"}
    assert active == {lb: float(lb == sw.health_view()["active"])
                      for lb in graftwatch.PLAN_SET}
    h = client.get("/healthz").json()
    assert h["auto_plan"] == sw.health_view()
    st = h["kv_pool_stats"]
    assert st["blocks_in_use"] == 0
    assert st["blocks_in_use"] + st["blocks_free"] == st["blocks_total"]
    kv_pool.graftsan_sweep(timeout=10.0)
    # the active plan rides the load driver's occupancy view, as in the
    # JAX package's
    assert loadgen.driver.OCCUPANCY_SERIES == jloadgen.driver.OCCUPANCY_SERIES
    assert any(lb.startswith("auto_plan_active")
               for lb in loadgen.occupancy_summary())


def test_expired_deadline_releases_inflight(weights, monkeypatch):
    """A request that dies between its admission and its runner (a spent
    deadline) still releases the switcher's in-flight count."""
    client, _, _ = port_app(weights, traffic="16/8")
    sw = client.app.plan_switcher
    base = sw.watcher.admitted()
    monkeypatch.setattr(graftfault.Deadline, "expired", lambda self: True)
    for i in range(3):
        r = client.post("/generate", json={"prompt": f"doomed request {i}",
                                           "max_new_tokens": 4,
                                           "mode": "greedy"},
                        headers={"X-Deadline-Ms": "5"})
        assert r.status_code == 503
        assert r.json()["error"] == "deadline_exceeded"
    assert sw.watcher.admitted() == base + 3
    with sw._lock:
        assert sw._inflight == 0
    monkeypatch.undo()
    r = client.post("/generate", json={"prompt": "healthy again",
                                       "max_new_tokens": 4, "mode": "greedy"})
    assert r.status_code == 200
    assert sw.watcher.estimate().concurrency == 1


# -- configuration ---------------------------------------------------------------


POOLED = dict(kv_pool_blocks=12, max_batch=3, batch_mode="iter", max_seq=64)
GUARDS = {
    "no-pool": dict(auto_plan_continuous=True),
    "admission": dict(POOLED, batch_mode="admission",
                      auto_plan_continuous=True),
    "spec": dict(POOLED, spec_decode=2, auto_plan_continuous=True),
    "prefix": dict(POOLED, prefix_cache=4, auto_plan_continuous=True),
    "chunk": dict(POOLED, prefill_chunk=16, auto_plan_continuous=True),
    "pool-dtype": dict(POOLED, kv_pool_dtype="int8",
                       auto_plan_continuous=True),
    "journal-alone": dict(auto_plan_journal="/j"),
}


@pytest.mark.parametrize("name", sorted(GUARDS))
def test_config_guards_give_jax_messages(name):
    with pytest.raises(ValueError) as got:
        ServingConfig(**GUARDS[name])
    with pytest.raises(ValueError) as want:
        JConfig(**GUARDS[name])
    assert str(got.value) == str(want.value)


def test_env_knobs_parse_as_jax(monkeypatch, tmp_path):
    from llm_sharding_demo_tpu.utils.config import from_env as jfrom_env
    from llm_sharding_demo_tpu_torch.utils.config import from_env
    env = {"AUTO_PLAN_CONTINUOUS": "yes", "AUTO_PLAN_TRAFFIC": "9/4x2,12/8",
           "AUTO_PLAN_JOURNAL": str(tmp_path / "j.json"),
           "KV_POOL_BLOCKS": "12", "MAX_BATCH": "3", "BATCH_MODE": "iter",
           "MAX_SEQ": "64"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = from_env(), jfrom_env()
    for field in ("auto_plan_continuous", "auto_plan_traffic",
                  "auto_plan_journal"):
        assert getattr(got, field) == getattr(want, field)
    monkeypatch.setenv("AUTO_PLAN_CONTINUOUS", "maybe")
    with pytest.raises(ValueError) as e:
        from_env()
    with pytest.raises(ValueError) as je:
        jfrom_env()
    assert str(e.value) == str(je.value)


def test_injected_pool_checks_and_malformed_journal(weights, tmp_path):
    """An injected pool of another width or of quantized blocks is
    refused with the JAX app's messages; a malformed AUTO_PLAN_JOURNAL
    refuses start-up with CalibrationError."""
    tcfg, tparams = weights
    cfg = ServingConfig(model_id="x", max_seq=MAX_SEQ, auto_plan_continuous=True,
                        **{k: v for k, v in POOLED.items() if k != "max_seq"})
    eng = DecodeEngine(tparams, tcfg, max_seq=MAX_SEQ // 2, device="cpu")
    narrow = KVBlockPool.for_engine(eng, num_blocks=12, block_size=16)
    with pytest.raises(ValueError, match=f"injected kv_pool spans "
                       f"{MAX_SEQ // 2} slots, engine cache is {MAX_SEQ}"):
        create_app(cfg, model=weights, tokenizer=ByteTokenizer(),
                   device="cpu", registry=MetricsRegistry(), kv_pool=narrow)
    eng = DecodeEngine(tparams, tcfg, max_seq=MAX_SEQ, device="cpu")
    quant = KVBlockPool.for_engine(eng, num_blocks=12, block_size=16,
                                   block_dtype="int8")
    with pytest.raises(ValueError, match="AUTO_PLAN_CONTINUOUS certifies "
                       "the full-precision mover programs only"):
        create_app(cfg, model=weights, tokenizer=ByteTokenizer(),
                   device="cpu", registry=MetricsRegistry(), kv_pool=quant)
    bad = tmp_path / "BENCH_bad.json"
    bad.write_text(json.dumps(BAD_JOURNALS["negative"]))
    with pytest.raises(costmodel.CalibrationError):
        port_app(weights, auto_plan_journal=str(bad))
    good = tmp_path / "BENCH_good.json"
    good.write_text(json.dumps(GOOD_JOURNALS["with-comm"]))
    client, _, _ = port_app(weights, auto_plan_journal=str(good))
    w = client.get("/debug/plan").json()["calibrated_weights"]
    assert w == jgw.fit_cost_weights(GOOD_JOURNALS["with-comm"]).to_dict()


# -- the trend reducer's planning hooks ------------------------------------------


def test_refit_threads_jax_weights_into_the_switcher():
    journal = GOOD_JOURNALS["with-comm"]
    sws = _switchers(_cost_pairs()[1])
    regs = (MetricsRegistry(), JRegistry())
    reds = (grafttrend.TrendReducer(registry=regs[0], blackbox=False),
            jgrafttrend.TrendReducer(registry=regs[1], blackbox=False))
    got = grafttrend.refit(journal, switcher=sws[0], registry=regs[0],
                           reducer=reds[0])
    want = jgrafttrend.refit(journal, switcher=sws[1], registry=regs[1],
                             reducer=reds[1])
    assert got.to_dict() == want.to_dict()
    assert sws[0].weights.to_dict() == sws[1].weights.to_dict()
    assert reds[0].refit_history() == reds[1].refit_history()
    gauge = {name: v for (name, _), v in regs[0].snapshot()["gauges"].items()}
    assert gauge["costmodel_byte_weight"] == \
        regs[1].snapshot()["costmodel_byte_weight"]
    assert js(reds[0].describe(now_ms=0.0)["refits"]) == js(
        reds[1].describe(now_ms=0.0)["refits"])
    # without calls or costs the live journal has no rows: a-priori
    assert grafttrend.live_attribution_journal()["workloads"] == []
    assert grafttrend.SIZING_POLICY == jgrafttrend.SIZING_POLICY


def test_reconcile_and_poll_plan_row_equal_jax(weights):
    """The ledger against the cost model's parameter bytes: an fp32
    engine's weights reconcile exactly (ratio 1, drift 0) in both
    packages, and ``poll(plan_row=)`` folds the drift as a sample."""
    tcfg, tparams = weights
    jcfg, jparams = jharness.demo_model(MAX_SEQ)
    graftmem.clear()
    jgraftmem.clear()
    eng = DecodeEngine(tparams, tcfg, max_seq=MAX_SEQ, device="cpu")
    jeng = JDecodeEngine(jparams, jcfg, max_seq=MAX_SEQ)
    row = {"label": "solo",
           "param_bytes_per_device": costmodel.param_bytes(tcfg),
           "kv_bytes_per_device": 0}
    got, want = graftmem.reconcile(row), jgraftmem.reconcile(row)
    assert got["components"]["params"] == want["components"]["params"]
    assert got["components"]["params"]["ratio"] == 1.0
    assert got["max_component_drift"] == want["max_component_drift"] == 0.0
    red = grafttrend.TrendReducer(registry=MetricsRegistry(), blackbox=False)
    assert red.poll(plan_row=row, now_ms=5.0) >= 1
    samples = red.dump_state()[0]
    assert samples["graftmem_params_drift"] == [(5.0, 0.0, 1.0)]
    del eng, jeng
