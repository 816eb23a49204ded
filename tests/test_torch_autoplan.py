"""The static planner (``AUTO_PLAN=1``) in the port against the JAX
package's.

Unsharded rows live against ``tools/graftcheck/costmodel.plan`` on the
JAX tests' planner families: the same labels in the same order, the same
ok flags, parameter and KV bytes, costs (to the JAX payload's rounding
of 0.1), shape exactness, guard findings and infeasible-budget notes.
Mesh rows against the values and choices the JAX package's own tests
write down (``tests/test_graftplan.py``): this JAX release cannot trace
the mesh stand-ins on the CPU, so its sharded rows are not scored here.
The byte terms against the ``nbytes`` of the port's real parameters,
caches, pools, stages and rank shards, and the exact rows' forward
shapes against what the engine observes. Then the apps (the port's and
the JAX app on the same weights), and two gloo ranks resolving one plan
and serving what the hand-set knobs serve.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu.utils.config import from_env as jfrom_env
from llm_sharding_demo_tpu_torch.models import gpt2, llama, moe
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.parallel import partition as P_
from llm_sharding_demo_tpu_torch.parallel import spmd
from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
from llm_sharding_demo_tpu_torch.runtime.kv_pool import (KVBlockPool,
                                                         PagedKVRunner)
from llm_sharding_demo_tpu_torch.serving.app import (check_mesh, create_app,
                                                     resolve_auto_plan)
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import config as tconfig
from llm_sharding_demo_tpu_torch.utils import costmodel as TC
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_grafttime import port_state_isolation  # noqa: F401
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)
from tools.graftcheck import costmodel as CM
from tools.graftcheck import registry
from torch_mesh_ranks import RankGroup

PORT_CONFIGS = {"GPT2Config": gpt2.GPT2Config,
                "LlamaConfig": llama.LlamaConfig,
                "MoEConfig": moe.MoEConfig}


def port_config(jcfg):
    """The port's config of a JAX config (the same fields)."""
    cls = PORT_CONFIGS[type(jcfg).__name__]
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg)})


def family(name: str):
    """(JAX module, JAX config, port config) of a planner family."""
    fams = dict(registry.planner_families())
    fams["llama-tiny"] = registry.families()["llama-tiny"]
    module, jcfg = fams[name]
    return module, jcfg, port_config(jcfg)


def messages(row) -> list:
    return [f["message"] for f in row["findings"]]


# -- unsharded rows, live against the JAX planner ------------------------------


@pytest.mark.parametrize("name,kw", [
    ("gpt2-tiny", dict(max_batch_cap=8, kv_pool_blocks=16)),
    ("gpt2-tiny", dict(traffic="8/8x8", max_batch_cap=8)),
    ("gpt2-tiny", dict(traffic="16/32x8,64/16", max_batch_cap=4,
                       kv_pool_blocks=32, kv_block_size=8)),
    ("llama-gqa", dict(max_batch_cap=4, kv_pool_blocks=16)),
    ("moe-tiny", dict(max_batch_cap=4, kv_pool_blocks=16)),
], ids=["gpt2-pool", "gpt2-batched", "gpt2-mixed", "llama-pool",
        "moe-illegal"])
def test_unsharded_rows_equal_jax(name, kw):
    """Every row, in rank order: label, ok, parameter and KV bytes, cost,
    shape exactness against program exactness, and the guards' findings
    (MoE's iter and paged rows rejected with the JAX messages, never
    scored)."""
    module, jcfg, tcfg = family(name)
    kw = dict(kw)
    if "traffic" in kw:
        kw["traffic"] = CM.parse_traffic(kw["traffic"])
    want = CM.plan(module, jcfg, {}, max_seq=64, **kw)
    got = TC.plan(tcfg, {}, max_seq=64, hbm_gb=CM.DEFAULT_HBM_GB, **kw)
    assert [r["label"] for r in got["plan"]] == \
        [r["label"] for r in want["plan"]]
    for g, w in zip(got["plan"], want["plan"]):
        assert (g["ok"], g["cost_per_token"], g["param_bytes_per_device"],
                g["kv_bytes_per_device"], g["comm_bytes_per_token"],
                g["config"], g["serving_env"]) == \
            (w["ok"], w["cost_per_token"], w["param_bytes_per_device"],
             w["kv_bytes_per_device"], w["comm_bytes_per_token"],
             w["config"], w["serving_env"]), g["label"]
        assert messages(g) == messages(w), g["label"]
        if g["ok"]:
            assert g["shapes_exact"] == w["programs_exact"], g["label"]
    assert got["chosen"]["label"] == want["chosen"]["label"]
    assert got["rejected"] == want["rejected"]
    assert set(got) == set(want)
    if name == "moe-tiny":
        bad = [r for r in got["plan"] if r["config"]["batch_mode"] == "iter"
               or r["config"]["kv_pool_blocks"]]
        assert bad and all(not r["ok"] and r["findings"]
                           and r["cost_per_token"] is None for r in bad)


def test_default_traffic_reproduces_the_serving_default():
    """One device, single-stream traffic: the hand-tuned default ranks
    first (admission, MAX_BATCH=1, no pool, no mesh), as in the JAX
    package; 8-way traffic chooses an mb8 row."""
    _, jcfg, tcfg = family("gpt2-tiny")
    chosen = TC.plan(tcfg, {}, max_seq=64, max_batch_cap=8,
                     kv_pool_blocks=16, hbm_gb=16.0)["chosen"]
    dflt = ServingConfig()
    assert chosen["label"] == "single/admission/mb1"
    assert (chosen["config"]["batch_mode"], chosen["config"]["max_batch"],
            chosen["config"]["kv_pool_blocks"]) == (
        dflt.batch_mode, dflt.max_batch, dflt.kv_pool_blocks)
    env = chosen["serving_env"]
    assert (env["PP_DECODE"], env["TP_DECODE"], env["EP_DECODE"]) == \
        ("0", "0", "0")
    batched = TC.plan(tcfg, {}, max_seq=64, max_batch_cap=8, hbm_gb=16.0,
                      traffic=TC.parse_traffic("8/8x8"))["chosen"]
    assert batched["config"]["max_batch"] == 8


def test_infeasible_budget_rejects_with_the_jax_note():
    """A ~1 KiB budget: nothing fits, nothing is chosen, every row says
    so in the JAX note's words; the port's bytes are its parameters, KV
    and its own activation count."""
    module, jcfg, tcfg = family("gpt2-tiny")
    want = CM.plan(module, jcfg, {}, max_seq=64, hbm_gb=1e-6)
    got = TC.plan(tcfg, {}, max_seq=64, hbm_gb=1e-6)
    assert got["chosen"] is None is want["chosen"]

    def words(note):
        return re.sub(r"^infeasible: \d+ ", "infeasible: N ", note)

    assert [words(r["note"]) for r in got["plan"]] == \
        [words(r["note"]) for r in want["plan"]]
    for r in got["plan"]:
        assert r["hbm_bytes_per_device"] == (
            r["param_bytes_per_device"] + r["kv_bytes_per_device"]
            + r["peak_activation_bytes"])
        assert f"infeasible: {r['hbm_bytes_per_device']} bytes" in r["note"]


def test_activation_count_beside_jax():
    """The port counts a decode step's largest live set (the cache is
    written in place); the JAX package its traced step's largest
    intermediate, the rewritten cache. Both decide feasibility only: the
    factor, pinned where it stands, is what the PERF notes state."""
    module, jcfg, tcfg = family("gpt2-tiny")
    for batch in (1, 8):
        port = TC.peak_activation_bytes(tcfg, batch, 64)
        jaxs = CM.peak_activation_bytes(module, jcfg, batch, 64)
        assert port == 4 * batch * (8 + 2 * 64)
        assert jaxs == TC.kv_cache_bytes(tcfg, batch, 64) + 4 * batch * 8
        assert jaxs / port == pytest.approx(16416 / 544)


# -- mesh rows, against the JAX tests' written values ---------------------------


def test_comm_byte_goldens():
    """tests/test_graftplan.py's goldens: the pp hand-off (gpt2-tiny, D=8)
    at pp=2 B=1 and pp=4 B=2, llama-gqa's tp=2 all-reduces, its kvp=2
    partial-softmax gather, and kvp x tp additive."""
    _, _, g = family("gpt2-tiny")
    _, _, lg = family("llama-gqa")
    assert TC.pp_decode_comm_bytes(g, 2, 1) == 128
    assert TC.pp_decode_comm_bytes(g, 4, 2) == 1152
    assert TC.tp_decode_comm_bytes(lg, 1, 2) == 1024
    assert TC.kvp_decode_comm_bytes(lg, 1, 2) == 640
    assert (TC.kvp_decode_comm_bytes(lg, 1, 2)
            + TC.tp_decode_comm_bytes(lg, 1, 2)) == 1664


def test_ep_comm_bytes_follow_the_dispatch_schedule():
    """moe-tiny (E=4, top 2, capacity factor 1.25: C=1 a token, D=8, L=2)
    over ep=2, B=1: a rank's operand [2, 2 x 1 x 1, 8] f32 = 128 B, two
    all-to-alls a block each moving it x (2 - 1): 2 x 2 x 128 = 512."""
    _, _, m = family("moe-tiny")
    assert moe.expert_capacity(m, 1) == 1
    assert TC.ep_decode_comm_bytes(m, 1, 2) == 512
    assert TC.ep_decode_comm_bytes(m, 2, 2) == 1024


def test_llama_gqa_tp_mesh_gets_a_clean_sharded_plan():
    _, _, lg = family("llama-gqa")
    payload = TC.plan(lg, {"tp": 2}, max_seq=64, hbm_gb=16.0)
    chosen = payload["chosen"]
    assert chosen["config"]["topology"] == "tp"
    assert chosen["findings"] == [] and chosen["comm_bytes_per_token"] == 1024
    tp_rows = [r for r in payload["plan"] if r["config"]["topology"] == "tp"]
    assert tp_rows and all(r["ok"] for r in tp_rows)


def test_moe_ep_mesh_gets_a_clean_expert_plan():
    _, _, m = family("moe-tiny")
    chosen = TC.plan(m, {"ep": 2}, max_seq=64, hbm_gb=16.0)["chosen"]
    assert chosen["config"]["topology"] == "ep"
    assert chosen["findings"] == []
    assert chosen["comm_bytes_per_token"] > 0


def test_indivisible_tp_and_kvp_are_rejected():
    """llama-tiny's n_kv_head=1 splits over neither a tp nor a kvp axis
    of 2: rejected rows with the engine's guard words, the single row
    still chosen; a kvp row of a family without kvp divisors rejected;
    no pool, no kvp rows."""
    _, _, lt = family("llama-tiny")
    payload = TC.plan(lt, {"tp": 2}, max_seq=64, hbm_gb=16.0)
    tp_rows = [r for r in payload["plan"] if r["config"]["topology"] == "tp"]
    assert tp_rows and all(not r["ok"] for r in tp_rows)
    assert any("n_kv_head=1" in m for r in tp_rows for m in messages(r))
    assert payload["chosen"]["config"]["topology"] == "single"
    kvp = TC.plan(lt, {"kvp": 2}, max_seq=64, kv_pool_blocks=16,
                  kv_block_size=16, hbm_gb=16.0)["plan"]
    kvp_rows = [r for r in kvp if r["config"]["topology"] == "kvp"]
    assert kvp_rows and all(not r["ok"] and r["cost_per_token"] is None
                            for r in kvp_rows)
    assert any("n_kv_head=1 not divisible" in m and "kvp" in m
               for r in kvp_rows for m in messages(r))
    _, _, m = family("moe-tiny")
    rows = TC.plan(m, {"kvp": 2}, max_seq=64, kv_pool_blocks=16,
                   kv_block_size=16, hbm_gb=16.0)["plan"]
    assert any("kvp_divisors" in msg for r in rows
               if r["config"]["topology"] == "kvp" for msg in messages(r))
    _, _, lg = family("llama-gqa")
    assert [r for r in TC.plan(lg, {"kvp": 2}, max_seq=64,
                               hbm_gb=16.0)["plan"]
            if r["config"]["topology"] == "kvp"] == []


def test_kvp_tp_rows_halve_the_pool():
    """The JAX test's multi-axis rows: kvp at 640 comm bytes, kvp x tp at
    1664, both with exactly half the pool a device, kvp x tp holding
    fewer parameter bytes."""
    _, _, lg = family("llama-gqa")
    rows = {r["config"]["topology"]: r for r in TC.plan(
        lg, {"kvp": 2, "tp": 2}, max_seq=64, kv_pool_blocks=16,
        kv_block_size=16, hbm_gb=16.0)["plan"]}
    half = TC.kv_pool_bytes(lg, 16, 16) // 2
    for topo, comm in (("kvp", 640), ("kvp-tp", 1664)):
        assert rows[topo]["ok"] and rows[topo]["findings"] == []
        assert rows[topo]["comm_bytes_per_token"] == comm
        assert rows[topo]["kv_bytes_per_device"] == half
        assert rows[topo]["serving_env"]["KVP_DECODE"] == "1"
    assert (rows["kvp-tp"]["param_bytes_per_device"]
            < rows["kvp"]["param_bytes_per_device"])


@pytest.mark.parametrize("bad", ["layout", "stage", "paged"])
def test_port_gates_reject_with_findings(monkeypatch, bad):
    """The port's own gates: a split dim the layout table cannot divide
    (a tp axis of 3 over llama-gqa's 16-wide hidden, with the head
    counts' guard lifted), an empty stage, and a paged geometry whose
    blocks miss MAX_SEQ, each a rejected row with a finding."""
    _, _, lg = family("llama-gqa")
    if bad == "layout":
        monkeypatch.setitem(TC._DIVISORS, "llama",
                            dict(TC._DIVISORS["llama"], tp=()))
        row = next(r for r in TC.plan(lg, {"tp": 3}, max_seq=64,
                                      hbm_gb=16.0)["plan"]
                   if r["config"]["topology"] == "tp")
        assert not row["ok"]
        assert any("does not split into" in m for m in messages(row))
    elif bad == "stage":
        found = TC._stage_findings(lg, (2, 2), "pp/b2+2")
        assert found and "empty" in found[0].message
    else:
        found = TC._paged_findings(lg, 16, 24, 64, (1, 2), "kv")
        assert found and "rejected geometry" in found[0].message
        assert TC._paged_findings(lg, 16, 16, 64, (1, 4), "kv") == []


# -- bytes against real tensors ---------------------------------------------------


@pytest.mark.parametrize("name", ["gpt2-tiny", "llama-gqa", "moe-tiny"])
def test_bytes_equal_real_tensors(name):
    """param_bytes, kv_cache_bytes and kv_pool_bytes equal the nbytes of
    the port's real init_params, cache and pool; each pipeline stage's
    bytes those of partition_params' stages."""
    _, _, cfg = family(name)
    mod = {"GPT2Config": gpt2, "LlamaConfig": llama,
           "MoEConfig": moe}[type(cfg).__name__]
    params = mod.init_params(cfg, torch.Generator().manual_seed(0))
    leaves = list(TC._leaves(params))
    assert TC.param_bytes(cfg) == sum(t.nbytes for t in leaves)
    cache = mod.make_cache(cfg, 3, 32)
    assert TC.kv_cache_bytes(cfg, 3, 32) == cache.k.nbytes + cache.v.nbytes
    heads = getattr(cfg, "n_kv_head", cfg.n_head)
    pool = KVBlockPool(cfg.n_layer, 16, heads, 8, cfg.head_dim, max_seq=64,
                       device="cpu")
    assert TC.kv_pool_bytes(cfg, 16, 8) == pool.data.nbytes
    if name != "moe-tiny":
        bounds = P_.balanced_boundaries(cfg.n_layer, 2)
        stages = P_.partition_params(
            params, P_.make_stage_specs(cfg.n_layer, bounds))
        assert TC.stage_param_bytes(cfg, bounds) == [
            sum(t.nbytes for t in TC._leaves(s)) for s in stages]


class StandInMesh:
    """One rank's view of a mesh, for ``spmd.shard_params`` without a
    process group."""

    def __init__(self, axes: dict, rank: int):
        self.mesh_dim_names = tuple(axes)
        self._sizes = list(axes.values())
        self._rank = rank

    def size(self, i: int) -> int:
        return self._sizes[i]

    def get_local_rank(self, axis: str) -> int:
        return self._rank


@pytest.mark.parametrize("name,axes", [
    ("gpt2-tiny", {"tp": 2}), ("llama-gqa", {"tp": 2}),
    ("moe-tiny", {"ep": 2}),
])
def test_sharded_param_bytes_equal_rank_shards(name, axes):
    """A rank's parameter bytes under the layout table equal the nbytes
    of what ``spmd.shard_params`` gives each rank."""
    _, _, cfg = family(name)
    mod = {"GPT2Config": gpt2, "LlamaConfig": llama,
           "MoEConfig": moe}[type(cfg).__name__]
    params = mod.init_params(cfg, torch.Generator().manual_seed(0))
    want = TC.sharded_param_bytes(cfg, axes)
    assert want < TC.param_bytes(cfg)
    for rank in range(2):
        mesh = StandInMesh(axes, rank)
        shards = spmd.shard_params(params, mesh,
                                   TC.layout_table(cfg, axes))
        assert sum(t.nbytes for t in TC._leaves(shards)) == want


def test_exact_rows_shapes_equal_observed():
    """Every scored row marked exact runs exactly its forward shapes
    when its traffic's rounds replay on a real engine (the solo paged
    row on a real pool-backed runner)."""
    _, _, cfg = family("gpt2-tiny")
    traffic = (TC.TrafficRow(8, 4, 1), TC.TrafficRow(8, 4, 2),
               TC.TrafficRow(5, 1, 1))
    payload = TC.plan(cfg, {}, max_seq=64, traffic=traffic,
                      max_batch_cap=2, kv_pool_blocks=16, kv_block_size=8,
                      hbm_gb=16.0)
    rows = [r for r in payload["plan"] if r["ok"] and r["shapes_exact"]]
    assert {r["label"] for r in rows} >= {
        "single/admission/mb1", "single/admission/mb2",
        "single/admission/mb1/kv16x8"}
    params = gpt2.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    for row in rows:
        c = row["config"]
        eng = DecodeEngine(params, cfg, max_seq=64, device="cpu")
        runner = eng
        if c["kv_pool_blocks"]:
            runner = PagedKVRunner(eng, KVBlockPool.for_engine(
                eng, num_blocks=c["kv_pool_blocks"],
                block_size=c["kv_block_size"]))
        for b, p, n in TC.traffic_calls(traffic, c["max_batch"]):
            prompts = rng.integers(0, cfg.vocab_size, size=(b, p))
            runner.generate(prompts if b > 1 else prompts[0], n)
        seen = sorted(f"{b}x{t}" for b, t in eng.forward_shapes())
        assert seen == sorted(row["forward_shapes"]), row["label"]


# -- the apps ------------------------------------------------------------------


@pytest.fixture(scope="module")
def served_model():
    """The JAX test's served model (D=8, two layers), both packages'
    weights from one numpy draw."""
    dims = dict(vocab_size=257, n_positions=128, n_embd=8, n_layer=2,
                n_head=2)
    np_params = np_gpt2_params(seed=5, dims=dims)
    return ((jgpt2.GPT2Config(**dims), jax.tree.map(jnp.asarray, np_params)),
            (gpt2.GPT2Config(**dims), params_from_numpy(np_params,
                                                        device="cpu")))


BODY = {"prompt": "Hi", "max_new_tokens": 4, "mode": "greedy"}


@pytest.mark.parametrize("kw,label", [
    ({}, "single/admission/mb1"),
    ({"max_batch": 8, "auto_plan_traffic": "8/8x8"}, "single/admission/mb8"),
    ({"max_batch": 8, "kv_pool_blocks": 16, "auto_plan_traffic": "8/8x8"},
     "single/admission/mb8"),
], ids=["default", "batched", "pool"])
def test_app_resolves_the_jax_apps_plan(served_model, kw, label):
    """The port's app and the JAX app on the same config choose the same
    row (the JAX app sees 8 forced devices, the port one rank: their
    candidate counts differ, the choice does not), serve the resolved
    knobs, report the row under /healthz and /debug/plan ("startup"),
    and answer the same greedy reply."""
    (jcfg, jp), (tcfg, tp) = served_model
    jclient = JTestClient(jcreate_app(
        JServingConfig(model_id="t", max_seq=64, auto_plan=True, **kw),
        model=(jcfg, jp), tokenizer=JByteTokenizer()))
    client = TestClient(create_app(
        ServingConfig(model_id="t", max_seq=64, auto_plan=True, **kw),
        model=(tcfg, tp), tokenizer=ByteTokenizer(), device="cpu"))
    jh, h = jclient.get("/healthz").json(), client.get("/healthz").json()
    assert h["auto_plan"]["chosen"] == jh["auto_plan"]["chosen"] == label
    keys = set(jh["auto_plan"]) - {"programs_exact"} | {"shapes_exact"}
    assert set(h["auto_plan"]) == keys
    assert h["auto_plan"]["candidates"] >= 1
    assert h["auto_plan"]["cost_per_token"] == jh["auto_plan"][
        "cost_per_token"]
    for knob in ("max_batch", "batch_mode", "kv_pool_blocks", "pp_decode",
                 "tp_decode", "ep_decode"):
        assert h[knob] == jh[knob], knob
    plan = client.get("/debug/plan").json()
    assert plan["mode"] == "startup" and plan["auto_plan"] == h["auto_plan"]
    assert client.get("/debug/requests").json()["serving"]["auto_plan"] == \
        h["auto_plan"]
    assert client.post("/generate", json=BODY).json() == \
        jclient.post("/generate", json=BODY).json()


def test_auto_plan_refused_off_the_coordinator(served_model):
    (jcfg, jp), (tcfg, tp) = served_model
    with pytest.raises(ValueError) as e:
        create_app(ServingConfig(model_id="t", shard_role="a",
                                 auto_plan=True),
                   model=(tcfg, tp), tokenizer=ByteTokenizer(), device="cpu")
    with pytest.raises(ValueError) as je:
        jcreate_app(JServingConfig(model_id="t", shard_role="a",
                                   auto_plan=True),
                    model=(jcfg, jp), tokenizer=JByteTokenizer())
    assert str(e.value) == str(je.value)
    assert "AUTO_PLAN applies to the coordinator's local" in str(e.value)


@pytest.mark.parametrize("value", ["1", "true", "off", "maybe"])
def test_auto_plan_env_parses_as_jax(monkeypatch, value):
    monkeypatch.setenv("AUTO_PLAN", value)
    assert "AUTO_PLAN" not in tconfig.REFUSED_KNOBS
    if value == "maybe":
        with pytest.raises(ValueError) as e:
            tconfig.from_env()
        with pytest.raises(ValueError) as je:
            jfrom_env()
        assert str(e.value) == str(je.value)
        return
    assert tconfig.from_env().auto_plan is jfrom_env().auto_plan


def test_int8_planned_onto_tp_refuses_as_the_jax_app(served_model):
    """Where the planner puts an int8 model on tp (two layers over four
    ranks: no pp candidate), the resolved knobs meet the TP_DECODE int8
    guard, whose message is the JAX app's: neither package's planner
    reads the dtype."""
    (jcfg, jp), (tcfg, _) = served_model
    cfg4 = gpt2.GPT2Config(vocab_size=257, n_positions=128, n_embd=16,
                           n_layer=2, n_head=4)
    cfg, info = resolve_auto_plan(
        ServingConfig(model_id="t", max_seq=64, auto_plan=True,
                      inference_dtype="int8"), cfg4, 4, "cpu")
    assert info["chosen"] == "tp/admission/mb1" and cfg.tp_decode
    with pytest.raises(ValueError) as e:
        check_mesh(cfg, cfg4, True, 4)
    with pytest.raises(ValueError) as je:
        jcreate_app(JServingConfig(model_id="t", max_seq=64, tp_decode=True,
                                   inference_dtype="int8"),
                    model=(jcfg, jp), tokenizer=JByteTokenizer())
    assert str(e.value) == str(je.value)


def test_auto_plan_under_continuous_planning_merges(served_model,
                                                   monkeypatch):
    """With AUTO_PLAN_CONTINUOUS the live block merges over the start-up
    row. A budget that holds the pool but not eight contiguous rows puts
    the planner on the pooled iter row continuous planning needs."""
    _, (tcfg, tp) = served_model
    budget = (TC.param_bytes(tcfg) + TC.kv_pool_bytes(tcfg, 16, 16)
              + TC.peak_activation_bytes(tcfg, 8, 64))
    monkeypatch.setattr(TC, "device_memory_bytes", lambda device=None: budget)
    client = TestClient(create_app(
        ServingConfig(model_id="t", max_seq=64, auto_plan=True, max_batch=8,
                      batch_mode="iter", kv_pool_blocks=16,
                      auto_plan_traffic="8/8x8", auto_plan_continuous=True),
        model=(tcfg, tp), tokenizer=ByteTokenizer(), device="cpu"))
    try:
        h = client.get("/healthz").json()
        row = client.app.auto_plan
        assert row["chosen"] == "single/iter/mb8/kv16x16"
        live = client.app.plan_switcher.health_view()
        assert h["auto_plan"] == {**row, **live}
        assert client.get("/debug/plan").json()["mode"] != "startup"
        assert client.post("/generate", json=BODY).status_code == 200
    finally:
        for plan in client.app.plan_switcher.plans.values():
            if hasattr(plan, "close"):
                plan.close()


# -- two gloo ranks --------------------------------------------------------------

DIMS = dict(vocab_size=211, n_positions=128, n_embd=32, n_layer=4, n_head=2)
BODIES = [{"prompt": "The ranks plan", "max_new_tokens": 6,
           "mode": "greedy"},
          {"prompt": "a stage apiece", "max_new_tokens": 5, "seed": 3}]


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(2)
    yield group
    group.close()


def test_two_ranks_resolve_one_plan_and_serve_it(ranks):
    """Both ranks resolve the CPU planner's row for a world of two (pp
    here: the stage split halves the weight stream for 128 bytes of
    hand-off a token) and serve fp32 streams byte-equal to the same
    knobs set by hand."""
    np_params = np_gpt2_params(seed=4, dims=DIMS)
    want = TC.plan_for_serving(gpt2.GPT2Config(**DIMS), 2, 64,
                               device="cpu")["chosen"]
    assert want["label"] == "pp/b2/admission/mb1"
    auto = ranks.run("serve", family="gpt2", cfg_kw=DIMS, np_params=np_params,
                     serving=dict(model_id="t", max_seq=64, auto_plan=True),
                     bodies=BODIES, timeout_s=120.0)
    assert [r["auto_plan"]["chosen"] for r in auto] == [want["label"]] * 2
    assert auto[0]["auto_plan"] == auto[1]["auto_plan"]
    assert auto[0]["health"]["auto_plan"] == auto[0]["auto_plan"]
    assert auto[0]["health"]["pp_decode"] is True
    hand = ranks.run("serve", family="gpt2", cfg_kw=DIMS, np_params=np_params,
                     serving=dict(model_id="t", max_seq=64, pp_decode=True,
                                  boundaries=(2,)),
                     bodies=BODIES, timeout_s=120.0)
    assert auto[0]["replies"] == hand[0]["replies"]
    assert all("generated" in r for r in auto[0]["replies"])
