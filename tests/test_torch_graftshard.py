"""The port's live placement auditor (``utils/graftshard``) against the
JAX package's.

Placement records stand in for JAX's ``.sharding``: the unit cases plant
them on CPU tensors owned by a fake module with a declared
``PLACEMENT_CONTRACT`` (the JAX tests' pattern); the live case arms
``GRAFTSHARD=1`` on two spawned gloo ranks (``torch_mesh_ranks``), where
a tp engine, an ep engine and the pipelined decoder must audit clean and
a planted wrong share must be found.
"""

import sys
import types

import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.utils import graftshard as jgraftshard
from llm_sharding_demo_tpu_torch.utils import graftmem, graftshard
from test_torch_model import np_gpt2_params, np_moe_params
from torch_mesh_ranks import RankGroup

FAKE = "graftshard_fake_owner_module"
# the fake owner module's declaration (its file is this one, so a
# violation points here)
PLACEMENT_CONTRACT = {"mesh_axes": ("tp",), "holding:buf": "replicated",
                      "holding:w": "tp"}


@pytest.fixture
def armed(monkeypatch):
    """GRAFTSHARD=1, a fake owner module declaring two holdings, and the
    auditor's and the ledger's state restored afterwards."""
    monkeypatch.setenv("GRAFTSHARD", "1")
    mod = types.ModuleType(FAKE)
    mod.__file__ = __file__
    mod.PLACEMENT_CONTRACT = PLACEMENT_CONTRACT
    monkeypatch.setitem(sys.modules, FAKE, mod)
    saved = graftmem.dump_state()
    graftshard.clear()
    yield type("Owner", (), {"__module__": FAKE})
    graftshard.clear()
    graftmem.restore_state(saved)


def test_mesh_axes_match_jax():
    assert graftshard.MESH_AXES == jgraftshard.MESH_AXES
    assert graftshard.REPLICATED == jgraftshard.REPLICATED
    assert issubclass(graftshard.GraftshardError, AssertionError)


def test_unarmed_records_and_checks_nothing(monkeypatch):
    monkeypatch.delenv("GRAFTSHARD", raising=False)
    graftshard.clear()
    t = torch.zeros(4, 2)
    assert graftshard.place(t, (8, 2), [(0, "tp", 4)]) is t
    assert graftshard.STATE.placement(t) is None
    assert graftshard.status() == {"enabled": False, "checks": 0,
                                   "violations": 0, "tracked": 0}


def test_replicated_holding_checks_shape_and_axes(armed):
    """A replicated holding passes at its global shape; a leaf split over
    an axis, or short of its global shape, raises with the declaration's
    provenance and JAX's wording."""
    owner = armed()
    ok = graftshard.place(torch.zeros(4, 2), (4, 2))
    graftmem.track(owner, "buf", "params", {"a": ok})
    assert graftshard.status()["checks"] == 1
    split = graftshard.place(torch.zeros(2, 2), (4, 2), [(0, "tp", 2)])
    with pytest.raises(graftshard.GraftshardError) as e:
        graftmem.track(owner, "buf", "params", {"a": ok, "b": split})
    err = e.value
    assert (err.holding, err.expected, err.found) == ("buf", "replicated",
                                                      ("tp",))
    line = next(i for i, text in enumerate(open(__file__), 1)
                if text.startswith("PLACEMENT_CONTRACT"))
    assert err.where == f"{__file__}:{line}"
    assert jgraftshard._problem("replicated", {"tp"}) in str(err)
    short = graftshard.place(torch.zeros(2, 2), (4, 2))
    with pytest.raises(graftshard.GraftshardError,
                       match=r"holds \[2, 2\] of global \[4, 2\]"):
        graftmem.track(owner, "buf", "params", short)


def test_axis_holding_checks_share_and_stray_axes(armed):
    """A holding declared over tp: each leaf's recorded share along its
    split dim, replicated leaves beside it, no other axis."""
    owner = armed()
    w = graftshard.place(torch.zeros(3, 4), (3, 8), [(1, "tp", 4)])
    b = graftshard.place(torch.zeros(8), (8,))
    h = graftmem.track(owner, "w", "params", {"w": w, "b": b})
    assert graftshard.status()["violations"] == 0
    wrong = graftshard.place(torch.zeros(3, 3), (3, 8), [(1, "tp", 4)])
    with pytest.raises(graftshard.GraftshardError,
                       match="dim 1 holds 3 of global 8"):
        graftmem.update(h, {"w": wrong, "b": b})
    stray = graftshard.place(torch.zeros(2, 8), (4, 8), [(0, "ep", 2)])
    with pytest.raises(graftshard.GraftshardError) as e:
        graftmem.track(owner, "w", "params", stray)
    assert jgraftshard._problem("tp", {"ep"}) in str(e.value)


def test_unplaced_tensors_satisfy_every_declaration(armed):
    """A single-device holding (no placement record) passes both
    declarations; an owner whose module declares nothing is not
    audited."""
    owner = armed()
    graftmem.track(owner, "buf", "params", torch.zeros(3))
    graftmem.track(owner, "w", "params", torch.zeros(3))
    undeclared = type("Undeclared", (), {"__module__": "no_such_module"})
    graftmem.track(undeclared(), "w", "params", torch.zeros(3))
    assert graftshard.status() == {"enabled": True, "checks": 2,
                                   "violations": 0, "tracked": 2}


def test_audit_rows_release_and_clear(armed):
    """``audit`` re-walks live holdings and reports (never raises) a
    placement that drifted after registration; a released holding is no
    longer audited."""
    owner = armed()
    t = torch.zeros(4, 2)
    graftshard.place(t, (4, 2))
    value = {"a": t}
    h = graftmem.track(owner, "buf", "params", value)
    assert graftshard.audit() == []
    graftshard.place(t, (8, 2), [(0, "tp", 4)])       # the record drifts
    rows = graftshard.audit()
    assert [(r["holding"], r["expected"], r["found"]) for r in rows] == [
        ("buf", "replicated", ["tp"])]
    assert graftshard.status()["violations"] == 1
    graftmem.release(h)
    assert graftshard.audit() == [] and graftshard.status()["tracked"] == 0
    graftshard.clear()
    assert graftshard.status() == {"enabled": True, "checks": 0,
                                   "violations": 0, "tracked": 0}


def test_healthz_serves_the_auditor(monkeypatch):
    """/healthz carries the auditor's status with its audit rows when
    armed, as the JAX app's does."""
    from llm_sharding_demo_tpu_torch.models import gpt2
    from llm_sharding_demo_tpu_torch.serving.app import create_app
    from llm_sharding_demo_tpu_torch.serving.http import TestClient
    from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
    monkeypatch.setenv("GRAFTSHARD", "1")
    graftshard.clear()
    cfg = gpt2.GPT2Config(vocab_size=256, n_positions=32, n_embd=32,
                          n_layer=2, n_head=2)
    app = create_app(ServingConfig(model_id="t", max_seq=32, max_batch=2),
                     model=(cfg, gpt2.init_params(
                         cfg, torch.Generator().manual_seed(0))),
                     tokenizer=ByteTokenizer(), device="cpu")
    health = TestClient(app).get("/healthz").json()
    assert health["graftshard"]["enabled"] is True
    assert health["graftshard"]["violations"] == 0
    assert health["graftshard"]["audit"] == []
    monkeypatch.delenv("GRAFTSHARD")
    assert TestClient(app).get("/healthz").json()["graftshard"] == {
        "enabled": False, **{k: health["graftshard"][k]
                             for k in ("checks", "violations", "tracked")}}
    graftshard.clear()


def test_mesh_runners_hold_their_contracts():
    """Armed on two gloo ranks: the tp engine's and the ep engine's
    weights and the tp cache, and the decoder's stage blocks and shared
    leaves, audit clean after a generate; a stage block whose record
    claims one layer too many is found."""
    dims = dict(vocab_size=211, n_positions=64, n_embd=128, n_layer=4,
                n_head=2)
    mdims = dict(vocab_size=211, n_positions=64, n_embd=128, n_layer=2,
                 n_head=2, n_experts=4, expert_top_k=2)
    group = RankGroup(2)
    try:
        out = group.run("graftshard_live", cfg_kw=dims,
                        np_params=np_gpt2_params(seed=1, dims=dims),
                        moe_kw=mdims,
                        moe_np=np_moe_params(1, 0.04, mdims))
    finally:
        group.close()
    for o in out:
        assert o["clean"] == []
        assert o["status"]["violations"] == 0
        # tp params, ep params, blocks, shared, and the tp cache
        assert o["status"]["checks"] >= 5
        assert [(r["owner"], r["holding"], r["expected"])
                for r in o["planted"]] == [
            ("PipelinedDecoder", "blocks", "pp")]
        assert "this rank's share is 3" in o["planted"][0]["problem"]
        assert o["planted"][0]["where"].endswith(
            "parallel/ppdecode.py:" + o["planted"][0]["where"].split(":")[-1])
    assert np.all([o["status"]["enabled"] for o in out])
