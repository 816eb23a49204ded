"""The port's process-group bootstrap and collectives
(``parallel.distributed``, ``parallel.spmd.make_mesh``) against the JAX
package's multi-host glue.

The environment contract (the no-op, the partial-config refusal) runs in
this process, which never joins a group; everything that needs a group
runs on spawned gloo ranks (``torch_mesh_ranks``: a module-scoped group
of two, and one of a single rank for the one-process round trip). The
JAX side runs here on its forced host devices. Messages are compared
word for word, the process and device counts standing in for the JAX
package's.
"""

import pytest
import torch

from llm_sharding_demo_tpu.parallel import distributed as jdistributed
from llm_sharding_demo_tpu_torch.parallel import distributed
from torch_mesh_ranks import RankGroup

ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(2)
    yield group
    group.close()


def test_single_process_is_noop(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert distributed.maybe_initialize() is False
    assert jdistributed.maybe_initialize() is False
    assert (distributed.world_size(), distributed.rank()) == (1, 0)


@pytest.mark.parametrize("present", [("COORDINATOR_ADDRESS",),
                                     ("NUM_PROCESSES", "PROCESS_ID")])
def test_partial_config_rejected(monkeypatch, present):
    """Some of the three variables set: the JAX package's message."""
    values = {"COORDINATOR_ADDRESS": "localhost:9999", "NUM_PROCESSES": "2",
              "PROCESS_ID": "0"}
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    for var in present:
        monkeypatch.setenv(var, values[var])
    with pytest.raises(ValueError, match="partial multi-host config") as e:
        distributed.maybe_initialize(device="cpu")
    with pytest.raises(ValueError) as j:
        jdistributed.maybe_initialize()
    assert str(e.value) == str(j.value)


def test_explicit_arguments_win_and_nccl_needs_a_device_a_rank(monkeypatch):
    """Explicit arguments override the environment, and an nccl group
    wider than the host's CUDA devices refuses before any rendezvous."""
    monkeypatch.setenv("NUM_PROCESSES", "not-a-number")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one CUDA device per rank"):
        distributed.maybe_initialize("127.0.0.1:1", 2, 0, device="cpu",
                                     backend="nccl")


def test_global_mesh_and_host_batch(ranks):
    """A named mesh over the world, its host batch slices, and the
    collectives the decoders use: a hop along the stage ring, a sum, a
    broadcast of a tensor and of an object."""
    out = ranks.run("collectives")
    for r, o in enumerate(out):
        assert o["names"] == ("dp",)
        assert o["local"] == [[r] * 3] * 2
        assert o["global_shape"] == (4, 3)
        assert o["sum"] == [3.0, 2.0]
        assert o["bcast"] == [10]                 # from the last rank
        assert o["obj"] == {"from": 0}
        assert o["mesh2"] == (("dp", "tp"), 2, r)
        assert o["host_paths"] == {"cpu": False, "cuda": True}
    assert out[0]["hop"] is None
    assert out[1]["hop"] == [[1.0] * 3] * 2


def test_global_mesh_size_mismatch(ranks):
    """The JAX message, the group's size where JAX counts devices and
    processes."""
    got = ranks.run("mesh_error", shape={"dp": 4, "tp": 4})
    with pytest.raises(ValueError) as j:
        jdistributed.global_mesh({"dp": 4, "tp": 4})
    want = (str(j.value).replace("have 8", "have 2")
            .replace("spans 1 process", "spans 2 process"))
    assert got == [want, want]
    assert "needs 16 devices" in want


def test_single_process_service_roundtrip():
    """A group of one rank joins its store, and every collective and the
    mesh still work: the path a multi-rank server takes, minus the
    peers."""
    group = RankGroup(1)
    try:
        info = group.run("mesh_info")[0]
        assert info == {"rank": 0, "world": 1, "device": "cpu"}
        out = group.run("collectives")[0]
        assert out["sum"] == [1.0, 0.0] and out["global_shape"] == (2, 3)
        assert out["hop"] is None and out["mesh2"] == (("dp", "tp"), 1, 0)
    finally:
        group.close()


def test_headers_reach_every_follower_in_order(ranks):
    """Rank 0's announced headers arrive at each follower in order, a
    follower's wait polls past its timeout, a stop header ends the loop,
    and rank 0 can wait until every follower has read it (the leader of
    a server leaves with the store)."""
    out = ranks.run("header_roundtrip", n=3)
    assert out[0] == {"sent": 4, "stop_read": True}
    assert out[1] == {"got": [0, 1, 2], "stopped": True}
