"""The port's GPT-2-MoE mesh training on sp meshes against the JAX
package's GSPMD ``MoETrainStep`` (``test_torch_moe_mesh``'s cases, dims
and tolerances), at ``capacity_factor`` 0.5, where capacity binds.

Each sp rank routes its own chunk of the sequence against the whole
sequence's capacity, placed by the selection counts the ranks exchange:
between them the ranks drop exactly the choices the single-device
forward drops, and every rank drops some of its own.
"""

import pytest
import torch

from llm_sharding_demo_tpu_torch.models import moe
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from test_torch_mesh_training import IDS
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies)
from test_torch_moe_mesh import dims, ranks, run_case, weights  # noqa: F401

CAPACITY = 0.5


def single_device_drops(np_params) -> int:
    """The expert choices capacity drops in the port's one-device forward
    of the training inputs."""
    cfg = moe.MoEConfig(**dims(CAPACITY))
    with torch.no_grad(), moe.counting_drops() as drops:
        moe.forward(params_from_numpy(np_params, device="cpu"),
                    torch.as_tensor(IDS[:, :-1]), cfg)
    return int(sum(int(n) for n in drops))


@pytest.mark.parametrize("shape,replica_axis", [
    ({"sp": 2, "ep": 2}, "ep"), ({"tp": 2, "sp": 2}, "tp"),
], ids=["sp2-ep2", "tp2-sp2"])
def test_moe_sp_mesh_train_step_matches_jax(ranks, weights, shape,
                                            replica_axis):
    """Three steps against the JAX GSPMD step with capacity binding; the
    dropped choices of each data shard (counted once: its
    ``replica_axis`` ranks route the same tokens) sum to the single
    device's."""
    res = run_case(ranks, weights, shape, CAPACITY)
    want = single_device_drops(weights)
    assert want > 0
    assert sum(r["dropped"] for r in res
               if r["coords"][replica_axis] == 0) == want
    assert all(r["dropped"] > 0 for r in res)
