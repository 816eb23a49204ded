"""The port's interleaved 1F1B (``virtual_stages=2``) on gloo ranks
against the JAX package's, and the gates interleaving keeps (JAX's
messages). Helpers, weights and tolerances: ``test_torch_gpipe.py``.
"""

import pytest

from llm_sharding_demo_tpu.training import train as jtrain
from test_torch_gpipe import (DIMS, check_pipeline,  # noqa: F401
                              gc_between_modules, gc_only_in_test_bodies,
                              jax_error, jconfig, jmesh, pipe_beside_jax,
                              ranks, weights)


@pytest.mark.parametrize("name,shape", [
    ("gpt2", {"pp": 2, "dp": 2}), ("llama", {"pp": 2, "dp": 2}),
    ("gpt2", {"dp": 2, "pp": 2}),
], ids=["gpt2-pp2", "llama-pp2", "gpt2-dp2-pp2"])
def test_interleaved_1f1b_matches_jax(ranks, weights, name, shape):
    """v = 2 on pp2: stage d owns chunks d and d + 2; the wrap from the
    last stage to the first carries chunk 0's output to chunk 1. The
    mesh's first axis varies slowest over the ranks: ``{"pp", "dp"}``
    puts the two stages of a pipeline on ranks 0 and 2."""
    res, jrun, single = pipe_beside_jax(
        ranks, name, weights[name], shape, schedule="1f1b",
        n_microbatches=4, virtual_stages=2)
    check_pipeline(res, *jrun, single, n_virtual=2)
    for r in res:
        assert 1 <= r["high"] <= 2 * 2 * 2 - 1


def test_interleaving_gates_equal_jax(ranks, weights):
    jcfg = jconfig("gpt2")
    cases = [({"pp": 2, "dp": 2}, dict(virtual_stages=2)),
             ({"pp": 2, "dp": 2}, dict(schedule="1f1b", virtual_stages=3)),
             ({"pp": 2, "dp": 2}, dict(schedule="1f1b", virtual_stages=2,
                                       boundaries=[3])),
             ({"pp": 2, "tp": 2}, dict(schedule="1f1b", virtual_stages=2)),
             ({"pp": 2, "sp": 2}, dict(schedule="1f1b", virtual_stages=2))]
    want = [jax_error(lambda: jtrain.GPipeTrainStep(
        jcfg, jtrain.adamw(), jmesh(shape), **kw)) for shape, kw in cases]
    assert all(want) and "strictly slower" in want[3]
    got = ranks.run("torch_train_ranks:pipe_errors", family="gpt2",
                    cfg_kw=DIMS["gpt2"], np_params=weights["gpt2"],
                    cases=cases)
    assert all(g == want for g in got), (got, want)
    # the default boundaries on a tp mesh at v = 1 run (no refusal)
    ok = ranks.run("torch_train_ranks:pipe_errors", family="gpt2",
                   cfg_kw=DIMS["gpt2"], np_params=weights["gpt2"],
                   cases=[({"pp": 2, "tp": 2}, dict(schedule="1f1b"))])
    assert all(g == [""] for g in ok)
