"""The port's 1F1B pipeline training (``GPipeTrainStep(schedule="1f1b")``,
``parallel.pipeline_1f1b``), flat and interleaved, on gloo ranks against
the JAX package's on its forced host devices.

One module-scoped group of four spawned CPU ranks runs every port case
(``torch_train_ranks``); each stage stashes only its in-flight
microbatches' inputs and recomputes its forward for the backward. The JAX
reference runs here, beside the ranks. Weights, helpers and tolerances:
``test_torch_gpipe.py`` (losses 1e-5 relative of the JAX 1F1B step's and
5e-3 of the one-device step's, first gradients rtol 2e-4 / atol 1e-6).
Interleaved 1F1B and its gates: ``test_torch_1f1b_interleaved.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from llm_sharding_demo_tpu.parallel.pipeline_1f1b import \
    one_f_one_b_loss_and_grads as jone_f_one_b
from llm_sharding_demo_tpu.training import train as jtrain
from llm_sharding_demo_tpu_torch.parallel.pipeline_1f1b import stash_depth
from test_torch_gpipe import (DIMS, IDS, check_pipeline,  # noqa: F401
                              gc_between_modules, gc_only_in_test_bodies,
                              jax_standard, jconfig, jmesh, jp,
                              pipe_beside_jax, ranks, stage_major, weights)


@pytest.mark.parametrize("shape,n_micro", [
    ({"pp": 2, "dp": 2}, 4), ({"pp": 4}, 4), ({"pp": 2, "tp": 2}, 8),
], ids=["pp2", "pp4", "pp2-tp2-M8"])
def test_1f1b_matches_jax(ranks, weights, shape, n_micro):
    """Three steps; with M = 8 > 2S - 1 = 3 on pp2 the stash holds at
    most three inputs (the first stage holds exactly that many). A dp
    rank microbatches its own rows, so M must divide them: M = 8 runs
    beside tp, not dp."""
    pp = shape["pp"]
    res, jrun, single = pipe_beside_jax(
        ranks, "gpt2", weights["gpt2"], shape, schedule="1f1b",
        n_microbatches=n_micro)
    check_pipeline(res, *jrun, single)
    bound = stash_depth(n_micro, pp)
    assert bound == min(n_micro, 2 * pp - 1)
    for r in res:
        assert 1 <= r["high"] <= bound
        if r["coords"]["pp"] == 0:
            assert r["high"] == bound


def test_1f1b_first_step_grads_match_jax_1f1b(ranks, weights):
    """pp4 leaf by leaf against ``one_f_one_b_loss_and_grads``'s
    stage-major gradients (unstacked), the tied ``wte``'s two halves
    included."""
    ranks.submit("torch_train_ranks:pipe", family="gpt2",
                 cfg_kw=DIMS["gpt2"], np_params=weights["gpt2"], ids=IDS,
                 shape={"pp": 4}, schedule="1f1b", n_microbatches=4)
    jcfg = jconfig("gpt2")
    mesh = jmesh({"pp": 4})
    step = jtrain.GPipeTrainStep(jcfg, jtrain.adamw(1e-3), mesh,
                                 n_microbatches=4, schedule="1f1b")
    gp, _ = step.init(jp(weights["gpt2"]))
    jloss, jgrads = jax.jit(lambda p, i: jone_f_one_b(p, i, jcfg, mesh, 4))(
        gp, jnp.asarray(IDS))
    res = ranks.results(120.0)
    want = jax_standard(jgrads, step)
    got = stage_major(res, "grads")
    assert res[0]["loss0"] == pytest.approx(float(jloss), rel=1e-5)
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=2e-4,
                                   atol=1e-6, err_msg=str(path))
