"""The port's GPipe step on uneven stages against the JAX package's
padded step (zero-padded stage-major blocks with a valid mask): stages
of 3 and 1 (``BOUNDARIES=[3]``, dp 2 beside pp 2) and 6 layers over pp 4
(2, 2, 1 and 1). Each rank holds only its own stage's blocks. Helpers,
weights and tolerances: ``test_torch_gpipe.py``.
"""

import pytest

from test_torch_gpipe import (check_pipeline, gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, pipe_beside_jax,
                              ranks, weights)


@pytest.mark.parametrize("name,pp,boundaries", [
    ("gpt2", 2, [3]),        # stages of 3 and 1, dp 2
    ("gpt2-6", 4, None),     # 2, 2, 1, 1
], ids=["pp2-[3]", "6-layers-pp4"])
def test_gpipe_uneven_stages_match_jax_padded_step(ranks, weights, name,
                                                   pp, boundaries):
    """Each rank holds only its own stage's blocks; the JAX step stacks
    them zero-padded with a valid mask."""
    res, jrun, single = pipe_beside_jax(
        ranks, name, weights[name], {"pp": pp, "dp": 4 // pp},
        n_microbatches=2, boundaries=boundaries)
    check_pipeline(res, *jrun, single)


