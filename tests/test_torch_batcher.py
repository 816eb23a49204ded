"""The port's admission batcher (``runtime.batcher.BatchingEngine``) and
the engine's per-row sampling, against the port's solo runs and the JAX
package's batcher on the same numpy weights.

The bar is the JAX package's: a request through the batcher, whatever it
was batched with and however its shapes were bucketed, gets exactly the
tokens of a solo engine run. fp32 greedy rows are also byte-equal to the
JAX ``BatchingEngine``'s rows; seeded sampled rows are byte-equal to the
port's own solo runs (streams cannot match across two RNGs). Every
blocking call has a timeout and every thread is joined with one.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu.runtime.batcher import (
    BatchingEngine as JBatchingEngine)
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime import engine as tengine
from llm_sharding_demo_tpu_torch.runtime.batcher import (BatchingEngine,
                                                         _Request)
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        SamplingConfig)
from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
    PrefixCachingEngine)
from llm_sharding_demo_tpu_torch.runtime.spec_decode import SpecDecodeEngine
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import tracing
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_model import np_gpt2_params

DIMS = dict(vocab_size=211, n_positions=512, n_embd=128, n_layer=2,
            n_head=2)
MAX_SEQ = 96
WAIT = 60  # seconds: a bound on every join and blocking call


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params(seed=0, dims=DIMS)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def setup(weights):
    engine = DecodeEngine(weights[1], gpt2.GPT2Config(**DIMS),
                          max_seq=MAX_SEQ, device="cpu")
    # a generous wait so that slow thread scheduling still coalesces
    return engine, BatchingEngine(engine, max_batch=4, max_wait_ms=200.0)


def _concurrent(fn, n):
    """Run ``fn(i)`` for i < n on n threads; returns the results."""
    out = [None] * n

    def run(i):
        out[i] = fn(i)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "a request never completed"
    return out


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_concurrent_greedy_matches_solo_and_jax(weights, setup):
    engine, batcher = setup
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 211, size=(n,)) for n in (3, 7, 12, 5, 9, 4)]
    want = [engine.generate(p[None, :], 8).tokens[0] for p in prompts]
    before = batcher.stats()
    got = _concurrent(
        lambda i: batcher.generate(prompts[i], 8, timeout=WAIT).tokens[0],
        len(prompts))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    after = batcher.stats()
    # the point: fewer device rounds than requests
    assert after["batches"] - before["batches"] < len(prompts)
    assert after["rows"] - before["rows"] == len(prompts)
    # the JAX batcher's rows on the same weights
    jeng = jengine.DecodeEngine(weights[0], jgpt2.GPT2Config(**DIMS),
                                max_seq=MAX_SEQ)
    jb = JBatchingEngine(jeng, max_batch=4, max_wait_ms=200.0)
    jgot = _concurrent(
        lambda i: jb.generate(prompts[i].astype(np.int32), 8,
                              timeout=WAIT).tokens[0], len(prompts))
    for i, (g, j) in enumerate(zip(got, jgot)):
        np.testing.assert_array_equal(g, j, err_msg=f"request {i}")


def test_varied_token_counts_truncate_per_request(setup):
    engine, batcher = setup
    rng = np.random.default_rng(2)
    jobs = [(rng.integers(0, 211, size=(6,)), 3),
            (rng.integers(0, 211, size=(11,)), 17)]
    got = _concurrent(lambda i: batcher.generate(
        jobs[i][0], jobs[i][1], timeout=WAIT).tokens[0], 2)
    for (p, n), g in zip(jobs, got):
        assert len(g) == len(p) + n
        np.testing.assert_array_equal(g, engine.generate(p[None, :],
                                                         n).tokens[0])


def test_sample_mode_reproducible_through_batcher(setup):
    _, batcher = setup
    p = np.asarray([5, 17, 33])
    s = SamplingConfig(mode="sample", temperature=0.6, top_k=10)
    a = batcher.generate(p, 6, sampling=s, generator=_gen(3), timeout=WAIT)
    b = batcher.generate(p, 6, sampling=s, generator=_gen(3), timeout=WAIT)
    np.testing.assert_array_equal(a.tokens, b.tokens)


def test_batched_sample_rows_byte_equal_solo(setup):
    """Seeded sampled requests batch together and each row is byte-equal
    to its solo run: distinct budgets exercise the steps-bucket
    over-decode, distinct prompt lengths the left pad, three requests
    the power-of-two dummy row."""
    engine, batcher = setup
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 211, size=(n,)) for n in (4, 9, 6)]
    steps = (5, 11, 8)
    s = SamplingConfig(mode="sample", temperature=0.6, top_k=40)
    want = [engine.generate(p[None, :], n, sampling=s,
                            generator=_gen(100 + i)).tokens[0]
            for i, (p, n) in enumerate(zip(prompts, steps))]
    before = batcher.stats()["batches"]
    got = _concurrent(lambda i: batcher.generate(
        prompts[i], steps[i], sampling=s, generator=_gen(100 + i),
        timeout=WAIT).tokens[0], 3)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    assert batcher.stats()["batches"] - before < 3


def test_mixed_policies_round_trip(setup):
    """Greedy and sampled requests interleave: rounds stay policy-pure,
    the held head keeps FIFO, nobody starves, all match solo runs."""
    engine, batcher = setup
    rng = np.random.default_rng(11)
    g_prompt = rng.integers(0, 211, size=(5,))
    s_prompt = rng.integers(0, 211, size=(7,))
    s = SamplingConfig(mode="sample", temperature=0.8, top_k=20)
    want_g = engine.generate(g_prompt[None, :], 6).tokens[0]
    want_s = engine.generate(s_prompt[None, :], 6, sampling=s,
                             generator=_gen(77)).tokens[0]
    jobs = [(g_prompt, SamplingConfig(), None), (s_prompt, s, _gen(77)),
            (g_prompt, SamplingConfig(), None)]
    got = _concurrent(lambda i: batcher.generate(
        jobs[i][0], 6, sampling=jobs[i][1], generator=jobs[i][2],
        timeout=WAIT).tokens[0], 3)
    np.testing.assert_array_equal(got[0], want_g)
    np.testing.assert_array_equal(got[1], want_s)
    np.testing.assert_array_equal(got[2], want_g)


def test_sample_request_without_generator_rejected(setup):
    _, batcher = setup
    s = SamplingConfig(mode="sample", temperature=0.6, top_k=10)
    with pytest.raises(ValueError, match="torch.Generator"):
        batcher.generate(np.asarray([5, 17, 33]), 4, sampling=s,
                         timeout=WAIT)


def test_overflow_surfaces_as_request_error(setup):
    _, batcher = setup
    with pytest.raises(ValueError, match="max_seq"):
        batcher.generate(np.arange(60) % 211, 90, timeout=WAIT)


def test_infeasible_together_requests_split_into_subbatches(setup):
    """Each request fits max_seq alone but not bucketed together (a long
    prompt beside a long generation): the planner splits them."""
    engine, batcher = setup
    rng = np.random.default_rng(5)
    long_prompt = rng.integers(0, 211, size=(80,))   # 80 + 8  = 88 <= 96
    long_gen = rng.integers(0, 211, size=(8,))       # 8  + 60 = 68 <= 96

    def fake(p, n):
        return _Request(prompt=p, max_new_tokens=n,
                        sampling=SamplingConfig(), generator=None)

    assert batcher._shapes([fake(long_prompt, 8), fake(long_gen, 60)]) is None
    assert len(batcher._plan([fake(long_prompt, 8),
                              fake(long_gen, 60)])) == 2
    jobs = [(long_prompt, 8), (long_gen, 60)]
    got = _concurrent(lambda i: batcher.generate(
        jobs[i][0], jobs[i][1], timeout=WAIT).tokens[0], 2)
    for (p, n), g in zip(jobs, got):
        np.testing.assert_array_equal(g, engine.generate(p[None, :],
                                                         n).tokens[0])


def test_batching_composes_with_chunked_prefill(weights):
    """Bucket left pad and chunk-alignment pad stack: batched requests
    through a prefill_chunk engine still equal solo monolithic runs."""
    cfg = gpt2.GPT2Config(**DIMS)
    plain = DecodeEngine(weights[1], cfg, max_seq=MAX_SEQ, device="cpu")
    chunked = DecodeEngine(weights[1], cfg, max_seq=MAX_SEQ,
                           prefill_chunk=8, device="cpu")
    batcher = BatchingEngine(chunked, max_batch=4, max_wait_ms=200.0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 211, size=(n,)) for n in (9, 13, 11, 17)]
    want = [plain.generate(p[None, :], 6).tokens[0] for p in prompts]
    got = _concurrent(lambda i: batcher.generate(
        prompts[i], 6, timeout=WAIT).tokens[0], len(prompts))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")


def test_round_phases_fan_out_to_every_row_trace(setup):
    """Each request's trace gets its queue wait and the round's shared
    prefill and decode spans."""
    _, batcher = setup
    traces = [tracing.RequestTrace(f"row-{i}") for i in range(3)]

    def run(i):
        with tracing.use_trace(traces[i]):
            return batcher.generate(np.asarray([5 + i, 9, 2]), 4,
                                    timeout=WAIT)

    _concurrent(run, 3)
    for t in traces:
        assert t.find("queue_wait").labels == {"scheduler": "admission"}
        assert t.find("prefill") is not None
        assert t.find("decode") is not None


def test_prefix_and_spec_compositions_refuse(weights, setup):
    """A prefix store or a speculative engine over another engine refuses
    (the JAX batcher's checks, with its messages)."""
    engine, _ = setup
    other = DecodeEngine(weights[1], gpt2.GPT2Config(**DIMS),
                         max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="same engine"):
        BatchingEngine(engine, prefix=PrefixCachingEngine(other))
    spec = SpecDecodeEngine(weights[1], gpt2.GPT2Config(**DIMS),
                            max_seq=MAX_SEQ, device="cpu")
    with pytest.raises(ValueError, match="same DecodeEngine"):
        BatchingEngine(engine, spec=spec)


# -- per-row sampling (engine.select_token's list form) ----------------------

S = SamplingConfig(mode="sample", temperature=0.7, top_k=30)


def test_one_row_generator_list_equals_solo_generator(setup):
    engine, _ = setup
    p = np.asarray([[8, 3, 77, 41]])
    solo = engine.generate(p, 20, sampling=S, generator=_gen(5)).tokens
    one = engine.generate(p, 20, sampling=S, generator=[_gen(5)]).tokens
    np.testing.assert_array_equal(one, solo)
    logits = torch.randn(1, 211, generator=_gen(0))
    assert (tengine.select_token(logits, S, [_gen(9)])
            == tengine.select_token(logits, S, _gen(9))).all()


@pytest.mark.parametrize("width,extra_steps", [(1, 0), (3, 0), (4, 7)])
def test_row_stream_independent_of_width_and_step_bucket(setup, width,
                                                         extra_steps):
    """Row 0's stream depends only on its own generator: not on the rows
    beside it (their prompts, generators or absence), the batch width,
    or steps decoded past its budget."""
    engine, _ = setup
    rng = np.random.default_rng(width)
    p0 = np.asarray([8, 3, 77, 41, 2])
    solo = engine.generate(p0[None, :], 16, sampling=S,
                           generator=_gen(5)).tokens[0]
    prompts = [p0] + [rng.integers(0, 211, size=(int(n),))
                      for n in rng.integers(2, 9, size=width - 1)]
    gens = [_gen(5)] + [_gen(50 + i) if i % 2 else None
                        for i in range(width - 1)]
    got = engine.generate(prompts, 16 + extra_steps, sampling=S,
                          generator=gens)
    np.testing.assert_array_equal(got.row_tokens(0)[:len(p0) + 16], solo)


def test_rows_without_a_generator_draw_nothing():
    """A row whose entry is None takes its top survivor and leaves every
    generator alone; the choices of the rows that draw stay in
    ``sampler_pmf``'s support."""
    logits = torch.randn(3, 211, generator=_gen(1))
    probs, idx = tengine.sampler_pmf(logits, S)
    g = _gen(4)
    state = g.get_state()
    tok = tengine.select_token(logits, S, [None, None, None])
    np.testing.assert_array_equal(tok.numpy(), idx[:, 0].numpy())
    assert torch.equal(g.get_state(), state)
    tok = tengine.select_token(logits, S, [_gen(2), None, _gen(3)])
    for r in (0, 2):
        k = (idx[r] == tok[r]).nonzero()[0, 0]
        assert probs[r, k] > 0
    with pytest.raises(ValueError, match="generators"):
        tengine.select_token(logits, S, [_gen(2)])


# -- serving -----------------------------------------------------------------

def test_serving_admission_batching_equals_jax(weights):
    """A MAX_BATCH=4 server answers concurrent greedy requests byte-equal
    to the JAX app with the same knobs, and a seeded request replays;
    /healthz reports the batching knobs and the batcher's counts."""
    jp, tp = weights
    cfg = dict(model_id="t", max_seq=48, max_batch=4, batch_wait_ms=100.0,
               boundaries=(1,))
    app = TestClient(create_app(ServingConfig(**cfg),
                                model=(gpt2.GPT2Config(**DIMS), tp),
                                tokenizer=ByteTokenizer(), device="cpu"))
    japp = JTestClient(jcreate_app(JServingConfig(**cfg),
                                   model=(jgpt2.GPT2Config(**DIMS), jp),
                                   tokenizer=JByteTokenizer()))
    prompts = ["Hi", "Hello there", "abc", "xyzw"]
    bodies = [{"prompt": p, "max_new_tokens": 6, "mode": "greedy"}
              for p in prompts]
    want = [japp.post("/generate", json=b).json() for b in bodies]
    got = _concurrent(lambda i: app.post("/generate", json=bodies[i]).json(),
                      len(bodies))
    assert got == want
    seeded = {"prompt": "Hi", "max_new_tokens": 6, "seed": 3}
    assert (app.post("/generate", json=seeded).json()
            == app.post("/generate", json=seeded).json())
    h = app.get("/healthz").json()
    assert (h["max_batch"], h["batch_mode"], h["prefill_chunk"]) == (
        4, "admission", 0)
    assert h["batch_stats"]["rows"] == 6
