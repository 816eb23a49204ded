"""The port's chunked prefill (``DecodeEngine(prefill_chunk=C)``) against
its monolithic prefill and the JAX package's chunked engine.

Weights are made with numpy from a seed and carried into both packages
(the ROADMAP's small shapes: GPT-2 with 2 layers, n_embd 128, head_dim
64, vocab 211; llama with n_embd 256 and 4 query heads over 2 kv heads).
fp32 greedy streams must be byte-equal; the last chunk's logits allclose
to the JAX package's at 1e-5 (the two sides differ only in summation
order); a seeded sampled stream is byte-equal to the monolithic stream
within the port (streams cannot match across two RNGs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu_torch.models import gpt2, llama
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        SamplingConfig)
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_llama import np_llama_params
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

DIMS = dict(vocab_size=211, n_positions=512, n_embd=128, n_layer=2,
            n_head=2)
LDIMS = dict(vocab_size=211, n_positions=1024, n_embd=256, n_layer=2,
             n_head=4, n_kv_head=2, intermediate_size=256)
MAX_SEQ = 128
CHUNK = 8


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params(seed=0, dims=DIMS)
    return (jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def engines(weights):
    jp, tp = weights
    cfg = gpt2.GPT2Config(**DIMS)
    return {
        "mono": DecodeEngine(tp, cfg, max_seq=MAX_SEQ, device="cpu"),
        "chunked": DecodeEngine(tp, cfg, max_seq=MAX_SEQ, device="cpu",
                                prefill_chunk=CHUNK),
        "jax": jengine.DecodeEngine(jp, jgpt2.GPT2Config(**DIMS),
                                    max_seq=MAX_SEQ, prefill_chunk=CHUNK),
    }


def _prompt(n, mult=13, vocab=211):
    return (np.arange(n, dtype=np.int64) * mult + 1) % vocab


@pytest.mark.parametrize("case,reserve", [("short", 4), ("unaligned", 4),
                                          ("no_room", 60)])
def test_align_chunks_paths_match_jax(weights, case, reserve):
    """Short prompt: monolithic; unaligned prompt: padded up to whole
    chunks; no headroom for the alignment pad: monolithic. The port's
    choice equals the JAX engine's, also on a kernel engine whose fused
    cache is rounded up to 256 slots (the headroom counts ``max_seq``)."""
    jp, tp = weights
    cfg = gpt2.GPT2Config(**DIMS)
    jeng = jengine.DecodeEngine(jp, jgpt2.GPT2Config(**DIMS), max_seq=64,
                                prefill_chunk=8)
    ids = np.arange(10, dtype=np.int64)[None, :]
    if case == "short":
        ids = ids[:, :6]
    pad0 = np.zeros((1,), np.int32)
    want = jeng._align_chunks(ids.astype(np.int32), pad0, ids.shape[1],
                              reserve)
    for kernel in ("xla", "layer"):
        eng = DecodeEngine(tp, cfg, max_seq=64, prefill_chunk=8,
                           decode_kernel=kernel, device="cpu")
        assert eng._cache_seq == (64 if kernel == "xla" else 256)
        got = eng._align_chunks(ids, pad0, ids.shape[1], reserve)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:]
    if case == "unaligned":
        assert want[3] == 8 and want[2] == 16 and list(want[1]) == [6]


@pytest.mark.parametrize("prompt_len", [9, 16, 23, 5])
def test_chunked_greedy_equals_monolithic_and_jax(engines, prompt_len):
    prompt = _prompt(prompt_len)
    mono = engines["mono"].generate(prompt, 12)
    got = engines["chunked"].generate(prompt, 12)
    want = engines["jax"].generate(prompt.astype(np.int32), 12)
    np.testing.assert_array_equal(got.row_tokens(0), mono.row_tokens(0))
    np.testing.assert_array_equal(got.row_tokens(0), want.row_tokens(0))
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_chunked_last_logits_match_jax(engines):
    """The last chunk's last-position logits (ragged batch, two chunk
    counts) against the JAX chunked prefill, at 1e-5."""
    eng, jeng = engines["chunked"], engines["jax"]
    rows = [_prompt(19, 7), _prompt(11, 5)]
    ids, pad = jengine.left_pad(rows)
    jids, jpad, plen, chunk = jeng._align_chunks(ids, pad, ids.shape[1], 4)
    assert chunk == CHUNK and plen == 24
    chunks = jnp.asarray(jids).reshape(2, plen // chunk, chunk).transpose(
        1, 0, 2)
    want, _ = jeng._prefill_chunked(jeng._run_params(), chunks,
                                    jnp.asarray(jpad))
    tids, tpad, tplen, tchunk = eng._align_chunks(
        ids.astype(np.int64), pad, ids.shape[1], 4)
    assert (tplen, tchunk) == (plen, chunk)
    with torch.inference_mode():
        got, cache = eng._prefill_chunked(eng._ids(tids), eng._pad(tpad),
                                          chunk)
    assert cache.length == plen
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_chunked_sampled_equals_monolithic_seeded(engines):
    """Chunk padding leaves the draws alone: the seeded sampled stream is
    byte-equal with and without chunking."""
    prompt = _prompt(11, 7)
    s = SamplingConfig(mode="sample", temperature=0.8, top_k=9)
    want = engines["mono"].generate(
        prompt, 10, sampling=s, generator=torch.Generator().manual_seed(3))
    got = engines["chunked"].generate(
        prompt, 10, sampling=s, generator=torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(got.row_tokens(0), want.row_tokens(0))


def test_chunked_ragged_batch(engines):
    """The alignment pad stacks on the ragged left pad: every row equals
    its solo monolithic run, and the batch equals the JAX chunked
    engine's."""
    rng = np.random.default_rng(4)
    prompts = [list(rng.integers(0, 211, size=(n,))) for n in (9, 14, 11)]
    got = engines["chunked"].generate(prompts, 7)
    want = engines["jax"].generate(prompts, 7)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.pad, want.pad)
    for b, prompt in enumerate(prompts):
        solo = engines["mono"].generate(np.asarray(prompt), 7)
        np.testing.assert_array_equal(got.row_tokens(b), solo.row_tokens(0))


def test_chunked_staged_engine(weights, engines):
    jp, tp = weights
    cfg = gpt2.GPT2Config(**DIMS)
    staged = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, boundaries=[1],
                          prefill_chunk=CHUNK, device="cpu")
    jstaged = jengine.DecodeEngine(jp, jgpt2.GPT2Config(**DIMS),
                                   max_seq=MAX_SEQ, boundaries=[1],
                                   prefill_chunk=CHUNK)
    prompt = _prompt(13, 5)
    got = staged.generate(prompt, 9)
    np.testing.assert_array_equal(
        got.row_tokens(0), engines["mono"].generate(prompt, 9).row_tokens(0))
    np.testing.assert_array_equal(
        got.tokens, jstaged.generate(prompt.astype(np.int32), 9).tokens)


def test_chunked_llama():
    tree = np_llama_params(seed=1, dims=LDIMS)
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    cfg = llama.LlamaConfig(**LDIMS)
    mono = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, device="cpu")
    chunked = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, prefill_chunk=CHUNK,
                           device="cpu")
    jchunked = jengine.DecodeEngine(jp, jllama.LlamaConfig(**LDIMS),
                                    max_seq=MAX_SEQ, prefill_chunk=CHUNK)
    prompt = _prompt(19, 3)
    got = chunked.generate(prompt, 8)
    np.testing.assert_array_equal(got.row_tokens(0),
                                  mono.generate(prompt, 8).row_tokens(0))
    np.testing.assert_array_equal(
        got.tokens, jchunked.generate(prompt.astype(np.int32), 8).tokens)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_chunked_prefill_on_the_fused_cache(weights, family):
    """A "mega" engine on the CPU (the kernels' plain versions, the fused
    cache rounded to 256 slots): chunked prefill matches monolithic, and
    a 1-wide chunk runs every prefill token through the whole-stack
    route."""
    if family == "gpt2":
        cfg, tp = gpt2.GPT2Config(**DIMS), weights[1]
    else:
        cfg = llama.LlamaConfig(**LDIMS)
        tp = params_from_numpy(np_llama_params(seed=1, dims=LDIMS),
                               device="cpu")
    mono = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, decode_kernel="mega",
                        device="cpu")
    assert mono.decode_kernel_mode == "mega" and mono._cache_seq == 256
    prompt = _prompt(21, 11)
    want = mono.generate(prompt, 10).row_tokens(0)
    for chunk in (CHUNK, 1):
        eng = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, decode_kernel="mega",
                           prefill_chunk=chunk, device="cpu")
        np.testing.assert_array_equal(eng.generate(prompt, 10).row_tokens(0),
                                      want)


def test_forward_shapes_count_the_chunks(weights):
    """The engine's forward ledger (what ``/healthz`` reports and the
    card's launch-count checks read): a 23-token prompt in 8-token chunks
    runs three 8-wide forwards, then one single-token forward a decode
    step."""
    eng = DecodeEngine(weights[1], gpt2.GPT2Config(**DIMS), max_seq=MAX_SEQ,
                       prefill_chunk=CHUNK, device="cpu")
    eng.generate(_prompt(23), 5)
    assert eng.forward_shapes() == {(1, CHUNK): 3, (1, 1): 4}
    eng.generate([_prompt(5), _prompt(3)], 2)
    assert eng.forward_shapes() == {(1, CHUNK): 3, (1, 1): 4, (2, 5): 1,
                                    (2, 1): 1}


def test_prefill_chunk_validation(weights):
    cfg = gpt2.GPT2Config(**DIMS)
    with pytest.raises(ValueError, match="prefill_chunk"):
        DecodeEngine(weights[1], cfg, max_seq=64, prefill_chunk=0,
                     device="cpu")
    with pytest.raises(ValueError, match="PREFILL_CHUNK"):
        ServingConfig(model_id="t", prefill_chunk=-1)


def test_serving_prefill_chunk_knob_equals_jax(weights):
    """A PREFILL_CHUNK=16 server answers greedy requests byte-equal to the
    JAX app with the same knob and to the unchunked server; /healthz
    reports the knob."""
    jp, tp = weights
    bodies = [{"prompt": p, "max_new_tokens": 6, "mode": "greedy"}
              for p in ("Hello chunked prefill world", "Hi", "x" * 40)]
    outs = {}
    for pc in (0, 16):
        t = TestClient(create_app(
            ServingConfig(model_id="t", max_seq=MAX_SEQ, prefill_chunk=pc,
                          boundaries=(1,)),
            model=(gpt2.GPT2Config(**DIMS), tp), tokenizer=ByteTokenizer(),
            device="cpu"))
        j = JTestClient(jcreate_app(
            JServingConfig(model_id="t", max_seq=MAX_SEQ, prefill_chunk=pc,
                           boundaries=(1,)),
            model=(jgpt2.GPT2Config(**DIMS), jp),
            tokenizer=JByteTokenizer()))
        assert t.get("/healthz").json()["prefill_chunk"] == pc
        outs[pc] = [t.post("/generate", json=b).json() for b in bodies]
        assert outs[pc] == [j.post("/generate", json=b).json()
                            for b in bodies]
    assert outs[0] == outs[16]
