"""The port's speculative decoding (``runtime.spec_decode.SpecDecodeEngine``)
against the JAX package's on the same numpy weights.

- The pieces of a verify step, function for function: ``_draft_row``
  bit-equal to JAX's on seeded buffers, greedy ``_accept_patch`` equal,
  the sample mode's draft probabilities and residual pmf within 1e-6 of
  JAX's from its ``sampler_pmf``, ``_roll_cache_rows`` bit-equal on
  plain, fused and staged caches.
- fp32 greedy streams and their ``verify_steps`` equal to the JAX
  engine's, GPT-2 and llama (solo, ragged batch, 1 token, exact budget,
  chunked prefill), and to the port's plain engine.
- bf16 spec equal to bf16 plain; ``top_k=1`` sampling equal to greedy;
  the sampled token's law against the sampler pmf (4 sigma, 2000
  trials); batched seeded rows byte-equal to solo runs, and replay.
- Guards and their messages, stats and counters, and the int8 engine's
  verify windows reaching the int8 matmul kernels' wrappers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu_torch.models.moe import MoEConfig
from llm_sharding_demo_tpu.ops.attention import KVCache as JKVCache
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu.runtime.spec_decode import (
    SpecDecodeEngine as JSpecDecodeEngine)
from llm_sharding_demo_tpu_torch.models import gpt2, llama
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.ops import quant
from llm_sharding_demo_tpu_torch.ops.attention import KVCache
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        SamplingConfig,
                                                        sampler_pmf)
from llm_sharding_demo_tpu_torch.runtime.prefix_cache import clone_cache
from llm_sharding_demo_tpu_torch.runtime.spec_decode import (
    SpecDecodeEngine, draft_probs, residual_pmf)
from llm_sharding_demo_tpu_torch.utils.metrics import REGISTRY
from test_torch_llama import np_llama_params
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

GPT2_DIMS = dict(vocab_size=211, n_positions=512, n_embd=128, n_layer=2,
                 n_head=2)
LLAMA_DIMS = dict(vocab_size=211, n_positions=512, n_embd=256, n_layer=2,
                  n_head=4, n_kv_head=2, intermediate_size=256)
MAX_SEQ = 96
K = 4
S = SamplingConfig(mode="sample", temperature=0.8, top_k=12)


@pytest.fixture(scope="module")
def models():
    out = {}
    for fam, dims, np_fn, jmod, tmod in (
            ("gpt2", GPT2_DIMS, np_gpt2_params, jgpt2, gpt2),
            ("llama", LLAMA_DIMS, np_llama_params, jllama, llama)):
        tree = np_fn(seed=3, std=0.08, dims=dims)
        cls = "LlamaConfig" if fam == "llama" else "GPT2Config"
        out[fam] = (getattr(jmod, cls)(**dims),
                    jax.tree.map(jnp.asarray, tree),
                    getattr(tmod, cls)(**dims),
                    params_from_numpy(tree, device="cpu"))
    return out


@pytest.fixture(scope="module")
def gpt(models):
    """The port's GPT-2 spec engine (K=4) and plain engine."""
    _, _, tcfg, tp = models["gpt2"]
    return (SpecDecodeEngine(tp, tcfg, max_seq=MAX_SEQ, draft_len=K,
                             device="cpu"),
            DecodeEngine(tp, tcfg, max_seq=MAX_SEQ, device="cpu"))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# -- the pieces of a verify step ---------------------------------------------

@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_draft_row_bit_equal_to_jax(models, ngram):
    """Seeded buffers over a 5-token alphabet (matches everywhere), with
    a left pad (``low > 0``) and without, and a buffer with no match
    (the repeat-last fallback): the port's host drafts equal JAX's."""
    jcfg, jp, tcfg, tp = models["gpt2"]
    mine = SpecDecodeEngine(tp, tcfg, max_seq=40, draft_len=K, ngram=ngram,
                            device="cpu")
    ref = JSpecDecodeEngine(jp, jcfg, max_seq=40, draft_len=K, ngram=ngram)
    rng = np.random.default_rng(ngram)
    buflen = 40 + K + 1
    cases = []
    for _ in range(40):
        buf = np.zeros(buflen, dtype=np.int64)
        total = int(rng.integers(ngram, 40))
        low = int(rng.integers(0, max(1, total - ngram)))
        buf[:total] = rng.integers(0, 5, total)
        cases.append((buf, low, total))
    distinct = np.zeros(buflen, dtype=np.int64)
    distinct[:30] = np.arange(100, 130)            # no earlier match
    cases += [(distinct, 0, 30), (distinct, 7, 30)]
    kinds = set()
    for buf, low, total in cases:
        t_last = int(buf[total - 1])
        got = mine._draft_row(buf, low, total, t_last)
        want = np.asarray(ref._draft_row(
            jnp.asarray(buf, jnp.int32), jnp.int32(low), jnp.int32(total),
            jnp.int32(t_last)))
        np.testing.assert_array_equal(got, want)
        kinds.add("fallback" if (got == t_last).all() else "match")
    assert kinds == {"fallback", "match"}


def test_accept_patch_greedy_equal_to_jax(models, gpt):
    """Drafts that agree with the argmax for 0..K positions: the port's
    ``(n_accept, patch)`` equals JAX's on the same logits."""
    jcfg, jp, _, _ = models["gpt2"]
    spec, _ = gpt
    ref = JSpecDecodeEngine(jp, jcfg, max_seq=MAX_SEQ, draft_len=K)
    rng = np.random.default_rng(5)
    greedy_cfg = SamplingConfig()
    seen = set()
    for i in range(24):
        logits = rng.standard_normal((K + 1, 211)).astype(np.float32)
        drafts = rng.integers(0, 211, K)
        agree = i % (K + 1)
        drafts[:agree] = logits.argmax(-1)[:agree]
        n, patch = spec._accept_patch(torch.from_numpy(logits),
                                      torch.from_numpy(drafts), None,
                                      greedy_cfg)
        jn, jpatch = ref._accept_patch(jnp.asarray(logits),
                                       jnp.asarray(drafts, jnp.int32), None,
                                       jengine.SamplingConfig())
        assert int(n) == int(jn)
        np.testing.assert_array_equal(patch.numpy(), np.asarray(jpatch))
        seen.add(int(n))
    assert seen == set(range(K + 1))


@pytest.mark.parametrize("top_p", [1.0, 0.75])
def test_accept_probabilities_equal_to_jax(top_p):
    """Sample mode: the drafts' acceptance probabilities ``p_d`` and the
    bonus's residual pmf after each possible count, from the port's
    ``sampler_pmf``, within 1e-6 of the same formulas on JAX's."""
    rng = np.random.default_rng(6)
    mine_cfg = SamplingConfig(mode="sample", temperature=0.7, top_k=9,
                              top_p=top_p)
    jcfg = jengine.SamplingConfig(mode="sample", temperature=0.7, top_k=9,
                                  top_p=top_p)
    for _ in range(6):
        logits = (2 * rng.standard_normal((K + 1, 50))).astype(np.float32)
        order = np.argsort(-logits, axis=-1)
        # drafts inside and outside the survivors
        drafts = np.asarray([order[j, j % 3] if j % 2 else
                             order[j, 20] for j in range(K)])
        probs, idx = sampler_pmf(torch.from_numpy(logits), mine_cfg)
        jprobs, jidx = jengine.sampler_pmf(jnp.asarray(logits), jcfg)
        jprobs, jidx = np.asarray(jprobs), np.asarray(jidx)
        np.testing.assert_array_equal(idx.numpy(), jidx)
        d = torch.from_numpy(drafts)
        want_pd = (jprobs[:K] * (jidx[:K] == drafts[:, None])).sum(-1)
        np.testing.assert_allclose(draft_probs(probs, idx, d).numpy(),
                                   want_pd, atol=1e-6, rtol=0)
        for n in range(K + 1):
            w, ids = residual_pmf(probs, idx, d, torch.tensor(n))
            row_p, row_i = jprobs[n], jidx[n]
            zero = (n < K) & (row_i == drafts[min(n, K - 1)])
            want = np.where(zero, 0.0, row_p)
            np.testing.assert_array_equal(ids.numpy(), row_i)
            np.testing.assert_allclose(w.numpy(), want, atol=1e-6, rtol=0)


def _jcache(c: KVCache) -> JKVCache:
    return JKVCache(k=jnp.asarray(c.k.numpy()), v=jnp.asarray(c.v.numpy()),
                    length=jnp.int32(c.length))


@pytest.mark.parametrize("form", ["plain", "fused", "staged"])
def test_roll_cache_rows_bit_equal_to_jax(form):
    """Signed per-row shifts, zero and past the slot count included."""
    g = torch.Generator().manual_seed(0)

    def plain(layers):
        return KVCache(k=torch.randn(layers, 4, 2, 12, 8, generator=g),
                       v=torch.randn(layers, 4, 2, 12, 8, generator=g),
                       length=9)

    if form == "plain":
        cache = plain(3)
    elif form == "fused":
        cache = KVCache(k=torch.randn(3, 4, 2, 12, 16, generator=g),
                        v=torch.zeros((0,)), length=9)
    else:
        cache = [plain(1), plain(2)]
    shifts = np.asarray([3, -5, 0, 14])
    got = SpecDecodeEngine._roll_cache_rows(cache, shifts)
    want = JSpecDecodeEngine._roll_cache_rows(
        [_jcache(c) for c in cache] if form == "staged" else _jcache(cache),
        jnp.asarray(shifts, jnp.int32))
    pairs = (zip(got, want) if form == "staged" else [(got, want)])
    for c, jc in pairs:
        np.testing.assert_array_equal(c.k.numpy(), np.asarray(jc.k))
        np.testing.assert_array_equal(c.v.numpy(), np.asarray(jc.v))
        assert c.length == int(jc.length)


# -- streams -----------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(7)
    return [np.asarray([5, 17, 3, 42] * 4),          # accepts
            rng.integers(0, 211, 11),                # mostly rejects
            np.asarray([9] * 6)]                     # degenerate


CASES = {
    # (prompts, max_new, prefill_chunk)
    "solo": (lambda: _prompts()[0], 22, None),
    "solo random": (lambda: _prompts()[1], 22, None),
    "ragged batch": (lambda: _prompts(), 22, None),
    "one token": (lambda: _prompts()[1], 1, None),
    "exact budget": (lambda: _prompts()[0], 7, None),
    "chunked prefill": (lambda: np.arange(21) % 7 + 3, 14, 8),
}


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("case", list(CASES))
def test_fp32_greedy_streams_equal_jax_and_plain(models, family, case):
    """Tokens and verify counts equal the JAX engine's; every row equals
    the port's plain engine's greedy stream."""
    jcfg, jp, tcfg, tp = models[family]
    make, new, chunk = CASES[case]
    prompts = make()
    mine = SpecDecodeEngine(tp, tcfg, max_seq=MAX_SEQ, draft_len=K,
                            prefill_chunk=chunk, device="cpu")
    ref = JSpecDecodeEngine(jp, jcfg, max_seq=MAX_SEQ, draft_len=K,
                            prefill_chunk=chunk)
    got = mine.generate(prompts, new)
    want = ref.generate(prompts if isinstance(prompts, np.ndarray)
                        else [p.astype(np.int32) for p in prompts], new)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    assert got.verify_steps == int(want.verify_steps)
    want_pad = None if want.pad is None else np.asarray(want.pad)
    if want_pad is None:
        assert got.pad is None
    else:
        np.testing.assert_array_equal(got.pad, want_pad)
    plain = DecodeEngine(tp, tcfg, max_seq=MAX_SEQ, device="cpu")
    rows = prompts if isinstance(prompts, list) else [prompts]
    for i, p in enumerate(rows):
        np.testing.assert_array_equal(
            got.row_tokens(i)[-(len(p) + new):],
            plain.generate(p, new).tokens[0], err_msg=f"row {i}")
    if case == "solo":
        # a repetitive prompt accepts drafts: fewer verifies than tokens
        assert got.verify_steps < new - 1


def test_bf16_spec_equals_bf16_plain(models):
    _, _, tcfg, tp = models["gpt2"]
    spec = SpecDecodeEngine(tp, tcfg, max_seq=MAX_SEQ, dtype="bfloat16",
                            device="cpu")
    plain = DecodeEngine(tp, tcfg, max_seq=MAX_SEQ, dtype="bfloat16",
                         device="cpu")
    prompt = (np.arange(12) * 7) % 211
    np.testing.assert_array_equal(spec.generate(prompt, 20).tokens,
                                  plain.generate(prompt, 20).tokens)


def test_sample_topk1_equals_greedy(gpt):
    """top_k=1 makes every rejection decision deterministic."""
    spec, plain = gpt
    prompt = np.asarray([7, 3, 7, 3, 7, 3, 7])
    got = spec.generate(prompt, 18, sampling=SamplingConfig(
        mode="sample", temperature=0.6, top_k=1), generator=_gen(11))
    np.testing.assert_array_equal(got.tokens, plain.generate(prompt,
                                                             18).tokens)


@pytest.mark.parametrize("top_p", [1.0, 0.75])
def test_sample_distribution_exact(models, top_p):
    """The first token the verify loop emits after a fixed prefix has the
    sampler pmf's law (top-k 12, and under a nucleus cutoff): 2000
    trials, each from a clone of one prefill state, within 4 sigma of a
    binomial frequency (the JAX package's test)."""
    _, _, tcfg, tp = models["gpt2"]
    temp, top_k, n_trials = 0.8, 12, 2000
    sampling = SamplingConfig(mode="sample", temperature=temp, top_k=top_k,
                              top_p=top_p)
    spec = SpecDecodeEngine(tp, tcfg, max_seq=64, draft_len=4, device="cpu")
    eng = spec.plain
    prompt = np.asarray([5, 9, 5, 9, 5, 9, 5])
    t0 = 5                                           # fixed first token
    with torch.inference_mode():
        prefix = eng._ids(np.concatenate([prompt, [t0]])[None])
        logits, _ = eng._prefill(prefix, None)
        probs, idx = sampler_pmf(logits[0, -1], sampling)
        pmf = np.zeros(tcfg.vocab_size)
        pmf[idx.numpy()] = probs.numpy()
        _, cache = eng._prefill(eng._ids(prompt[None]), None)
    counts = np.zeros(tcfg.vocab_size, dtype=np.int64)
    first = torch.tensor([t0])
    for i in range(n_trials):
        out = spec.run_loop(prompt, first, clone_cache(cache), len(prompt),
                            _gen(1000 + i), 2, sampling)
        counts[int(out.tokens[0, len(prompt) + 1])] += 1
    freq = counts / n_trials
    assert counts[pmf == 0].sum() == 0
    tol = 4 * np.sqrt(pmf * (1 - pmf) / n_trials) + 1e-3
    assert (np.abs(freq - pmf) <= tol).all(), (
        f"max dev {np.abs(freq - pmf).max():.4f} vs tol {tol.max():.4f}")


def test_batched_seeded_rows_equal_solo_runs_and_replay(gpt):
    """Each batched row draws from its own generator: byte-equal to its
    solo run on a generator of the same seed; a rerun replays."""
    spec, _ = gpt
    prompts = [np.asarray([5, 9, 5, 9, 5, 9, 5]),
               np.asarray([3, 1, 4, 1, 5, 9, 2, 6, 5, 3]),
               np.asarray([8, 8, 2, 8, 8, 2])]
    seeds = [101, 202, 303]
    want = [spec.generate(p, 15, sampling=S, generator=_gen(s)).tokens[0]
            for p, s in zip(prompts, seeds)]
    for _ in range(2):
        got = spec.generate(prompts, 15, sampling=S,
                            generator=[_gen(s) for s in seeds])
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got.row_tokens(i), w,
                                          err_msg=f"row {i}")


def test_guards_and_messages(models, gpt):
    spec, _ = gpt
    _, _, tcfg, tp = models["gpt2"]
    prompt = np.arange(8)
    with pytest.raises(ValueError, match="torch.Generator"):
        spec.generate(prompt, 5, sampling=S)
    with pytest.raises(ValueError, match="per-row"):
        spec.generate(np.stack([prompt, prompt]), 5, sampling=S,
                      generator=_gen(0))
    with pytest.raises(ValueError, match="headroom"):
        spec.generate(prompt, MAX_SEQ - 8)     # fits max_seq, not + K
    with pytest.raises(ValueError, match="shorter than ngram"):
        SpecDecodeEngine(tp, tcfg, max_seq=64, ngram=3,
                         device="cpu").generate(np.arange(2), 5)
    with pytest.raises(ValueError, match="draft_len must be >= 1"):
        SpecDecodeEngine(tp, tcfg, max_seq=64, draft_len=0, device="cpu")
    with pytest.raises(ValueError, match="ngram must be >= 1"):
        SpecDecodeEngine(tp, tcfg, max_seq=64, ngram=0, device="cpu")
    # the port's own MoE family (ported) is window-dependent
    moe = MoEConfig(vocab_size=64, n_positions=64, n_embd=32, n_layer=2,
                    n_head=4)
    with pytest.raises(NotImplementedError, match="window-independent"):
        SpecDecodeEngine(tp, moe, max_seq=64, device="cpu")
    # check_request names the request's numbers, as JAX's does
    jcfg, jp, _, _ = models["gpt2"]
    ref = JSpecDecodeEngine(jp, jcfg, max_seq=MAX_SEQ, draft_len=K)
    for plen, new in ((1, 4), (50, MAX_SEQ - 50 - K + 1), (10, 20)):
        msgs = []
        for eng in (spec, ref):
            try:
                eng.check_request(plen, new)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1]
        assert spec.eligible(plen, new) == (msgs[0] is None)
    assert spec.plain.decode_kernel_mode == "xla"


def test_stats_and_counters(models):
    _, _, tcfg, tp = models["gpt2"]
    spec = SpecDecodeEngine(tp, tcfg, max_seq=MAX_SEQ, draft_len=K,
                            device="cpu")
    before = REGISTRY.snapshot()["counters"]
    r1 = spec.generate(np.asarray([5, 17, 3, 42] * 4), 20)
    r2 = spec.generate(_prompts(), 10, delivered=(3, 17))
    st = spec.stats()
    steps = r1.verify_steps + r2.verify_steps
    assert st == {"requests": 4, "verify_steps": steps,
                  "emitted_tokens": 37, "draft_len": K,
                  "tokens_per_verify": round(37 / steps, 2)}
    after = REGISTRY.snapshot()["counters"]

    def delta(name):
        key = (name, ())
        return after.get(key, 0) - before.get(key, 0)
    assert delta("spec_verify_steps_total") == steps
    assert delta("spec_emitted_tokens_total") == 37


# -- int8: the verify windows on the int8 kernels' wrappers -------------------

@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_int8_verify_windows_take_the_int8_kernels(monkeypatch, family):
    """The spec engine's int8 matmuls go through ``quant_linear`` (and
    GPT-2's tied head through ``quant_head``) at every window of <= 16
    rows, exactly as its ``forward_shapes`` predict; the plain "xla"
    int8 engine stays kernel-free. On the CPU the wrappers run their
    plain versions, so the spec stream equals the spec engine's own
    plain greedy stream."""
    is_llama = family == "llama"
    dims = dict(LLAMA_DIMS, vocab_size=256) if is_llama else GPT2_DIMS
    tree = (np_llama_params if is_llama else np_gpt2_params)(
        seed=4, std=0.08, dims=dims)
    tcfg = (llama.LlamaConfig if is_llama else gpt2.GPT2Config)(**dims)
    tp = params_from_numpy(tree, device="cpu")
    calls = {"quant_linear": 0, "quant_head": 0}
    for name in calls:
        real = getattr(quant, name)

        def counted(*a, _real=real, _name=name):
            calls[_name] += 1
            return _real(*a)
        monkeypatch.setattr(quant, name, counted)
    plain = DecodeEngine(tp, tcfg, max_seq=MAX_SEQ, dtype="int8",
                         decode_kernel="xla", device="cpu")
    plain.generate(np.arange(20) % 50, 6)
    assert calls == {"quant_linear": 0, "quant_head": 0}
    spec = SpecDecodeEngine(tp, tcfg, max_seq=MAX_SEQ, dtype="int8",
                            draft_len=6, device="cpu")
    prompts = [np.asarray([5, 17, 3, 42] * 5), np.arange(20) % 50 + 7]
    for batch in (prompts[:1], prompts):
        calls.update(quant_linear=0, quant_head=0)
        spec.plain._forward_shapes.clear()
        got = spec.generate(batch if len(batch) > 1 else batch[0], 12)
        shapes = spec.plain.forward_shapes()
        windows = sum(n for (b, t), n in shapes.items()
                      if b * t <= quant.MAX_KERNEL_ROWS)
        assert windows == got.verify_steps >= 1
        assert set(shapes) == {(len(batch), 20), (len(batch), 7)}
        per = 7 * tcfg.n_layer + 1 if is_llama else 4 * tcfg.n_layer
        assert calls == {"quant_linear": per * windows,
                         "quant_head": 0 if is_llama else windows}
        for i, p in enumerate(batch):
            np.testing.assert_array_equal(
                got.row_tokens(i), spec.plain.generate(p, 12).tokens[0])
