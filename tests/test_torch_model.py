"""The PyTorch port's GPT-2 model and decode engine against the JAX package.

Weights and inputs are drawn with numpy from a seed and carried into
both packages (``np.asarray`` on the JAX side, ``params_from_numpy`` on
the port's); everything runs on the CPU at a small size (2 layers,
n_embd 128, head_dim 64 so the fused-cache kernel geometry applies,
vocab 211). The weight std (0.04) keeps greedy argmax margins wide
while bf16/int8 stay inside their declared budgets.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu.parallel.pipeline import (
    PipelineRunner as JPipelineRunner)
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.ops.attention import create_fused_cache
from llm_sharding_demo_tpu_torch.parallel.pipeline import PipelineRunner
from llm_sharding_demo_tpu_torch.runtime import engine
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        SamplingConfig)
from llm_sharding_demo_tpu_torch.utils import graftnum

# One intra-op thread a process. The suite runs six workers, with
# spawned gloo ranks beside them, on a few cores, and every worker
# imports this module when it collects, so this holds for each port test
# it runs. torch's intra-op pool waits for threads the oversubscribed
# cores do not schedule: test_torch_spec_decode's sampling-law test,
# 4.3 s alone, took 54 s beside twelve busy processes with the default
# pool of eight threads and 4.3 s with one.
torch.set_num_threads(1)

# The JAX package's memory ledger retires a holding from a weakref
# finalizer that samples graftscope under its lock, and the per-test
# metrics isolation in tests/conftest.py holds that same lock while it
# copies the rings: a cyclic collection inside that copy that frees a JAX
# engine deadlocks the worker. These two fixtures, imported by every
# port test module that builds JAX engines, keep the collector off from
# the end of a test's body to the start of the next one's, and collect
# once when the module ends.
@pytest.fixture(scope="module", autouse=True)
def gc_between_modules():
    gc.disable()
    yield
    gc.collect()
    gc.enable()


@pytest.fixture(autouse=True)
def gc_only_in_test_bodies():
    gc.enable()
    yield
    gc.disable()


DIMS = dict(vocab_size=211, n_positions=512, n_embd=128, n_layer=2,
            n_head=2)
JCFG = jgpt2.GPT2Config(**DIMS)
CFG = gpt2.GPT2Config(**DIMS)
MAX_SEQ = 300
RAGGED = [[5, 9, 2, 77, 30], [42, 3]]


def np_moe_params(seed: int, std: float, dims: dict) -> dict:
    """GPT-2-MoE params at ``dims`` as nested dicts of float32 numpy
    arrays (the JAX package's layout), with non-trivial LN and bias
    values."""
    rng = np.random.default_rng(seed)
    d, l, v = dims["n_embd"], dims["n_layer"], dims["vocab_size"]
    e = dims["n_experts"]

    def w(*shape, s=std, mean=0.0):
        return (mean + s * rng.standard_normal(shape)).astype(np.float32)

    return {
        "wte": w(v, d), "wpe": w(dims["n_positions"], d),
        "blocks": {
            "ln_1": {"scale": w(l, d, s=0.1, mean=1.0), "bias": w(l, d, s=0.02)},
            "attn": {"c_attn": {"kernel": w(l, d, 3 * d), "bias": w(l, 3 * d, s=0.02)},
                     "c_proj": {"kernel": w(l, d, d), "bias": w(l, d, s=0.02)}},
            "ln_2": {"scale": w(l, d, s=0.1, mean=1.0), "bias": w(l, d, s=0.02)},
            "moe": {"router": {"kernel": w(l, d, e, s=0.3)},
                    "experts": {
                        "c_fc": {"kernel": w(l, e, d, 4 * d),
                                 "bias": w(l, e, 4 * d, s=0.02)},
                        "c_proj": {"kernel": w(l, e, 4 * d, d),
                                   "bias": w(l, e, d, s=0.02)}}},
        },
        "ln_f": {"scale": w(d, s=0.1, mean=1.0), "bias": w(d, s=0.02)},
    }


def np_gpt2_params(seed: int = 0, std: float = 0.04, dims=None) -> dict:
    """GPT-2 params as nested dicts of float32 numpy arrays (the JAX
    package's layout), with non-trivial LN and bias values."""
    dims = dims or DIMS
    rng = np.random.default_rng(seed)
    d, l, v = dims["n_embd"], dims["n_layer"], dims["vocab_size"]

    def w(*shape, s=std, mean=0.0):
        return (mean + s * rng.standard_normal(shape)).astype(np.float32)

    return {
        "wte": w(v, d), "wpe": w(dims["n_positions"], d),
        "blocks": {
            "ln_1": {"scale": w(l, d, s=0.1, mean=1.0), "bias": w(l, d, s=0.02)},
            "attn": {"c_attn": {"kernel": w(l, d, 3 * d), "bias": w(l, 3 * d, s=0.02)},
                     "c_proj": {"kernel": w(l, d, d), "bias": w(l, d, s=0.02)}},
            "ln_2": {"scale": w(l, d, s=0.1, mean=1.0), "bias": w(l, d, s=0.02)},
            "mlp": {"c_fc": {"kernel": w(l, d, 4 * d), "bias": w(l, 4 * d, s=0.02)},
                    "c_proj": {"kernel": w(l, 4 * d, d), "bias": w(l, d, s=0.02)}},
        },
        "ln_f": {"scale": w(d, s=0.1, mean=1.0), "bias": w(d, s=0.02)},
    }


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params()
    return to_jax(tree), params_from_numpy(tree, device="cpu")


# -- (e) model ------------------------------------------------------------------

def test_params_round_trip_from_jax_pytree():
    """JAX params -> numpy -> port: every leaf arrives bit-equal and the
    port's forward gives the JAX logits."""
    jparams = jgpt2.init_params(JCFG, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    ids = np.asarray([[1, 7, 42, 200, 3]])
    want = np.asarray(jgpt2.forward(jparams, jnp.asarray(ids), JCFG))
    got = gpt2.forward(tparams, torch.as_tensor(ids), CFG).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert np.array_equal(tparams["blocks"]["attn"]["c_attn"]["kernel"].numpy(),
                          np.asarray(jparams["blocks"]["attn"]["c_attn"]["kernel"]))


def test_forward_matches_jax(weights):
    jp, tp = weights
    ids = np.random.default_rng(1).integers(0, 211, (2, 9))
    want = np.asarray(jgpt2.forward(jp, jnp.asarray(ids), JCFG))
    got = gpt2.forward(tp, torch.as_tensor(ids), CFG).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 9, 211)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_with_cache_ragged_matches_jax(weights, fused):
    """Prefill of a left-padded ragged batch, then two cached steps, on
    the separate and the fused cache layouts."""
    jp, tp = weights
    ids, pad = engine.left_pad(RAGGED)
    jc = jgpt2.make_cache(JCFG, 2, 256)
    if fused:
        tc = create_fused_cache(2, 2, 2, 256, 64, torch.float32)
    else:
        tc = gpt2.make_cache(CFG, 2, 256)
    jpad, tpad = jnp.asarray(pad), torch.as_tensor(pad)
    steps = [ids, np.asarray([[11], [12]]), np.asarray([[13], [14]])]
    for x in steps:
        jl, jc = jgpt2.forward_with_cache(jp, jnp.asarray(x), JCFG, jc, jpad)
        tl, tc = gpt2.forward_with_cache(tp, torch.as_tensor(x), CFG, tc,
                                         tpad)
        # pad columns attend to nothing real and are never read; their
        # garbage depends on the attended window, so compare real ones
        for b in range(2):
            real = slice(max(pad[b] - tc.length + x.shape[1], 0), None)
            np.testing.assert_allclose(tl[b, real].numpy(),
                                       np.asarray(jl)[b, real], atol=1e-5,
                                       rtol=1e-5)
    assert tc.length == int(jc.length) == ids.shape[1] + 2


# -- (f) engine ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_streams(weights):
    jp, _ = weights
    eng = jengine.DecodeEngine(jp, JCFG, max_seq=MAX_SEQ, decode_kernel="xla")
    solo = eng.generate(np.asarray([RAGGED[0]]), 24).tokens
    ragged = eng.generate(RAGGED, 16).tokens
    return solo, ragged


@pytest.mark.parametrize("decode_kernel", ["xla", "layer"])
def test_fp32_greedy_streams_equal_jax(weights, jax_streams, decode_kernel):
    """fp32 greedy streams are byte-equal to the JAX engine's plain path,
    at bs=1 and in a ragged batch (the "layer" engine on the CPU runs the
    kernels' plain versions over the fused cache)."""
    _, tp = weights
    solo, ragged = jax_streams
    eng = DecodeEngine(tp, CFG, max_seq=MAX_SEQ, decode_kernel=decode_kernel,
                       device="cpu")
    assert np.array_equal(eng.generate(np.asarray([RAGGED[0]]), 24).tokens,
                          solo)
    assert np.array_equal(eng.generate(RAGGED, 16).tokens, ragged)


def test_pipeline_runner_matches_jax(weights, jax_streams):
    jp, tp = weights
    want = JPipelineRunner(jp, JCFG, [1], max_seq=MAX_SEQ).generate(
        np.asarray([RAGGED[0]]), 24).tokens
    got = PipelineRunner(tp, CFG, [1], max_seq=MAX_SEQ, device="cpu"
                         ).generate(np.asarray([RAGGED[0]]), 24).tokens
    assert np.array_equal(got, want)
    assert np.array_equal(got, jax_streams[0])


@pytest.mark.parametrize("bounds", [[1], [1, 2, 3], [3], [], [2, 2], [0],
                                    [4], [3, 1]])
def test_stage_specs_agree_with_jax(bounds):
    """make_stage_specs accepts and refuses the same partitions of 4
    layers as the JAX package, and validate_specs refuses a list whose
    order or coverage is broken."""
    from llm_sharding_demo_tpu.parallel import partition as jpartition
    from llm_sharding_demo_tpu_torch.parallel import partition

    def specs_or_error(mod):
        try:
            return [(s.index, s.n_stages, s.start, s.end)
                    for s in mod.make_stage_specs(4, bounds)]
        except ValueError:
            return "refused"

    got = specs_or_error(partition)
    assert got == specs_or_error(jpartition)
    if got == "refused":
        return
    specs = partition.make_stage_specs(4, bounds)
    partition.validate_specs(specs, 4)
    broken = [specs[::-1], specs[:-1]] if len(specs) > 1 else [[]]
    for bad in broken:
        with pytest.raises(ValueError):
            partition.validate_specs(bad, 4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_staged_engine_equals_unstaged(weights, dtype):
    _, tp = weights
    plain = DecodeEngine(tp, CFG, max_seq=MAX_SEQ, dtype=dtype,
                         decode_kernel="layer", device="cpu")
    staged = DecodeEngine(tp, CFG, max_seq=MAX_SEQ, dtype=dtype,
                          boundaries=[1], decode_kernel="layer", device="cpu")
    assert np.array_equal(plain.generate(RAGGED, 12).tokens,
                          staged.generate(RAGGED, 12).tokens)


@pytest.mark.parametrize("top_p", [1.0, 0.7])
def test_sampler_pmf_matches_jax(top_p):
    logits = np.random.default_rng(5).standard_normal((3, 211)).astype(
        np.float32) * 3
    jp, ji = jengine.sampler_pmf(
        jnp.asarray(logits), jengine.SamplingConfig(mode="sample", top_p=top_p))
    tp, ti = engine.sampler_pmf(
        torch.as_tensor(logits), SamplingConfig(mode="sample", top_p=top_p))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    assert np.array_equal(ti.numpy(), np.asarray(ji))


def test_seeded_sampling_replays(weights):
    _, tp = weights
    eng = DecodeEngine(tp, CFG, max_seq=MAX_SEQ, device="cpu")
    s = SamplingConfig(mode="sample", temperature=1.5, top_k=50)

    def run(seed):
        gen = torch.Generator().manual_seed(seed)
        return eng.generate(np.asarray([RAGGED[0]]), 20, s, gen).tokens

    assert np.array_equal(run(7), run(7))
    assert not np.array_equal(run(7), run(8))
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(np.asarray([RAGGED[0]]), 4, s)


def test_eos_stops_at_a_check_boundary_with_an_exact_prefix(weights):
    _, tp = weights
    eng = DecodeEngine(tp, CFG, max_seq=MAX_SEQ, device="cpu")
    full = eng.generate(np.asarray([RAGGED[0]]), 100).tokens[0, 5:]
    eos = int(full[3])
    stopped = eng.generate(np.asarray([RAGGED[0]]), 100, eos_id=eos)
    # the first token is checked on its own, then every 32 steps
    want = 1 if full[0] == eos else 1 + engine.EOS_SEGMENT
    assert stopped.new_tokens == want
    assert np.array_equal(stopped.tokens[0, 5:], full[:stopped.new_tokens])
    assert engine.eos_chunks(400) == [32, 64, 128, 176]


def teacher_forced_logits(eng, prompt, forced):
    """f32 logits [len(forced), vocab]: row 0 from the prefill of the
    prompt, every later row from a cached single-token step fed
    ``forced[t - 1]`` (the decode path)."""
    with torch.inference_mode():
        cache = eng._fresh_cache(1)
        logits, cache = eng._forward_cached(eng._ids([prompt]), cache, None)
        rows = [logits[0, -1]]
        for tok in forced[:-1]:
            logits, cache = eng._forward_cached(eng._ids([[tok]]), cache,
                                                None)
            rows.append(logits[0, -1])
    return torch.stack(rows).float()


@pytest.mark.parametrize("regime,path", [("bfloat16", "decode.bf16"),
                                         ("int8", "decode.int8")])
def test_approximate_regimes_within_budget_of_jax_fp32(weights, regime,
                                                       path):
    """bf16 and int8 on the "layer" path (the kernels' plain versions on
    the CPU), teacher-forced over a fixed sequence, stay inside the
    declared budgets against the JAX fp32 logits."""
    jp, tp = weights
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 211, 6).tolist()
    forced = rng.integers(0, 211, 24).tolist()
    seq = jnp.asarray([prompt + forced])
    exact = np.asarray(jgpt2.forward(jp, seq, JCFG))[0, len(prompt) - 1:-1]
    eng = DecodeEngine(tp, CFG, max_seq=MAX_SEQ, dtype=regime,
                       decode_kernel="layer", device="cpu")
    assert eng.decode_kernel == "layer"
    approx = teacher_forced_logits(eng, prompt, forced)
    report = graftnum.compare(path, approx, torch.tensor(exact))
    assert report["n_positions"] == len(forced)


def test_kernel_mode_resolution_and_cache_rounding(weights):
    """The decode_kernel modes resolve as documented and kernel mode
    sizes its cache exactly as the JAX engine does."""
    jp, tp = weights
    jeng = jengine.DecodeEngine(jp, JCFG, max_seq=MAX_SEQ,
                                decode_kernel="interpret")
    eng = DecodeEngine(tp, CFG, max_seq=MAX_SEQ, decode_kernel="layer",
                       device="cpu")
    assert eng._cache_seq == jeng._cache_seq == 512
    assert eng._fresh_cache(2).k.shape == jeng._fresh_cache(2).k.shape
    auto = DecodeEngine(tp, CFG, max_seq=MAX_SEQ, dtype="bfloat16",
                        device="cpu")
    assert auto.decode_kernel is None and auto._cache_seq == MAX_SEQ
    mega = DecodeEngine(tp, CFG, max_seq=MAX_SEQ, decode_kernel="mega",
                        device="cpu")
    assert (mega.decode_kernel_mode, mega._cache_seq) == ("mega", 512)
    for mode in ("interpret", "layer-interpret", "mega-interpret", "bogus"):
        with pytest.raises(ValueError):
            DecodeEngine(tp, CFG, max_seq=MAX_SEQ, decode_kernel=mode,
                         device="cpu")
    tiny = gpt2.CONFIGS["tiny-gpt2"]
    tiny_params = gpt2.init_params(tiny, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="ineligible"):
        DecodeEngine(tiny_params, tiny, max_seq=64, decode_kernel="layer",
                     device="cpu")


def test_entry_points_need_cuda_or_an_explicit_cpu(weights, monkeypatch):
    _, tp = weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(tp, CFG, max_seq=MAX_SEQ)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PipelineRunner(tp, CFG, [1], max_seq=MAX_SEQ)
