"""The port's llama family against the JAX package's, on the CPU.

Weights are drawn with numpy from a seed at the JAX tests' scale
(tests/test_decode_layer.py: init std 0.02 times 4) and carried into both
packages. The geometry is the smallest the llama megakernel takes:
n_embd 256, 4 query heads and 2 kv heads of 64 (GQA, g = 2), SwiGLU
hidden size 256, vocab 211, 2 layers (4 for the staged engine).

Tolerances: fp32 logits 1e-5 (abs and rel; the two sides differ only in
summation order). RoPE's angles come from each library's own float32
pow, cos and sin, and at positions in the thousands those differ by an
ulp or two between XLA and PyTorch (about 3e-7 on a value of 1), so the
angle test holds them to 1e-6 and, where the angle test feeds both
sides the same angles, the rotation to 1e-6 as well.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.models.moe import MoEConfig as JMoEConfig
from llm_sharding_demo_tpu.ops import attention as jattention
from llm_sharding_demo_tpu.ops import layers as jlayers
from llm_sharding_demo_tpu.ops import quant as jquant
from llm_sharding_demo_tpu.ops import rope as jrope
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu_torch.models import (family_module,
                                                is_partitionable,
                                                is_stage_partitionable, llama)
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.models.gpt2 import map_params
from llm_sharding_demo_tpu_torch.ops import attention, layers, quant, rope
from llm_sharding_demo_tpu_torch.ops import decode_layer as DL
from llm_sharding_demo_tpu_torch.parallel import partition as P
from llm_sharding_demo_tpu_torch.parallel.pipeline import PipelineRunner
from llm_sharding_demo_tpu_torch.runtime.engine import (DecodeEngine,
                                                        resolve_decode_kernel)
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import graftnum
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies)

DIMS = dict(vocab_size=211, n_positions=1024, n_embd=256, n_layer=2,
            n_head=4, n_kv_head=2, intermediate_size=256)
STD = 0.08          # the JAX test's init_params std 0.02, scaled by 4
MAX_SEQ = 300
RAGGED = [[5, 9, 2, 77, 30], [42, 3]]


def np_llama_params(seed: int = 0, std: float = STD, dims=None) -> dict:
    """llama params as nested dicts of float32 numpy arrays (the JAX
    package's layout), with non-trivial RMSNorm scales."""
    dims = dims or DIMS
    rng = np.random.default_rng(seed)
    d, l, v = dims["n_embd"], dims["n_layer"], dims["vocab_size"]
    kv = dims["n_kv_head"] * d // dims["n_head"]
    i = dims["intermediate_size"]

    def w(*shape, s=std, mean=0.0):
        return (mean + s * rng.standard_normal(shape)).astype(np.float32)

    return {
        "wte": w(v, d),
        "blocks": {
            "ln_attn": {"scale": w(l, d, s=0.1, mean=1.0)},
            "attn": {"wq": {"kernel": w(l, d, d)},
                     "wk": {"kernel": w(l, d, kv)},
                     "wv": {"kernel": w(l, d, kv)},
                     "wo": {"kernel": w(l, d, d)}},
            "ln_mlp": {"scale": w(l, d, s=0.1, mean=1.0)},
            "mlp": {"gate": {"kernel": w(l, d, i)},
                    "up": {"kernel": w(l, d, i)},
                    "down": {"kernel": w(l, i, d)}},
        },
        "ln_f": {"scale": w(d, s=0.1, mean=1.0)},
        "lm_head": {"kernel": w(d, v)},
    }


def _trees(dims):
    tree = np_llama_params(seed=1, dims=dims)
    return (jllama.LlamaConfig(**dims), jax.tree.map(jnp.asarray, tree),
            llama.LlamaConfig(**dims), params_from_numpy(tree, device="cpu"))


@pytest.fixture(scope="module")
def model():
    return _trees(DIMS)


@pytest.fixture(scope="module")
def model4():
    return _trees(dict(DIMS, n_layer=4))


# -- ops --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 256)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = jlayers.rms_norm(jnp.asarray(x, jdt), jnp.asarray(s, jdt), 1e-5)
    got = layers.rms_norm(torch.tensor(x).to(tdt), torch.tensor(s).to(tdt),
                          1e-5)
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    else:
        # the f32 statistics may round the normalized value the other way:
        # at most one bf16 ulp before the scale multiply, one after
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                                   atol=0)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_jax(per_row):
    """Angles at positions up to 4095 and the rotation of [B, H, S, hd]
    queries, uniform ([S, hd]) and per-row ([B, S, hd]) angles."""
    rng = np.random.default_rng(1)
    pos = (np.stack([np.arange(7) + 4088, np.arange(7) + 3]) if per_row
           else np.arange(7) + 1020)
    jc, js = jrope.rope_angles(jnp.asarray(pos), 64)
    tc, ts = rope.rope_angles(torch.tensor(pos), 64)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    x = rng.standard_normal((2, 4, 7, 64)).astype(np.float32)
    want = jrope.apply_rope(jnp.asarray(x), jc, js)
    got = rope.apply_rope(torch.tensor(x), torch.tensor(np.asarray(jc)),
                          torch.tensor(np.asarray(js)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("q_offset", [0, 3])
def test_gqa_causal_attention_matches_jax(q_offset, valid):
    """Grouped-query attention (8 query heads over 2 kv heads): query head
    i reads kv head i // 4, as the JAX package's grouped einsums."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 8, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 2, 4 + q_offset, 64)).astype(np.float32)
            for _ in range(2))
    vf = np.asarray([0, 2], np.int32) if valid else None
    want = jattention.causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=q_offset,
        k_valid_from=None if vf is None else jnp.asarray(vf))
    got = attention.causal_attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), q_offset=q_offset,
        k_valid_from=None if vf is None else torch.tensor(vf))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # the repeat_kv order: a dropped mapping (h % Hkv) gives other values
    wrong = attention.causal_attention(
        torch.tensor(q).reshape(2, 4, 2, 4, 64).transpose(1, 2).reshape(
            2, 8, 4, 64), torch.tensor(k), torch.tensor(v), q_offset=q_offset)
    assert not np.allclose(wrong.numpy(), np.asarray(want), atol=1e-3)


# -- model --------------------------------------------------------------------

def test_config_and_family_registry():
    cfg = llama.CONFIGS["llama-124m"]
    assert (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_kv_head, cfg.head_dim,
            cfg.intermediate_size, cfg.vocab_size, cfg.n_positions) == (
        12, 768, 12, 4, 64, 2048, 32000, 4096)
    assert family_module(cfg) is llama
    assert is_stage_partitionable(cfg) and not is_partitionable(cfg)
    # "pallas" (the flash-attention kernels) and "ring" (ring attention
    # over a mesh's sp axis) are ported
    assert llama.LlamaConfig(attention_impl="pallas").attention_impl == \
        "pallas"
    assert llama.LlamaConfig(attention_impl="ring").attention_impl == "ring"
    with pytest.raises(ValueError):
        llama.LlamaConfig(attention_impl="flash")
    with pytest.raises(ValueError, match="multiple"):
        llama.LlamaConfig(n_head=12, n_kv_head=5)
    # the port's MoEConfig resolves to its family; the JAX package's
    # config object is foreign to the port and refuses
    from llm_sharding_demo_tpu_torch.models import moe
    dims = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2,
                n_head=2)
    assert family_module(moe.MoEConfig(**dims)) is moe
    with pytest.raises(TypeError, match="unknown model config type"):
        family_module(JMoEConfig(**dims))


def test_params_round_trip_from_jax_init():
    """JAX init_params -> numpy -> port: every leaf arrives bit-equal and
    the port's forward gives the JAX logits."""
    cfg = jllama.LlamaConfig(**DIMS)
    jp = jllama.init_params(cfg, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert "lm_head" in tp and "wpe" not in tp
    ids = np.asarray([[1, 7, 42, 200, 3]])
    want = np.asarray(jllama.forward(jp, jnp.asarray(ids), cfg))
    got = llama.forward(tp, torch.tensor(ids), llama.LlamaConfig(**DIMS))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_forward_matches_jax(model):
    jcfg, jp, cfg, tp = model
    ids = np.random.default_rng(4).integers(0, 211, (2, 9))
    want = np.asarray(jllama.forward(jp, jnp.asarray(ids), jcfg))
    got = llama.forward(tp, torch.tensor(ids), cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_forward_with_cache_ragged_matches_jax(model, fused):
    """A left-padded prefill (per-row RoPE offsets, pad mask) and three
    cached steps: the real rows' logits equal the JAX package's."""
    jcfg, jp, cfg, tp = model
    ids = np.asarray([[5, 9, 2, 77, 30], [0, 0, 0, 42, 3]])
    pad = np.asarray([0, 3], np.int32)
    jcache = jattention.KVCache.create(2, 2, 2, 64, 64)
    if fused:
        tcache = attention.create_fused_cache(2, 2, 2, 64, 64, torch.float32)
    else:
        tcache = llama.make_cache(cfg, 2, 64)
    jl, jcache = jllama.forward_with_cache(jp, jnp.asarray(ids), jcfg, jcache,
                                           pad=jnp.asarray(pad))
    tl, tcache = llama.forward_with_cache(tp, torch.tensor(ids), cfg, tcache,
                                          pad=torch.tensor(pad))
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tl[1, 3:].numpy(), np.asarray(jl)[1, 3:],
                               atol=1e-5, rtol=1e-5)
    tok = np.asarray([[11], [12]])
    for _ in range(3):
        jl, jcache = jllama.forward_with_cache(jp, jnp.asarray(tok), jcfg,
                                               jcache, pad=jnp.asarray(pad))
        tl, tcache = llama.forward_with_cache(tp, torch.tensor(tok), cfg,
                                              tcache, pad=torch.tensor(pad))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        tok = np.asarray(jl)[:, -1].argmax(-1)[:, None]


# -- engine: fp32 greedy streams byte-equal to the JAX engine ----------------

CASES = {"solo": (np.asarray([RAGGED[0]]), 32), "ragged": (RAGGED, 24),
         "one_token": (np.asarray([[7]]), 12),
         "staged": (np.asarray([RAGGED[0]]), 24)}


@pytest.fixture(scope="module")
def jax_streams(model, model4):
    """The JAX engine's fp32 streams: the plain path ("xla") and the
    megakernel ("interpret" resolves to "mega-interpret" there)."""
    out = {}
    for kernel in ("xla", "interpret"):
        for case, (prompt, n) in CASES.items():
            jcfg, jp, _, _ = model4 if case == "staged" else model
            eng = jengine.DecodeEngine(
                jp, jcfg, max_seq=MAX_SEQ, decode_kernel=kernel,
                boundaries=[1] if case == "staged" else None)
            if kernel == "interpret":
                assert eng._decode_kernel == "mega-interpret"
            out[kernel, case] = eng.generate(prompt, n).tokens
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kernel", ["xla", "mega"])
def test_fp32_greedy_streams_equal_jax(model, model4, jax_streams, kernel,
                                       case):
    """fp32 greedy streams: the port's plain engine against the JAX
    plain engine, the port's "mega" engine (the llama kernel's plain
    version on the CPU) against the JAX mega-interpret engine; solo, a
    ragged batch, a 1-token prompt (its prefill runs the megakernel too)
    and a staged engine (boundaries [1], one launch per stage)."""
    _, _, cfg, tp = model4 if case == "staged" else model
    eng = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, decode_kernel=kernel,
                       boundaries=[1] if case == "staged" else None,
                       device="cpu")
    assert eng.decode_kernel_mode == kernel
    prompt, n = CASES[case]
    want = jax_streams["xla" if kernel == "xla" else "interpret", case]
    assert np.array_equal(eng.generate(prompt, n).tokens, want)


def test_pipeline_runner_serves_llama_fp32(model4, jax_streams):
    _, _, cfg, tp = model4
    runner = PipelineRunner(tp, cfg, [1], max_seq=MAX_SEQ, device="cpu")
    assert runner.decode_kernel_mode == "xla"
    prompt, n = CASES["staged"]
    assert np.array_equal(runner.generate(prompt, n).tokens,
                          jax_streams["xla", "staged"])


def test_decode_past_position_1024(model):
    """Decode continues past position 1024 (GPT-2's ceiling): a 1150-token
    prompt and 30 new tokens on the "mega" engine equal the JAX engine's
    stream, and the last token equals the argmax of an uncached forward
    over the whole sequence."""
    jcfg, jp, cfg, tp = model
    jlong = dataclasses.replace(jcfg, n_positions=1280)
    tlong = dataclasses.replace(cfg, n_positions=1280)
    prompt = (np.arange(1150, dtype=np.int64) * 31) % 211
    eng = DecodeEngine(tp, tlong, max_seq=1280, decode_kernel="mega",
                       device="cpu")
    out = eng.generate(prompt, 30).tokens
    assert out.shape == (1, 1180)
    want = jengine.DecodeEngine(jp, jlong, max_seq=1280).generate(prompt, 30)
    assert np.array_equal(out, want.tokens)
    full = llama.forward(tp, torch.tensor(out[:, :-1]), tlong)
    assert int(out[0, -1]) == int(full[0, -1].argmax())


@pytest.mark.parametrize("regime,path", [("bfloat16", "decode.bf16"),
                                         ("int8", "decode.int8")])
@pytest.mark.parametrize("kernel", ["layer", "mega"])
def test_approximate_regimes_within_budget_of_jax_fp32(model, regime, path,
                                                       kernel):
    """bf16 and int8 on the kernel paths (the kernels' plain versions on
    the CPU), teacher-forced, stay inside the declared budgets against
    the JAX fp32 logits. The budgets are in logit units, so the weights
    here have the models' own init std (0.02): the 4x tree of the other
    tests has logits twice as wide and reads 3e-3 on int8, outside its
    cap, on either package."""
    from test_torch_model import teacher_forced_logits
    jcfg, _, cfg, _ = model
    tree = np_llama_params(seed=1, std=0.02)
    jp, tp = (jax.tree.map(jnp.asarray, tree),
              params_from_numpy(tree, device="cpu"))
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 211, 6).tolist()
    forced = rng.integers(0, 211, 24).tolist()
    seq = jnp.asarray([prompt + forced])
    exact = np.asarray(jllama.forward(jp, seq, jcfg))[0, len(prompt) - 1:-1]
    eng = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, dtype=regime,
                       decode_kernel=kernel, device="cpu")
    assert eng.decode_kernel == kernel
    approx = teacher_forced_logits(eng, prompt, forced)
    graftnum.compare(path, approx, torch.tensor(exact))


def test_quantize_params_on_the_llama_tree(model):
    """The untied head stays a 2-D block kernel; wte is padded to whole
    2048-row blocks; the codes equal the JAX package's."""
    _, jp, _, tp = model
    jq = jquant.quantize_params(jp, jnp.bfloat16)
    tq = quant.quantize_params(tp, torch.bfloat16)
    head = tq["lm_head"]["kernel"]
    assert quant.is_quantized(head) and head.q.shape == (256, 211)
    assert head.rows is None
    assert tq["wte"].q.shape == (2048, 256) and tq["wte"].rows == 211
    assert tq["blocks"]["ln_attn"]["scale"].dtype == torch.bfloat16
    for t, j in ((head, jq["lm_head"]["kernel"]),
                 (tq["blocks"]["mlp"]["down"]["kernel"],
                  jq["blocks"]["mlp"]["down"]["kernel"])):
        assert np.array_equal(t.q.numpy(), np.asarray(j.q))
    big = llama.CONFIGS["llama-124m"]
    assert quant.round_up_vocab(big.vocab_size) == 32768


def test_stage_partition_of_the_llama_tree(model4):
    _, _, cfg, tp = model4
    specs = P.make_stage_specs(cfg.n_layer, [1, 3])
    first, mid, last = P.partition_params(tp, specs)
    assert set(first) == {"blocks", "wte"}
    assert set(mid) == {"blocks"}
    assert set(last) == {"blocks", "ln_f", "lm_head"}
    assert first["blocks"]["attn"]["wq"]["kernel"].shape[0] == 1
    cache = P.make_stage_cache(specs[1], cfg, 3, 64)
    assert cache.k.shape == (2, 3, 2, 64, 64)
    eng = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, dtype="int8",
                       boundaries=[1, 3], decode_kernel="mega", device="cpu")
    assert [c.k.shape for c in eng._fresh_cache(1)] == [
        (n, 1, 2, 512, 128) for n in (1, 2, 1)]


def test_mega_route_runs_the_whole_stack_once_per_stage_step(model,
                                                             monkeypatch):
    """A mega engine's decode step calls decode_layers_llama once per
    stage, with [B, hd] angles of the step's position; a longer prompt's
    prefill takes the per-layer path."""
    _, _, cfg, tp = model
    calls = []
    real = llama.decode_layers_llama

    def spy(blocks, h, KV, offset, cos, sin, *a, **k):
        calls.append((offset, tuple(cos.shape)))
        want_c, _ = rope.rope_angles(torch.tensor([offset]), 64)
        assert torch.equal(cos, want_c.expand(h.shape[0], 64))
        return real(blocks, h, KV, offset, cos, sin, *a, **k)

    monkeypatch.setattr(llama, "decode_layers_llama", spy)
    staged = DecodeEngine(tp, cfg, max_seq=MAX_SEQ, decode_kernel="mega",
                          boundaries=[1], device="cpu")
    staged.generate(np.asarray([RAGGED[0]]), 3)
    assert calls == [(o, (1, 64)) for o in (5, 5, 6, 6)]


def test_kernel_mode_resolution_on_cuda(model):
    """What "auto" picks on a card, decided without one: the llama
    megakernel for bf16/int8 at an eligible geometry, the per-layer
    kernels where only they apply, the plain path for fp32."""
    _, _, cfg, _ = model
    for regime in ("bfloat16", "int8"):
        assert resolve_decode_kernel("auto", cfg, MAX_SEQ, regime, True) == (
            "mega", 512)
        assert resolve_decode_kernel("auto", cfg, MAX_SEQ, "float32",
                                     True) == (None, MAX_SEQ)
    big = llama.CONFIGS["llama-124m"]
    assert DL.llama_eligible(big, 4096)
    assert resolve_decode_kernel("auto", big, 4096, "int8", True) == (
        "mega", 4096)
    # 8 query heads per kv head: past the kernel's group, "layer" only
    g8 = llama.LlamaConfig(**dict(DIMS, n_embd=512, n_head=8, n_kv_head=1))
    assert not DL.llama_eligible(g8, 512)
    assert resolve_decode_kernel("auto", g8, MAX_SEQ, "int8", True) == (
        "layer", 512)
    with pytest.raises(ValueError, match="ineligible"):
        resolve_decode_kernel("mega", g8, MAX_SEQ, "int8", True)
    # a kv width of 64 (one kv head) is not 128-aligned
    kv64 = llama.LlamaConfig(**dict(DIMS, n_kv_head=1))
    assert not DL.llama_eligible(kv64, 512)


def test_entry_points_need_cuda_or_an_explicit_cpu(model, monkeypatch):
    _, _, cfg, tp = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(tp, cfg, max_seq=MAX_SEQ)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_app(ServingConfig(model_id="llama-tiny"))


# -- the megakernel's plain version: planted faults --------------------------

def _gqa_dropped(real):
    """decode_attention_plain with the GQA mapping dropped: query head h
    reads kv head h % Hkv instead of h // g."""
    def faulty(q, k_new, v_new, KV, *a, **k):
        b, h, s, hd = q.shape
        hkv = k_new.shape[1]
        perm = torch.arange(h).reshape(hkv, h // hkv).t().reshape(-1)
        out, KV = real(q[:, perm], k_new, v_new, KV, *a, **k)
        return out[:, torch.argsort(perm)], KV
    return faulty


def _k_rope_skipped():
    """A copy of decode_layers_llama_plain whose k is not rotated (so the
    cache row holds the unrotated k)."""
    src = inspect.getsource(DL.decode_layers_llama_plain)
    line = "        k = rope_rows(k, cos, sin)\n"
    assert src.count(line) == 1
    scope = dict(vars(DL))
    exec(src.replace(line, ""), scope)
    return scope["decode_layers_llama_plain"]


@pytest.mark.parametrize("fault", ["gqa_dropped", "k_rope_skipped"])
@pytest.mark.parametrize("regime", ["bfloat16", "int8"])
def test_stack_check_rejects_a_planted_fault(model, monkeypatch, regime,
                                             fault):
    """``graftnum.compare_stack`` (the output and the written cache rows)
    passes the plain version against the JAX kernel and rejects a copy
    with the GQA mapping dropped or k's rotation skipped."""
    from test_torch_decode_layer import jax_llama_kernel, llama_case
    jb, tb, jdt, tdt = _llama_blocks(model, regime)
    h, KV, vf, cos, sin = llama_case(3, 37, masked=True)
    want_h, want_kv = jax_llama_kernel(jb, h, KV, 37, cos, sin, vf, jdt)
    want_h, want_row = torch.tensor(want_h), torch.tensor(want_kv[:, :, :, 37])
    th = torch.tensor(h).to(tdt)

    def run(fn):
        kv = torch.tensor(KV).to(tdt)
        out, kv = fn(tb, th, kv, 37, torch.tensor(cos), torch.tensor(sin),
                     torch.tensor(vf), n_head=4, eps=1e-5)
        return out, kv[:, :, :, 37]

    out, row = run(DL.decode_layers_llama_plain)
    graftnum.compare_stack(out, want_h, th, row, want_row)
    if fault == "gqa_dropped":
        monkeypatch.setattr(DL, "decode_attention_plain",
                            _gqa_dropped(DL.decode_attention_plain))
        bad = run(DL.decode_layers_llama_plain)
    else:
        bad = run(_k_rope_skipped())
    with pytest.raises(graftnum.GraftnumError):
        graftnum.compare_stack(bad[0], want_h, th, bad[1], want_row)


def _llama_blocks(model, regime):
    _, jp, _, tp = model
    if regime == "bfloat16":
        return (jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp["blocks"]),
                map_params(lambda x: x.to(torch.bfloat16), tp["blocks"]),
                jnp.bfloat16, torch.bfloat16)
    return (jquant.quantize_params(jp, jnp.bfloat16)["blocks"],
            quant.quantize_params(tp, torch.bfloat16)["blocks"],
            jnp.bfloat16, torch.bfloat16)


# -- serving ------------------------------------------------------------------

def test_serving_llama(model):
    """/generate answers for llama (staged, SPLIT_AT=1, greedy equal to
    the JAX app's), the GPT-2 wire endpoints decline it, remote dispatch
    refuses, and MODEL_ID=llama-tiny resolves."""
    from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
    from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
    from llm_sharding_demo_tpu.serving.tokenizer import (
        ByteTokenizer as JByteTokenizer)
    from llm_sharding_demo_tpu.utils.config import (
        ServingConfig as JServingConfig)
    from llm_sharding_demo_tpu_torch.serving import loader

    jcfg, jp, cfg, tp = model
    big = dict(vocab_size=256)
    jcfg = dataclasses.replace(jcfg, **big)
    cfg = dataclasses.replace(cfg, **big)
    tree = np_llama_params(seed=5, dims=dict(DIMS, **big))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree, device="cpu")
    body = {"prompt": "Hi, shard", "max_new_tokens": 8, "mode": "greedy"}
    t = TestClient(create_app(ServingConfig(model_id="llama-test", max_seq=64),
                              model=(cfg, tp), tokenizer=ByteTokenizer(),
                              device="cpu"))
    health = t.get("/healthz").json()
    assert health["n_stages"] == 2 and "decode_layers_llama" in health[
        "kernel_launches"]
    r = t.post("/generate", json=body)
    j = JTestClient(jcreate_app(JServingConfig(model_id="llama-test",
                                               max_seq=64),
                                model=(jcfg, jp), tokenizer=JByteTokenizer()))
    assert r.status_code == 200
    assert r.json() == j.post("/generate", json=body).json()
    for role, path, payload in (
            ("a", "/forward", {"input_ids": [1, 2]}),
            ("b", "/forward_b", {"hidden_states": [[[0.0] * 256]]})):
        c = TestClient(create_app(
            ServingConfig(model_id="llama-test", shard_role=role, max_seq=64),
            model=(cfg, tp), tokenizer=ByteTokenizer(), device="cpu"))
        assert "dense GPT-2 only" in c.post(path, json=payload).json()["error"]
    with pytest.raises(ValueError, match="DISPATCH=remote requires the "
                       "dense GPT-2 stage-shard topology"):
        create_app(ServingConfig(model_id="llama-test", dispatch="remote"),
                   model=(cfg, tp), tokenizer=ByteTokenizer(), device="cpu")
    config, params = loader.resolve_model(ServingConfig(model_id="llama-tiny"),
                                          torch.device("cpu"))
    assert config == llama.CONFIGS["llama-tiny"]
    assert params["lm_head"]["kernel"].shape == (32, 256)
