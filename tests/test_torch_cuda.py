"""The port's CUDA kernels against their plain versions, on a GPU.

Marked ``cuda`` and skipped without a CUDA device (the decision is made
in a fixture, at run time). On a machine with a card and without JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest`` skips the repository conftest, which sets up JAX).
"""

import os

import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu_torch.models import gpt2, llama
from llm_sharding_demo_tpu_torch.ops import cuda_build, quant
from llm_sharding_demo_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_plain)
from llm_sharding_demo_tpu_torch.ops.decode_layer import (
    decode_layers, decode_layers_llama, decode_layers_llama_plain,
    decode_layers_plain)
from llm_sharding_demo_tpu_torch.ops.rope import rope_angles
from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
from llm_sharding_demo_tpu_torch.utils import graftnum

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "their plain versions are tested on the CPU)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("off", [0, 100, 300])
def test_decode_attention_kernel_matches_plain(dev, dtype, tol, off):
    g = torch.Generator(device=dev).manual_seed(off)
    B, H, hd, S = 3, 4, 64, 512
    KV = torch.randn(2, B, 2, S, 2 * hd, generator=g, device=dev).to(dtype)
    q = torch.randn(B, H, 1, hd, generator=g, device=dev).to(dtype)
    kn, vn = (torch.randn(B, 2, 1, hd, generator=g, device=dev).to(dtype)
              for _ in range(2))
    vf = torch.tensor([0, 5, off // 2], dtype=torch.int32, device=dev)
    a, b = KV.clone(), KV.clone()
    n0 = cuda_build.launch_counts()["decode_attention"]
    out_k, _ = decode_attention(q, kn, vn, a, 1, off, vf)
    out_p, _ = decode_attention_plain(q, kn, vn, b, 1, off, vf)
    assert cuda_build.launch_counts()["decode_attention"] == n0 + 1
    torch.testing.assert_close(out_k.float(), out_p.float(), atol=tol,
                               rtol=tol)
    assert torch.equal(a, b)


@pytest.mark.parametrize("rows", [1, 16])
def test_int8_kernels_match_plain(dev, rows):
    g = torch.Generator(device=dev).manual_seed(rows)
    x = torch.randn(rows, 256, generator=g, device=dev).to(torch.bfloat16)
    qt = quant.quantize_array(torch.randn(256, 384, generator=g,
                                          device=dev) * 0.05)
    y_k = quant.quant_linear(x, qt.q, qt.scale)
    y_p = quant.linear_plain(x, qt.q, qt.scale)
    assert (y_k.float() - y_p.float()).abs().max() <= \
        2 ** -7 * y_p.float().abs().max()
    table = quant.quantize_params(
        {"wte": torch.randn(300, 256, generator=g, device=dev)})["wte"]
    torch.testing.assert_close(quant.quant_head(x, table.q),
                               quant.head_plain(x, table.q), atol=1e-3,
                               rtol=1e-5)


def test_layer_engine_matches_plain_engine_greedy(dev):
    cfg = gpt2.GPT2Config(vocab_size=211, n_positions=512, n_embd=128,
                          n_layer=2, n_head=2)
    params = gpt2.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                              std=0.04)
    prompt = np.asarray([[5, 9, 2, 77, 30]])
    for dtype in ("bfloat16", "int8"):
        ker = DecodeEngine(params, cfg, max_seq=300, dtype=dtype,
                           decode_kernel="layer")
        plain = DecodeEngine(params, cfg, max_seq=300, dtype=dtype,
                             decode_kernel="xla")
        assert ker.decode_kernel == "layer"
        assert np.array_equal(ker.generate(prompt, 24).tokens,
                              plain.generate(prompt, 24).tokens)


@pytest.mark.parametrize("off", [0, 37, 300])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("regime", ["bfloat16", "int8"])
@pytest.mark.parametrize("n_layer", [1, 3])
def test_decode_layers_kernel_matches_plain(dev, n_layer, regime, batch, off):
    """The whole-stack kernel against its plain version: the hidden state
    within ``graftnum.STACK_POLICY`` (the two sum in different orders, and
    a bf16 rounding that flips grows through the layers), the cache equal
    outside row ``off``, two launches bit-identical. One layer is the case
    where layer 0 is also the last."""
    cfg = gpt2.GPT2Config(vocab_size=211, n_positions=512, n_embd=256,
                          n_layer=n_layer, n_head=4)
    g = torch.Generator(device=dev).manual_seed(batch * 1000 + off)
    params = gpt2.init_params(cfg, g, std=0.05)
    if regime == "int8":
        blocks = quant.quantize_params(params)["blocks"]
    else:
        blocks = gpt2.map_params(lambda x: x.to(torch.bfloat16),
                                 params["blocks"])
    KV = torch.randn(n_layer, batch, 4, 512, 128, generator=g,
                     device=dev).to(torch.bfloat16)
    h = torch.randn(batch, 1, 256, generator=g, device=dev).to(torch.bfloat16)
    vf = torch.tensor([b % 3 * (off // 3) for b in range(batch)],
                      dtype=torch.int32, device=dev)
    a, b, c = KV.clone(), KV.clone(), KV.clone()
    n0 = cuda_build.launch_counts()["decode_layers"]
    out_k, _ = decode_layers(blocks, h, a, off, vf, n_head=4, eps=1e-5)
    out_k2, _ = decode_layers(blocks, h, b, off, vf, n_head=4, eps=1e-5)
    out_p, _ = decode_layers_plain(blocks, h, c, off, vf, n_head=4, eps=1e-5)
    assert cuda_build.launch_counts()["decode_layers"] == n0 + 2
    assert torch.equal(out_k, out_k2) and torch.equal(a, b)
    lim = graftnum.compare_stack(out_k, out_p, h)["max_abs_limit"]
    assert (a[:, :, :, off].float() - c[:, :, :, off].float()).abs().max() \
        <= lim
    a[:, :, :, off] = c[:, :, :, off]
    assert torch.equal(a, c)


# faults planted in a copy of the kernel source: (text, replacement)
PLANTED_FAULTS = {
    # the output projection's merge skips the last span of cached positions
    "drop_last_span": (
        "merge_state(mf, lf, of, st[kHd], st[kHd + 1], st[c - hh * kHd]);",
        "if (s == 0 || s != n_spans - 1) merge_state(mf, lf, of, st[kHd], "
        "st[kHd + 1], st[c - hh * kHd]);"),
    # attention ignores k_valid_from (left-pad rows attend their pads)
    "ignore_mask": (
        "const int start = p.valid_from != nullptr ? max(p.valid_from[b], 0) "
        ": 0;", "const int start = 0;"),
}


@pytest.mark.parametrize("n_layer", [1, 12])
@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_stack_check_catches_planted_fault(dev, tmp_path, monkeypatch,
                                           fault, n_layer):
    """``graftnum.compare_stack`` passes the kernel and rejects a copy of
    it with one planted fault, at GPT-2 124M's width with int8 weights,
    8 rows, 255 cached positions and the odd rows masked over half or all
    of them (chip_smoke's masks). Prints both readings."""
    text, planted = PLANTED_FAULTS[fault]
    src = open(cuda_build.DECODE_LAYER_LIB.source).read()
    assert src.count(text) == 1
    path = tmp_path / "decode_layer.cu"
    path.write_text(src.replace(text, planted))
    faulty = cuda_build.KernelLibrary(
        os.fspath(path), cuda_build.DECODE_LAYER_LIB.functions,
        cuda_build.DECODE_LAYER_LIB.error_fn)
    cfg = gpt2.CONFIGS["gpt2"]
    g = torch.Generator(device=dev).manual_seed(7)
    params = gpt2.init_params(cfg, g)
    params["blocks"] = gpt2.map_params(lambda x: x[:n_layer],
                                       params["blocks"])
    blocks = quant.quantize_params(params)["blocks"]
    B, off = 8, 255
    KV = torch.randn(n_layer, B, cfg.n_head, cfg.n_positions, 128,
                     generator=g, device=dev).to(torch.bfloat16)
    h = torch.randn(B, 1, cfg.n_embd, generator=g,
                    device=dev).to(torch.bfloat16)
    vf = torch.tensor([off * (b % 4 + 1) // 4 if b % 2 else 0
                       for b in range(B)], dtype=torch.int32, device=dev)

    def run(fn):
        out, _ = fn(blocks, h, KV.clone(), off, vf, n_head=cfg.n_head,
                    eps=cfg.layer_norm_epsilon)
        return out

    ref = run(decode_layers_plain)
    sound = graftnum.compare_stack(run(decode_layers), ref, h)
    monkeypatch.setattr(cuda_build.DECODE_LAYERS, "library", faulty)
    with pytest.raises(graftnum.GraftnumError) as caught:
        graftnum.compare_stack(run(decode_layers), ref, h)
    bad = caught.value.report
    print(f"\n{fault}, {n_layer} layers: sound max_abs_err "
          f"{sound['max_abs_err']:.3e} rel_rms_err {sound['rel_rms_err']:.3e};"
          f" faulty max_abs_err {bad['max_abs_err']:.3e} rel_rms_err "
          f"{bad['rel_rms_err']:.3e}; limits {bad['max_abs_limit']:.3e} / "
          f"{bad['rel_rms_limit']:.3e}")


def test_mega_refuses_fp32_on_cuda(dev):
    cfg = gpt2.GPT2Config(vocab_size=211, n_positions=512, n_embd=128,
                          n_layer=2, n_head=2)
    params = gpt2.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    with pytest.raises(ValueError, match="float32"):
        DecodeEngine(params, cfg, max_seq=300, dtype="float32",
                     decode_kernel="mega")
    eng = DecodeEngine(params, cfg, max_seq=300, dtype="bfloat16")
    assert eng.decode_kernel_mode == "mega"


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("off", [0, 100, 300])
def test_decode_attention_kernel_g3_matches_plain(dev, dtype, tol, off):
    """Grouped-query decode attention at llama-124m's group of 3 query
    heads per kv head (6 over 2 here): query head h reads kv head h // 3."""
    g = torch.Generator(device=dev).manual_seed(off + 1)
    B, H, Hkv, hd, S = 3, 6, 2, 64, 512
    KV = torch.randn(2, B, Hkv, S, 2 * hd, generator=g, device=dev).to(dtype)
    q = torch.randn(B, H, 1, hd, generator=g, device=dev).to(dtype)
    kn, vn = (torch.randn(B, Hkv, 1, hd, generator=g, device=dev).to(dtype)
              for _ in range(2))
    vf = torch.tensor([0, 5, off // 2], dtype=torch.int32, device=dev)
    a, b = KV.clone(), KV.clone()
    out_k, _ = decode_attention(q, kn, vn, a, 1, off, vf)
    out_p, _ = decode_attention_plain(q, kn, vn, b, 1, off, vf)
    torch.testing.assert_close(out_k.float(), out_p.float(), atol=tol,
                               rtol=tol)
    assert torch.equal(a, b)


# the llama megakernel's test geometry: the smallest the kernel takes with
# llama-124m's group of 3 query heads per kv head
LLAMA_DIMS = dict(vocab_size=211, n_positions=512, n_embd=384, n_head=6,
                  n_kv_head=2, intermediate_size=256)


def _llama_inputs(dev, cfg, regime, batch, off, seed):
    """Stacked llama blocks (non-trivial RMSNorm scales), h, a fused
    cache, pad starts and the step's per-row angles."""
    g = torch.Generator(device=dev).manual_seed(seed)
    params = llama.init_params(cfg, g, std=0.05)
    for grp in ("ln_attn", "ln_mlp"):
        sc = params["blocks"][grp]["scale"]
        params["blocks"][grp]["scale"] = sc + 0.1 * torch.randn(
            sc.shape, generator=g, device=dev)
    if regime == "int8":
        blocks = quant.quantize_params(params)["blocks"]
    else:
        blocks = gpt2.map_params(lambda x: x.to(torch.bfloat16),
                                 params["blocks"])
    KV = torch.randn(cfg.n_layer, batch, cfg.n_kv_head, cfg.n_positions, 128,
                     generator=g, device=dev).to(torch.bfloat16)
    h = torch.randn(batch, 1, cfg.n_embd, generator=g,
                    device=dev).to(torch.bfloat16)
    vf = torch.tensor([off * (b % 4 + 1) // 4 if b % 2 else 0
                       for b in range(batch)], dtype=torch.int32, device=dev)
    cos, sin = rope_angles(torch.clamp(off - vf.long(), min=0), 64)
    return blocks, h, KV, vf, cos, sin


@pytest.mark.parametrize("off", [0, 37, 300])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("regime", ["bfloat16", "int8"])
@pytest.mark.parametrize("n_layer", [1, 3])
def test_decode_layers_llama_kernel_matches_plain(dev, n_layer, regime,
                                                  batch, off):
    """The llama whole-stack kernel against its plain version: the hidden
    state and the written rows within ``graftnum.STACK_POLICY``, the cache
    equal outside row ``off``, two launches bit-identical."""
    cfg = llama.LlamaConfig(n_layer=n_layer, **LLAMA_DIMS)
    blocks, h, KV, vf, cos, sin = _llama_inputs(dev, cfg, regime, batch, off,
                                                batch * 1000 + off)
    a, b, c = KV.clone(), KV.clone(), KV.clone()
    n0 = cuda_build.launch_counts()["decode_layers_llama"]
    args = dict(n_head=cfg.n_head, eps=cfg.rms_norm_eps)
    out_k, _ = decode_layers_llama(blocks, h, a, off, cos, sin, vf, **args)
    out_k2, _ = decode_layers_llama(blocks, h, b, off, cos, sin, vf, **args)
    out_p, _ = decode_layers_llama_plain(blocks, h, c, off, cos, sin, vf,
                                         **args)
    assert cuda_build.launch_counts()["decode_layers_llama"] == n0 + 2
    assert torch.equal(out_k, out_k2) and torch.equal(a, b)
    graftnum.compare_stack(out_k, out_p, h, a[:, :, :, off], c[:, :, :, off])
    a[:, :, :, off] = c[:, :, :, off]
    assert torch.equal(a, c)


# faults planted in a copy of the llama kernel's source: (text, replacement)
LLAMA_PLANTED_FAULTS = {
    # query head h reads kv head h % Hkv instead of h // g
    "kv_head_mod": (
        "auto q_head = [&](int kh, int j) { return kh * g + j; };",
        "auto q_head = [&](int kh, int j) { return j * Hkv + kh; };"),
    # k is not rotated (the self term and the row written use raw k)
    "k_rope_skipped": (
        "rv[j] = __fadd_rn(__fmul_rn(x[d], cs[d]), __fmul_rn(rot, sn[d]));",
        "rv[j] = r < g ? __fadd_rn(__fmul_rn(x[d], cs[d]), "
        "__fmul_rn(rot, sn[d])) : x[d];"),
}


@pytest.mark.parametrize("n_layer", [1, 12])
@pytest.mark.parametrize("fault", sorted(LLAMA_PLANTED_FAULTS))
def test_llama_stack_check_catches_planted_fault(dev, tmp_path, monkeypatch,
                                                 fault, n_layer):
    """``graftnum.compare_stack`` (the output and the written cache rows)
    passes the llama kernel and rejects a copy of it with one planted
    fault, at llama-124m's width with int8 weights, 8 rows, 255 cached
    positions and the odd rows masked over half or all of them. Prints
    both readings."""
    text, planted = LLAMA_PLANTED_FAULTS[fault]
    lib = cuda_build.DECODE_LAYERS_LLAMA.library
    src = open(lib.source).read()
    assert src.count(text) == 1
    path = tmp_path / "decode_layer.cu"
    path.write_text(src.replace(text, planted))
    faulty = cuda_build.KernelLibrary(os.fspath(path), lib.functions,
                                      lib.error_fn)
    cfg = llama.CONFIGS["llama-124m"]
    cfg = llama.LlamaConfig(**dict(vars(cfg), n_layer=n_layer,
                                   n_positions=1024))
    B, off = 8, 255
    blocks, h, KV, vf, cos, sin = _llama_inputs(dev, cfg, "int8", B, off, 7)
    args = dict(n_head=cfg.n_head, eps=cfg.rms_norm_eps)

    def run(fn):
        kv = KV.clone()
        out, _ = fn(blocks, h, kv, off, cos, sin, vf, **args)
        return out, kv[:, :, :, off]

    ref, ref_row = run(decode_layers_llama_plain)
    out, row = run(decode_layers_llama)
    sound = graftnum.compare_stack(out, ref, h, row, ref_row)
    monkeypatch.setattr(cuda_build.DECODE_LAYERS_LLAMA, "library", faulty)
    with pytest.raises(graftnum.GraftnumError) as caught:
        out, row = run(decode_layers_llama)
        graftnum.compare_stack(out, ref, h, row, ref_row)
    bad = caught.value.report
    print(f"\n{fault}, {n_layer} layers: sound max_abs_err "
          f"{sound['max_abs_err']:.3e} rel_rms_err {sound['rel_rms_err']:.3e} "
          f"row_err {sound['row_err']:.3e}; faulty max_abs_err "
          f"{bad['max_abs_err']:.3e} rel_rms_err {bad['rel_rms_err']:.3e} "
          f"row_err {bad['row_err']:.3e}; limits {bad['max_abs_limit']:.3e} "
          f"/ {bad['rel_rms_limit']:.3e} / {bad['row_limit']:.3e}")
