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
    cluster_plan, decode_attention, decode_attention_plain)
from llm_sharding_demo_tpu_torch.ops.decode_layer import (
    decode_layers, decode_layers_llama, decode_layers_llama_plain,
    decode_layers_plain)
from llm_sharding_demo_tpu_torch.ops.attention import causal_attention
from llm_sharding_demo_tpu_torch.ops.flash_attention import (
    _bwd_dkv_plain, _bwd_dq_plain, _forward_plain, flash_attention,
    flash_bwd_dkv, flash_bwd_dq, flash_delta, flash_forward)
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


def _span_masks(B, off, span, dev):
    """``valid_from`` rows that start past 0-3 whole spans of the cluster
    split (row 0 past two), or at ``off`` (everything cached masked)."""
    return {"spans": torch.tensor(
                [min(off, ((b + 2) % 4) * span + b % 3) for b in range(B)],
                dtype=torch.int32, device=dev),
            "all": torch.full((B,), off, dtype=torch.int32, device=dev)}


@pytest.mark.parametrize("mask", ["spans", "all"])
@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("hkv", [12, 4])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-5)])
def test_decode_attention_cluster_split_matches_plain(dev, dtype, tol, hkv, B,
                                                      mask):
    """The cluster split at its edges: offsets around one and two spans of
    ``MIN_SPAN`` positions, at 255/256, at llama's 3000 (16 spans of 188)
    and at the last slot, with g = 1 (12 kv heads, GPT-2) and g = 3 (4 kv
    heads, llama-124m); ``valid_from`` past whole spans, or at ``off``
    (the output is then v_new to rounding). Each case: within ``tol`` of
    the plain version, the cache byte-equal, two launches bit-identical,
    one launch counted per call."""
    g = torch.Generator(device=dev).manual_seed(B * 100 + hkv)
    H, hd, S = 12, 64, 4096
    KV = torch.randn(2, B, hkv, S, 2 * hd, generator=g, device=dev).to(dtype)
    for off in (0, 1, 63, 64, 65, 127, 128, 129, 255, 256, 3000, 4095):
        q = torch.randn(B, H, 1, hd, generator=g, device=dev).to(dtype)
        kn, vn = (torch.randn(B, hkv, 1, hd, generator=g,
                              device=dev).to(dtype) for _ in range(2))
        vf = _span_masks(B, off, cluster_plan(off, B, hkv)[1], dev)[mask]
        a, b = KV.clone(), KV.clone()
        n0 = cuda_build.launch_counts()["decode_attention"]
        out_k, _ = decode_attention(q, kn, vn, a, 1, off, vf)
        again, _ = decode_attention(q, kn, vn, a, 1, off, vf)
        assert cuda_build.launch_counts()["decode_attention"] == n0 + 2
        out_p, _ = decode_attention_plain(q, kn, vn, b, 1, off, vf)
        torch.testing.assert_close(out_k.float(), out_p.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"off={off}: {m}")
        assert torch.equal(out_k, again), off
        assert torch.equal(a, b), off
        if mask == "all":
            want = vn.repeat_interleave(H // hkv, dim=1)
            torch.testing.assert_close(out_k.float(), want.float(), atol=tol,
                                       rtol=tol)


# faults planted in a copy of the decode-attention source: (text,
# replacement)
DECODE_ATTENTION_PLANTED_FAULTS = {
    # the merge leaves out the last rank's span
    "last_rank_dropped": ("if (r < nranks) {\n          lf += lw;",
                          "if (r + 1 < nranks) {\n          lf += lw;"),
    # each rank's state merged without its shift to the common max
    "rank_max_ignored": ("const float cr = expf(mr - mf);",
                         "const float cr = lane < nranks ? 1.f : 0.f;"),
}


@pytest.mark.parametrize("fault", sorted(DECODE_ATTENTION_PLANTED_FAULTS))
def test_decode_attention_check_catches_planted_fault(dev, tmp_path,
                                                      monkeypatch, fault):
    """The kernel-vs-plain check passes the sound split merge and rejects
    a copy of the source with one planted fault, at llama-124m's g = 3
    with 3000 cached (16 spans): row 0 sees only the last span, row 1
    all of them. Prints both readings."""
    text, planted = DECODE_ATTENTION_PLANTED_FAULTS[fault]
    lib = cuda_build.DECODE_ATTENTION_LIB
    src = open(lib.source).read()
    assert src.count(text) == 1
    path = tmp_path / "decode_attention.cu"
    path.write_text(src.replace(text, planted))
    faulty = cuda_build.KernelLibrary(os.fspath(path), lib.functions,
                                      lib.error_fn)
    g = torch.Generator(device=dev).manual_seed(3000)
    B, H, hkv, hd, off, dtype = 2, 12, 4, 64, 3000, torch.bfloat16
    assert cluster_plan(off, B, hkv)[0] > 1
    KV = torch.randn(1, B, hkv, 4096, 2 * hd, generator=g,
                     device=dev).to(dtype)
    q = torch.randn(B, H, 1, hd, generator=g, device=dev).to(dtype)
    kn, vn = (torch.randn(B, hkv, 1, hd, generator=g, device=dev).to(dtype)
              for _ in range(2))
    vf = torch.tensor([2900, 0], dtype=torch.int32, device=dev)
    want, _ = decode_attention_plain(q, kn, vn, KV.clone(), 0, off, vf)

    def err():
        out, _ = decode_attention(q, kn, vn, KV.clone(), 0, off, vf)
        return (out.float() - want.float()).abs().max().item()

    sound = err()
    assert sound <= 1e-2
    monkeypatch.setattr(cuda_build.DECODE_ATTENTION, "library", faulty)
    bad = err()
    print(f"\n{fault}: sound max_abs_err {sound:.3e}; planted {bad:.3e}; "
          f"limit 1e-2")
    assert bad > 1e-2


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


# (d, n) of every projection the served models give the int8 linear:
# llama's untied head, GPT-2's c_fc and c_attn, llama's gate/up, the
# 768-wide q/o/attention c_proj, GPT-2's mlp c_proj, llama's down and k/v
QUANT_LINEAR_SHAPES = [(768, 32000), (768, 3072), (768, 2304), (768, 2048),
                       (768, 768), (3072, 768), (2048, 768), (768, 256)]


def _quant_linear_inputs(dev, d, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    qt = quant.quantize_array(torch.randn(d, n, generator=g, device=dev)
                              * 0.02)
    xs = [torch.randn(rows, d, generator=g, device=dev).to(torch.bfloat16)
          for rows in range(1, quant.MAX_KERNEL_ROWS + 1)]
    return qt, xs


def _linear_err(y_k, y_p):
    """Max error and its limit: two bf16 ulps of the largest output (the
    f32 sums differ from the plain version's in order only, then round
    once)."""
    return ((y_k.float() - y_p.float()).abs().max().item(),
            2.0 ** -7 * y_p.float().abs().max().item())


@pytest.mark.parametrize("d,n", QUANT_LINEAR_SHAPES)
def test_quant_linear_kernel_matches_plain_every_row_count(dev, d, n):
    """The int8 linear at each served shape (its ``linear_plan``: split
    or not) and rows 1..16 (one and two n8 tiles of activation rows)
    within two bf16 ulps of the largest output, one launch counted per
    call."""
    qt, xs = _quant_linear_inputs(dev, d, n, d + n)
    for x in xs:
        n0 = cuda_build.launch_counts()["quant_linear"]
        y_k = quant.quant_linear(x, qt.q, qt.scale)
        assert cuda_build.launch_counts()["quant_linear"] == n0 + 1
        err, lim = _linear_err(y_k, quant.linear_plain(x, qt.q, qt.scale))
        assert err <= lim, (x.shape[0], err, lim)


@pytest.mark.parametrize("d,n", QUANT_LINEAR_SHAPES)
def test_quant_linear_two_launches_bit_identical(dev, d, n):
    """No atomics: the cluster ranks' partial sums are added in rank
    order, so two launches on the same inputs give the same bits."""
    qt, xs = _quant_linear_inputs(dev, d, n, 7 * d + n)
    for x in xs:
        a = quant.quant_linear(x, qt.q, qt.scale)
        b = quant.quant_linear(x, qt.q, qt.scale)
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)), \
            x.shape[0]


# faults planted in a copy of the int8 source: (text, replacement)
QUANT_PLANTED_FAULTS = {
    # the cluster merge leaves out the last rank's partial sums
    "last_rank_dropped": ("if (b < split) s += v[b];",
                          "if (b + 1 < split) s += v[b];"),
    # every step reads the ring's first stage
    "stage_reused": ("const uint8_t* stage = ring + st * kBox;",
                     "const uint8_t* stage = ring;"),
}


@pytest.mark.parametrize("fault", sorted(QUANT_PLANTED_FAULTS))
def test_quant_linear_check_catches_planted_fault(dev, tmp_path, monkeypatch,
                                                  fault):
    """The kernel-vs-plain check passes the int8 linear and rejects a copy
    of its source with one planted fault, at GPT-2's c_fc (768->3072:
    a 4-way split, 12 steps a CTA in 12 ring stages) and 16 rows. Prints
    both readings."""
    text, planted = QUANT_PLANTED_FAULTS[fault]
    lib = cuda_build.QUANT_LIB
    src = open(lib.source).read()
    assert src.count(text) == 1
    path = tmp_path / "quant.cu"
    path.write_text(src.replace(text, planted))
    faulty = cuda_build.KernelLibrary(os.fspath(path), lib.functions,
                                      lib.error_fn)
    d, n = 768, 3072
    assert quant.linear_plan(16, d, n) == (128, 4)
    qt, xs = _quant_linear_inputs(dev, d, n, 11)
    x = xs[-1]
    want = quant.linear_plain(x, qt.q, qt.scale)
    sound, lim = _linear_err(quant.quant_linear(x, qt.q, qt.scale), want)
    assert sound <= lim
    monkeypatch.setattr(cuda_build.QUANT_LINEAR, "library", faulty)
    bad, _ = _linear_err(quant.quant_linear(x, qt.q, qt.scale), want)
    print(f"\n{fault}: sound max_abs_err {sound:.3e}; planted {bad:.3e}; "
          f"limit {lim:.3e}")
    assert bad > lim


def _quant_head_inputs(dev, seed):
    """GPT-2's int8 tied head: the 50257 x 768 table padded to 51200 rows
    (``head_plan``: 264 CTAs, spans of 12 and 13 m16 tiles), and
    activations of rows 1..16."""
    g = torch.Generator(device=dev).manual_seed(seed)
    table = quant.quantize_params(
        {"wte": torch.randn(50257, 768, generator=g, device=dev) * 0.02})
    xs = [torch.randn(rows, 768, generator=g, device=dev).to(torch.bfloat16)
          for rows in range(1, quant.MAX_KERNEL_ROWS + 1)]
    return table["wte"].q, xs


def test_quant_head_kernel_matches_plain_every_row_count(dev):
    """The head at GPT-2's table and rows 1..16 (one and two n8 tiles of
    activation rows) within atol 1e-3, rtol 1e-5 of the plain f32
    product, one launch counted per call."""
    q, xs = _quant_head_inputs(dev, 50257)
    assert quant.head_plan(1, q.shape[0], 768) == (264, 13)
    for x in xs:
        n0 = cuda_build.launch_counts()["quant_head"]
        got = quant.quant_head(x, q)
        assert cuda_build.launch_counts()["quant_head"] == n0 + 1
        torch.testing.assert_close(got, quant.head_plain(x, q), atol=1e-3,
                                   rtol=1e-5, msg=lambda m: f"rows="
                                   f"{x.shape[0]}: {m}")


def test_quant_head_two_launches_bit_identical(dev):
    """No atomics: each logit is one warp's sum in a fixed order, so two
    launches on the same inputs give the same bits."""
    q, xs = _quant_head_inputs(dev, 51200)
    for x in xs:
        a = quant.quant_head(x, q)
        b = quant.quant_head(x, q)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
            x.shape[0]


# faults planted in a copy of the int8 source's head kernel: (text,
# replacement)
QUANT_HEAD_PLANTED_FAULTS = {
    # each CTA leaves out the last m16 tile of its span
    "last_tile_dropped": ("const int span = hi - lo;",
                          "const int span = hi - lo - 1;"),
    # every box read from the ring's first stage
    "box_stage_reused": ("const uint8_t* box = ring + st * kHeadBox;",
                         "const uint8_t* box = ring;"),
}


@pytest.mark.parametrize("fault", sorted(QUANT_HEAD_PLANTED_FAULTS))
def test_quant_head_check_catches_planted_fault(dev, tmp_path, monkeypatch,
                                                fault):
    """The kernel-vs-plain check (atol 1e-3, rtol 1e-5) passes the head
    and rejects a copy of its source with one planted fault, at GPT-2's
    table and 16 rows. The sound output stays alive while the planted
    kernel runs, so no unwritten logit can read it back. Prints the
    largest error beyond the tolerance of each."""
    text, planted = QUANT_HEAD_PLANTED_FAULTS[fault]
    lib = cuda_build.QUANT_LIB
    src = open(lib.source).read()
    assert src.count(text) == 1
    path = tmp_path / "quant.cu"
    path.write_text(src.replace(text, planted))
    faulty = cuda_build.KernelLibrary(os.fspath(path), lib.functions,
                                      lib.error_fn)
    q, xs = _quant_head_inputs(dev, 13)
    x = xs[-1]
    want = quant.head_plain(x, q)

    def excess(got):
        """The largest |got - want| beyond atol + rtol |want| (NaN counts
        as infinite)."""
        over = (got - want).abs() - (1e-3 + 1e-5 * want.abs())
        return over.nan_to_num(nan=float("inf")).max().item()

    sound_out = quant.quant_head(x, q)
    sound = excess(sound_out)
    assert sound <= 0
    monkeypatch.setattr(cuda_build.QUANT_HEAD, "library", faulty)
    bad = excess(quant.quant_head(x, q))
    print(f"\n{fault}: largest error beyond the tolerance: sound {sound:.3e};"
          f" planted {bad:.3e}")
    assert bad > 0
    del sound_out


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


# -- flash attention ------------------------------------------------------------

def _flash_inputs(dev, B, S, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, 12, S, 64, generator=g, device=dev).to(dtype)
            for _ in range(4)]


def _flash_run(q, k, v, do):
    """Every flash kernel once on one input set: out, lse, dq, dk, dv."""
    out, lse = flash_forward(q, k, v)
    delta = flash_delta(out, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def _flash_plain(q, k, v, do, got):
    """The plain versions on the same inputs; the backward reads the
    kernel's own out and lse, so each kernel is checked alone."""
    out, lse = _forward_plain(q, k, v)
    delta = flash_delta(got["out"], do)
    dq = _bwd_dq_plain(q, k, v, do, got["lse"], delta)
    dk, dv = _bwd_dkv_plain(q, k, v, do, got["lse"], delta)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def _flash_compare(got, want, dtype):
    return [graftnum.compare_flash(n, got[n], want[n], dtype) for n in got]


@pytest.mark.parametrize("S", [2048, 4096])
@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_match_plain(dev, dtype, B, S):
    """The three flash kernels against their plain versions at
    llama-124m's attention shapes (12 heads of 64) within
    ``graftnum.FLASH_POLICY``; two launches bit-identical; one launch
    counted per kernel call."""
    q, k, v, do = _flash_inputs(dev, B, S, dtype, S + B)
    n0 = cuda_build.launch_counts()
    got = _flash_run(q, k, v, do)
    again = _flash_run(q, k, v, do)
    n1 = cuda_build.launch_counts()
    assert all(n1[name] - n0[name] == 2
               for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    for name in got:
        assert torch.equal(got[name], again[name]), name
    reports = _flash_compare(got, _flash_plain(q, k, v, do, got), dtype)
    print("\n" + "; ".join(f"{r['name']} max {r['max_rel_err']:.2e} rms "
                           f"{r['rms_rel_err']:.2e}" for r in reports))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_kernels_ragged_length(dev, dtype):
    """A length that is no multiple of the kernels' 64-row tiles: the
    last tile's rows past S are masked and never written."""
    q, k, v, do = _flash_inputs(dev, 2, 333, dtype, 5)
    got = _flash_run(q, k, v, do)
    _flash_compare(got, _flash_plain(q, k, v, do, got), dtype)


def test_flash_attention_function_grads_match_plain(dev):
    """The autograd Function on the card (forward kernel, D, the two
    backward kernels) against autograd through the plain causal
    attention, in f32."""
    q, k, v, do = _flash_inputs(dev, 1, 512, torch.float32, 9)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    ref = [x.clone().requires_grad_() for x in (q, k, v)]
    ref_out = causal_attention(*ref)
    ref_grads = torch.autograd.grad(ref_out, ref, do)
    graftnum.compare_flash("out", out, ref_out, torch.float32)
    for name, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        graftnum.compare_flash(name, a, b, torch.float32)


# faults planted in a copy of the flash source: (text, replacement); every
# occurrence is replaced
FLASH_PLANTED_FAULTS = {
    # the causal mask taken as k < q: the diagonal dropped
    "diagonal_dropped": [("col <= row[r]", "col < row[r]"),
                         ("key[r] <= i", "key[r] < i")],
    # D left out of dS = P * (dP - D)
    "delta_dropped": [("s[nt][c] = pr * (dp[nt][c] - dd[r]);",
                       "s[nt][c] = pr * dp[nt][c];"),
                      ("s[4 * j + c] = s[4 * j + c] * (dp[4 * j + c] - "
                       "dd_s[ci]);",
                       "s[4 * j + c] = s[4 * j + c] * dp[4 * j + c];")],
    # the forward's output accumulator not rescaled when the row max grows
    "rescale_dropped": [("o[4 * j + c] *= alpha[c >> 1];",
                         "o[4 * j + c] *= 1.f;")],
    # bf16 dK/dV's second consumer warpgroup scores the first one's 64
    # keys in place of its own
    "warpgroup_keys_shared": [("sw128_desc(sm.k[b] + 64 * cw * kHd, 16, "
                               "1024)", "sw128_desc(sm.k[b], 16, 1024)")],
}
# the faults that the bf16 forward (fwd_bf16) holds; delta_dropped is the
# backward's alone (the forward has no D)
FLASH_FORWARD_FAULTS = ("diagonal_dropped", "rescale_dropped")
# the faults that bf16 dK/dV (dkv_bf16) holds
FLASH_DKV_FAULTS = ("diagonal_dropped", "delta_dropped",
                    "warpgroup_keys_shared")


def _kernel_body(src, name):
    """The text of ``__global__`` function ``name`` up to the next one."""
    parts = src.split("__global__")[1:]
    (body,) = [p for p in parts if f"{name}(" in p.split("{", 1)[0]]
    return body


def _planted_cases():
    return ([("decode_layer.cu", f, [t]) for f, t in PLANTED_FAULTS.items()]
            + [("decode_layer.cu", f, [t])
               for f, t in LLAMA_PLANTED_FAULTS.items()]
            + [("decode_attention.cu", f, [t])
               for f, t in DECODE_ATTENTION_PLANTED_FAULTS.items()]
            + [("quant.cu", f, [t]) for f, t in QUANT_PLANTED_FAULTS.items()]
            + [("quant.cu", f, [t])
               for f, t in QUANT_HEAD_PLANTED_FAULTS.items()]
            + [("flash_attention.cu", f, t)
               for f, t in FLASH_PLANTED_FAULTS.items()])


@pytest.mark.parametrize("source,fault,edits", _planted_cases(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_planted_fault_text_occurs_in_source(source, fault, edits):
    """Runs without a card: every planted fault's text still occurs in the
    current kernel source (once where the card test replaces it once), so
    a rewrite of a kernel cannot leave its planted-fault test vacuous;
    the forward's faults reach the bf16 forward's own body, and dK/dV's
    the body of bf16 dK/dV."""
    src = open(os.path.join(cuda_build.CSRC_DIR, source)).read()
    for text, _ in edits:
        assert src.count(text) >= 1, (fault, text)
        if source != "flash_attention.cu":
            assert src.count(text) == 1, (fault, text)
    for faults, kernel in ((FLASH_FORWARD_FAULTS, "fwd_bf16"),
                           (FLASH_DKV_FAULTS, "dkv_bf16")):
        if source == "flash_attention.cu" and fault in faults:
            body = _kernel_body(src, kernel)
            assert any(text in body for text, _ in edits), (fault, kernel)


@pytest.mark.parametrize("fault", sorted(FLASH_PLANTED_FAULTS))
def test_flash_check_catches_planted_fault(dev, tmp_path, monkeypatch, fault):
    """``graftnum.compare_flash`` passes the bf16 kernels and rejects a
    copy of the source with one planted fault, at B=1, S=2048. Prints
    both readings."""
    lib = cuda_build.FLASH_ATTENTION_LIB
    src = open(lib.source).read()
    for text, planted in FLASH_PLANTED_FAULTS[fault]:
        assert src.count(text) >= 1, text
        src = src.replace(text, planted)
    path = tmp_path / "flash_attention.cu"
    path.write_text(src)
    faulty = cuda_build.KernelLibrary(os.fspath(path), lib.functions,
                                      lib.error_fn)
    dtype = torch.bfloat16
    q, k, v, do = _flash_inputs(dev, 1, 2048, dtype, 11)
    got = _flash_run(q, k, v, do)
    want = _flash_plain(q, k, v, do, got)
    sound = _flash_compare(got, want, dtype)
    for kern in (cuda_build.FLASH_FWD, cuda_build.FLASH_BWD_DQ,
                 cuda_build.FLASH_BWD_DKV):
        monkeypatch.setattr(kern, "library", faulty)
    bad = _flash_run(q, k, v, do)
    readings = []
    for name in bad:
        try:
            graftnum.compare_flash(name, bad[name], want[name], dtype)
        except graftnum.GraftnumError as e:
            readings.append(e.report)
    assert readings, f"{fault}: no output outside FLASH_POLICY"
    print(f"\n{fault}: sound " + "; ".join(
        f"{r['name']} max {r['max_rel_err']:.2e} rms {r['rms_rel_err']:.2e}"
        for r in sound) + "; planted " + "; ".join(
        f"{r['name']} max {r['max_rel_err']:.2e} rms {r['rms_rel_err']:.2e}"
        for r in readings) + f"; limits {graftnum.FLASH_POLICY['bfloat16']}")
