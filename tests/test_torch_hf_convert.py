"""The port's Hugging Face bridge (``models/hf_convert.py``,
``tools/convert_hf.py``) against the JAX package's and against HF's own
forward, on the CPU.

A ``GPT2LMHeadModel`` and a ``LlamaForCausalLM`` with seeded random
weights, from configs built here (nothing is downloaded), convert in both
packages to the same leaves; the port's forward gives HF's logits; every
refusal keeps the JAX text; a ``save_pretrained`` directory converts
through the port's CLI (with its tokenizer assets) and serves.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from llm_sharding_demo_tpu.models import hf_convert as jhf  # noqa: E402
from llm_sharding_demo_tpu_torch.models import gpt2, hf_convert, llama  # noqa: E402
from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine  # noqa: E402
from llm_sharding_demo_tpu_torch.serving import loader  # noqa: E402
from llm_sharding_demo_tpu_torch.serving.app import create_app  # noqa: E402
from llm_sharding_demo_tpu_torch.serving.http import TestClient  # noqa: E402
from llm_sharding_demo_tpu_torch.serving.tokenizer import (  # noqa: E402
    BPETokenizer)
from llm_sharding_demo_tpu_torch.tools import convert_hf  # noqa: E402
from llm_sharding_demo_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig  # noqa: E402
from test_torch_checkpoint import leaves, write_bpe_assets  # noqa: E402


@pytest.fixture(scope="module")
def hf_gpt2():
    torch.manual_seed(0)
    cfg = transformers.GPT2Config(vocab_size=256, n_positions=64, n_embd=64,
                                  n_layer=2, n_head=4)
    return transformers.GPT2LMHeadModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_llama():
    torch.manual_seed(1)
    cfg = transformers.LlamaConfig(
        vocab_size=211, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-6)
    return transformers.LlamaForCausalLM(cfg).eval()


def assert_leaves_equal(tparams, jparams):
    got = dict(leaves(tparams))
    want = {tuple(k.key for k in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(jparams)}
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=str(k))


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_both_packages_convert_to_the_same_leaves(hf_gpt2, hf_llama, family):
    if family == "gpt2":
        tcfg, tp = hf_convert.params_from_hf_model(hf_gpt2)
        jcfg, jp = jhf.params_from_hf_model(hf_gpt2)
    else:
        tcfg, tp = hf_convert.llama_params_from_hf_model(hf_llama)
        jcfg, jp = jhf.llama_params_from_hf_model(hf_llama)
    import dataclasses
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert_leaves_equal(tp, jp)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_port_forward_equals_hf_logits(hf_gpt2, hf_llama, family):
    model, conv, fam = ((hf_gpt2, hf_convert.params_from_hf_model, gpt2)
                        if family == "gpt2" else
                        (hf_llama, hf_convert.llama_params_from_hf_model,
                         llama))
    cfg, params = conv(model)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 11)))
    with torch.no_grad():
        want = model(ids).logits
    torch.testing.assert_close(fam.forward(params, ids, cfg), want,
                               atol=1e-4, rtol=1e-4)


GPT2_BAD = [dict(tie_word_embeddings=False),
            dict(activation_function="relu"),
            dict(scale_attn_weights=False),
            dict(scale_attn_by_inverse_layer_idx=True),
            dict(reorder_and_upcast_attn=True)]
LLAMA_BAD = [dict(tie_word_embeddings=True), dict(hidden_act="gelu"),
             dict(rope_scaling={"type": "linear", "factor": 2.0}),
             dict(attention_bias=True), dict(head_dim=32)]
GPT2_BASE = dict(vocab_size=256, n_positions=64, n_embd=64, n_layer=2,
                 n_head=4, layer_norm_epsilon=1e-5)
LLAMA_BASE = dict(vocab_size=211, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=64,
                  rms_norm_eps=1e-6)


@pytest.mark.parametrize("family,bad", [("gpt2", b) for b in GPT2_BAD]
                         + [("llama", b) for b in LLAMA_BAD])
def test_refusals_keep_the_jax_text(family, bad):
    base, tfn, jfn = ((GPT2_BASE, hf_convert.config_from_hf,
                       jhf.config_from_hf) if family == "gpt2" else
                      (LLAMA_BASE, hf_convert.llama_config_from_hf,
                       jhf.llama_config_from_hf))
    cfg = types.SimpleNamespace(**dict(base, **bad))
    with pytest.raises(ValueError) as t:
        tfn(cfg)
    with pytest.raises(ValueError) as j:
        jfn(cfg)
    assert str(t.value) == str(j.value)


def test_safetensors_reader_equals_the_library(tmp_path, hf_gpt2):
    from safetensors.torch import load_file
    hf_gpt2.save_pretrained(str(tmp_path))
    path = str(tmp_path / "model.safetensors")
    got, want = hf_convert.read_safetensors(path), load_file(path)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_cli_converts_a_save_pretrained_dir_and_it_serves(
        tmp_path, hf_gpt2, hf_llama, family):
    model = hf_gpt2 if family == "gpt2" else hf_llama
    src, out = str(tmp_path / "hf"), str(tmp_path / "ckpt")
    model.save_pretrained(src)
    if family == "gpt2":
        write_bpe_assets(src)
    assert convert_hf.main([src, out]) == 0
    config, params = ckpt.load(out)
    conv = (hf_convert.params_from_hf_model if family == "gpt2"
            else hf_convert.llama_params_from_hf_model)
    want_cfg, want = conv(model)
    assert config == want_cfg
    for (k, a), (_, b) in zip(leaves(params), leaves(want)):
        assert torch.equal(a, b), k
    # MODEL_ID naming the HF directory converts it (the loader's step 2)
    lcfg, lparams = loader.resolve_model(ServingConfig(model_id=src),
                                         torch.device("cpu"))
    assert lcfg == want_cfg and torch.equal(lparams["wte"], want["wte"])
    client = TestClient(create_app(ServingConfig(
        model_id="m", checkpoint_dir=out, max_seq=48), device="cpu"))
    body = {"prompt": "hi there", "max_new_tokens": 8, "mode": "greedy"}
    r = client.post("/generate", json=body)
    assert r.status_code == 200
    if family == "gpt2":
        tok = BPETokenizer.from_dir(os.path.join(out, "tokenizer"))
        eng = DecodeEngine(want, want_cfg, max_seq=48, device="cpu")
        ref = eng.generate(np.asarray(tok.encode("hi there")), 8)
        assert r.json()["generated"] == tok.decode(
            [int(t) for t in ref.row_tokens(0)])
    assert r.json()["generated"].startswith("hi there")


def test_cli_refuses_a_model_it_cannot_find(tmp_path, capsys):
    assert convert_hf.main([str(tmp_path / "nothing"),
                            str(tmp_path / "out")]) == 1
    assert "nothing is downloaded" in capsys.readouterr().err
