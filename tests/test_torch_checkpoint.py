"""The port's checkpoints (``utils/checkpoint.py``) against the JAX
package's, on the CPU.

``config.json`` is byte-identical to the JAX ``save``'s for each family;
a round trip is bit-equal in fp32 and bf16; a round-tripped model's
logits equal the JAX forward's after its own Orbax round trip on the
same numpy weights; a stage restore equals ``extract_stage_params`` and
opens only its files; a train state resumes bit-exactly; the tokenizer
comes from ``<ckpt>/tokenizer``; servers started with ``CHECKPOINT_DIR``
answer as the JAX app serving its checkpoint of the same weights; a
remote coordinator reads the configuration only.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import llama as jllama
from llm_sharding_demo_tpu.models import moe as jmoe
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.utils import checkpoint as jckpt
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu_torch.models import family_module, gpt2, llama, moe
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.parallel import partition as P
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import (
    TOKENIZER_SUBDIR, BPETokenizer, _bytes_to_unicode, get_tokenizer)
from llm_sharding_demo_tpu_torch.training import train
from llm_sharding_demo_tpu_torch.utils import checkpoint as ckpt
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_llama import np_llama_params
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)
from test_torch_moe import np_moe_params

GPT2_DIMS = dict(vocab_size=256, n_positions=64, n_embd=32, n_layer=4,
                 n_head=2)
LLAMA_DIMS = dict(vocab_size=211, n_positions=64, n_embd=32, n_layer=4,
                  n_head=4, n_kv_head=2, intermediate_size=64)
MOE_DIMS = dict(vocab_size=97, n_positions=64, n_embd=32, n_layer=2,
                n_head=2, n_experts=4, expert_top_k=2)
FAMILIES = {
    "gpt2": (jgpt2.GPT2Config, gpt2.GPT2Config, GPT2_DIMS,
             lambda: np_gpt2_params(seed=2, dims=GPT2_DIMS)),
    "llama": (jllama.LlamaConfig, llama.LlamaConfig, LLAMA_DIMS,
              lambda: np_llama_params(seed=2, dims=LLAMA_DIMS)),
    "moe": (jmoe.MoEConfig, moe.MoEConfig, MOE_DIMS,
            lambda: np_moe_params(seed=2, dims=MOE_DIMS)),
}


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    else:
        yield path, tree


def assert_bit_equal(a, b):
    la, lb = dict(leaves(a)), dict(leaves(b))
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Each family's numpy weights saved by both packages: ``{family:
    (jax dir, port dir, tree)}``."""
    out = {}
    for fam, (jcls, tcls, dims, make) in FAMILIES.items():
        root = tmp_path_factory.mktemp(fam)
        tree = make()
        jckpt.save(str(root / "jax"), jax.tree.map(jnp.asarray, tree),
                   jcls(**dims))
        ckpt.save(str(root / "port"), params_from_numpy(tree, device="cpu"),
                  tcls(**dims))
        out[fam] = (str(root / "jax"), str(root / "port"), tree)
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_config_json_bytes_equal_jax(saved, family):
    jdir, tdir, _ = saved[family]
    with open(os.path.join(jdir, "config.json"), "rb") as f:
        want = f.read()
    with open(os.path.join(tdir, "config.json"), "rb") as f:
        assert f.read() == want
    _, tcls, dims, _ = FAMILIES[family]
    assert ckpt.load_config(tdir) == tcls(**dims)
    assert type(ckpt.load_config(tdir)) is tcls


def test_unknown_family_refuses_with_the_jax_text(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"family": "rwkv"}))
    with pytest.raises(ValueError) as t:
        ckpt.load_config(str(tmp_path))
    with pytest.raises(ValueError) as j:
        jckpt.load_config(str(tmp_path))
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_bit_equal(tmp_path, saved, family, dtype):
    _, tcls, dims, _ = FAMILIES[family]
    params = params_from_numpy(saved[family][2], device="cpu", dtype=dtype)
    ckpt.save(str(tmp_path), params, tcls(**dims))
    config, got = ckpt.load(str(tmp_path))
    assert config == tcls(**dims)
    assert list(got) == list(params)  # the family's own key order
    assert_bit_equal(got, params)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_after_round_trip_equal_jax(saved, family):
    jdir, tdir, _ = saved[family]
    jconfig, jparams = jckpt.load(jdir)
    config, params = ckpt.load(tdir)
    ids = np.random.default_rng(3).integers(0, config.vocab_size, (2, 9))
    jmod = {"gpt2": jgpt2, "llama": jllama, "moe": jmoe}[family]
    jout = family_out(jmod, jparams, ids, jconfig)
    tout = family_out(family_module(config), params, ids, config)
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=1e-5)


def family_out(module, params, ids, config):
    if module in (jgpt2, jllama, jmoe):
        out = module.forward(params, jnp.asarray(ids), config)
    else:
        out = module.forward(params, torch.from_numpy(ids), config)
    out = out[0] if isinstance(out, tuple) else out
    return np.asarray(out)


@pytest.fixture
def record_reads(monkeypatch):
    """The files ``torch.load`` opens, in order."""
    reads = []
    real = torch.load

    def spy(path, *a, **kw):
        reads.append(os.path.abspath(path))
        return real(path, *a, **kw)

    monkeypatch.setattr(torch, "load", spy)
    return reads


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("stage", [0, 1])
def test_stage_restore_reads_only_its_files(saved, record_reads, family,
                                            stage):
    _, tdir, tree = saved[family]
    _, tcls, dims, _ = FAMILIES[family]
    spec = P.make_stage_specs(dims["n_layer"], [1])[stage]
    config, got = ckpt.load_stage_params(tdir, spec)
    assert config == tcls(**dims)
    assert_bit_equal(got, P.extract_stage_params(
        params_from_numpy(tree, device="cpu"), spec))
    p = os.path.join(tdir, "params")
    want = [os.path.join(p, "blocks", f"{i}.pt")
            for i in range(spec.start, spec.end)]
    head = "lm_head" if family == "llama" else "wte"
    want += ([os.path.join(p, f) for f in (
        ["wte.pt"] + ([] if family == "llama" else ["wpe.pt"]))]
        if stage == 0 else
        [os.path.join(p, "ln_f.pt"), os.path.join(p, f"{head}.pt")])
    assert record_reads == want


def test_train_state_resume_bit_equal(tmp_path):
    """2 steps, save, a fresh step restores onto its templates, 2 more:
    bit-equal to 4 uninterrupted steps, with the schedule's count."""
    cfg = gpt2.GPT2Config(**GPT2_DIMS)
    tree = np_gpt2_params(seed=4, dims=GPT2_DIMS)
    ids = np.random.default_rng(4).integers(0, 256, (2, 9))
    opt = train.adamw(1e-3, warmup_steps=2, total_steps=6)

    def run(params, state, n):
        step = train.TrainStep(cfg, opt, device="cpu")
        for _ in range(n):
            params, state, _ = step(params, state, ids)
        return params, state

    step = train.TrainStep(cfg, opt, device="cpu")
    straight = run(*step.init(params_from_numpy(tree, device="cpu")), 4)
    p, s = run(*step.init(params_from_numpy(tree, device="cpu")), 2)
    ckpt.save_train_state(str(tmp_path), p, s, step=2)
    tp, ts = step.init(params_from_numpy(np_gpt2_params(seed=9,
                                                        dims=GPT2_DIMS),
                                         device="cpu"))
    p, s, n = ckpt.load_train_state(str(tmp_path), tp, ts)
    assert n == 2 and s["count"] == 2
    resumed = run(p, s, 2)
    assert_bit_equal(resumed[0], straight[0])
    assert_bit_equal(resumed[1]["mu"], straight[1]["mu"])
    assert_bit_equal(resumed[1]["nu"], straight[1]["nu"])
    assert resumed[1]["count"] == straight[1]["count"] == 4
    bad = dict(tp, wte=tp["wte"][:5])
    with pytest.raises(ValueError, match="params.wte"):
        ckpt.load_train_state(str(tmp_path), bad, ts)


def write_bpe_assets(directory):
    """A 256-entry byte-level BPE: 255 byte symbols (byte 0 left out) and
    one merge, ``h i`` -> id 255."""
    chars = [c for b, c in _bytes_to_unicode().items() if b != 0]
    vocab = {c: i for i, c in enumerate(chars)}
    vocab["hi"] = 255
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(directory, "merges.txt"), "w") as f:
        f.write("#version: 0.2\nh i\n")


def test_tokenizer_from_checkpoint(tmp_path):
    write_bpe_assets(str(tmp_path / TOKENIZER_SUBDIR))
    tok = get_tokenizer("m", checkpoint_dir=str(tmp_path))
    assert isinstance(tok, BPETokenizer)
    ids = tok.encode("hi there")
    assert ids[0] == 255 and tok.decode(ids) == "hi there"
    assert type(get_tokenizer("m", checkpoint_dir=str(tmp_path / "x"))
                ).__name__ == "ByteTokenizer"


@pytest.fixture(scope="module")
def served(saved):
    """The GPT-2 checkpoints of both packages with the same BPE assets."""
    jdir, tdir, _ = saved["gpt2"]
    for d in (jdir, tdir):
        write_bpe_assets(os.path.join(d, TOKENIZER_SUBDIR))
    return jdir, tdir


def apps(served, **kw):
    jdir, tdir = served
    j = jcreate_app(JServingConfig(model_id="m", checkpoint_dir=jdir,
                                   max_seq=48, **kw))
    t = create_app(ServingConfig(model_id="m", checkpoint_dir=tdir,
                                 max_seq=48, **kw), device="cpu")
    return JTestClient(j), TestClient(t)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_checkpoint_coordinator_generate_equals_jax(served, dtype):
    jc, tc = apps(served, inference_dtype=dtype)
    body = {"prompt": "hi there", "max_new_tokens": 12, "mode": "greedy"}
    r = tc.post("/generate", json=body)
    assert r.status_code == 200
    assert r.json() == jc.post("/generate", json=body).json()
    assert r.json()["generated"].startswith("hi there")


def test_checkpoint_shard_forward_equals_jax(served, record_reads):
    jc, tc = apps(served, shard_role="a", boundaries=(2,))
    p = os.path.join(served[1], "params")
    assert record_reads == [os.path.join(p, f) for f in (
        "blocks/0.pt", "blocks/1.pt", "wte.pt", "wpe.pt")]
    body = {"input_ids": [5, 9, 2, 77]}
    got = np.asarray(tc.post("/forward", json=body).json()["hidden_states"])
    want = np.asarray(jc.post("/forward", json=body).json()["hidden_states"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_remote_coordinator_reads_the_config_only(served, record_reads):
    _, tdir = served
    app = create_app(ServingConfig(model_id="m", checkpoint_dir=tdir,
                                   dispatch="remote", max_seq=48),
                     device="cpu")
    assert record_reads == []
    assert TestClient(app).get("/healthz").json()["forward_shapes"] == {}


def test_a_set_checkpoint_that_fails_to_load_is_an_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        create_app(ServingConfig(model_id="gpt2",
                                 checkpoint_dir=str(tmp_path / "none")),
                   device="cpu")


@pytest.mark.parametrize("foreign", [
    ["config.json", "model.safetensors"],        # an HF model directory
    ["params/blocks/0.pt", "notes.txt"],         # params/ with no config
])
def test_save_refuses_a_directory_that_is_not_a_checkpoint(tmp_path,
                                                           foreign):
    for name in foreign:
        (tmp_path / name).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / name).write_text(name)
    params = params_from_numpy(np_gpt2_params(seed=2, dims=GPT2_DIMS),
                               device="cpu")
    with pytest.raises(ValueError, match="not a checkpoint"):
        ckpt.save(str(tmp_path), params, gpt2.GPT2Config(**GPT2_DIMS))
    for name in foreign:  # nothing removed, nothing rewritten
        assert (tmp_path / name).read_text() == name


def test_save_over_a_checkpoint_replaces_it(tmp_path):
    big = dict(GPT2_DIMS, n_layer=4)
    small = dict(GPT2_DIMS, n_layer=2)
    ckpt.save(str(tmp_path), params_from_numpy(
        np_gpt2_params(seed=2, dims=big), device="cpu"),
        gpt2.GPT2Config(**big))
    (tmp_path / "tokenizer").mkdir()
    params = params_from_numpy(np_gpt2_params(seed=3, dims=small),
                               device="cpu")
    ckpt.save(str(tmp_path), params, gpt2.GPT2Config(**small))
    config, got = ckpt.load(str(tmp_path))
    assert config == gpt2.GPT2Config(**small)
    assert_bit_equal(got, params)
    # the larger checkpoint's layer files went with it
    assert sorted(os.listdir(tmp_path / "params" / "blocks")) == [
        "0.pt", "1.pt"]
