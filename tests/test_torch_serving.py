"""The PyTorch port's HTTP app against the JAX package's, on the same weights.

Both apps are driven in-process through their ``TestClient``s with the
byte tokenizer; greedy ``/generate`` JSON, the role guards and the
``/forward`` + ``/forward_b`` composition must agree. Also: knobs the
port does not serve yet refuse at startup.
"""

import numpy as np
import pytest

from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu.utils.config import from_env as jfrom_env
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.serving import app as tapp
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import (BPETokenizer,
                                                           ByteTokenizer)
from llm_sharding_demo_tpu_torch.utils import config as tconfig
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig

import jax
import jax.numpy as jnp
from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)

DIMS = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=4,
            n_head=2)


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params(seed=3, dims=DIMS)
    return ((jgpt2.GPT2Config(**DIMS), jax.tree.map(jnp.asarray, tree)),
            (gpt2.GPT2Config(**DIMS), params_from_numpy(tree, device="cpu")))


def clients(weights, role, **kw):
    (jcfg, jp), (tcfg, tp) = weights
    j = jcreate_app(JServingConfig(model_id="test", shard_role=role,
                                   max_seq=96, boundaries=(2,), **kw),
                    model=(jcfg, jp), tokenizer=JByteTokenizer())
    t = create_app(ServingConfig(model_id="test", shard_role=role,
                                 max_seq=96, boundaries=(2,), **kw),
                   model=(tcfg, tp), tokenizer=ByteTokenizer(), device="cpu")
    return JTestClient(j), TestClient(t)


@pytest.mark.parametrize("prompt,n", [("Hello, shard", 24), ("x", 8)])
def test_generate_greedy_json_equals_jax(weights, prompt, n):
    jc, tc = clients(weights, "coordinator")
    body = {"prompt": prompt, "max_new_tokens": n, "mode": "greedy"}
    r = tc.post("/generate", json=body)
    assert r.status_code == 200
    assert r.json() == jc.post("/generate", json=body).json()
    assert r.json()["generated"].startswith(prompt)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16"])
def test_generate_int8_runs_the_staged_engine(weights, dtype):
    """int8 and bf16 serve through the staged DecodeEngine (the runner
    whose decode steps take the whole-stack kernel on CUDA)."""
    _, tc = clients(weights, "coordinator", inference_dtype=dtype)
    body = {"prompt": "Hi", "max_new_tokens": 6, "mode": "sample",
            "seed": 5}
    a, b = (tc.post("/generate", json=body).json() for _ in range(2))
    assert a == b and a["generated"].startswith("Hi")
    h = tc.get("/healthz").json()
    assert h["inference_dtype"] == dtype and h["device"] == "cpu"
    # "auto" keeps the plain path on the CPU (kernels are for CUDA)
    assert h["decode_kernel"] == "xla"
    assert set(h["kernel_launches"]) == {"decode_attention", "quant_linear",
                                         "quant_head", "decode_layers",
                                         "decode_layers_llama", "flash_fwd",
                                         "flash_bwd_dq", "flash_bwd_dkv"}


@pytest.mark.parametrize("role", ["coordinator", "a", "b"])
def test_role_guards_match_jax(weights, role):
    jc, tc = clients(weights, role)
    calls = [("/forward", {"input_ids": [1, 2, 3]}),
             ("/forward_b", {"hidden_states": [[[0.0] * 128]]}),
             ("/generate", {"prompt": "Hi", "max_new_tokens": 2,
                            "mode": "greedy"})]
    for path, body in calls:
        j, t = jc.post(path, json=body), tc.post(path, json=body)
        assert t.status_code == j.status_code == 200
        jb, tb = j.json(), t.json()
        if "error" in jb or "generated" in jb:
            assert tb == jb
        else:
            assert set(tb) == set(jb)
            key = next(iter(jb))
            np.testing.assert_allclose(np.asarray(tb[key]),
                                       np.asarray(jb[key]), atol=1e-5,
                                       rtol=1e-5)


def test_forward_then_forward_b_composes_to_the_full_model(weights):
    (_, _), (tcfg, tp) = weights
    _, a = clients(weights, "a")
    _, b = clients(weights, "b")
    ids = [3, 14, 15, 92]
    hidden = a.post("/forward", json={"input_ids": ids}).json()
    logits = b.post("/forward_b", json=hidden).json()["logits"]
    import torch
    want = gpt2.forward(tp, torch.tensor([ids]), tcfg).numpy()
    np.testing.assert_allclose(np.asarray(logits), want, atol=1e-5,
                               rtol=1e-5)


def test_request_validation(weights):
    _, tc = clients(weights, "coordinator")
    assert tc.post("/generate", json={"max_new_tokens": 3}).status_code == 422
    assert tc.post("/generate", json={"prompt": 7}).status_code == 422
    assert tc.post("/generate", json=[1, 2]).status_code == 422
    assert tc.post("/generate", json={"prompt": "a", "mode": "nope"}
                   ).json() == {"error": "unknown mode 'nope'"}
    assert "exceeds max_seq" in tc.post(
        "/generate", json={"prompt": "a", "max_new_tokens": 200}
    ).json()["error"]
    _, a = clients(weights, "a")
    assert a.post("/forward", json={"input_ids": [1, 999]}).status_code == 422
    _, b = clients(weights, "b")
    assert b.post("/forward_b", json={"hidden_states": [[1.0]]}
                  ).status_code == 422
    assert tc.get("/nope").status_code == 404
    h = tc.get("/healthz").json()
    assert (h["status"], h["role"], h["n_stages"], h["decode_kernel"]) == (
        "ok", "coordinator", 2, "xla")


@pytest.mark.parametrize("knob,value", [
    ("AUTO_PLAN_CONTINUOUS", "1"), ("PP_DECODE", "1"),
    ("TP_DECODE", "true"), ("EP_DECODE", "1"), ("AUTO_PLAN", "1"),
    ("FLEET_ROLE", "decode"), ("CHECKPOINT_DIR", "/ckpt"),
    ("AUTO_PLAN_JOURNAL", "/j"),
])
def test_unported_knobs_refuse_at_startup(monkeypatch, knob, value):
    """Each knob the port does not serve refuses, naming its ROADMAP item;
    CHECKPOINT_DIR is served now (checkpoints are ported): it parses into
    the config instead. So is FLEET_ROLE (the fleet is ported): it parses,
    and without the pool-backed prefix store it raises the JAX config's
    validation message, naming no ROADMAP item."""
    monkeypatch.setenv(knob, value)
    if knob == "CHECKPOINT_DIR":
        assert knob not in tconfig.REFUSED_KNOBS
        assert tconfig.from_env().checkpoint_dir == value
        return
    if knob == "FLEET_ROLE":
        assert knob not in tconfig.REFUSED_KNOBS
        monkeypatch.delenv("KV_POOL_BLOCKS", raising=False)
        monkeypatch.delenv("PREFIX_CACHE", raising=False)
        with pytest.raises(ValueError) as e:
            tconfig.from_env()
        with pytest.raises(ValueError) as jerr:
            jfrom_env()
        assert str(e.value) == str(jerr.value)
        assert "pool-backed prefix store" in str(e.value)
        assert "ROADMAP Queue 1 item" not in str(e.value)
        return
    with pytest.raises(ValueError, match="ROADMAP Queue 1 item"):
        tconfig.from_env()


@pytest.mark.parametrize("env", [
    {"DISPATCH": "remote", "SHARD_A_SERVICE": "127.0.0.1:5001",
     "SHARD_B_SERVICE": "shard-b", "SHARD_PORT": "5002"},
    {"DISPATCH": "bogus"},
])
def test_dispatch_knobs_parse_and_validate_as_jax(monkeypatch, env):
    """DISPATCH, SHARD_A_SERVICE and SHARD_B_SERVICE are served: they
    parse as the JAX config parses them, and DISPATCH refuses anything
    but local|remote with its message."""
    from llm_sharding_demo_tpu.utils import config as jconfig
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if env["DISPATCH"] == "bogus":
        with pytest.raises(ValueError) as jerr:
            jconfig.from_env()
        with pytest.raises(ValueError, match="not local|remote") as terr:
            tconfig.from_env()
        assert str(terr.value) == str(jerr.value)
        return
    cfg, jc = tconfig.from_env(), jconfig.from_env()
    assert (cfg.dispatch, cfg.shard_a_url, cfg.shard_b_url) == (
        jc.dispatch, jc.shard_a_url, jc.shard_b_url) == (
        "remote", "http://127.0.0.1:5001", "http://shard-b:5002")


@pytest.mark.parametrize("env,at_startup", [
    # KV_POOL_DTYPE without KV_POOL_BLOCKS: a silently ignored knob
    ({"KV_POOL_DTYPE": "int8"}, False),
    # the gathered view must be exactly the cache width
    ({"KV_POOL_BLOCKS": "16", "KV_BLOCK_SIZE": "20", "MAX_SEQ": "96"},
     False),
    # parse, then the app's composition checks refuse
    ({"KV_POOL_BLOCKS": "16", "PREFILL_CHUNK": "8"}, True),
    ({"KV_POOL_BLOCKS": "16", "MAX_BATCH": "4", "BATCH_MODE": "admission"},
     True),
])
def test_paged_knobs_parse_and_refuse_as_jax(weights, monkeypatch, env,
                                             at_startup):
    """KV_POOL_BLOCKS, KV_BLOCK_SIZE and KV_POOL_DTYPE are served: they
    parse from the environment and refuse where the JAX package's config
    (or, for compositions, its app) refuses, with its message."""
    from llm_sharding_demo_tpu.utils import config as jconfig
    (jcfg, jp), (tcfg, tp) = weights
    monkeypatch.setenv("KV_BLOCK_SIZE", "8")
    monkeypatch.setenv("MAX_SEQ", "96")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if not at_startup:
        with pytest.raises(ValueError) as jerr:
            jconfig.from_env()
        with pytest.raises(ValueError) as terr:
            tconfig.from_env()
        assert str(terr.value) == str(jerr.value)
        return
    cfg, jc = tconfig.from_env(), jconfig.from_env()
    assert (cfg.kv_pool_blocks, cfg.kv_block_size) == (
        jc.kv_pool_blocks, jc.kv_block_size) == (16, 8)
    with pytest.raises(ValueError) as jerr:
        jcreate_app(jc, model=(jcfg, jp), tokenizer=JByteTokenizer())
    with pytest.raises(ValueError) as terr:
        create_app(cfg, model=(tcfg, tp), tokenizer=ByteTokenizer(),
                   device="cpu")
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("env", [
    # parse: the store, its chunk, the tier below a pool
    {"PREFIX_CACHE": "8", "PREFIX_CHUNK": "16", "KV_POOL_BLOCKS": "16",
     "KV_HOST_BLOCKS": "64"},
    # PREFIX_CHUNK without PREFIX_CACHE, KV_HOST_BLOCKS without a pool:
    # silently ignored knobs
    {"PREFIX_CHUNK": "16"},
    {"KV_HOST_BLOCKS": "64"},
    # negative values
    {"PREFIX_CACHE": "-1"},
    {"PREFIX_CACHE": "2", "PREFIX_CHUNK": "-4"},
    {"KV_POOL_BLOCKS": "16", "KV_HOST_BLOCKS": "-2"},
])
def test_prefix_and_host_tier_knobs_parse_and_validate_as_jax(monkeypatch,
                                                              env):
    """PREFIX_CACHE, PREFIX_CHUNK and KV_HOST_BLOCKS are served: they
    parse, and refuse where the JAX config refuses, with its message."""
    from llm_sharding_demo_tpu.utils import config as jconfig
    monkeypatch.setenv("KV_BLOCK_SIZE", "8")
    monkeypatch.setenv("MAX_SEQ", "96")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        jc = jconfig.from_env()
    except ValueError as jerr:
        with pytest.raises(ValueError) as terr:
            tconfig.from_env()
        assert str(terr.value) == str(jerr)
        return
    cfg = tconfig.from_env()
    assert (cfg.prefix_cache, cfg.prefix_chunk, cfg.kv_host_blocks) == (
        jc.prefix_cache, jc.prefix_chunk, jc.kv_host_blocks) == (8, 16, 64)


def test_kept_knobs_and_defaults_parse(monkeypatch):
    for k, v in {"MODEL_ID": "gpt2", "SHARD_ROLE": "b", "BOUNDARIES": "3,6",
                 "SHARD_PORT": "5055", "MAX_SEQ": "1024",
                 "INFERENCE_DTYPE": "int8", "MAX_BATCH": "1",
                 "DISPATCH": "local", "PP_DECODE": "0"}.items():
        monkeypatch.setenv(k, v)
    cfg = tconfig.from_env()
    assert (cfg.model_id, cfg.shard_role, cfg.boundaries, cfg.shard_port,
            cfg.max_seq, cfg.inference_dtype) == (
        "gpt2", "b", (3, 6), 5055, 1024, "int8")
    with pytest.raises(ValueError, match="INFERENCE_DTYPE"):
        ServingConfig(inference_dtype="float16")


def test_batching_and_chunk_knobs_parse_and_validate(monkeypatch):
    """MAX_BATCH, BATCH_MODE, BATCH_WAIT_MS and PREFILL_CHUNK are served:
    they parse from the environment and are validated as the JAX package
    validates them."""
    for k, v in {"MAX_BATCH": "32", "BATCH_MODE": "iter",
                 "BATCH_WAIT_MS": "2.5", "PREFILL_CHUNK": "16"}.items():
        monkeypatch.setenv(k, v)
    cfg = tconfig.from_env()
    assert (cfg.max_batch, cfg.batch_mode, cfg.batch_wait_ms,
            cfg.prefill_chunk) == (32, "iter", 2.5, 16)
    defaults = ServingConfig()
    assert (defaults.max_batch, defaults.batch_mode, defaults.batch_wait_ms,
            defaults.prefill_chunk) == (1, "admission", 5.0, 0)
    for bad, match in ((dict(max_batch=0), "MAX_BATCH"),
                       (dict(batch_mode="continuous"), "BATCH_MODE"),
                       (dict(batch_wait_ms=-1.0), "BATCH_WAIT_MS"),
                       (dict(prefill_chunk=-1), "PREFILL_CHUNK")):
        with pytest.raises(ValueError, match=match):
            ServingConfig(**bad)
        with pytest.raises(ValueError, match=match):
            JServingConfig(**bad)
    monkeypatch.setenv("MAX_BATCH", "four")
    with pytest.raises(ValueError, match="MAX_BATCH"):
        tconfig.from_env()


def test_unported_models_refuse(monkeypatch):
    """llama-tiny resolves (the llama family is ported), and so does the
    port's MoEConfig (the MoE family is ported); a config object of
    another package (the JAX package's MoEConfig) still refuses."""
    from llm_sharding_demo_tpu.models.moe import MoEConfig as JMoEConfig
    from llm_sharding_demo_tpu_torch.models import family_module, llama, moe
    from llm_sharding_demo_tpu_torch.serving import loader
    import torch
    cfg, params = loader.resolve_model(ServingConfig(model_id="llama-tiny"),
                                       torch.device("cpu"))
    assert cfg == llama.CONFIGS["llama-tiny"] and "lm_head" in params
    dims = dict(vocab_size=64, n_positions=32, n_embd=32, n_layer=2,
                n_head=2)
    assert family_module(moe.MoEConfig(**dims)) is moe
    with pytest.raises(TypeError, match="unknown model config type"):
        family_module(JMoEConfig(**dims))
    cfg, params = loader.resolve_model(
        ServingConfig(model_id="sshleifer/tiny-gpt2"), torch.device("cpu"))
    assert cfg.n_embd == 2 and params["wte"].shape == (50257, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.create_app(ServingConfig(model_id="sshleifer/tiny-gpt2"))


def test_bpe_tokenizer_round_trips(tmp_path):
    import json
    vocab = {c: i for i, c in enumerate(["h", "i", "Ġ", "t", "hi", "Ġt"])}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nh i\nĠ t\n")
    tok = BPETokenizer.from_dir(str(tmp_path))
    assert tok.encode("hi t") == [4, 5]
    assert tok.decode([4, 5]) == "hi t"
    assert ByteTokenizer().decode(ByteTokenizer().encode("héllo")) == "héllo"
