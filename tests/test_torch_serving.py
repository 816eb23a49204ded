"""The PyTorch port's HTTP app against the JAX package's, on the same weights.

Both apps are driven in-process through their ``TestClient``s with the
byte tokenizer; greedy ``/generate`` JSON, the role guards and the
``/forward`` + ``/forward_b`` composition must agree. Also: knobs the
port does not serve yet refuse at startup.
"""

import dataclasses

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
def test_unported_knobs_refuse_at_startup(weights, monkeypatch, knob,
                                          value):
    """No knob refuses now: each parses. AUTO_PLAN (the static planner
    is ported) parses into the config as the JAX config parses it;
    CHECKPOINT_DIR is served (checkpoints are ported): it parses into
    the config instead. So are
    FLEET_ROLE (the fleet is ported), AUTO_PLAN_CONTINUOUS and
    AUTO_PLAN_JOURNAL (continuous planning is ported): each parses, and
    without its companions (the pool-backed prefix store; the pooled
    iter composition; continuous mode) raises the JAX config's
    validation message, naming no ROADMAP item. PP_DECODE, TP_DECODE and
    EP_DECODE (multi-device decode is ported) parse, and without their
    companions (speculation off; fp32/bf16; an MoE model) the app raises
    the JAX app's guard message; PP_DECODE on a world of one rank raises
    the JAX guard's device count."""
    monkeypatch.setenv(knob, value)
    multi = {"PP_DECODE": ({"SPEC_DECODE": "4"}, "own the single-device"),
             "TP_DECODE": ({"INFERENCE_DTYPE": "int8"}, "fp32/bf16"),
             "EP_DECODE": ({}, "have no expert axis")}
    if knob in multi:
        assert knob not in tconfig.REFUSED_KNOBS
        assert getattr(tconfig.from_env(), knob.lower()) is True
        extra, needle = multi[knob]
        for k, v in extra.items():
            monkeypatch.setenv(k, v)
        (jcfg, jp), (tcfg, tp) = weights
        with pytest.raises(ValueError) as e:
            create_app(tconfig.from_env(), model=(tcfg, tp),
                       tokenizer=ByteTokenizer(), device="cpu")
        with pytest.raises(ValueError) as jerr:
            jcreate_app(jfrom_env(), model=(jcfg, jp),
                        tokenizer=JByteTokenizer())
        assert str(e.value) == str(jerr.value)
        assert needle in str(e.value)
        assert "ROADMAP Queue 1 item" not in str(e.value)
        if knob == "PP_DECODE":
            monkeypatch.delenv("SPEC_DECODE")
            with pytest.raises(ValueError) as e:
                create_app(tconfig.from_env(), model=(tcfg, tp),
                           tokenizer=ByteTokenizer(), device="cpu")
            assert str(e.value) == ("PP_DECODE needs >= 2 devices (one per "
                                    "stage); this pod sees 1")
        return
    if knob == "CHECKPOINT_DIR":
        assert knob not in tconfig.REFUSED_KNOBS
        assert tconfig.from_env().checkpoint_dir == value
        return
    companions = {"FLEET_ROLE": "pool-backed prefix store",
                  "AUTO_PLAN_CONTINUOUS": "requires KV_POOL_BLOCKS > 0",
                  "AUTO_PLAN_JOURNAL": "needs AUTO_PLAN_CONTINUOUS=1"}
    if knob in companions:
        assert knob not in tconfig.REFUSED_KNOBS
        for other in ("KV_POOL_BLOCKS", "PREFIX_CACHE", "MAX_BATCH",
                      "BATCH_MODE", "AUTO_PLAN_CONTINUOUS"):
            if other != knob:
                monkeypatch.delenv(other, raising=False)
        with pytest.raises(ValueError) as e:
            tconfig.from_env()
        with pytest.raises(ValueError) as jerr:
            jfrom_env()
        assert str(e.value) == str(jerr.value)
        assert companions[knob] in str(e.value)
        assert "ROADMAP Queue 1 item" not in str(e.value)
        return
    assert knob == "AUTO_PLAN" and knob not in tconfig.REFUSED_KNOBS
    assert tconfig.from_env().auto_plan is jfrom_env().auto_plan is True


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


# pydantic's lax mode, as the JAX app validates bodies: (route, body)
LAX_CASES = [
    ("/generate", {"prompt": "ab", "max_new_tokens": "3", "mode": "greedy"}),
    ("/generate", {"prompt": "ab", "max_new_tokens": 3.0, "mode": "greedy"}),
    ("/generate", {"prompt": "ab", "max_new_tokens": True,
                   "mode": "greedy"}),
    ("/generate", {"prompt": "ab", "max_new_tokens": " 4 ", "top_k": "4.0",
                   "mode": "greedy"}),
    ("/generate", {"prompt": "ab", "max_new_tokens": 2, "mode": "greedy",
                   "temperature": "0.6", "top_p": "1", "seed": "7"}),
    ("/generate", {"prompt": "ab", "max_new_tokens": 2, "mode": "greedy",
                   "stop_at_eos": 1, "eos_token_id": "5"}),
    ("/generate", {"prompt": "ab", "max_new_tokens": 2, "mode": "greedy",
                   "stop_at_eos": "true"}),
    ("/generate", {"prompt": "ab", "max_new_tokens": 2, "mode": "greedy",
                   "stop_at_eos": "OFF"}),
    ("/generate", {"prompt": "ab", "max_new_tokens": 2, "mode": "greedy",
                   "stop_at_eos": "y", "seed": None}),
    ("/generate", {"prompt": "ab", "max_new_tokens": 20.5}),
    ("/generate", {"prompt": "ab", "max_new_tokens": "2x"}),
    ("/generate", {"prompt": "ab", "max_new_tokens": None}),
    ("/generate", {"prompt": "ab", "max_new_tokens": [2]}),
    ("/generate", {"prompt": "ab", "temperature": "hot"}),
    ("/generate", {"prompt": "ab", "stop_at_eos": 2}),
    ("/generate", {"prompt": "ab", "stop_at_eos": "maybe"}),
    ("/generate", {"prompt": "ab", "stop_at_eos": 0.5}),
    ("/generate", {"prompt": 5}),
    ("/generate", {"max_new_tokens": 3}),
    ("/generate", {"prompt": 1, "max_new_tokens": "z", "top_p": [],
                   "seed": 1.5}),
    ("/generate", [1, 2]),
    ("/forward", {"input_ids": ["1", 2, True]}),
    ("/forward", {"input_ids": [1.5, "x"]}),
    ("/forward", {"input_ids": "1 2"}),
]


@pytest.fixture(scope="module")
def lax_apps(weights):
    return {role: clients(weights, role) for role in ("coordinator", "a")}


@pytest.mark.parametrize("route,body", LAX_CASES)
def test_lax_request_validation_matches_jax(lax_apps, route, body):
    """The port's validator coerces what pydantic's lax mode coerces:
    the same status as the JAX app, the same parsed values, and each 422
    ``detail`` entry with pydantic's ``type``, ``loc``, ``msg`` and
    ``input``."""
    from llm_sharding_demo_tpu.serving import app as japp_mod
    from llm_sharding_demo_tpu_torch.serving import http as thttp
    jc, tc = lax_apps["coordinator" if route == "/generate" else "a"]
    j, t = jc.post(route, json=body), tc.post(route, json=body)
    assert t.status_code == j.status_code
    if j.status_code == 422:
        keys = ("type", "loc", "msg", "input")
        assert [{k: d[k] for k in keys} for d in t.json()["detail"]] == [
            {k: d[k] for k in keys} for d in j.json()["detail"]]
        return
    if route == "/forward":
        np.testing.assert_allclose(t.json()["hidden_states"],
                                   j.json()["hidden_states"], atol=1e-5)
    else:
        assert t.json() == j.json()
    model, jmodel = {"/generate": (tapp.GenerateReq, japp_mod.GenerateReq),
                     "/forward": (tapp.InputIDs, japp_mod.InputIDs)}[route]
    parsed = dataclasses.asdict(thttp.validate(model, body))
    assert parsed == jmodel.model_validate(body).model_dump()
    assert all(type(v) is type(w) for v, w in zip(
        parsed.values(), jmodel.model_validate(body).model_dump().values()))
