"""The three multi-device serving knobs (``PP_DECODE``, ``TP_DECODE``,
``EP_DECODE``) on gloo ranks against the JAX app.

Every rank builds the port's app (``torch_mesh_ranks.serve``: one
module-scoped group of two spawned CPU ranks, which import only torch and
the port); rank 0 posts the requests through its in-process client while
the other rank follows it. The JAX apps run here over the forced host
devices. Replies are compared as JSON (fp32 and int8 greedy streams
byte-equal), and every startup refusal with the JAX app's message, the
ranks standing where the JAX app counts devices.
"""

import jax
import jax.numpy as jnp
import pytest

from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.models import moe as jmoe
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from test_torch_model import (gc_between_modules,  # noqa: F401
                              gc_only_in_test_bodies, np_gpt2_params)
from test_torch_moe import np_moe_params
from torch_mesh_ranks import RankGroup

# the pipelined decoder's model (test_torch_ppdecode's), the MoE and the
# small GPT-2 of the ep refusals (test_torch_tp_decode's)
DIMS = dict(vocab_size=211, n_positions=128, n_embd=128, n_layer=4,
            n_head=2)
MDIMS = dict(vocab_size=256, n_positions=128, n_embd=128, n_layer=2,
             n_head=2, n_experts=4, expert_top_k=2)
MAX_SEQ = 64


@pytest.fixture(scope="module")
def ranks():
    group = RankGroup(2)
    yield group
    group.close()


@pytest.fixture(scope="module")
def np_params():
    return np_gpt2_params(seed=3, dims=DIMS)


@pytest.fixture(scope="module")
def moe_np():
    return np_moe_params(seed=2, dims=MDIMS)


def jmodel(family, np_params, dims):
    cls = {"gpt2": jgpt2.GPT2Config, "moe": jmoe.MoEConfig}[family]
    return cls(**dims), jax.tree.map(jnp.asarray, np_params)


def test_serving_pp_decode_knob(ranks, np_params):
    """PP_DECODE=1 serves /generate with one stage a rank, replies equal
    to the JAX app's (uneven BOUNDARIES; int8 stages behind MAX_BATCH=4,
    against the JAX app's same composition); /healthz
    reports the knob and the stage count; speculation refuses with the
    JAX app's message."""
    jcfg = jgpt2.GPT2Config(**DIMS)
    jp = jax.tree.map(jnp.asarray, np_params)
    bodies = [{"prompt": "Hi, ", "max_new_tokens": 6, "mode": "greedy"},
              {"prompt": "pipe", "max_new_tokens": 5, "mode": "greedy"}]

    def jax_replies(**kw):
        app = JTestClient(jcreate_app(
            JServingConfig(model_id="t", max_seq=MAX_SEQ, **kw),
            model=(jcfg, jp), tokenizer=JByteTokenizer()))
        return [app.post("/generate", json=b).json() for b in bodies]

    for kw in ({"boundaries": (1,)},
               {"boundaries": (2,), "max_batch": 4,
                "inference_dtype": "int8"}):
        out = ranks.run("serve", family="gpt2", cfg_kw=DIMS,
                        np_params=np_params,
                        serving=dict(model_id="t", max_seq=MAX_SEQ,
                                     pp_decode=True, **kw), bodies=bodies)
        assert out[0]["replies"] == jax_replies(pp_decode=True, **kw), kw
        assert out[1]["served"] == len(bodies)
        health = out[0]["health"]
        assert (health["pp_decode"], health["n_stages"]) == (True, 2)
    out = ranks.run("serve", family="gpt2", cfg_kw=DIMS, np_params=np_params,
                    serving=dict(model_id="t", pp_decode=True,
                                 spec_decode=4, boundaries=(2,)), bodies=[])
    with pytest.raises(ValueError) as j:
        jcreate_app(JServingConfig(model_id="t", pp_decode=True,
                                   spec_decode=4, boundaries=(2,)),
                    model=(jcfg, jp), tokenizer=JByteTokenizer())
    assert out[0]["error"] == str(j.value)


BODIES = [{"prompt": "Hi, ", "max_new_tokens": 5, "mode": "greedy"},
          {"prompt": "mesh", "max_new_tokens": 4, "mode": "greedy"}]


def _jax_app(family, np_params, dims, **kw):
    jcfg, jp = jmodel(family, np_params, dims)
    return JTestClient(jcreate_app(
        JServingConfig(model_id="t", max_seq=MAX_SEQ, **kw),
        model=(jcfg, jp), tokenizer=JByteTokenizer()))


def _serve(ranks, family, np_params, dims, bodies=BODIES, **kw):
    return ranks.run("serve", family=family, cfg_kw=dims,
                     np_params=np_params,
                     serving=dict(model_id="t", max_seq=MAX_SEQ, **kw),
                     bodies=bodies)


def _jax_app_error(family, np_params, dims, **kw):
    jcfg, jp = jmodel(family, np_params, dims)
    with pytest.raises(ValueError) as e:
        jcreate_app(JServingConfig(model_id="t", max_seq=MAX_SEQ, **kw),
                    model=(jcfg, jp), tokenizer=JByteTokenizer())
    return str(e.value)


def test_serving_tp_decode_knob(ranks):
    """TP_DECODE=1 serves dense /generate over both ranks, replies equal
    to the JAX app's (over its eight devices), alone and behind the
    batcher; misconfigurations refuse with the JAX app's messages (the
    ranks standing where it counts devices)."""
    dims = dict(vocab_size=256, n_positions=64, n_embd=128, n_layer=2,
                n_head=8)
    np_params = np_gpt2_params(seed=9, dims=dims)
    jreplies = [_jax_app("gpt2", np_params, dims).post(
        "/generate", json=b).json() for b in BODIES]
    for kw in ({}, {"max_batch": 4}):
        out = _serve(ranks, "gpt2", np_params, dims, tp_decode=True, **kw)
        assert out[0]["replies"] == jreplies, kw
        assert out[0]["health"]["tp_decode"] is True
        assert out[0]["health"]["n_stages"] == 1
    assert (_serve(ranks, "moe", np_moe_params(seed=1, dims=MDIMS), MDIMS,
                   tp_decode=True)[0]["error"]
            == _jax_app_error("moe", np_moe_params(seed=1, dims=MDIMS),
                              MDIMS, tp_decode=True))
    for kw in ({"pp_decode": True}, {"inference_dtype": "int8"}):
        assert (_serve(ranks, "gpt2", np_params, dims, tp_decode=True,
                       **kw)[0]["error"]
                == _jax_app_error("gpt2", np_params, dims, tp_decode=True,
                                  **kw))
    bad = dict(dims, n_embd=192, n_head=3)
    bad_np = np_gpt2_params(seed=1, dims=bad)
    assert (_serve(ranks, "gpt2", bad_np, bad, tp_decode=True)[0]["error"]
            == _jax_app_error("gpt2", bad_np, bad, tp_decode=True)
            .replace("this pod's 8 devices", "this pod's 2 devices"))


def test_serving_ep_decode_knob(ranks, moe_np):
    """EP_DECODE=1 serves MoE /generate with the experts split over both
    ranks, replies equal to the JAX app's (and to the unsharded port
    app's); a dense model and a prefix store refuse with the JAX app's
    messages."""
    jreplies = [_jax_app("moe", moe_np, MDIMS, ep_decode=True).post(
        "/generate", json=b).json() for b in BODIES]
    out = _serve(ranks, "moe", moe_np, MDIMS, ep_decode=True)
    assert out[0]["replies"] == jreplies
    assert out[0]["health"]["ep_decode"] is True
    assert out[1]["served"] == len(BODIES)
    assert _serve(ranks, "moe", moe_np, MDIMS)[0]["replies"] == jreplies
    np_params = np_gpt2_params(seed=1, dims=dict(DIMS, vocab_size=256))
    for family, params, dims, kw in (
            ("gpt2", np_params, dict(DIMS, vocab_size=256), {}),
            ("moe", moe_np, MDIMS, {"prefix_cache": 2})):
        assert (_serve(ranks, family, params, dims, ep_decode=True,
                       **kw)[0]["error"]
                == _jax_app_error(family, params, dims, ep_decode=True, **kw))
