"""Remote dispatch: the reference's three-role topology over real sockets.

Shard A (``/forward``) and shard B (``/forward_b``) of each package run
in process behind ``serve(block=False)``; a ``DISPATCH=remote``
coordinator relays every token through them. On the same numpy-made
weights the port's greedy reply equals its local reply and the JAX
three-role reply, and a seeded sampled reply equals the JAX one (one
numpy draw a token from ``sampler_pmf``, whose pmfs agree within 1e-6).
``HopPolicy`` runs side by side with the JAX package's (recorded sleeps,
fixed jitter seed): the same backoff schedule and breaker transitions.
Dead, misrouted and breaker-open shards answer the JAX app's typed 502
and 503; a seeded ``FaultPlan`` at ``serving.shard_hop`` gives the same
retries in both (these hold the coordinators, so both relay through the
port's shards, which answer faster than the JAX package's eager ones).
No test waits out a real backoff.
"""

import functools
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.runtime import engine as jengine
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.http import serve as jserve
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils import graftfault as jgraftfault
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu.utils.metrics import (
    MetricsRegistry as JMetricsRegistry)
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.runtime import engine as tengine
from llm_sharding_demo_tpu_torch.serving import app as tapp
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient, serve
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import graftfault
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from llm_sharding_demo_tpu_torch.utils.metrics import REGISTRY
from test_torch_model import np_gpt2_params

DIMS = dict(vocab_size=211, n_positions=64, n_embd=128, n_layer=2,
            n_head=2)
MAX_SEQ = 64
# the sampler's pmf of the two packages on the same logits
PMF_TOL = 1e-6
# the JAX shards compile a forward for each sequence length: every
# request through them starts from a 2-token prompt and takes 3 tokens
PROMPT = "Hi"
NEW = 3


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params(seed=11, dims=DIMS)
    return ((jgpt2.GPT2Config(**DIMS), jax.tree.map(jnp.asarray, tree)),
            (gpt2.GPT2Config(**DIMS), params_from_numpy(tree, device="cpu")))


def port_app(weights, role="coordinator", **kw):
    return create_app(ServingConfig(model_id="test", shard_role=role,
                                    max_seq=MAX_SEQ, **kw),
                      model=weights[1], tokenizer=ByteTokenizer(),
                      device="cpu")


def jax_app(weights, role="coordinator", **kw):
    registry = JMetricsRegistry()
    app = jcreate_app(JServingConfig(model_id="test", shard_role=role,
                                     max_seq=MAX_SEQ, **kw),
                      model=weights[0], tokenizer=JByteTokenizer(),
                      registry=registry)
    app.test_registry = registry
    return app


def _address(server) -> str:
    return f"127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def shards(weights):
    """``{"port": (a, b), "jax": (a, b)}``: each package's two shards on
    ephemeral ports, as ``host:port`` services."""
    servers = {
        "port": [serve(port_app(weights, r), host="127.0.0.1", port=0,
                       block=False) for r in ("a", "b")],
        "jax": [jserve(jax_app(weights, r), host="127.0.0.1", port=0,
                       block=False) for r in ("a", "b")],
    }
    yield {k: tuple(_address(s) for s in v) for k, v in servers.items()}
    every = [s for pair in servers.values() for s in pair]
    stops = [threading.Thread(target=s.shutdown) for s in every]
    for t in stops:
        t.start()
    for t in stops:
        t.join(timeout=10)
    for s in every:
        s.server_close()


@pytest.fixture
def recorded_sleeps(monkeypatch):
    """Every HopPolicy that either app builds records its backoff sleeps
    instead of waiting them out."""
    slept = {"port": [], "jax": []}
    monkeypatch.setattr(graftfault, "HopPolicy", functools.partial(
        graftfault.HopPolicy, sleep=slept["port"].append))
    monkeypatch.setattr(jgraftfault, "HopPolicy", functools.partial(
        jgraftfault.HopPolicy, sleep=slept["jax"].append))
    return slept


def remote_clients(weights, port_services, jax_services):
    """A remote coordinator of each package: the port's relays through
    the ``(a, b)`` services ``port_services``, the JAX app's through
    ``jax_services``."""
    (pa, pb), (ja, jb) = port_services, jax_services
    t = TestClient(port_app(weights, dispatch="remote", shard_a_service=pa,
                            shard_b_service=pb))
    j = JTestClient(jax_app(weights, dispatch="remote", shard_a_service=ja,
                            shard_b_service=jb))
    return t, j


# -- the three-role topology ------------------------------------------------


@pytest.mark.parametrize("shard_pkg", ["port", "jax"])
def test_greedy_remote_equals_local_and_jax(weights, shards, shard_pkg):
    """The port's coordinator, relaying through the port's shards (or,
    wire-compatible, the JAX package's), answers as its local fp32
    coordinator and as the JAX three-role topology, byte for byte."""
    t, j = remote_clients(weights, shards[shard_pkg], shards["jax"])
    local = TestClient(port_app(weights))
    body = {"prompt": PROMPT, "max_new_tokens": NEW, "mode": "greedy"}
    r = t.post("/generate", json=body)
    assert r.status_code == 200, r.json()
    assert r.json()["generated"].startswith(PROMPT)
    assert r.json() == local.post("/generate", json=body).json()
    assert r.json() == j.post("/generate", json=body).json()
    h = t.get("/healthz").json()
    # the remote coordinator holds no engine
    assert (h["dispatch"], h["decode_kernel"], h["forward_shapes"]) == (
        "remote", None, {})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_sample_equals_jax(weights, shards, seed):
    t, j = remote_clients(weights, shards["port"], shards["jax"])
    body = {"prompt": PROMPT, "max_new_tokens": NEW, "mode": "sample",
            "temperature": 0.9, "top_k": 40, "top_p": 0.95, "seed": seed}
    r = t.post("/generate", json=body)
    assert r.status_code == 200
    assert r.json() == j.post("/generate", json=body).json()
    assert r.json() == t.post("/generate", json=body).json()  # replays
    # the pmf each package draws from, on the port shards' logits
    hidden = tapp.post_json(f"http://{shards['port'][0]}/forward",
                            {"input_ids": [97, 98, 7 * seed]}, 10.0)
    logits = np.asarray(tapp.post_json(
        f"http://{shards['port'][1]}/forward_b", hidden, 10.0)["logits"])
    last = logits[0, -1]
    kw = dict(mode="sample", temperature=0.9, top_k=40, top_p=0.95)
    tp, ti = tengine.sampler_pmf(torch.from_numpy(last),
                                 tengine.SamplingConfig(**kw))
    jp, ji = jengine.sampler_pmf(jnp.asarray(last),
                                 jengine.SamplingConfig(**kw))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=PMF_TOL)


def test_eos_stops_the_relay(weights, shards, monkeypatch):
    t, j = remote_clients(weights, shards["port"], shards["port"])
    tcfg, tp = weights[1]
    ids = ByteTokenizer().encode(PROMPT)
    for _ in range(4):   # the greedy stream, from the model itself
        logits = gpt2.forward(tp, torch.tensor([ids]), tcfg)
        ids.append(int(logits[0, -1].argmax()))
    new = ids[len(PROMPT):]
    eos = new[1]
    stop = new.index(eos)   # the first new token may already be it
    hops = []
    real = tapp.post_json
    monkeypatch.setattr(tapp, "post_json",
                        lambda url, *a: hops.append(url) or real(url, *a))
    body = {"prompt": PROMPT, "max_new_tokens": 4, "mode": "greedy",
            "eos_token_id": eos}
    r = t.post("/generate", json=body)
    assert r.json() == j.post("/generate", json=body).json()
    assert r.json() == {"generated": ByteTokenizer().decode(
        ids[:len(PROMPT) + stop]), "finish_reason": "stop"}
    # two hops a token, and none past the EOS token
    assert len(hops) == 2 * (stop + 1)


def test_remote_startup_guards_match_jax(weights, monkeypatch):
    """A remote coordinator decodes nothing locally: it builds no weights,
    the local-path knobs refuse with the JAX app's messages, and DISPATCH
    must be local|remote."""
    from llm_sharding_demo_tpu_torch.serving import loader

    def no_weights(*a, **k):
        raise AssertionError("a remote coordinator must build no weights")

    monkeypatch.setattr(loader, "resolve_model", no_weights)
    coord = create_app(ServingConfig(model_id="gpt2", dispatch="remote"),
                       tokenizer=ByteTokenizer(), device="cpu")
    assert TestClient(coord).get("/healthz").json()["dispatch"] == "remote"
    with pytest.raises(AssertionError, match="no weights"):
        create_app(ServingConfig(model_id="gpt2"), device="cpu")
    for kw in (dict(inference_dtype="int8"), dict(spec_decode=4),
               dict(prefix_cache=4)):
        with pytest.raises(ValueError) as terr:
            port_app(weights, dispatch="remote", **kw)
        with pytest.raises(ValueError) as jerr:
            jax_app(weights, dispatch="remote", **kw)
        assert str(terr.value) == str(jerr.value)
    for kw in (dict(max_batch=4), dict(prefill_chunk=8)):
        with pytest.raises(ValueError, match="local decode path only"):
            port_app(weights, dispatch="remote", **kw)
    with pytest.raises(ValueError) as terr:
        ServingConfig(dispatch="bogus")
    with pytest.raises(ValueError) as jerr:
        JServingConfig(dispatch="bogus")
    assert str(terr.value) == str(jerr.value)
    cfg = ServingConfig(shard_a_service="10.0.0.7", shard_port=5055,
                        shard_b_service="127.0.0.1:5002")
    jcfg = JServingConfig(shard_a_service="10.0.0.7", shard_port=5055,
                          shard_b_service="127.0.0.1:5002")
    assert (cfg.shard_a_url, cfg.shard_b_url) == (
        jcfg.shard_a_url, jcfg.shard_b_url) == (
        "http://10.0.0.7:5055", "http://127.0.0.1:5002")


# -- the hop policy, side by side with the JAX package's ----------------------


def _fail(timeout_s):
    raise ConnectionError("down")


def _run_policy(gf, case):
    """Drive one package's HopPolicy through ``case``; returns what the
    two packages must agree on."""
    log, slept, retries, seen = [], [], [], []
    kw = dict(sleep=slept.append,
              on_retry=lambda s, r: retries.append((s, r)))

    def call(pol, fn, shard, **ckw):
        try:
            out = pol.call(fn, shard=shard, **ckw)
            log.append(("ok", out, pol.breaker_state(shard)))
        except Exception as e:  # noqa: BLE001 - the outcome is compared
            log.append((type(e).__name__, getattr(e, "code", None),
                        pol.breaker_state(shard)))

    if case == "retry_then_open":
        pol = gf.HopPolicy(attempts=2, timeout_s=5.0, base_backoff_s=0.25,
                           breaker_threshold=3, breaker_cooldown_s=30.0,
                           jitter_seed=11, **kw)
        for _ in range(3):   # streak 2; streak 3 opens; fast-fail
            call(pol, _fail, "a")
    elif case == "backoff_schedule":
        pol = gf.HopPolicy(attempts=5, timeout_s=5.0, base_backoff_s=0.25,
                           max_backoff_s=2.0, breaker_threshold=20,
                           jitter_seed=7, **kw)
        for _ in range(3):
            call(pol, _fail, "b")
    elif case in ("half_open_probe_closes", "probe_not_wedged"):
        pol = gf.HopPolicy(attempts=1, breaker_threshold=1,
                           breaker_cooldown_s=0.05, base_backoff_s=0.001,
                           **kw)
        call(pol, _fail, "d")
        time.sleep(0.06)     # the cooldown: the next call is the probe
        log.append(("state", pol.breaker_state("d")))
        if case == "probe_not_wedged":
            # a probe whose attempt never ran releases its claim
            call(pol, lambda t: "ok", "d",
                 deadline=gf.Deadline(time.monotonic() - 1.0))
        call(pol, lambda t: "ok", "d")
    elif case == "deadline_timeouts":
        pol = gf.HopPolicy(attempts=3, timeout_s=30.0,
                           base_backoff_s=0.001, breaker_threshold=10, **kw)

        def attempt(timeout_s):
            seen.append(timeout_s)
            raise ConnectionError("down")

        call(pol, attempt, "c", deadline=gf.Deadline.from_ms(150))
    return log, slept, retries, seen


@pytest.mark.parametrize("case", ["retry_then_open", "backoff_schedule",
                                  "half_open_probe_closes",
                                  "probe_not_wedged", "deadline_timeouts"])
def test_hop_policy_matches_jax(case):
    tlog, tslept, tretries, tseen = _run_policy(graftfault, case)
    jlog, jslept, jretries, jseen = _run_policy(jgraftfault, case)
    assert tlog == jlog
    assert tslept == jslept      # the same seeded jitter, bit for bit
    assert tretries == jretries
    assert len(tseen) == len(jseen)
    assert all(t <= 0.151 for t in tseen)
    if case == "retry_then_open":
        assert tlog[1][:2] == ("CircuitOpenError", "circuit_open")
        assert tretries == [("a", "connection")]
    if case == "backoff_schedule":
        # capped exponential: 0.25, 0.5, 1.0, 2.0 times jitter [0.5, 1.5)
        for s, base in zip(tslept, [0.25, 0.5, 1.0, 2.0] * 3):
            assert 0.5 * base <= s < 1.5 * base
    if case.startswith(("half", "probe")):
        assert tlog[-1] == ("ok", "ok", "closed")
        assert ("state", "half-open") in tlog


def test_deadline_timeout_is_capped_and_positive():
    assert graftfault.Deadline.from_ms(10_000).timeout(2.0) == 2.0
    assert graftfault.Deadline(time.monotonic() - 5).timeout(2.0) == 1e-3
    assert jgraftfault.Deadline(time.monotonic() - 5).timeout(2.0) == 1e-3


# -- failures ---------------------------------------------------------------


def _closed_port() -> str:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


BODY = {"prompt": PROMPT, "max_new_tokens": 2, "mode": "greedy"}


def test_dead_shard_answers_502_then_breaker_503(weights, shards,
                                                 recorded_sleeps):
    dead = _closed_port()
    t, j = remote_clients(weights, (shards["port"][0], dead),
                          (shards["port"][0], dead))
    before = REGISTRY.snapshot()["counters"]
    replies = []
    for c in (t, j):
        first = c.post("/generate", json=BODY,
                       headers={"X-Request-ID": "dead-1"})
        second = c.post("/generate", json=BODY)
        replies.append((first, second))
    (t1, t2), (j1, j2) = replies
    for r in (t1, j1):
        assert r.status_code == 502
        body = r.json()
        assert (body["error"], body["shard"], body["upstream"]) == (
            "upstream_failure", "b", f"http://{dead}/forward_b")
        assert "ConnectionError" in body["detail"]
        assert r.headers["X-Request-ID"] == "dead-1"
    # 3 attempts, then 2 more: the fifth consecutive failure opens it
    for r in (t2, j2):
        assert r.status_code == 503
        assert r.json()["error"] == "circuit_open"
        assert r.headers["Retry-After"] == "5"
        assert r.headers["X-Request-ID"]
    assert len(recorded_sleeps["port"]) == len(recorded_sleeps["jax"]) == 3
    after = REGISTRY.snapshot()["counters"]
    key = ("upstream_failures_total", (("shard", "b"),))
    assert after[key] - before.get(key, 0) == 1
    retry = ("shard_hop_retries_total",
             (("reason", "connection"), ("stage", "b")))
    assert after[retry] - before.get(retry, 0) == 3


def test_misrouted_shard_answers_502_with_its_guard(weights, shards,
                                                    recorded_sleeps):
    # shard B's service points at an A-role shard: its role guard answers
    # 200 {"error": "This instance is not shard B."}, a fatal hop
    a = shards["port"][0]
    t, j = remote_clients(weights, (a, a), (a, a))
    rt, rj = t.post("/generate", json=BODY), j.post("/generate", json=BODY)
    assert rt.status_code == rj.status_code == 502
    bt, bj = rt.json(), rj.json()
    assert bt["shard"] == bj["shard"] == "b"
    assert bt["detail"] == bj["detail"] == "This instance is not shard B."
    assert recorded_sleeps["port"] == recorded_sleeps["jax"] == []


def _port_retries(before) -> dict:
    """``{"stage/reason": count}`` added to the port's retry counter
    since the ``before`` snapshot of its counters."""
    out = {}
    for (name, labels), v in REGISTRY.snapshot()["counters"].items():
        n = v - before.get((name, labels), 0)
        if name == "shard_hop_retries_total" and n:
            d = dict(labels)
            out[f"{d['stage']}/{d['reason']}"] = n
    return out


def _jax_retries(app) -> dict:
    """``{"stage/reason": count}`` of the JAX app's retry counter."""
    out = {}
    prefix = "shard_hop_retries_total{"
    for name, v in app.test_registry.snapshot().items():
        if name.startswith(prefix) and v:
            d = dict(p.split("=") for p in name[len(prefix):-1].split(","))
            out[f"{d['stage']}/{d['reason']}"] = v
    return out


@pytest.mark.parametrize("seed", [4, 9])
def test_seeded_fault_plan_at_the_hop_matches_jax(weights, shards, seed,
                                                  recorded_sleeps):
    """The packages' plans are the same function of (seed, site, call),
    and both relays call ``inject`` at the same point of each attempt:
    the same faults land on the same hops, with the same retries."""
    t, j = remote_clients(weights, shards["port"], shards["port"])
    body = {"prompt": PROMPT, "max_new_tokens": 4, "mode": "greedy"}
    before = REGISTRY.snapshot()["counters"]
    plan_kw = dict(seed=seed, rate=0.5, sites={"serving.shard_hop"})
    with graftfault.use(graftfault.FaultPlan(**plan_kw)) as tplan:
        rt = t.post("/generate", json=body)
    with jgraftfault.use(jgraftfault.FaultPlan(**plan_kw)) as jplan:
        rj = j.post("/generate", json=body)
    assert tplan.injections, "the plan fired nothing"
    assert [(i.site, i.kind, i.seq) for i in tplan.injections] == [
        (i.site, i.kind, i.seq) for i in jplan.injections]
    assert rt.status_code == rj.status_code
    assert rt.json().get("generated") == rj.json().get("generated")
    assert rt.json().get("error") == rj.json().get("error")
    retries = _port_retries(before)
    assert retries and retries == _jax_retries(j.app)
    assert recorded_sleeps["port"] == recorded_sleeps["jax"]
