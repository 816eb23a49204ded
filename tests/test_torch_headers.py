"""Request headers on ``/generate``, against the JAX app.

Both apps take the request headers through ``JSONApp.handle`` and their
``TestClient``s: ``X-Deadline-Ms`` answers 400 when malformed (the JAX
message), 503 ``deadline_exceeded`` with ``Retry-After`` once spent
before any runner, and cancels an iteration-batched row at a segment
boundary with its blocks freed; ``X-Request-ID`` is echoed on 200, 400,
429, 502 and 503 replies, and minted when absent or malformed.
"""

import functools
import re
import time

import pytest

import jax
import jax.numpy as jnp
from llm_sharding_demo_tpu.models import gpt2 as jgpt2
from llm_sharding_demo_tpu.serving.app import create_app as jcreate_app
from llm_sharding_demo_tpu.serving.http import TestClient as JTestClient
from llm_sharding_demo_tpu.serving.tokenizer import (
    ByteTokenizer as JByteTokenizer)
from llm_sharding_demo_tpu.utils import graftfault as jgraftfault
from llm_sharding_demo_tpu.utils.config import (
    ServingConfig as JServingConfig)
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.models.convert import params_from_numpy
from llm_sharding_demo_tpu_torch.serving.app import (DEADLINE_MS_ERROR,
                                                     create_app)
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import graftfault
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
from test_torch_model import np_gpt2_params

DIMS = dict(vocab_size=211, n_positions=64, n_embd=128, n_layer=2,
            n_head=2)
BODY = {"prompt": "Hi", "max_new_tokens": 2, "mode": "greedy"}
# the pooled iteration server of the JAX package's deadline tests
POOLED = dict(max_batch=4, batch_mode="iter", batch_wait_ms=10.0,
              kv_pool_blocks=24, kv_block_size=8)
RID = re.compile(r"[A-Za-z0-9._:-]{1,128}")


@pytest.fixture(scope="module")
def weights():
    tree = np_gpt2_params(seed=13, dims=DIMS)
    return ((jgpt2.GPT2Config(**DIMS), jax.tree.map(jnp.asarray, tree)),
            (gpt2.GPT2Config(**DIMS), params_from_numpy(tree, device="cpu")))


class _Slow:
    """A tokenizer that takes 5 ms to encode: an X-Deadline-Ms of 1 is
    spent before any runner sees the request."""

    def __init__(self, tok):
        self.tok = tok

    def encode(self, text):
        time.sleep(0.005)
        return self.tok.encode(text)

    def __getattr__(self, name):
        return getattr(self.tok, name)


def clients(weights, slow=False, **kw):
    """``(port, jax)`` TestClients of one configuration on the weights."""
    (jcfg, jp), (tcfg, tp) = weights
    ttok, jtok = ByteTokenizer(), JByteTokenizer()
    if slow:
        ttok, jtok = _Slow(ttok), _Slow(jtok)
    t = create_app(ServingConfig(model_id="test", max_seq=64, **kw),
                   model=(tcfg, tp), tokenizer=ttok, device="cpu")
    j = jcreate_app(JServingConfig(model_id="test", max_seq=64, **kw),
                    model=(jcfg, jp), tokenizer=jtok)
    return TestClient(t), JTestClient(j)


@pytest.fixture(scope="module")
def local(weights):
    return clients(weights)


def both(pair, headers, body=None):
    """The port's reply and the JAX app's to the same request."""
    return tuple(c.post("/generate", json=body or BODY, headers=headers)
                 for c in pair)


@pytest.mark.parametrize("value", ["banana", "0", "-5", "86400001", "1.5"])
def test_malformed_deadline_answers_400(local, value):
    t, j = both(local, {"X-Deadline-Ms": value, "X-Request-ID": "dl-bad"})
    assert t.status_code == j.status_code == 400
    assert t.json() == j.json() == {"error": DEADLINE_MS_ERROR}
    assert t.headers == j.headers == {"X-Request-ID": "dl-bad"}


def test_spent_deadline_is_refused_before_any_runner(weights):
    t, j = both(clients(weights, slow=True),
                {"X-Deadline-Ms": "1", "X-Request-ID": "dl-spent"})
    assert t.status_code == j.status_code == 503
    assert t.json()["error"] == j.json()["error"] == "deadline_exceeded"
    assert t.json()["detail"].startswith("generate: deadline budget")
    assert t.headers == j.headers == {"X-Request-ID": "dl-spent",
                                      "Retry-After": "1"}


def _quiesced(client, timeout=60.0):
    """The pool's stats once no block is in use (or the last read)."""
    end = time.monotonic() + timeout
    while True:
        st = client.get("/healthz").json()["kv_pool_stats"]
        if st["blocks_in_use"] == 0 or time.monotonic() > end:
            return st
        time.sleep(0.02)   # leave the interpreter to the worker


def test_deadline_cancels_an_iter_batched_row(weights):
    """Every segment stalls 50 ms: a 60 ms budget admits the row, the
    caller gets the typed 503 at its wait's expiry, and the worker
    cancels the row at a segment boundary and frees its blocks."""
    pair = clients(weights, **POOLED)
    body = {"prompt": "Hello, world", "max_new_tokens": 48,
            "mode": "greedy"}
    replies = []
    for c, gf in zip(pair, (graftfault, jgraftfault)):
        plan = gf.FaultPlan(seed=3, rate=1.0, sites={"iterbatch.decode_seg"},
                            kinds={"decode_slow"})
        with gf.use(plan):
            replies.append(c.post("/generate", json=body, headers={
                "X-Deadline-Ms": "60", "X-Request-ID": "dl-row"}))
            st = _quiesced(c)
        assert st["blocks_in_use"] == 0
        assert st["blocks_in_use"] + st["blocks_free"] == st["blocks_total"]
    for r in replies:
        assert r.status_code == 503
        assert r.json()["error"] == "deadline_exceeded"
        assert int(r.headers["Retry-After"]) >= 1
        assert r.headers["X-Request-ID"] == "dl-row"
    # the row was cut: its 48 tokens take two 32-step segments
    assert pair[0].get("/healthz").json()["batch_stats"]["segments"] < 2
    # a generous budget answers as no budget does
    ok = both(pair, {"X-Deadline-Ms": "60000"}, body)
    assert ok[0].status_code == ok[1].status_code == 200
    assert ok[0].json() == ok[1].json() == pair[0].post(
        "/generate", json=body).json()


def _closed_port() -> str:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


def _reply(weights, monkeypatch, status):
    """A ``(port, jax)`` pair of replies with ``status``, each to a request
    carrying X-Request-ID."""
    headers = {"X-Request-ID": f"echo-{status}"}
    if status == 200:
        return both(clients(weights), headers)
    if status == 400:
        return both(clients(weights), dict(headers, **{
            "X-Deadline-Ms": "never"}))
    if status == 429:
        # a seeded pool-exhaustion spike at the iteration batcher's gate
        pair = clients(weights, **POOLED)
        out = []
        for c, gf in zip(pair, (graftfault, jgraftfault)):
            with gf.use(gf.FaultPlan(seed=5, rate=1.0,
                                     sites={"iterbatch.admission_load"})):
                out.append(c.post("/generate", json=BODY, headers=headers))
        return tuple(out)
    if status == 502:
        for gf in (graftfault, jgraftfault):
            monkeypatch.setattr(gf, "HopPolicy", functools.partial(
                gf.HopPolicy, sleep=lambda s: None))
        dead = _closed_port()
        return both(clients(weights, dispatch="remote", shard_a_service=dead,
                            shard_b_service=dead), headers)
    return both(clients(weights, slow=True),
                dict(headers, **{"X-Deadline-Ms": "1"}))


@pytest.mark.parametrize("status", [200, 400, 429, 502, 503])
def test_request_id_is_echoed(weights, monkeypatch, status):
    t, j = _reply(weights, monkeypatch, status)
    assert t.status_code == j.status_code == status
    assert t.headers["X-Request-ID"] == j.headers["X-Request-ID"] == (
        f"echo-{status}")
    assert ("Retry-After" in t.headers) == ("Retry-After" in j.headers) == (
        status in (429, 503))
    assert set(t.json()) == set(j.json())
    if status == 200:
        assert t.json() == j.json()
    else:
        assert t.json()["error"] == j.json()["error"]


@pytest.mark.parametrize("headers", [
    {}, {"X-Request-ID": "two words"}, {"X-Request-ID": "x" * 129},
    {"X-Request-ID": "   "}, {"x-request-id": "ok-but-lower.case:1"}])
def test_request_id_is_minted_when_absent_or_malformed(local, headers):
    t, j = both(local, headers)
    assert t.status_code == j.status_code == 200
    given = next(iter(headers.values()), "").strip()
    if RID.fullmatch(given):
        assert t.headers["X-Request-ID"] == j.headers["X-Request-ID"] == given
        return
    for r in (t, j):
        rid = r.headers["X-Request-ID"]
        assert re.fullmatch(r"[0-9a-f]{12}", rid) and rid != given
    assert t.headers["X-Request-ID"] != j.headers["X-Request-ID"]
