"""The PyTorch port stands alone: it imports no JAX and nothing of the
JAX package, and its served path needs neither pydantic, transformers
nor requests (remote dispatch relays over ``urllib``).
"""

import ast
import os
import pkgutil
import subprocess
import sys

import llm_sharding_demo_tpu_torch as port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(port.__file__)
FORBIDDEN = ("jax", "jaxlib", "llm_sharding_demo_tpu", "optax", "pydantic",
             "transformers", "requests")


def _sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    bad = [(os.path.relpath(p, ROOT), name) for p in _sources()
           for name in _imported_roots(p) if name in FORBIDDEN]
    assert not bad, bad


def test_no_module_imports_the_repos_tools_package():
    """The port keeps its own trimmed copies of what it needs from the
    repo's ``tools/`` (the cost model's planning terms): no port module
    and not chip_smoke.py imports ``tools`` (the port's own
    ``llm_sharding_demo_tpu_torch.tools`` is imported by its full name
    or relatively)."""
    bad = [os.path.relpath(p, ROOT) for p in _sources()
           if "tools" in _imported_roots(p)]
    assert not bad, bad


PLANNING = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils import graftsched, graftwatch
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
import torch
cfg = gpt2.GPT2Config(vocab_size=64, n_positions=32, n_embd=32, n_layer=2,
                      n_head=2)
model = (cfg, gpt2.init_params(cfg, torch.Generator().manual_seed(0)))
app = create_app(ServingConfig(model_id="t", max_seq=32, max_batch=2,
                               batch_mode="iter", kv_pool_blocks=8,
                               auto_plan_continuous=True,
                               auto_plan_traffic="4/3"),
                 model=model, tokenizer=ByteTokenizer(), device="cpu")
r = TestClient(app).post("/generate", json={{"prompt": "\x01\x02\x03\x04",
                                            "max_new_tokens": 3}})
assert r.status_code == 200, r.json()
assert app.plan_switcher.certified["solo"]["shape_total"] == 2
assert graftsched.mode() == "trace"
print("ok")
"""


def test_continuous_planning_runs_with_jax_and_tools_blocked():
    """A continuous-planning app certifies its plans and serves, traced
    by GRAFTSCHED, where neither JAX, the JAX package nor the repo's
    ``tools`` can be imported."""
    env = dict(os.environ, GRAFTSCHED="trace")
    out = subprocess.run(
        [sys.executable, "-c",
         PLANNING.format(forbidden=FORBIDDEN + ("tools",))], cwd=ROOT,
        capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_imports_with_jax_blocked():
    """Every module imports in a fresh interpreter where jax, jaxlib, the
    JAX package, pydantic and transformers cannot be imported."""
    modules = sorted(m.name for m in pkgutil.walk_packages(
        [PKG], prefix="llm_sharding_demo_tpu_torch."))
    assert "llm_sharding_demo_tpu_torch.serving.app" in modules
    for name in ("ops.decode_layer", "ops.rope", "models.llama",
                 "ops.flash_attention", "training.train",
                 "ops.paged_attention", "ops.kv_quant", "runtime.kv_pool",
                 "runtime.prefix_cache", "runtime.kv_tier",
                 "runtime.batcher", "runtime.spec_decode",
                 "utils.graftfault", "serving.http", "models.moe",
                 "models.hf_convert", "utils.checkpoint",
                 "tools.convert_hf", "serving.loader", "utils.grafttime",
                 "utils.grafttrend", "loadgen.profiles", "utils.graftwatch",
                 "utils.graftsched", "utils.costmodel"):
        assert f"llm_sharding_demo_tpu_torch.{name}" in modules
    code = "; ".join([
        "import sys",
        *(f"sys.modules[{name!r}] = None" for name in FORBIDDEN),
        "import importlib",
        *(f"importlib.import_module({m!r})" for m in modules),
        "print('ok')",
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


RELAY = """
import sys
for name in {forbidden!r}:
    sys.modules[name] = None
import torch
from llm_sharding_demo_tpu_torch.models import gpt2
from llm_sharding_demo_tpu_torch.serving.app import create_app
from llm_sharding_demo_tpu_torch.serving.http import TestClient, serve
from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
cfg = gpt2.GPT2Config(vocab_size=64, n_positions=16, n_embd=32, n_layer=2,
                      n_head=2)
model = (cfg, gpt2.init_params(cfg, torch.Generator().manual_seed(0)))
def app(**kw):
    return create_app(ServingConfig(model_id="t", max_seq=16, **kw),
                      model=model, tokenizer=ByteTokenizer(), device="cpu")
shards = [serve(app(shard_role=r), host="127.0.0.1", port=0, block=False)
          for r in ("a", "b")]
a, b = (f"127.0.0.1:{{s.server_address[1]}}" for s in shards)
coord = TestClient(app(dispatch="remote", shard_a_service=a,
                       shard_b_service=b))
body = {{"prompt": "\\x01", "max_new_tokens": 3, "mode": "greedy"}}
r = coord.post("/generate", json=body, headers={{"X-Request-ID": "r1"}})
assert r.status_code == 200 and r.headers["X-Request-ID"] == "r1", r.json()
assert r.json() == TestClient(app()).post("/generate", json=body).json()
for s in shards:
    s.shutdown()
print("ok")
"""


def test_remote_relay_runs_with_jax_blocked():
    """The three-role topology (two shards over real sockets, a remote
    coordinator relaying through them) serves a request in an
    interpreter where the forbidden packages cannot be imported."""
    out = subprocess.run(
        [sys.executable, "-c", RELAY.format(forbidden=FORBIDDEN)], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
