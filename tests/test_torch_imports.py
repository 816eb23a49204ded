"""The PyTorch port stands alone: it imports no JAX and nothing of the
JAX package, and its served path needs neither pydantic nor transformers.
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
             "transformers")


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
                 "runtime.batcher", "runtime.spec_decode"):
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
