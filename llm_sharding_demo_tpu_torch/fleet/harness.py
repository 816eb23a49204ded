"""A seeded fleet in one process: the router and its replicas.

Counterpart of ``llm_sharding_demo_tpu/fleet/harness.py``. Real
``serving.app.create_app`` instances (prefill replicas and decode
replicas) share one ``KVBlockPool`` in this process, fronted by a real
``serving/router.py`` app; everything speaks the serving dispatch path
(``serving/http.py`` ``TestClient``, no sockets), so a load profile
driven at the router runs the hops, sheds, breakers and block handoffs a
deployment would.

Every replica serves the same weights and the prefix store is exact, so
a greedy (fp32) reply is byte-equal to the single-replica path
(``build_single``) whichever replica served it. The keyword arguments
beyond the JAX package's: ``model=(config, params)`` serves given
weights (default ``demo_model``), ``device`` places the pool and the
engines (``cuda`` unless given), ``inference_dtype`` is every replica's
regime, and ``tokenizer`` replaces the byte tokenizer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


def demo_model(max_seq: int = 128, seed: int = 0, device=None):
    """The tiny demo model of the in-process harnesses: the JAX
    package's geometry (vocab 256, width 32, 2 layers, 4 heads) with
    normal(0.02) weights, zero biases and unit norms drawn from a seeded
    numpy generator (JAX's ``PRNGKey(0)`` draw has no torch
    counterpart: tests that compare the packages pass the JAX weights).
    Returns ``(config, params)`` on ``device`` (``cuda`` unless given)."""
    from ..models import gpt2
    from ..models.convert import params_from_numpy

    cfg = gpt2.GPT2Config(vocab_size=256, n_positions=max_seq, n_embd=32,
                          n_layer=2, n_head=4)
    rng = np.random.default_rng(seed)
    d, n, v = cfg.n_embd, cfg.n_layer, cfg.vocab_size

    def normal(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, np.float32)

    def ones(*shape):
        return np.ones(shape, np.float32)

    tree = {
        "wte": normal(v, d), "wpe": normal(max_seq, d),
        "blocks": {
            "ln_1": {"scale": ones(n, d), "bias": zeros(n, d)},
            "attn": {"c_attn": {"kernel": normal(n, d, 3 * d),
                                "bias": zeros(n, 3 * d)},
                     "c_proj": {"kernel": normal(n, d, d),
                                "bias": zeros(n, d)}},
            "ln_2": {"scale": ones(n, d), "bias": zeros(n, d)},
            "mlp": {"c_fc": {"kernel": normal(n, d, 4 * d),
                             "bias": zeros(n, 4 * d)},
                    "c_proj": {"kernel": normal(n, 4 * d, d),
                               "bias": zeros(n, d)}},
        },
        "ln_f": {"scale": ones(d), "bias": zeros(d)},
    }
    return cfg, params_from_numpy(tree, device=device)


@dataclasses.dataclass
class FleetHarness:
    """The router's client and every handle a test or a smoke run needs
    (pool conservation, per-replica registries, recorder joins)."""

    client: object                    # TestClient at the router
    app: object                       # the router's JSONApp
    topology: object                  # fleet.topology.FleetTopology
    pool: object                      # the shared KVBlockPool
    recorder: object                  # the router's FlightRecorder
    registry: object                  # the router's MetricsRegistry
    registries: Dict[str, object]     # replica name -> MetricsRegistry
    chunk: int = 64


def _model_and_device(model, device, max_seq: int):
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if model is None:
        model = demo_model(max_seq, device=dev)
    return model, dev


def build_fleet(n_decode: int = 2, n_prefill: int = 1,
                max_seq: int = 128, max_batch: int = 1,
                kv_pool_blocks: int = 0, kv_block_size: int = 16,
                chunk: int = 16, prefix_cache: int = 8,
                recorder_capacity: int = 512,
                hop_policy=None, *, model=None, device=None,
                inference_dtype: str = "float32",
                tokenizer=None) -> FleetHarness:
    """One shared-pool fleet: ``n_prefill`` prefill replicas (solo paged
    runners serving ``/prefill``) and ``n_decode`` decode replicas,
    with a router in front. ``max_batch=1`` serves decode through solo
    ``PagedKVRunner``s, where a registered prefix's blocks land in the
    row's table zero-copy; ``max_batch > 1`` puts the decode replicas
    on the pooled iteration batcher. ``kv_pool_blocks=0`` sizes the pool
    for every decode row at full depth plus two rows of headroom.
    ``chunk`` is both the prefix store's width and the router's affinity
    key width: one value, so the two cannot drift."""
    from ..runtime.kv_pool import KVBlockPool
    from ..serving.app import create_app
    from ..serving.http import TestClient
    from ..serving.router import create_router_app
    from ..serving.tokenizer import ByteTokenizer
    from ..utils.config import ServingConfig
    from ..utils.device import regime_of, torch_dtype
    from ..utils.metrics import MetricsRegistry
    from ..utils.tracing import FlightRecorder
    from .topology import FleetTopology, ReplicaHandle

    (cfg_model, params), dev = _model_and_device(model, device, max_seq)
    blocks_per_row = -(-max_seq // kv_block_size)
    if kv_pool_blocks <= 0:
        kv_pool_blocks = (n_decode * max_batch + 2) * blocks_per_row
    heads = getattr(cfg_model, "n_kv_head", cfg_model.n_head)
    # one pool for every replica, in the cache dtype of the regime
    pool = KVBlockPool(cfg_model.n_layer, kv_pool_blocks, heads,
                       kv_block_size, cfg_model.head_dim, max_seq,
                       dtype=torch_dtype(regime_of(inference_dtype)),
                       device=dev)
    tokenizer = tokenizer or ByteTokenizer()

    replicas: List[ReplicaHandle] = []
    registries: Dict[str, object] = {}

    def spawn(name: str, role: str, mb: int, mode: str) -> None:
        cfg = ServingConfig(
            model_id=f"graftfleet-{name}", shard_role="coordinator",
            max_seq=max_seq, boundaries=(1,), max_batch=mb,
            batch_mode=mode, batch_wait_ms=10.0,
            inference_dtype=inference_dtype,
            kv_pool_blocks=kv_pool_blocks, kv_block_size=kv_block_size,
            prefix_cache=prefix_cache, prefix_chunk=chunk,
            fleet_role=role)
        registry = MetricsRegistry()
        recorder = FlightRecorder(capacity=recorder_capacity)
        # ``replica=name`` labels the app's timeline events, so a fleet
        # run's one stream shows which replica each event happened on
        app = create_app(cfg, model=(cfg_model, params),
                         tokenizer=tokenizer, device=dev,
                         registry=registry, recorder=recorder,
                         kv_pool=pool, replica=name)
        registries[name] = registry
        replicas.append(ReplicaHandle(name=name, role=role,
                                      client=TestClient(app),
                                      recorder=recorder, app=app))

    for i in range(n_prefill):
        spawn(f"prefill{i}", "prefill", 1, "admission")
    for i in range(n_decode):
        spawn(f"decode{i}", "decode", max_batch,
              "iter" if max_batch > 1 else "admission")

    topology = FleetTopology(replicas)
    router_registry = MetricsRegistry()
    router_recorder = FlightRecorder(capacity=recorder_capacity)
    router_app = create_router_app(topology, tokenizer, chunk=chunk,
                                   registry=router_registry,
                                   recorder=router_recorder,
                                   hop_policy=hop_policy)
    return FleetHarness(client=TestClient(router_app), app=router_app,
                        topology=topology, pool=pool,
                        recorder=router_recorder,
                        registry=router_registry,
                        registries=registries, chunk=chunk)


def build_single(max_seq: int = 128, max_batch: int = 1,
                 kv_pool_blocks: int = 0, kv_block_size: int = 16,
                 chunk: int = 16, prefix_cache: int = 8,
                 recorder_capacity: int = 512, *, model=None,
                 device=None, inference_dtype: str = "float32",
                 tokenizer=None):
    """The single-replica path the fleet is held byte-equal against: the
    same weights and serving composition as one decode replica, its own
    pool, no router. Returns ``(client, recorder, registry)``."""
    from ..serving.app import create_app
    from ..serving.http import TestClient
    from ..serving.tokenizer import ByteTokenizer
    from ..utils.config import ServingConfig
    from ..utils.metrics import MetricsRegistry
    from ..utils.tracing import FlightRecorder

    (cfg_model, params), dev = _model_and_device(model, device, max_seq)
    if kv_pool_blocks <= 0:
        kv_pool_blocks = (max_batch + 2) * (-(-max_seq // kv_block_size))
    cfg = ServingConfig(
        model_id="graftfleet-single", shard_role="coordinator",
        max_seq=max_seq, boundaries=(1,), max_batch=max_batch,
        batch_mode="iter" if max_batch > 1 else "admission",
        batch_wait_ms=10.0, inference_dtype=inference_dtype,
        kv_pool_blocks=kv_pool_blocks, kv_block_size=kv_block_size,
        prefix_cache=prefix_cache, prefix_chunk=chunk)
    registry = MetricsRegistry()
    recorder = FlightRecorder(capacity=recorder_capacity)
    app = create_app(cfg, model=(cfg_model, params),
                     tokenizer=tokenizer or ByteTokenizer(), device=dev,
                     registry=registry, recorder=recorder)
    return TestClient(app), recorder, registry
