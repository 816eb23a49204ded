"""The port's lock tracer and fault plan against the JAX package's.

graftsched: the environment knobs, plain locks when unarmed, the
step-mode race fixtures (the ``Cell`` lost update, ``trace_admission``'s
overshoot against ``admit_alloc``'s none, a runtime lock-order
inversion), each one finding a seed and the same finding as the JAX
package's; a deadlock found by its acquisition timeout with the wait-for
chain, in a choreography no worker's load can reorder (every thread is
blocked before the timed acquisition starts); contention accounting and
its timeline events; the declared lock names against the JAX package's;
and an armed pooled server under an open burst (no finding, no lock
left held). graftfault: the ``GRAFTFAULT*`` plan gives the JAX
package's injection sequence over the same order of site calls, and
stays off unarmed.
"""

import os
import re
import threading
import time

import pytest

from llm_sharding_demo_tpu.runtime.kv_pool import (
    BlockAllocator as JBlockAllocator)
from llm_sharding_demo_tpu.utils import graftfault as jgraftfault
from llm_sharding_demo_tpu.utils import graftsched as jgraftsched
from llm_sharding_demo_tpu_torch import loadgen
from llm_sharding_demo_tpu_torch.runtime.kv_pool import BlockAllocator
from llm_sharding_demo_tpu_torch.utils import (graftfault, graftsched,
                                               grafttime)
from test_torch_grafttime import port_state_isolation  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (graftsched, BlockAllocator),
            "jax": (jgraftsched, JBlockAllocator)}
# the JAX package's pinned seeds (tests/test_graftlock.py)
LOST_UPDATE_SEED, LOST_UPDATE_SERIAL_SEED, OVERSHOOT_SEED = 0, 2, 4


@pytest.fixture(autouse=True)
def tracer_state(monkeypatch):
    """Both tracers cleared around each test, with GRAFTSCHED unset."""
    monkeypatch.delenv("GRAFTSCHED", raising=False)
    monkeypatch.delenv("GRAFTSCHED_SEED", raising=False)
    for gs, _ in PACKAGES.values():
        gs.clear()
    yield
    for gs, _ in PACKAGES.values():
        gs.clear()


def finding_key(f) -> tuple:
    return (f.rule, f.path, f.line, f.scope, f.seed)


@pytest.mark.parametrize("value,mode", [("", ""), ("0", ""), ("1", "sched"),
                                        ("trace", "trace"), ("yes", "sched")])
def test_env_knobs_equal_jax(monkeypatch, value, mode):
    monkeypatch.setenv("GRAFTSCHED", value)
    monkeypatch.setenv("GRAFTSCHED_SEED", "oops" if value == "yes" else "9")
    for gs, _ in PACKAGES.values():
        assert gs.mode() == mode
        assert gs.enabled() == bool(mode)
        assert gs.seed() == (0 if value == "yes" else 9)
        lk, rl = gs.lock("fx.plain"), gs.rlock("fx.plain_r")
        if mode:
            assert isinstance(lk, gs.TracedLock) and not lk.reentrant
            assert isinstance(rl, gs.TracedLock) and rl.reentrant
        else:
            # unarmed: the plain threading primitives, nothing traced
            assert type(lk) is type(threading.Lock())
            assert type(rl) is type(threading.RLock())


# -- step-mode race fixtures: one finding a seed, the JAX package's -------------


def run_lost_update(gs, seed):
    gs.clear()
    h = gs.Harness(seed=seed, step=True)
    cell = gs.Cell(0, name="gauge")

    def inc():
        v = cell.get()
        cell.set(v + 1)

    with h.use():
        h.run([inc, inc], timeout=30)
    return h, cell


def test_cell_lost_update_equals_jax():
    got = {side: run_lost_update(gs, LOST_UPDATE_SEED)
           for side, (gs, _) in PACKAGES.items()}
    h, cell = got["port"]
    assert [f.rule for f in h.findings] == ["lost-update"]
    f = h.findings[0]
    assert f.path == "test_torch_graftsched.py" and f.line > 0
    assert f.seed == LOST_UPDATE_SEED and cell.value == 1
    jh, jcell = got["jax"]
    assert [finding_key(x) for x in h.findings] == \
        [finding_key(x) for x in jh.findings]
    assert f.message == jh.findings[0].message and jcell.value == 1
    # the same seed replays; a seed whose schedule runs serially finds
    # nothing, in both packages
    h2, _ = run_lost_update(graftsched, LOST_UPDATE_SEED)
    assert [finding_key(x) for x in h2.findings] == [finding_key(f)]
    for gs, _ in PACKAGES.values():
        h3, cell3 = run_lost_update(gs, LOST_UPDATE_SERIAL_SEED)
        assert h3.findings == [] and cell3.value == 2


def run_admission(gs, alloc_cls, seed, atomic):
    gs.clear()
    h = gs.Harness(seed=seed, step=True)
    # built unarmed: the pinned seed schedules only trace_admission's
    # yield points
    alloc = alloc_cls(10, 4, watermark=0.5, sanitize=False)
    gs.trace_admission(alloc)
    grants = []

    def admit():
        if atomic:
            ids = alloc.admit_alloc(3)
            if ids:
                grants.append(ids)
        elif alloc.can_admit(3):
            # the check and the grant under separate allocator holds
            grants.append(alloc.alloc(3))

    with h.use():
        h.run([admit, admit], timeout=30)
    return h, alloc, grants


def test_check_then_act_overshoot_equals_jax():
    got = {side: run_admission(gs, cls, OVERSHOOT_SEED, atomic=False)
           for side, (gs, cls) in PACKAGES.items()}
    h, _, grants = got["port"]
    assert [f.rule for f in h.findings] == ["atomic-check-act"]
    assert "overshoot" in h.findings[0].message
    assert "admit_alloc" in h.findings[0].message
    assert len(grants) == 2                # 6 blocks > the watermark's 5
    jh = got["jax"][0]
    assert [finding_key(x) for x in h.findings] == \
        [finding_key(x) for x in jh.findings]
    assert h.findings[0].message == jh.findings[0].message


def test_admit_alloc_never_overshoots_under_the_same_schedule():
    for gs, cls in PACKAGES.values():
        h, alloc, grants = run_admission(gs, cls, OVERSHOOT_SEED, atomic=True)
        assert h.findings == []
        assert len(grants) == 1
        assert alloc.stats().blocks_in_use <= \
            alloc.watermark * alloc.num_blocks


def run_inversion(gs):
    gs.clear()
    h = gs.Harness(seed=7, step=False, jitter=0.0)
    a, b = h.lock("inv.A"), h.lock("inv.B")
    with h.use():
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    return h


def test_runtime_lock_order_inversion_equals_jax():
    h, jh = run_inversion(graftsched), run_inversion(jgraftsched)
    assert len(h.findings) == 1
    f = h.findings[0]
    assert f.rule == "lock-order" and "inversion" in f.message
    assert "opposite order" in f.message
    # both sites named, each a line of this file
    assert len(re.findall(r"test_torch_graftsched\.py:\d+", f.message)) == 2
    assert [(x.rule, x.message, x.line) for x in h.findings] == \
        [(x.rule, x.message, x.line) for x in jh.findings]


def run_deadlock(gs):
    """A three-lock cycle (A->B, B->C, C->A: no pairwise inversion
    anywhere). Each thread takes its first lock; the second and third
    then wait on their second with a long budget; only once both are
    registered as waiting does the first wait on B with a short budget,
    which must expire (B's holder waits on C, C's on A, A is held)."""
    gs.clear()
    locks = {n: gs.TracedLock(f"fx.{n}", timeout=60.0) for n in "ABC"}
    held = threading.Barrier(3)
    errors = []

    def waiting_on(names):
        with gs._STATE:
            return {lk.name for lk in gs._WAITING.values()} >= names

    def grab(first, second, budget, wait_for=()):
        def fn():
            with locks[first]:
                held.wait(30)
                deadline = time.monotonic() + 30
                while wait_for and not waiting_on(wait_for):
                    if time.monotonic() > deadline:
                        errors.append("peers never waited")
                        return
                    time.sleep(0.001)
                try:
                    if locks[second].acquire(timeout=budget):
                        locks[second].release()
                except gs.DeadlockError:
                    pass
        return fn

    threads = [threading.Thread(target=fn, daemon=True) for fn in (
        grab("A", "B", 0.05, wait_for={"fx.C", "fx.A"}),
        grab("B", "C", 60.0), grab("C", "A", 60.0))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errors and not any(t.is_alive() for t in threads)
    return gs.findings()


def test_deadlock_by_timeout_reports_the_wait_for_chain_as_jax():
    got, want = run_deadlock(graftsched), run_deadlock(jgraftsched)
    assert len(got) == 1
    f = got[0]
    assert f.rule == "lock-order" and "deadlock" in f.message
    assert "wait-for chain fx.B -> fx.C -> fx.A" in f.message
    assert f.path == "test_torch_graftsched.py"
    assert [(x.rule, x.message, x.line) for x in got] == \
        [(x.rule, x.message, x.line) for x in want]
    assert graftsched.held_locks() == []


def test_contention_accounting_and_timeline_events():
    """One acquisition that waits (its holder lets go only once the
    waiter is registered as waiting) and one that does not."""
    lk = graftsched.TracedLock("fx.contended")
    grafttime.clear()
    lk.acquire()
    waiter = threading.Thread(target=lambda: (lk.acquire(), lk.release()),
                              daemon=True)
    waiter.start()
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        with graftsched._STATE:
            if lk in graftsched._WAITING.values():
                break
        time.sleep(0.001)
    lk.release()
    waiter.join(30)
    c = graftsched.contention()["fx.contended"]
    assert (c["acquisitions"], c["contended"]) == (2, 1)
    assert c["wait_seconds"] > 0.001
    kinds = [e["kind"] for e in grafttime.events()
             if e.get("name") == "fx.contended"]
    assert kinds.count("lock_acquire") == 2
    assert kinds.count("lock_contend") == 1
    assert graftsched.held_locks() == []


def declared_locks(package_dir: str) -> dict:
    """``{name: file}`` of every ``graftsched.lock``/``rlock`` site."""
    out = {}
    pat = re.compile(r'graftsched\.r?lock\(\s*"([^"]+)"')
    for dirpath, _, files in os.walk(os.path.join(ROOT, package_dir)):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                for m in pat.finditer(open(path, encoding="utf-8").read()):
                    out[m.group(1)] = os.path.relpath(path, ROOT)
    return out


def test_declared_locks_carry_the_jax_names():
    """Every lock a ported module declares goes through graftsched under
    the JAX package's name; the one JAX lock without a port counterpart
    guards the jit compile watch, which eager PyTorch has no use for."""
    port = declared_locks("llm_sharding_demo_tpu_torch")
    ref = declared_locks("llm_sharding_demo_tpu")
    assert set(ref) - set(port) == {"metrics.CompileWatch._lock"}
    assert set(port) <= set(ref)
    assert len(port) == 21 and len(ref) == 22


def test_device_locks_carry_the_jax_timeout(monkeypatch):
    """Armed, the locks held across a whole generation (the paged
    runner's and the prefix store's) time out after the JAX package's
    600 s, every other declared lock after 15 s."""
    from llm_sharding_demo_tpu.fleet.harness import demo_model as jdemo
    from llm_sharding_demo_tpu.runtime.engine import DecodeEngine as JEngine
    from llm_sharding_demo_tpu.runtime.kv_pool import (
        KVBlockPool as JPool, PagedKVRunner as JRunner)
    from llm_sharding_demo_tpu.runtime.prefix_cache import (
        PrefixCachingEngine as JPrefix)
    from llm_sharding_demo_tpu_torch.fleet.harness import demo_model
    from llm_sharding_demo_tpu_torch.runtime.engine import DecodeEngine
    from llm_sharding_demo_tpu_torch.runtime.kv_pool import (KVBlockPool,
                                                             PagedKVRunner)
    from llm_sharding_demo_tpu_torch.runtime.prefix_cache import (
        PrefixCachingEngine)
    monkeypatch.setenv("GRAFTSCHED", "trace")
    got, want = {}, {}
    for out, eng_cls, pool_cls, runner_cls, prefix_cls, model, kw in (
            (got, DecodeEngine, KVBlockPool, PagedKVRunner,
             PrefixCachingEngine, demo_model(64, device="cpu"),
             {"device": "cpu"}),
            (want, JEngine, JPool, JRunner, JPrefix, jdemo(64), {})):
        eng = eng_cls(model[1], model[0], max_seq=64, **kw)
        pool = pool_cls.for_engine(eng, num_blocks=8, block_size=16)
        runner = runner_cls(eng, pool)
        prefix = prefix_cls(eng, capacity=2, chunk=16)
        out.update({lk.name: lk._timeout for lk in (
            runner._gen_lock, prefix._lock, prefix._store_lock,
            pool.allocator._lock, pool._dev_lock)})
    assert got == want
    assert got["kv_pool.PagedKVRunner._gen_lock"] == 600.0
    assert got["prefix_cache.PrefixCachingEngine._lock"] == 600.0
    assert got["kv_pool.BlockAllocator._lock"] == 15.0


def test_armed_pooled_server_under_a_burst(monkeypatch):
    """A pooled iteration server built with GRAFTSCHED=1 (seeded jitter)
    and GRAFTSAN=1 answers an open agentic burst: every lock traced, no
    finding, no lock left held, the pool's locks accounted."""
    from llm_sharding_demo_tpu_torch.fleet.harness import demo_model
    from llm_sharding_demo_tpu_torch.runtime import kv_pool
    from llm_sharding_demo_tpu_torch.serving.app import create_app
    from llm_sharding_demo_tpu_torch.serving.http import TestClient
    from llm_sharding_demo_tpu_torch.serving.tokenizer import ByteTokenizer
    from llm_sharding_demo_tpu_torch.utils.config import ServingConfig
    from llm_sharding_demo_tpu_torch.utils.metrics import MetricsRegistry
    from llm_sharding_demo_tpu_torch.utils.tracing import FlightRecorder
    monkeypatch.setenv("GRAFTSCHED", "1")
    monkeypatch.setenv("GRAFTSCHED_SEED", "11")
    monkeypatch.setenv("GRAFTSAN", "1")
    graftsched.clear()
    cfg = ServingConfig(model_id="graftsched-demo", max_seq=64, max_batch=3,
                        batch_mode="iter", batch_wait_ms=10.0,
                        kv_pool_blocks=12, kv_block_size=16)
    recorder = FlightRecorder(capacity=64)
    client = TestClient(create_app(
        cfg, model=demo_model(64, device="cpu"), tokenizer=ByteTokenizer(),
        device="cpu", registry=MetricsRegistry(), recorder=recorder))
    rep = loadgen.run_load(client, loadgen.profile("agentic"), seed=3, n=8,
                           rate_scale=20.0, mode="open", recorder=recorder)
    assert rep["completed"] == 8, rep["error_codes"]
    assert graftsched.findings() == []
    deadline = time.monotonic() + 10
    while graftsched.held_locks() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert graftsched.held_locks() == []
    names = set(graftsched.contention())
    assert {"kv_pool.BlockAllocator._lock",
            "iterbatch.IterBatchingEngine._stats_lock",
            "metrics.MetricsRegistry._lock"} <= names
    kv_pool.graftsan_sweep(timeout=10.0)


# -- graftfault's environment plan ------------------------------------------------


SITES = [("iterbatch.decode_seg", ("decode_transient", "decode_permanent",
                                   "decode_slow")),
         ("serving.admission", ("pool_spike",)),
         ("serving.shard_hop", ("reset", "timeout", "http_503", "slow")),
         ("kv_pool.admit_alloc", ("pool_spike",))]


@pytest.mark.parametrize("env", [
    {"GRAFTFAULT": "1", "GRAFTFAULT_SEED": "9", "GRAFTFAULT_RATE": "0.3"},
    {"GRAFTFAULT": "1", "GRAFTFAULT_SEED": "4", "GRAFTFAULT_RATE": "0.5",
     "GRAFTFAULT_SITES": "serving.admission, iterbatch.decode_seg",
     "GRAFTFAULT_KINDS": "pool_spike,decode_slow"},
    {"GRAFTFAULT": "1", "GRAFTFAULT_RATE": "bogus"},
])
def test_env_fault_plan_equals_jax(monkeypatch, env):
    """The same order of site calls under the same environment: the
    same outcome at every call, the same injection log."""
    for k in ("GRAFTFAULT", "GRAFTFAULT_SEED", "GRAFTFAULT_RATE",
              "GRAFTFAULT_SITES", "GRAFTFAULT_KINDS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sides = (graftfault, jgraftfault)
    for gf in sides:
        gf.reset()
    try:
        for gf in sides:
            assert gf.enabled()
        order = [SITES[i % len(SITES)] for i in (7 * k % 11
                                                 for k in range(200))]
        got = [graftfault.inject(site, *kinds) for site, kinds in order]
        want = [jgraftfault.inject(site, *kinds) for site, kinds in order]
        assert got == want and any(got)
        assert graftfault.plan() is graftfault.plan()    # built once
        assert [(i.site, i.kind, i.seq) for i in graftfault.plan().injections
                ] == [(i.site, i.kind, i.seq)
                      for i in jgraftfault.plan().injections]
        # an installed plan takes precedence over the environment's
        mine = graftfault.FaultPlan(seed=1, rate=0.0)
        with graftfault.use(mine):
            assert graftfault.plan() is mine
    finally:
        for gf in sides:
            gf.reset()


def test_unarmed_fault_plan_is_off(monkeypatch):
    for value in ("", "0"):
        monkeypatch.setenv("GRAFTFAULT", value)
        graftfault.reset()
        assert not graftfault.enabled()
        assert graftfault.plan() is None
        assert graftfault.inject("serving.admission", "pool_spike") is None
    monkeypatch.setenv("GRAFTFAULT", "1")
    assert graftfault.plan() is not None
    graftfault.reset()
    monkeypatch.delenv("GRAFTFAULT")
    assert graftfault.plan() is None
