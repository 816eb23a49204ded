"""A continuous-planning server driven through the agentic mix.

Builds an ``AUTO_PLAN_CONTINUOUS`` server in process from the env
contract (``PLAN_ENV``: ``KV_POOL_BLOCKS=256 KV_BLOCK_SIZE=16
MAX_BATCH=8 BATCH_MODE=iter MAX_SEQ=1024``, ``AUTO_PLAN_TRAFFIC`` from
the schedule's own classes), seeded GPT-2 weights and a tokenizer whose
replies name their token ids, then runs 10 ``agentic`` arrivals serial,
open at 60x the profile's rate and serial, twice, and prints each run's
forwards (``DecodeEngine.forward_shapes``), tokens/s and p50, the plan
switches, the int8 kernels' launches those forwards predict, the
certified shape totals, the shapes the replay added and whether the
replies of every run are equal. ``chip_smoke.py`` (its ``plan`` phase)
drives the same server on the card and checks it.

    python -m llm_sharding_demo_tpu_torch.tools.plan_drive            # card
    python -m llm_sharding_demo_tpu_torch.tools.plan_drive --tiny --device cpu

``--tiny`` serves a 2-layer, 64-wide fp32 GPT-2 of vocab 256 (the
rehearsal of the card run on the CPU: the serial runs' forwards and the
switches do not depend on the width; an open run's widths depend on
timing); without it GPT-2 124M int8.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Dict, Optional

PLAN_SEED = 7        # the agentic schedule's seed
PLAN_N = 10          # arrivals a run
PLAN_RATE = 60.0     # the open burst's multiple of the profile's rate
PLAN_ENV = {"AUTO_PLAN_CONTINUOUS": "1", "KV_POOL_BLOCKS": "256",
            "KV_BLOCK_SIZE": "16", "MAX_BATCH": "8", "BATCH_MODE": "iter",
            "MAX_SEQ": "1024", "INFERENCE_DTYPE": "int8",
            "MODEL_ID": "gpt2"}
# serial, the burst, serial: one mix
MIX = (("serial", 1.0), ("open", PLAN_RATE), ("serial", 1.0))


class IdTokenizer:
    """Text to its UTF-8 byte ids, ids back to ``<id>`` each: a reply then
    names its token ids."""

    eos_token_id = None

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return "".join(f"<{int(i)}>" for i in ids)


@contextlib.contextmanager
def environ(values: Dict[str, Optional[str]]):
    """``os.environ`` with ``values`` set (None: unset), restored after."""
    saved = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def plan_traffic() -> str:
    """``AUTO_PLAN_TRAFFIC`` from the schedule's own (prompt bytes,
    max_new) classes: with a byte tokenizer bytes are tokens."""
    from .. import loadgen

    arrivals = loadgen.schedule(loadgen.profile("agentic"), PLAN_SEED, PLAN_N)
    classes = sorted({(len(a.prompt.encode("utf-8")), a.max_new)
                      for a in arrivals})
    return ",".join(f"{p}/{n}" for p, n in classes)


def plan_app(model, tokenizer, device, **env):
    """An in-process server from the env contract with ``PLAN_ENV`` and
    ``env`` set (None unsets a knob): ``(client, recorder, registry)``."""
    from ..serving.app import create_app
    from ..serving.http import TestClient
    from ..utils.config import from_env
    from ..utils.metrics import MetricsRegistry
    from ..utils.tracing import FlightRecorder

    with environ({**PLAN_ENV, "AUTO_PLAN_TRAFFIC": plan_traffic(), **env}):
        cfg = from_env()
        registry, recorder = MetricsRegistry(), FlightRecorder(capacity=256)
        app = create_app(cfg, model=model, tokenizer=tokenizer, device=device,
                         registry=registry, recorder=recorder)
    return TestClient(app), recorder, registry


def plan_run(client, recorder, mode: str, rate: float = 1.0) -> dict:
    """One agentic run's load report; raises if the pool's conservation
    broke at ``/healthz`` after it."""
    from .. import loadgen

    rep = loadgen.run_load(client, loadgen.profile("agentic"), seed=PLAN_SEED,
                           n=PLAN_N, mode=mode, rate_scale=rate,
                           recorder=recorder)
    st = client.get("/healthz").json()["kv_pool_stats"]
    if st["blocks_in_use"] + st["blocks_free"] != st["blocks_total"]:
        raise AssertionError(f"pool conservation broke at /healthz: {st}")
    return rep


def replies(rep: dict) -> list:
    return [(o.status, o.generated) for o in rep["outcomes"]]


def expected_launches(shapes: dict, n_layer: int) -> dict:
    """A paged GPT-2 int8 engine's launches from its forwards (``{(B, T):
    n}``): the int8 linear at the 4 projections of each of ``n_layer``
    layers and the tied head on each forward of <= 16 rows; nothing
    else."""
    from ..ops import cuda_build
    from ..ops.quant import MAX_KERNEL_ROWS

    want = {k.name: 0 for k in cuda_build.KERNELS}
    for (b, t), n in shapes.items():
        if b * t <= MAX_KERNEL_ROWS:
            want["quant_linear"] += 4 * n_layer * n
            want["quant_head"] += n
    return want


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu: the rehearsal)")
    ap.add_argument("--tiny", action="store_true",
                    help="a 2-layer fp32 GPT-2 instead of GPT-2 124M int8")
    args = ap.parse_args()
    import torch

    from ..models import gpt2
    from ..utils.device import resolve_device

    dev = resolve_device(args.device)
    env = {}
    if args.tiny:
        cfg = gpt2.GPT2Config(vocab_size=256, n_positions=1024, n_embd=64,
                              n_layer=2, n_head=2)
        env["INFERENCE_DTYPE"] = "float32"
    else:
        cfg = gpt2.CONFIGS["gpt2"]
    params = gpt2.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    client, recorder, _ = plan_app((cfg, params), IdTokenizer(), dev, **env)
    sw = client.app.plan_switcher
    eng = sw.plans["solo"].engine
    print(f"AUTO_PLAN_TRAFFIC={plan_traffic()}; certified shapes "
          f"{ {k: v['shape_total'] for k, v in sw.certified.items()} }")
    runs, first = [], None
    for _ in range(2):
        for mode, rate in MIX:
            before = eng.forward_shapes()
            rep = plan_run(client, recorder, mode, rate)
            after = eng.forward_shapes()
            delta = {k: n - before.get(k, 0) for k, n in sorted(after.items())
                     if n != before.get(k, 0)}
            runs.append(replies(rep))
            print(f"{mode}: {sum(delta.values())} forwards {delta}; "
                  f"{rep['throughput_tokens_per_sec']} tokens/s, p50 e2e "
                  f"{rep['p50_e2e_ms']} ms")
        if first is None:
            first = eng.forward_shapes()
    shapes = eng.forward_shapes()
    print("switches", [(e["wave"], e["from"], e["to"]) for e in sw.events()
                       if e["switched"]], f"of {len(sw.events())} waves")
    print(f"{sum(shapes.values())} forwards predict launches "
          f"{expected_launches(shapes, cfg.n_layer)}")
    print("outside the certified set", sw.uncertified_shapes(shapes),
          "; the replay's new shapes", sorted(k for k in shapes
                                              if k not in first))
    print("every run's replies equal to the first's:",
          all(r == runs[0] for r in runs))


if __name__ == "__main__":
    main()
