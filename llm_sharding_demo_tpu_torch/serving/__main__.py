"""Process entry point: ``python -m llm_sharding_demo_tpu_torch.serving``.

The port comes from ``SHARD_PORT`` (default 5000) or ``--port``; the
server runs on ``cuda``. At exit the process logs its kernel launch
counts (also on ``GET /healthz``).

The reference's three-role topology on one machine (each shard builds
the same seeded weights; the coordinator holds none and relays every
token through them)::

    SHARD_ROLE=a SHARD_PORT=5001 python -m llm_sharding_demo_tpu_torch.serving
    SHARD_ROLE=b SHARD_PORT=5002 python -m llm_sharding_demo_tpu_torch.serving
    DISPATCH=remote SHARD_A_SERVICE=127.0.0.1:5001 \
        SHARD_B_SERVICE=127.0.0.1:5002 \
        python -m llm_sharding_demo_tpu_torch.serving --port 5000

Multi-device decode (``PP_DECODE``, ``TP_DECODE``, ``EP_DECODE``) runs one
process a rank, each on ``cuda:{rank % device_count}`` over ``nccl``,
joined through ``COORDINATOR_ADDRESS`` (rank 0's host:port),
``NUM_PROCESSES`` and ``PROCESS_ID``: rank 0 serves HTTP, every other
rank follows it, and rank 0 stops them at exit::

    for r in 0 1; do COORDINATOR_ADDRESS=127.0.0.1:29500 NUM_PROCESSES=2 \
        PROCESS_ID=$r MODEL_ID=gpt2 PP_DECODE=1 BOUNDARIES=6 \
        python -m llm_sharding_demo_tpu_torch.serving --port 5000 & done
"""

from __future__ import annotations

import argparse
import atexit
import json
import logging
import signal
import sys

from ..ops import cuda_build
from ..parallel import distributed
from ..utils.config import from_env
from .app import create_app
from .http import serve


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=None,
                        help="default: SHARD_PORT env (5000)")
    args = parser.parse_args()
    cfg = from_env()
    # a multi-rank server joins its process group before any device work,
    # and leaves it last thing at exit
    if distributed.maybe_initialize():
        atexit.register(distributed.destroy)
    app = create_app(cfg)
    log = logging.getLogger(__name__)
    if app.mesh_runner is not None and distributed.rank() > 0:
        log.info("rank %d follows rank 0", distributed.rank())
        served = app.mesh_runner.follow()
        log.info("rank %d served %d requests; kernel_launches %s",
                 distributed.rank(), served,
                 json.dumps(cuda_build.launch_counts()))
        return
    if app.mesh_runner is not None:
        # the followers' loops end with rank 0's
        atexit.register(app.mesh_runner.stop_followers)
    atexit.register(lambda: log.info("kernel_launches %s", json.dumps(
        cuda_build.launch_counts())))
    # SIGTERM exits through the interpreter, so the atexit line is written
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    port = args.port if args.port is not None else cfg.shard_port
    log.info("serving role=%s dispatch=%s dtype=%s on %s:%d",
             cfg.shard_role, cfg.dispatch, cfg.inference_dtype, args.host,
             port)
    serve(app, host=args.host, port=port)


if __name__ == "__main__":
    main()
