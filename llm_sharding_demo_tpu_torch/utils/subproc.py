"""Watchdogged child processes with a line filter on their output.

Counterpart of ``llm_sharding_demo_tpu/utils/subproc.py``. A child's
stdout and stderr stream, merged, to this process's stdout, minus the
lines that carry a ``drop`` marker; a kill timer bounds the child's wall
clock (a blocking readline cannot time out by itself), and a failure on
this side kills the child, so it never blocks on a full pipe with no
reader.
"""

from __future__ import annotations

import subprocess
import threading
from typing import Optional, Sequence

# the JAX package's markers (its XLA AOT loader's per-hit log lines);
# harmless where no child prints them
AOT_SPEW_MARKERS = ("cpu_aot_loader", "machine feature")


def run_filtered(cmd: Sequence[str], *, env: Optional[dict] = None,
                 cwd: Optional[str] = None, timeout_s: float,
                 drop: Sequence[str] = AOT_SPEW_MARKERS) -> int:
    """Run ``cmd`` streaming its combined output to stdout minus lines
    containing any ``drop`` marker. Returns the exit code; raises
    ``TimeoutError`` when the watchdog killed the child."""
    proc = subprocess.Popen(list(cmd), env=env, cwd=cwd,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            errors="replace")
    # The timer sets ``killed`` before it kills, and only a live child
    # can be killed: a child that exited nonzero on its own, even just
    # before the timer fired, keeps its own code. Whether the timer
    # thread is still alive cannot tell the two apart.
    killed = threading.Event()

    def _watchdog_kill():
        if proc.poll() is None:
            killed.set()
            proc.kill()

    timer = threading.Timer(timeout_s, _watchdog_kill)
    timer.start()
    try:
        assert proc.stdout is not None
        for line in proc.stdout:
            if any(marker in line for marker in drop):
                continue
            print(line, end="", flush=True)
        # no timeout here: the kill timer bounds the child
        rc = proc.wait()
    except BaseException:
        # a failure on this side mid-stream (SIGINT, a broken pipe):
        # never leave a child blocked on a pipe nobody reads
        proc.kill()
        raise
    finally:
        timer.cancel()
    if rc != 0 and killed.is_set():
        raise TimeoutError(f"child exceeded the {timeout_s:g}s watchdog")
    return rc
