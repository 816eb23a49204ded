"""The port's ``utils.subproc.run_filtered`` (the six cases of
``tests/test_subproc.py``, against the port's copy) and its CUDA form of
``utils.backend_probe.probe_default_backend``: a hang, a nonzero exit
and no device each give ``(None, reason)``, never a CPU success."""

import os
import sys
import time

import pytest

from llm_sharding_demo_tpu_torch.utils import backend_probe, subproc
from llm_sharding_demo_tpu_torch.utils.subproc import run_filtered


def test_filters_spew_and_passes_rc(capfd):
    rc = run_filtered(
        [sys.executable, "-c",
         "import sys;"
         "print('keep this line');"
         "print('E0000 cpu_aot_loader.cc:210] giant machine feature diff');"
         "print('also keep');"
         "sys.exit(3)"],
        timeout_s=60)
    assert rc == 3
    out = capfd.readouterr().out
    assert "keep this line" in out and "also keep" in out
    assert "cpu_aot_loader" not in out


def test_watchdog_kills_and_raises():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="watchdog"):
        run_filtered([sys.executable, "-c", "import time; time.sleep(60)"],
                     timeout_s=1.0)
    assert time.monotonic() - t0 < 30  # killed, not waited out


def test_expired_timer_that_killed_nothing_reports_child_rc(monkeypatch):
    """A timer that looks expired but never killed anything: the child's
    own nonzero exit comes through, not a ``TimeoutError``."""

    class _ExpiredNeverFired:
        def __init__(self, t, cb):
            pass

        def start(self):
            pass

        def cancel(self):
            pass

        def is_alive(self):
            return False

    monkeypatch.setattr(subproc.threading, "Timer", _ExpiredNeverFired)
    rc = run_filtered([sys.executable, "-c", "import sys; sys.exit(7)"],
                      timeout_s=60)
    assert rc == 7


def test_watchdog_kill_raises_even_while_timer_looks_alive(monkeypatch):
    """The watchdog killed the child while its thread still looks alive:
    the killed flag, not the thread, makes it a ``TimeoutError``."""

    class _FiresInsideStart:
        def __init__(self, t, cb):
            self._cb = cb

        def start(self):
            self._cb()

        def cancel(self):
            pass

        def is_alive(self):
            return True

    monkeypatch.setattr(subproc.threading, "Timer", _FiresInsideStart)
    with pytest.raises(TimeoutError, match="watchdog"):
        run_filtered([sys.executable, "-c", "import time; time.sleep(60)"],
                     timeout_s=60)


def test_timer_firing_after_own_exit_keeps_child_rc(monkeypatch):
    """The child exits nonzero on its own and only then does the timer
    fire: the callback finds no live child, sets no flag, and the child's
    own code comes through."""

    class _FiresAfterChildExit:
        def __init__(self, t, cb):
            self._cb = cb

        def start(self):
            time.sleep(1.5)     # the instant child has exited by now
            self._cb()

        def cancel(self):
            pass

        def is_alive(self):
            return False

    monkeypatch.setattr(subproc.threading, "Timer", _FiresAfterChildExit)
    rc = run_filtered([sys.executable, "-c", "import sys; sys.exit(5)"],
                      timeout_s=60)
    assert rc == 5


def test_stderr_merged_and_filtered(capfd):
    rc = run_filtered(
        [sys.executable, "-c",
         "import sys;"
         "sys.stderr.write('machine feature spew\\n');"
         "sys.stderr.write('real error context\\n')"],
        timeout_s=60)
    assert rc == 0
    out = capfd.readouterr().out
    assert "real error context" in out
    assert "machine feature" not in out


def test_probe_reports_no_cuda_device():
    """The real probe with every card hidden (this CPU build has none):
    ``(None, reason)``, not a CPU platform."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    platform, reason = backend_probe.probe_default_backend(120, env=env)
    assert platform is None
    assert reason.startswith("no CUDA device (attempt 1/1): torch ")


def test_probe_hang_is_a_reason_not_a_hang(monkeypatch):
    monkeypatch.setattr(backend_probe, "_PROBE_CODE",
                        "import time; time.sleep(60)")
    t0 = time.monotonic()
    platform, reason = backend_probe.probe_default_backend(
        1.0, attempts=2)
    assert time.monotonic() - t0 < 30
    assert platform is None
    assert reason == "CUDA probe hung >1s (attempt 2/2)"


def test_probe_nonzero_exit_and_success(monkeypatch):
    """A child that fails gives its code and the tail of its stderr; one
    that names a device gives ``("cuda", name)``."""
    monkeypatch.setattr(backend_probe, "_PROBE_CODE",
                        "import sys; sys.stderr.write('cuInit "
                        "failed'); sys.exit(2)")
    assert backend_probe.probe_default_backend(60) == (
        None, "CUDA probe rc=2 (attempt 1/1): cuInit failed")
    monkeypatch.setattr(backend_probe, "_PROBE_CODE",
                        "print('CUDA_DEVICE=NVIDIA H100 80GB HBM3')")
    assert backend_probe.probe_default_backend(60) == (
        "cuda", "NVIDIA H100 80GB HBM3")
