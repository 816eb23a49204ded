"""Declared locks.

Trimmed counterpart of ``llm_sharding_demo_tpu/utils/graftsched.py``:
``lock(name)`` and ``rlock(name)``, the ways the runtime modules create
a lock. The name is the declaration key (``module.Class.attr``) the JAX
package's lock tracer reports under; with its tracing off (the default
there) it hands out a plain ``threading.Lock`` (or ``RLock``), and so
does this copy. The tracer, its step-mode harness and the deadlock
report wait for ROADMAP Queue 1 item 15.
"""

from __future__ import annotations

import threading


def lock(name: str) -> threading.Lock:
    """A plain lock for the declared ``name``."""
    del name  # the reporting key of the JAX package's tracer
    return threading.Lock()


def rlock(name: str) -> threading.RLock:
    """A plain reentrant lock for the declared ``name``."""
    del name
    return threading.RLock()
