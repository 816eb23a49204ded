"""Prefix-cache affinity: route by the prefix registry's own content keys.

Counterpart of ``llm_sharding_demo_tpu/fleet/affinity.py``. The router's
notion of "same prefix" is the registry's: the affinity key is
``PrefixCachingEngine._key`` of the prompt's first chunk, so requests
that share a cached prefix land where its blocks are warm. One chunk
deep: the first chunk is the widest unit the registry caches, and deeper
keys would split traffic that shares a system prompt and diverges later.
A prompt too short to have a cacheable prefix has no key and is placed
by load.

The placement is a consistent-hash ring (sha256 points, ``VNODES``
virtual nodes a replica): adding or draining one replica remaps only its
arc of keys.
"""

from __future__ import annotations

import hashlib
from bisect import bisect_left
from typing import List, Optional, Sequence

import numpy as np

from ..runtime.prefix_cache import PrefixCachingEngine

# where the affinity key comes from: this module calls it and derives no
# content key of its own
AFFINITY_KEY_SOURCE = ("llm_sharding_demo_tpu_torch/runtime/prefix_cache.py"
                       ":PrefixCachingEngine._key")

# virtual nodes a replica on the ring
VNODES = 64


def affinity_key(prompt_ids: Sequence[int], chunk: int) -> Optional[bytes]:
    """The routing key of a tokenized prompt: the registry's content key
    of its first full chunk, or None when the prompt has no cacheable
    prefix (fewer than ``chunk + 1`` tokens: the registry leaves at least
    one token to forward)."""
    prompt = np.asarray(prompt_ids, dtype=np.int32).reshape(-1)
    if (len(prompt) - 1) // chunk < 1:
        return None
    return PrefixCachingEngine._key(prompt, 1, chunk)


class HashRing:
    """Consistent-hash placement over replica names (sha256 points, the
    same in every process, unlike the builtin ``hash``)."""

    def __init__(self, names: Sequence[str], vnodes: int = VNODES):
        if not names:
            raise ValueError("HashRing needs at least one replica name")
        # immutable once built: reads need no lock
        pts = []
        for name in names:
            for i in range(vnodes):
                h = hashlib.sha256(f"{name}#{i}".encode()).digest()
                pts.append((int.from_bytes(h[:8], "big"), name))
        pts.sort()
        self._ring_points: List[int] = [p for p, _ in pts]
        self._ring_owners: List[str] = [o for _, o in pts]

    def pick(self, key: bytes) -> str:
        """The replica owning ``key``'s arc (the first point clockwise)."""
        h = int.from_bytes(hashlib.sha256(key).digest()[:8], "big")
        i = bisect_left(self._ring_points, h)
        if i == len(self._ring_points):
            i = 0
        return self._ring_owners[i]
