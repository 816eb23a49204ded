"""Seeded open-loop arrival schedules: pure functions of (seed, profile, k).

Counterpart of ``llm_sharding_demo_tpu/loadgen/schedule.py``, byte for
byte in what it draws. The generator is open-loop: arrival k fires at
its offset ``t_k`` whether or not earlier requests finished (a
closed-loop generator throttles itself exactly when the system
saturates, and its p99 then leaves out the queueing users feel).

Every field of arrival k (its gap, prompt, decode budget, deadline,
walk-away flag) is drawn from ``random.Random(f"{seed}/{name}/{k}")``,
so two schedules of one seed are byte-identical (``schedule_bytes`` is
the serialization to compare), and equal to the JAX package's. ``t_k``
is the running sum of the gaps. Prompts are ascii text; shared prefixes
depend on ``(profile, prefix_id)`` and not on the seed, so runs of
different seeds hit the same prefix-store entries, as system prompts do.
"""

from __future__ import annotations

import dataclasses
import json
import random
import string
from typing import List, Optional

from .profiles import WorkloadProfile

_ALPHABET = string.ascii_lowercase + "    "   # spaces keep text wordy


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request (the open-loop unit of work)."""

    k: int                      # arrival index within the run
    t: float                    # seconds from run start (open-loop)
    prompt: str
    max_new: int
    mode: str
    seed: int                   # per-request sampling seed (wire field)
    deadline_ms: Optional[int]  # X-Deadline-Ms budget, None = none
    abandoned: bool             # True: deadline IS the walk-away budget

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def shared_prefix(profile: WorkloadProfile, prefix_id: int) -> str:
    """The deterministic shared prefix ``prefix_id`` of a profile —
    seed-independent, so distinct load runs share store entries."""
    rng = random.Random(f"prefix/{profile.name}/{prefix_id}")
    return "".join(rng.choice(_ALPHABET)
                   for _ in range(profile.shared_prefix_len))


def _gap(profile: WorkloadProfile, rng: random.Random,
         rate_scale: float) -> float:
    """Inter-arrival gap BEFORE arrival k (arrival 0 fires at t=0)."""
    rate = max(profile.rate_rps * rate_scale, 1e-6)
    if profile.arrival == "bursty" and profile.burst > 1:
        # geometric burst membership: roughly 1/burst of arrivals start
        # a new burst (gap at the burst rate), the rest pile in behind
        # it — the clumping that stresses admission and queue depth
        if rng.random() < 1.0 / profile.burst:
            return rng.expovariate(rate / profile.burst)
        return 0.002
    return rng.expovariate(rate)


def arrival_fields(profile: WorkloadProfile, seed: int, k: int,
                   rate_scale: float = 1.0) -> dict:
    """Every draw for arrival k (gap included) — THE pure function.
    ``schedule`` only accumulates gaps into offsets."""
    rng = random.Random(f"{seed}/{profile.name}/{k}")
    gap = 0.0 if k == 0 else _gap(profile, rng, rate_scale)
    plen = rng.randint(*profile.prompt_len)
    parts = []
    if profile.cache_busting:
        # unique leading bytes: content-keyed reuse whiffs on purpose
        parts.append(f"bust-{seed}-{k}-")
    elif profile.shared_prefix_len > 0:
        # prefix_depth > 0 widens the draw past prefix_pool so a run
        # can touch more distinct prefixes than the device pool holds
        # (the grafttier spill driver); 0 keeps the historical draw,
        # and either way it is ONE randrange call so the rest of the
        # per-arrival draw sequence is byte-identical (replay pin).
        parts.append(shared_prefix(
            profile,
            rng.randrange(profile.prefix_depth
                          or max(profile.prefix_pool, 1))))
    need = max(plen - sum(len(p) for p in parts), 1)
    parts.append("".join(rng.choice(_ALPHABET) for _ in range(need)))
    abandoned = rng.random() < profile.abandon_rate
    deadline_ms = (profile.abandon_after_ms if abandoned
                   else profile.deadline_ms)
    return {
        "gap": gap,
        "prompt": "".join(parts),
        "max_new": rng.randint(*profile.max_new),
        "mode": profile.mode,
        "seed": rng.randrange(2 ** 31),
        "deadline_ms": deadline_ms,
        "abandoned": abandoned,
    }


def schedule(profile: WorkloadProfile, seed: int, n: int,
             rate_scale: float = 1.0) -> List[Arrival]:
    """The first ``n`` arrivals of ``(seed, profile)`` at
    ``rate_scale`` x the profile's declared rate. Replay-identical:
    same arguments, byte-identical schedule (pinned)."""
    out: List[Arrival] = []
    t = 0.0
    for k in range(n):
        f = arrival_fields(profile, seed, k, rate_scale)
        t += f.pop("gap")
        out.append(Arrival(k=k, t=round(t, 9), **f))
    return out


def schedule_bytes(profile: WorkloadProfile, seed: int, n: int,
                   rate_scale: float = 1.0) -> bytes:
    """Canonical serialization of the schedule — what the replay pin
    compares byte-for-byte."""
    rows = [a.to_dict() for a in schedule(profile, seed, n, rate_scale)]
    return json.dumps(rows, sort_keys=True,
                      separators=(",", ":")).encode()
