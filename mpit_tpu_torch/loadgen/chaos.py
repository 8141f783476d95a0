"""Seeded chaos for the serving loop: boundary delays and a mid-run kill.

The serving analogue of :class:`mpit_tpu_torch.transport.chaos.ChaosTransport`
with the same determinism contract — every fault is a pure function of
``(seed, boundary_index)`` via the shared :func:`_mix` hash, never of
wall-clock or scheduling jitter, so a failing soak seed replays the
identical fault schedule. The harness applies faults at scheduling
boundaries (the only points the host controls anyway):

- ``delay``: sleep before the boundary's segment — a stalled host /
  preempted core / GC pause. Rare large delays are the p99 story: a
  request unlucky enough to span a delayed boundary eats the whole
  stall, the median request never sees one (pinned in
  tests/test_loadgen.py: p99 moves, p50 stays).
- ``kill``: the server dies at boundary N — in-flight and queued
  requests are abandoned, which ``obs slo`` reports as ``unfinished``
  (goodput counts them against, a killed run can't hide its losses).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

from mpit_tpu_torch.transport.chaos import _mix

# domain separator: serving draws must not collide with wire-chaos
# draws made from the same user seed
_SERVE_STREAM = 0x5E12E


@dataclasses.dataclass(frozen=True)
class ServeChaos:
    """One frozen fault schedule for a load run.

    ``delay_p``: per-boundary probability of a stall; ``delay_s``: its
    magnitude (jittered ±50%, seeded); ``kill_after``: boundary index at
    which the server dies (None = never)."""

    seed: int = 0
    delay_p: float = 0.0
    delay_s: float = 0.02
    kill_after: Optional[int] = None

    def __post_init__(self):
        if not (0.0 <= self.delay_p <= 1.0):
            raise ValueError("delay_p must be in [0, 1]")
        if self.delay_s < 0:
            raise ValueError("delay_s must be >= 0")
        if self.kill_after is not None and self.kill_after < 0:
            raise ValueError("kill_after must be >= 0")

    def draw(self, boundary: int):
        """The fault for scheduling boundary ``boundary``:
        ``("kill", 0.0)``, ``("delay", seconds)``, or None. Stateless —
        replaying any boundary yields the identical draw."""
        if self.kill_after is not None and boundary >= self.kill_after:
            return ("kill", 0.0)
        if self.delay_p <= 0.0 or self.delay_s <= 0.0:
            return None
        rng = random.Random(_mix(self.seed, _SERVE_STREAM, boundary))
        if rng.random() >= self.delay_p:
            return None
        return ("delay", self.delay_s * (0.5 + rng.random()))
