"""Open-loop workload generation: seeded, replayable request schedules.

The open-loop discipline (the serving-benchmark standard): requests
arrive at times drawn ONCE from a Poisson process and do not slow down
when the server falls behind — queueing delay shows up in TTFT instead
of silently throttling the offered load, which is exactly the failure
mode a closed loop hides.

Everything is derived from ``LoadSpec.seed`` through one
``random.Random`` stream: same spec → token-identical schedule (arrival
times, prompts, budgets, sampling overrides, cancellations), the replay
contract ``transport.chaos`` established for faults applied to traffic.
Stdlib-only — the schedule can be generated (and asserted on) without
torch. A copy of ``mpit_tpu/loadgen/workload.py``: the same spec gives the
reference's schedule.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Optional

# (lo, hi, weight): lengths drawn uniformly from [lo, hi), buckets drawn
# by weight — the mixed prompt/output regimes of real traffic (short
# chat, long context, long generation) in one schedule
Buckets = tuple


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """One frozen spec per run (the ChaosConfig idiom).

    ``rate`` is the Poisson arrival rate in requests/second — the
    offered load, independent of service capacity. Per-request e2e SLOs
    scale with the budget (``slo_base_ms + slo_per_token_ms * max_new``)
    so a long generation is not penalized for being long; goodput then
    measures scheduling, not workload mix. ``temperatures``/``top_ps``
    are per-request override choices (empty = server defaults; only
    valid against a sampling server). ``cancel_prob`` of the requests
    abandon mid-stream, ``cancel_after_s`` (±50%) after arrival."""

    requests: int = 32
    rate: float = 100.0
    seed: int = 0
    prompt_buckets: Buckets = ((1, 8, 0.6), (8, 24, 0.3), (24, 40, 0.1))
    output_buckets: Buckets = ((2, 8, 0.6), (8, 20, 0.4))
    cancel_prob: float = 0.0
    cancel_after_s: float = 0.05
    temperatures: tuple = ()
    top_ps: tuple = ()
    slo_base_ms: float = 1000.0
    slo_per_token_ms: float = 100.0

    def __post_init__(self):
        if self.requests < 1:
            raise ValueError("requests must be >= 1")
        if self.rate <= 0:
            raise ValueError("rate must be > 0")
        if not (0.0 <= self.cancel_prob <= 1.0):
            raise ValueError("cancel_prob must be in [0, 1]")
        for name, buckets in (
            ("prompt_buckets", self.prompt_buckets),
            ("output_buckets", self.output_buckets),
        ):
            if not buckets:
                raise ValueError(f"{name} must be non-empty")
            for lo, hi, w in buckets:
                if lo < 1 or hi <= lo or w <= 0:
                    raise ValueError(
                        f"{name} entry ({lo}, {hi}, {w}) needs "
                        "1 <= lo < hi and weight > 0"
                    )


@dataclasses.dataclass
class Request:
    """One scheduled request. ``rid`` is filled by the harness at submit
    time — the join key between the schedule and the server's journal."""

    arrival_s: float
    prompt: tuple
    max_new: int
    slo_ms: float
    cancel_after_s: Optional[float] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    rid: Optional[int] = None


def _pick_len(rng: random.Random, buckets) -> int:
    total = sum(w for _, _, w in buckets)
    x = rng.random() * total
    for lo, hi, w in buckets:
        x -= w
        if x <= 0:
            return rng.randrange(lo, hi)
    lo, hi, _ = buckets[-1]
    return rng.randrange(lo, hi)


def make_workload(
    spec: LoadSpec, vocab_size: int, max_len: Optional[int] = None
) -> list[Request]:
    """The schedule: ``spec.requests`` Requests in arrival order.

    ``max_len`` is the server's effective horizon (``model.max_len``
    minus any shared prefix; None for horizon-free RNNs): drawn lengths
    are clamped so ``prompt + max_new <= max_len`` with at least one
    token of each — a spec can oversubscribe the horizon without
    producing requests ``submit`` would reject. Token values are drawn
    from ``[1, vocab_size)`` (0 left out as the conventional pad id).
    """
    if vocab_size < 2:
        raise ValueError("vocab_size must be >= 2")
    rng = random.Random(spec.seed)
    t = 0.0
    out: list[Request] = []
    for _ in range(spec.requests):
        t += rng.expovariate(spec.rate)
        p_len = _pick_len(rng, spec.prompt_buckets)
        m_new = _pick_len(rng, spec.output_buckets)
        if max_len is not None:
            p_len = max(1, min(p_len, max_len - 1))
            m_new = max(1, min(m_new, max_len - p_len))
        # every draw below happens unconditionally so the stream stays
        # aligned across spec knob changes that don't touch it
        cancel_draw = rng.random()
        cancel_jitter = rng.random()
        temp = rng.choice(spec.temperatures) if spec.temperatures else None
        top_p = rng.choice(spec.top_ps) if spec.top_ps else None
        prompt = tuple(
            rng.randrange(1, vocab_size) for _ in range(p_len)
        )
        out.append(Request(
            arrival_s=t,
            prompt=prompt,
            max_new=m_new,
            slo_ms=spec.slo_base_ms + spec.slo_per_token_ms * m_new,
            cancel_after_s=(
                spec.cancel_after_s * (0.5 + cancel_jitter)
                if cancel_draw < spec.cancel_prob else None
            ),
            temperature=temp,
            top_p=top_p,
        ))
    return out
