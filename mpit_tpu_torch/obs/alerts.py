"""Online health alerts over live telemetry snapshots.

A copy of ``mpit_tpu/obs/alerts.py`` for the port.

The :class:`AlertEngine` evaluates the per-rank ``live/rank_<r>.json``
snapshots (written by :class:`mpit_tpu_torch.obs.live.LiveExporter`) against
three conditions and appends structured records to ``alerts.jsonl``:

- **dead_rank** — a rank's heartbeat (wall-clock ``t`` of its freshest
  snapshot) is stale relative to the freshest rank in the world, beyond
  ``staleness_factor`` x that rank's own export interval. Staleness is
  judged *relative* (max ``t`` across ranks, not the reader's clock) so
  the check is meaningful both in-flight and post-mortem: when the
  launcher tears the whole world down, the rank that died *first* is
  still the stale one.
- **straggler** — one training rank's rolling compute fraction (the
  ``train.compute_s`` counter's rolling rate — seconds of compute per
  wall second) is an outlier: the min-max spread across ranks exceeds
  ``straggler_spread`` and the flagged rank is the farthest from the
  median. A rank starved by a slow wire computes less per second; this
  is the signal a group leader will use to route around it.
- **slo_burn** — a serving rank's rolling SLO miss fraction, normalized
  by the error budget ``(1 - slo_target)``, exceeds ``burn_threshold``.
  Burn 1.0 means the budget is being consumed exactly as fast as it
  accrues; >1 means the run will blow its SLO if the window persists.
- **staleness_runaway** — a server rank's rolling push-staleness p99
  (the ``train.staleness`` histogram, docs/OBSERVABILITY.md "dynamics")
  jumps past ``staleness_runaway_factor`` x its OWN baseline (the
  median of its prior observations, floored at ``staleness_floor``
  units). Relative-to-self, so a topology whose steady state is 3
  updates of staleness doesn't false-positive where one whose steady
  state is 0.2 would.
- **divergence** — a client rank's elastic distance ‖x_local − x̃‖
  gauge grows strictly monotonically across ``divergence_windows``
  consecutive exports AND by more than ``divergence_factor`` overall —
  the EASGD exploration term failing to pull workers back to the
  center (unstable alpha/lr), caught while the run still has something
  to save. Histories advance only when a rank's snapshot ``seq``
  advances, so re-reading an unchanged snapshot set is idempotent.

Alerts deduplicate per ``(kind, rank)`` while the condition holds and
re-arm on recovery; existing ``alerts.jsonl`` content seeds the active
set so ``--once`` re-runs don't duplicate. Like the rest of the reader
side this module is stdlib-only — no jax, no transport imports.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
from typing import Mapping, Optional

from mpit_tpu_torch.obs.live import (
    M_ELASTIC_DIST,
    M_REQ_FINISHED,
    M_SLO_MISSES,
    M_STALENESS,
    compute_fraction,
    percentile_ms,
)

# per-rank dynamics histories are capped — the engine may outlive a long
# run and the conditions only ever look at a recent suffix
_HISTORY_CAP = 64


@dataclasses.dataclass(frozen=True)
class AlertConfig:
    """Thresholds for the three alert conditions.

    ``staleness_factor`` is multiplied by each rank's own export
    interval (with ``min_staleness_s`` as a floor) — one number that
    stays correct when ranks export at different rates."""

    staleness_factor: float = 3.0
    min_staleness_s: float = 1.0
    straggler_spread: float = 0.25
    min_compute_fraction: float = 0.02
    min_uptime_s: float = 1.0
    burn_threshold: float = 1.0
    slo_target: float = 0.95
    min_finished_rate: float = 0.5
    # training-dynamics rules (docs/OBSERVABILITY.md "dynamics")
    divergence_windows: int = 4
    divergence_factor: float = 2.0
    staleness_runaway_factor: float = 3.0
    staleness_floor: float = 1.0
    staleness_baseline_len: int = 3

    def __post_init__(self):
        if self.staleness_factor <= 0:
            raise ValueError("staleness_factor must be > 0")
        if not 0 < self.slo_target < 1:
            raise ValueError("slo_target must be in (0, 1)")
        if self.divergence_windows < 2:
            raise ValueError("divergence_windows must be >= 2")
        if self.divergence_factor <= 1.0:
            raise ValueError("divergence_factor must be > 1")
        if self.staleness_runaway_factor <= 1.0:
            raise ValueError("staleness_runaway_factor must be > 1")
        if self.staleness_floor <= 0:
            raise ValueError("staleness_floor must be > 0")
        if self.staleness_baseline_len < 1:
            raise ValueError("staleness_baseline_len must be >= 1")


def staleness_s(snap: dict, config: AlertConfig) -> float:
    interval = snap.get("interval_s") or 1.0
    return max(config.min_staleness_s, config.staleness_factor * interval)


class AlertEngine:
    """Evaluate snapshots, append newly-firing alerts to ``path``.

    ``path=None`` keeps the engine in-memory (tests, dashboards that
    only display). ``evaluate`` returns the records that fired *this*
    pass; an alert stays suppressed while its condition persists and
    re-arms once the condition clears.

    ``on_fire`` (optional) is called once per newly-fired record —
    the black-box trigger hook: ``obs live`` wires it to
    :func:`mpit_tpu_torch.obs.blackbox.request_dump` so a dead_rank /
    straggler / slo_burn / divergence firing freezes the incident
    window on every rank of the fleet. A callback that raises never
    takes the alert loop down."""

    def __init__(
        self,
        path: Optional[str],
        config: AlertConfig = AlertConfig(),
        on_fire=None,
    ):
        self.path = path
        self.config = config
        self.on_fire = on_fire
        self._active: set = set()  # (kind, rank) currently firing
        # dynamics histories: rank -> [(seq, value), ...] capped at
        # _HISTORY_CAP; advanced once per NEW snapshot seq (see
        # _observe_dynamics) — the memory behind staleness_runaway and
        # divergence
        self._elastic_hist: dict = {}
        self._staleness_hist: dict = {}
        if path is not None and os.path.exists(path):
            for rec in _read_jsonl(path):
                if rec.get("ev") == "alert":
                    self._active.add((rec.get("kind"), rec.get("rank")))

    # -- conditions -------------------------------------------------------

    def _dead_ranks(self, snapshots: Mapping[int, dict], now: float) -> list:
        out = []
        for rank, snap in snapshots.items():
            limit = staleness_s(snap, self.config)
            age = now - snap["t"]
            if age > limit:
                out.append((
                    "dead_rank", rank,
                    {
                        "age_s": round(age, 3),
                        "staleness_s": round(limit, 3),
                        "last_seq": snap.get("seq"),
                    },
                ))
        return out

    def _stragglers(self, snapshots: Mapping[int, dict]) -> list:
        cfg = self.config
        fracs = {}
        for rank, snap in snapshots.items():
            f = compute_fraction(snap)
            if f is None or (snap.get("uptime_s") or 0.0) < cfg.min_uptime_s:
                continue
            fracs[rank] = f
        if len(fracs) < 2 or max(fracs.values()) < cfg.min_compute_fraction:
            return []
        spread = max(fracs.values()) - min(fracs.values())
        if spread <= cfg.straggler_spread:
            return []
        med = statistics.median(fracs.values())
        rank = max(fracs, key=lambda r: abs(fracs[r] - med))
        return [(
            "straggler", rank,
            {
                "compute_fraction": round(fracs[rank], 4),
                "median": round(med, 4),
                "spread": round(spread, 4),
                "fractions": {str(r): round(f, 4) for r, f in sorted(fracs.items())},
            },
        )]

    def _slo_burns(self, snapshots: Mapping[int, dict]) -> list:
        cfg = self.config
        out = []
        for rank, snap in snapshots.items():
            counters = snap.get("counters", {})
            finished = counters.get(M_REQ_FINISHED)
            if finished is None or finished["rate"] < cfg.min_finished_rate:
                continue
            misses = counters.get(M_SLO_MISSES, {"rate": 0.0})
            miss_frac = misses["rate"] / finished["rate"]
            burn = miss_frac / (1.0 - cfg.slo_target)
            if burn > cfg.burn_threshold:
                out.append((
                    "slo_burn", rank,
                    {
                        "burn": round(burn, 3),
                        "miss_fraction": round(miss_frac, 4),
                        "slo_target": cfg.slo_target,
                        "finished_rate": round(finished["rate"], 3),
                    },
                ))
        return out

    def _observe_dynamics(self, snapshots: Mapping[int, dict]) -> None:
        """Advance the per-rank dynamics histories — one observation per
        new snapshot ``seq``, so evaluating an unchanged snapshot set
        twice (``--once`` re-runs, slow pollers) never manufactures a
        trend that isn't there."""
        for rank, snap in snapshots.items():
            seq = snap.get("seq")
            elastic = snap.get("gauges", {}).get(M_ELASTIC_DIST)
            if elastic is not None:
                hist = self._elastic_hist.setdefault(rank, [])
                if not hist or hist[-1][0] != seq:
                    hist.append((seq, float(elastic)))
                    del hist[:-_HISTORY_CAP]
            h = snap.get("hists", {}).get(M_STALENESS)
            if h is not None:
                buckets = h.get("rolling") or h.get("buckets") or {}
                p99 = percentile_ms(buckets, 0.99)
                if p99 is not None:
                    hist = self._staleness_hist.setdefault(rank, [])
                    if not hist or hist[-1][0] != seq:
                        # /1e3 undoes percentile_ms's ms scaling — the
                        # staleness hist is in units, not time
                        hist.append((seq, p99 / 1e3))
                        del hist[:-_HISTORY_CAP]

    def _divergences(self) -> list:
        cfg = self.config
        out = []
        for rank, hist in sorted(self._elastic_hist.items()):
            vals = [v for _, v in hist][-cfg.divergence_windows:]
            if len(vals) < cfg.divergence_windows or vals[0] <= 0:
                continue
            if all(b > a for a, b in zip(vals, vals[1:])) and (
                vals[-1] / vals[0] > cfg.divergence_factor
            ):
                out.append((
                    "divergence", rank,
                    {
                        "elastic_dist": round(vals[-1], 6),
                        "growth": round(vals[-1] / vals[0], 3),
                        "windows": cfg.divergence_windows,
                        "trajectory": [round(v, 6) for v in vals],
                    },
                ))
        return out

    def _staleness_runaways(self) -> list:
        cfg = self.config
        out = []
        for rank, hist in sorted(self._staleness_hist.items()):
            vals = [v for _, v in hist]
            if len(vals) < cfg.staleness_baseline_len + 1:
                continue
            newest = vals[-1]
            baseline = max(statistics.median(vals[:-1]), cfg.staleness_floor)
            if newest > cfg.staleness_runaway_factor * baseline:
                out.append((
                    "staleness_runaway", rank,
                    {
                        "staleness_p99": round(newest, 3),
                        "baseline": round(baseline, 3),
                        "factor": round(newest / baseline, 3),
                    },
                ))
        return out

    # -- driver -----------------------------------------------------------

    def evaluate(
        self,
        snapshots: Mapping[int, dict],
        now: Optional[float] = None,
    ) -> list:
        """One pass over the current snapshots. ``now`` defaults to the
        freshest snapshot's wall-clock (relative staleness — see module
        docstring); pass ``time.time()`` to also catch *all* ranks going
        silent at once while the run should still be alive."""
        if not snapshots:
            return []
        if now is None:
            now = max(s["t"] for s in snapshots.values())
        self._observe_dynamics(snapshots)
        found = (
            self._dead_ranks(snapshots, now)
            + self._stragglers(snapshots)
            + self._slo_burns(snapshots)
            + self._staleness_runaways()
            + self._divergences()
        )
        condition_keys = {(kind, rank) for kind, rank, _ in found}
        fired = []
        for kind, rank, detail in found:
            if (kind, rank) in self._active:
                continue
            self._active.add((kind, rank))
            fired.append({
                "ev": "alert",
                "kind": kind,
                "rank": rank,
                "t": now,
                "detail": detail,
            })
        # re-arm alerts whose condition cleared
        self._active &= condition_keys
        self._active |= {(f["kind"], f["rank"]) for f in fired}
        if fired and self.path is not None:
            with open(self.path, "a") as f:
                for rec in fired:
                    f.write(json.dumps(rec) + "\n")
        if fired and self.on_fire is not None:
            for rec in fired:
                try:
                    self.on_fire(rec)
                except Exception:
                    pass
        return fired


def _read_jsonl(path: str) -> list:
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return out


def read_alerts(path: str) -> list:
    """Parsed ``alerts.jsonl`` records (tolerant of partial lines)."""
    return [r for r in _read_jsonl(path) if r.get("ev") == "alert"]
