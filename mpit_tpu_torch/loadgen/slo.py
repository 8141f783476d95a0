"""Streaming SLO aggregation over serving journals, and gate files.

A copy of ``mpit_tpu/loadgen/slo.py`` (stdlib only) for the port's
``python -m mpit_tpu_torch.obs slo``.

Reads the request-lifecycle events ``models/serving.py`` journals
(``req_enqueue``/``req_admit``/``req_first_token``/``req_finish``/
``req_cancel`` plus ``prefill``/``segment``/``serve_fault``/
``journal_cap``) and reduces them to the serving scorecard: TTFT, TPOT,
e2e percentiles, goodput, queue depth and batch occupancy over time.

Constant memory: latencies go into geometric histograms (base 1.1 on
microseconds → percentiles within ~10% quantization at any volume, the
``_lat_bucket`` idea from obs.merge carried further), and per-request
state is held only between enqueue and finish — a journal of millions
of requests aggregates in O(in-flight + buckets).

Gate files (``obs slo <dir> --gate slo.json``) are flat JSON objects of
ceiling/floor keys — ``ttft_p99_ms: 250`` means "p99 TTFT must be at
most 250ms". Unknown keys are an error, not a silent pass: a typo'd
gate must fail loudly rather than wave every build through.
"""

from __future__ import annotations

import json
import math
import re
from typing import Optional

# base-1.1 geometric buckets on microseconds: bucket b covers
# (1.1^(b-1), 1.1^b] µs, so any reported percentile is within one 10%
# step of the true value regardless of how many samples were folded in
_BASE = 1.1
_LOG_BASE = math.log(_BASE)


def _bucket(seconds: float) -> int:
    us = seconds * 1e6
    if us <= 1.0:
        return 0
    return int(math.ceil(math.log(us) / _LOG_BASE))


def _bucket_ms(b: int) -> float:
    return _BASE ** b / 1e3


class _Hist:
    """Geometric latency histogram: O(log range) buckets, exact count
    and mean, percentiles to ~10%."""

    __slots__ = ("counts", "total", "sum_s")

    def __init__(self):
        self.counts: dict = {}
        self.total = 0
        self.sum_s = 0.0

    def add(self, seconds: float) -> None:
        b = _bucket(seconds)
        self.counts[b] = self.counts.get(b, 0) + 1
        self.total += 1
        self.sum_s += seconds

    def percentile_ms(self, q: float) -> Optional[float]:
        if self.total == 0:
            return None
        need = q * self.total
        seen = 0
        for b in sorted(self.counts):
            seen += self.counts[b]
            if seen >= need:
                return _bucket_ms(b)
        return _bucket_ms(max(self.counts))

    def summary(self) -> dict:
        if self.total == 0:
            return {"count": 0}
        return {
            "count": self.total,
            "mean_ms": round(self.sum_s / self.total * 1e3, 3),
            "p50_ms": round(self.percentile_ms(0.50), 3),
            "p90_ms": round(self.percentile_ms(0.90), 3),
            "p99_ms": round(self.percentile_ms(0.99), 3),
        }


class SLOAggregator:
    """Fold journal records (dicts) into the serving scorecard.

    Feed records in any order across files; within one rank's journal
    the serving loop is single-threaded so lifecycle order holds.
    ``default_slo_ms`` applies to requests enqueued without ``slo_ms``
    (None = such requests meet their SLO vacuously when they finish)."""

    def __init__(self, default_slo_ms: Optional[float] = None):
        self.default_slo_ms = default_slo_ms
        # rid -> [t_enqueue, t_first_token|None, slo_ms|None]
        self._open: dict = {}
        self.ttft = _Hist()
        self.tpot = _Hist()
        self.e2e = _Hist()
        self.submitted = 0
        self.finished = 0
        self.cancelled = 0
        self.slo_met = 0
        self.tokens = 0
        self.finish_reasons: dict = {}
        self.faults: dict = {}
        self.dropped_records = 0
        # time-weighted queue depth / occupancy from segment events
        self.segments = 0
        self.spec_segments = 0
        self._seg_time = 0.0
        self._depth_time = 0.0   # ∫ waiting dt over segment time
        self._occ_time = 0.0     # ∫ occupied dt
        self._slot_time = 0.0    # ∫ nslots dt
        self.max_queue_depth = 0
        self._t_min: Optional[float] = None
        self._t_max: Optional[float] = None

    def observe(self, rec: dict) -> None:
        ev = rec.get("ev")
        if ev is None:
            return
        t = rec.get("t")
        if t is not None:
            self._t_min = t if self._t_min is None else min(self._t_min, t)
            self._t_max = t if self._t_max is None else max(self._t_max, t)
        if ev == "req_enqueue":
            self.submitted += 1
            self._open[rec["rid"]] = [
                t, None, rec.get("slo_ms", self.default_slo_ms),
            ]
        elif ev == "req_first_token":
            st = self._open.get(rec["rid"])
            if st is not None and st[1] is None:
                st[1] = t
                if st[0] is not None and t is not None:
                    self.ttft.add(t - st[0])
        elif ev == "req_finish":
            st = self._open.pop(rec["rid"], None)
            self.finished += 1
            gen = rec.get("gen", 0)
            self.tokens += gen
            reason = rec.get("reason", "?")
            self.finish_reasons[reason] = (
                self.finish_reasons.get(reason, 0) + 1
            )
            if st is None or st[0] is None or t is None:
                return
            e2e_s = t - st[0]
            self.e2e.add(e2e_s)
            if st[1] is not None and gen > 1:
                self.tpot.add((t - st[1]) / (gen - 1))
            if st[2] is None or e2e_s * 1e3 <= st[2]:
                self.slo_met += 1
        elif ev == "req_cancel":
            self._open.pop(rec["rid"], None)
            self.cancelled += 1
            self.tokens += rec.get("gen", 0)
        elif ev == "segment":
            self.segments += 1
            if rec.get("spec"):
                self.spec_segments += 1
            dur = rec.get("dur", 0.0)
            waiting = rec.get("waiting", 0)
            self._seg_time += dur
            self._depth_time += waiting * dur
            self._occ_time += rec.get("occupied", 0) * dur
            self._slot_time += rec.get("nslots", 0) * dur
            self.max_queue_depth = max(self.max_queue_depth, waiting)
        elif ev == "serve_fault":
            kind = rec.get("kind", "?")
            self.faults[kind] = self.faults.get(kind, 0) + 1
        elif ev == "journal_cap":
            self.dropped_records += rec.get("dropped_records", 0)

    def report(self) -> dict:
        unfinished = len(self._open)
        denom = self.submitted - self.cancelled
        duration_s = (
            (self._t_max - self._t_min)
            if self._t_min is not None and self._t_max is not None
            else 0.0
        )
        return {
            "requests": {
                "submitted": self.submitted,
                "finished": self.finished,
                "cancelled": self.cancelled,
                "unfinished": unfinished,
            },
            "finish_reasons": dict(sorted(self.finish_reasons.items())),
            "ttft": self.ttft.summary(),
            "tpot": self.tpot.summary(),
            "e2e": self.e2e.summary(),
            # of the requests the client still wanted, the fraction that
            # finished within SLO — unfinished (killed/abandoned) count
            # against, so a crashed run cannot score well
            "goodput": (
                round(self.slo_met / denom, 4) if denom > 0 else None
            ),
            "queue_depth": {
                "time_mean": (
                    round(self._depth_time / self._seg_time, 2)
                    if self._seg_time > 0 else None
                ),
                "max": self.max_queue_depth,
            },
            "occupancy": (
                round(self._occ_time / self._slot_time, 4)
                if self._slot_time > 0 else None
            ),
            "segments": self.segments,
            "spec_segments": self.spec_segments,
            "tokens": self.tokens,
            "duration_s": round(duration_s, 4),
            "tokens_per_sec": (
                round(self.tokens / duration_s, 1)
                if duration_s > 0 else None
            ),
            "faults": dict(sorted(self.faults.items())),
            "dropped_records": self.dropped_records,
        }


def _stream(paths, agg: SLOAggregator) -> SLOAggregator:
    """Feed journal files into ``agg``. Unparseable lines are skipped
    (a crashed writer's torn tail must not take the postmortem down
    with it)."""
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except (json.JSONDecodeError, ValueError):
                    continue
                agg.observe(rec)
    return agg


def aggregate_paths(
    paths, default_slo_ms: Optional[float] = None
) -> dict:
    """Stream journal files through one aggregator; returns the report."""
    return _stream(
        paths, SLOAggregator(default_slo_ms=default_slo_ms)
    ).report()


def pooled_latencies(groups, names=("ttft", "tpot", "e2e")) -> dict:
    """Latency summaries pooled across journal *groups* whose rid
    spaces collide — one group per serving replica (each replica's
    ``Server`` numbers requests locally, so rid 0 in two replica
    journals is two different requests and they must never share one
    aggregator). Each group streams through its own
    :class:`SLOAggregator`; the geometric histograms then merge exactly
    (bucket counts add). Returns ``{name: summary}`` in the same shape
    as the per-histogram ``summary()`` of :func:`aggregate_paths`."""
    pooled = {name: _Hist() for name in names}
    for paths in groups:
        agg = _stream(list(paths), SLOAggregator())
        for name in names:
            h: _Hist = getattr(agg, name)
            dst = pooled[name]
            for b, c in h.counts.items():
                dst.counts[b] = dst.counts.get(b, 0) + c
            dst.total += h.total
            dst.sum_s += h.sum_s
    return {name: hist.summary() for name, hist in pooled.items()}


# gate keys: latency ceilings in ms, plus run-shape floors/ceilings
_LAT_KEY = re.compile(r"^(ttft|tpot|e2e)_p(50|90|99)_ms$")
_OTHER_KEYS = frozenset(
    ("goodput_min", "min_finished", "max_unfinished",
     "max_dropped_records")
)


def validate_gate(gate: dict) -> None:
    if not isinstance(gate, dict):
        raise ValueError("gate must be a JSON object")
    for k, v in gate.items():
        if not (_LAT_KEY.match(k) or k in _OTHER_KEYS):
            raise ValueError(
                f"unknown gate key {k!r} (latency gates look like "
                "ttft_p99_ms; others: " + ", ".join(sorted(_OTHER_KEYS))
                + ")"
            )
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise ValueError(f"gate {k!r} must be a number, got {v!r}")


def load_gate(path: str) -> dict:
    with open(path) as f:
        gate = json.load(f)
    validate_gate(gate)
    return gate


def evaluate_gate(report: dict, gate: dict) -> list:
    """Violation strings (empty = pass). A gated percentile that the
    run produced no samples for is itself a violation — a gate must not
    pass because the thing it bounds never happened."""
    out = []
    for k, limit in gate.items():
        m = _LAT_KEY.match(k)
        if m:
            metric, pct = m.group(1), "p" + m.group(2) + "_ms"
            got = report.get(metric, {}).get(pct)
            if got is None:
                out.append(f"{k}: no samples (gate needs <= {limit})")
            elif got > limit:
                out.append(f"{k}: {got} > {limit}")
        elif k == "goodput_min":
            got = report.get("goodput")
            if got is None:
                out.append(f"goodput_min: no eligible requests "
                           f"(gate needs >= {limit})")
            elif got < limit:
                out.append(f"goodput_min: {got} < {limit}")
        elif k == "min_finished":
            got = report["requests"]["finished"]
            if got < limit:
                out.append(f"min_finished: {got} < {limit}")
        elif k == "max_unfinished":
            got = report["requests"]["unfinished"]
            if got > limit:
                out.append(f"max_unfinished: {got} > {limit}")
        elif k == "max_dropped_records":
            got = report.get("dropped_records", 0)
            if got > limit:
                out.append(f"max_dropped_records: {got} > {limit}")
    return out


def format_report(report: dict) -> str:
    """Human-readable scorecard (the ``obs slo`` default output)."""
    r = report["requests"]
    lines = [
        f"requests: {r['submitted']} submitted, {r['finished']} "
        f"finished, {r['cancelled']} cancelled, "
        f"{r['unfinished']} unfinished",
    ]
    for name in ("ttft", "tpot", "e2e"):
        s = report[name]
        if s.get("count"):
            lines.append(
                f"{name:>4}: p50 {s['p50_ms']:.3f}ms  "
                f"p90 {s['p90_ms']:.3f}ms  p99 {s['p99_ms']:.3f}ms  "
                f"(mean {s['mean_ms']:.3f}ms, n={s['count']})"
            )
        else:
            lines.append(f"{name:>4}: no samples")
    gp = report["goodput"]
    lines.append(
        "goodput: " + (f"{gp:.4f}" if gp is not None else "n/a")
    )
    qd = report["queue_depth"]
    qmean = qd["time_mean"]
    lines.append(
        "queue depth: "
        + (f"{qmean} time-mean" if qmean is not None else "n/a")
        + f", {qd['max']} max"
    )
    occ = report["occupancy"]
    lines.append(
        "occupancy: " + (f"{occ:.4f}" if occ is not None else "n/a")
        + f" over {report['segments']} segments"
    )
    tps = report["tokens_per_sec"]
    lines.append(
        f"tokens: {report['tokens']} in {report['duration_s']}s"
        + (f" ({tps} tok/s)" if tps is not None else "")
    )
    if report["faults"]:
        lines.append(
            "faults: " + ", ".join(
                f"{k}={v}" for k, v in report["faults"].items()
            )
        )
    if report["dropped_records"]:
        lines.append(
            f"WARNING: journal dropped {report['dropped_records']} "
            "records (MPIT_OBS_MAX_RECORDS cap) — stats above are "
            "truncated"
        )
    return "\n".join(lines)
