"""Live telemetry plane — in-run metrics registry + atomic snapshot export.

A copy of ``mpit_tpu/obs/live.py`` for the port (the ``M_*`` names are the
reference's, so the PS roles publish to the same metrics).

Everything obs built so far (tracing, roofline, SLO) is post-mortem:
JSONL journals reduced after the run ends. This module is the in-flight
half: a per-rank :class:`MetricsRegistry` that instrumentation publishes
into (counters, gauges, rolling-window geometric histograms), and a
:class:`LiveExporter` background thread that atomically snapshots the
registry to ``<MPIT_OBS_DIR>/live/rank_<r>.json`` on a configurable
interval. ``python -m mpit_tpu_torch.obs live <dir>`` aggregates the snapshots
across ranks into a dashboard and runs the online alert engine
(:mod:`mpit_tpu_torch.obs.alerts`) — the signals a replica router or elastic
scheduler will consume (ROADMAP: serving replicas, elastic membership).

Design rules:

- **Names are a registry.** Every metric name published here is an
  ``M_*`` module constant below — the one registered namespace. Lint rule
  MPT012 flags publishes that bypass it (a typo'd key otherwise just
  splits a series silently).
- **Two publish paths.** Per-round / per-request events push directly
  (``inc``/``set_gauge``/``observe`` — cheap at that frequency);
  per-message wire counters are *pulled* at export time via
  ``add_collector`` (the TelemetryTransport already counts every message
  under its own lock — re-counting per send would tax the hot path for a
  1 Hz consumer).
- **Disabled cost is a getattr.** When live export is not armed there is
  no registry; :func:`live_registry` returns the shared
  :data:`NULL_REGISTRY` whose methods are no-ops — the ``NULL_SPAN``
  idiom, pinned by the micro-benchmark in tests/test_live.py.
- **Snapshots are atomic and versioned.** Write-to-temp + ``os.replace``
  so a reader never sees a torn file; ``schema`` guards parsing across
  versions; ``seq`` is a monotonic heartbeat (a stuck exporter is
  distinguishable from a slow one), and staleness is judged *relative*
  to the freshest rank so post-mortem aggregation still identifies which
  rank died first.

This module reads/writes only files and must import neither jax nor the
transport stack (the ``obs.merge`` contract) — the CLI stays fast and
safe to run anywhere, including the lint.sh schema gate.
"""

from __future__ import annotations

import glob
import json
import math
import os
import threading
import time
from typing import Any, Callable, Mapping, Optional

from mpit_tpu_torch.analysis.runtime import make_lock

SNAPSHOT_SCHEMA = 1

# ---------------------------------------------------------------------------
# The registered metric namespace (lint rule MPT012's source of truth):
# module-level M_* string constants, one per published series. Publishing
# code imports these by name — never inlines the string.

# PS training plane (published by parallel/ps_roles.py per round)
M_STEPS = "train.steps"
M_SAMPLES = "train.samples"
M_COMPUTE_S = "train.compute_s"
M_EXCHANGE_S = "train.exchange_s"
M_EXCHANGE_LAT = "train.exchange_lat"
M_ROUNDS = "train.rounds"
M_PUSHES = "train.pushes"
M_SKIPPED_ROUNDS = "train.skipped_rounds"
M_EXCHANGE_FAILURES = "train.exchange_failures"
M_STALE_PARAMS = "train.stale_params_dropped"
M_REPAIRED_CHUNKS = "train.repaired_chunks"

# training-dynamics plane (docs/OBSERVABILITY.md "dynamics"):
# M_STALENESS is a histogram published by the SERVER per applied
# versioned push — one staleness unit recorded as one "second", so the
# unit-agnostic geometric buckets apply and percentile_ms/1000 recovers
# staleness units within one ~10% bucket step. The rest are per-round
# client gauges from parallel/ps_roles._record_dynamics.
M_STALENESS = "train.staleness"
M_ELASTIC_DIST = "train.elastic_dist"
M_PUSH_NORM = "train.push_norm"
M_PARAM_NORM = "train.param_norm"
M_NORM_RATIO = "train.norm_ratio"

# serving plane (published by models/serving.py lifecycle events)
M_REQ_SUBMITTED = "serve.submitted"
M_REQ_FINISHED = "serve.finished"
M_REQ_CANCELLED = "serve.cancelled"
M_SLO_MISSES = "serve.slo_misses"
M_TOKENS = "serve.tokens"
M_TTFT = "serve.ttft"
M_E2E = "serve.e2e"
M_SEGMENTS = "serve.segments"
M_WAITING = "serve.waiting"
M_OCCUPIED = "serve.occupied"
M_SERVE_FAULTS = "serve.faults"

# load-harness plane (published by loadgen/harness.py per boundary)
M_LOAD_PENDING = "load.pending"
M_LOAD_LATENESS_S = "load.submit_lateness_s"

# serving-fleet plane (published by fleet/router.py and fleet/replica.py)
M_FLEET_ROUTED = "fleet.routed"
M_FLEET_REDISPATCHED = "fleet.redispatched"
M_FLEET_SHED = "fleet.shed"
M_FLEET_REPLICAS = "fleet.replicas"
M_FLEET_OUTSTANDING = "fleet.outstanding"
M_FLEET_WEIGHTS_VERSION = "fleet.weights_version"

# base-1.1 geometric buckets on microseconds — kept in lockstep with
# mpit_tpu_torch.loadgen.slo (bucket b covers (1.1^(b-1), 1.1^b] µs, any
# percentile within one ~10% step); replicated here, as in the
# reference, so this module needs nothing of the loadgen package
_BASE = 1.1
_LOG_BASE = math.log(_BASE)


def _bucket(seconds: float) -> int:
    us = seconds * 1e6
    if us <= 1.0:
        return 0
    return int(math.ceil(math.log(us) / _LOG_BASE))


def _bucket_ms(b: int) -> float:
    return _BASE ** b / 1e3


def percentile_ms(counts: Mapping, q: float) -> Optional[float]:
    """q-th percentile (0..1) of a ``{bucket: count}`` histogram, in ms.

    Bucket keys may be ints or their str forms (JSON round-trip)."""
    total = sum(counts.values())
    if total == 0:
        return None
    need = q * total
    seen = 0
    for b in sorted(counts, key=int):
        seen += counts[b]
        if seen >= need:
            return _bucket_ms(int(b))
    return _bucket_ms(max(int(b) for b in counts))


class _RollingSum:
    """Time-sliced rolling accumulator: the window is ``nslices`` fixed
    slices; expired slices are dropped on read/write. O(nslices) memory,
    no per-sample timestamps."""

    __slots__ = ("slice_s", "nslices", "slices")

    def __init__(self, window_s: float, nslices: int):
        self.slice_s = window_s / nslices
        self.nslices = nslices
        self.slices: list = []  # [[slice_idx, value], ...] ascending

    def _prune(self, idx: int) -> None:
        lo = idx - self.nslices + 1
        while self.slices and self.slices[0][0] < lo:
            self.slices.pop(0)

    def add(self, now: float, value: float) -> None:
        idx = int(now / self.slice_s)
        if self.slices and self.slices[-1][0] == idx:
            self.slices[-1][1] += value
        else:
            self.slices.append([idx, value])
            self._prune(idx)

    def value(self, now: float) -> float:
        self._prune(int(now / self.slice_s))
        return sum(v for _, v in self.slices)


class _RollingHist:
    """Rolling ``{bucket: count}`` histogram, same slice scheme."""

    __slots__ = ("slice_s", "nslices", "slices")

    def __init__(self, window_s: float, nslices: int):
        self.slice_s = window_s / nslices
        self.nslices = nslices
        self.slices: list = []  # [[slice_idx, {bucket: count}], ...]

    def _prune(self, idx: int) -> None:
        lo = idx - self.nslices + 1
        while self.slices and self.slices[0][0] < lo:
            self.slices.pop(0)

    def add(self, now: float, bucket: int) -> None:
        idx = int(now / self.slice_s)
        if not self.slices or self.slices[-1][0] != idx:
            self.slices.append([idx, {}])
            self._prune(idx)
        counts = self.slices[-1][1]
        counts[bucket] = counts.get(bucket, 0) + 1

    def counts(self, now: float) -> dict:
        self._prune(int(now / self.slice_s))
        out: dict = {}
        for _, counts in self.slices:
            for b, c in counts.items():
                out[b] = out.get(b, 0) + c
        return out


class MetricsRegistry:
    """Thread-safe per-rank metric store: monotonically increasing
    counters (cumulative total + rolling-window sum), last-write gauges,
    and base-1.1 geometric histograms (cumulative + rolling buckets).

    ``clock`` is the monotonic time source for the rolling windows
    (injectable for tests); wall-clock stamps in snapshots come from
    ``time.time`` so cross-rank staleness can be compared.

    Collectors (``add_collector``) are sampled at snapshot time OUTSIDE
    the registry lock — they may take their own locks (the telemetry
    stats lock) and must never publish back into the registry from
    inside the callback."""

    def __init__(
        self,
        rank: int,
        role: str = "ps",
        window_s: float = 30.0,
        slices: int = 6,
        clock: Callable[[], float] = time.monotonic,
    ):
        if window_s <= 0 or slices < 1:
            raise ValueError("window_s must be > 0 and slices >= 1")
        self.rank = rank
        self.role = role
        self.window_s = float(window_s)
        self.slices = int(slices)
        self._clock = clock
        self._lock = make_lock("obs.MetricsRegistry._lock")
        self._counters: dict = {}  # name -> [total, _RollingSum]
        self._gauges: dict = {}    # name -> value
        self._hists: dict = {}     # name -> [counts, total, sum_s, _RollingHist]
        self._collectors: list = []  # (name, fn)
        self._t0_wall = time.time()
        self._t0 = clock()

    # -- publish ----------------------------------------------------------

    def inc(self, name: str, value: float = 1.0) -> None:
        now = self._clock()
        with self._lock:
            entry = self._counters.get(name)
            if entry is None:
                entry = self._counters[name] = [
                    0.0, _RollingSum(self.window_s, self.slices)
                ]
            entry[0] += value
            entry[1].add(now, value)

    def set_gauge(self, name: str, value: float) -> None:
        # coercion lives here, not at call sites: publishers sit in hot
        # loops where a float() on the caller's side reads as (and is
        # linted as) a device sync
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name: str, seconds: float) -> None:
        b = _bucket(seconds)
        now = self._clock()
        with self._lock:
            entry = self._hists.get(name)
            if entry is None:
                entry = self._hists[name] = [
                    {}, 0, 0.0, _RollingHist(self.window_s, self.slices)
                ]
            entry[0][b] = entry[0].get(b, 0) + 1
            entry[1] += 1
            entry[2] += seconds
            entry[3].add(now, b)

    def add_collector(self, name: str, fn: Callable[[], dict]) -> None:
        with self._lock:
            self._collectors.append((name, fn))

    # -- snapshot ---------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-able versioned state. Counter ``rate`` is the rolling sum
        divided by the covered window (= the window once uptime exceeds
        it) — for a seconds-valued counter that rate IS the rolling phase
        fraction, which is what the dashboard and the straggler alert
        read."""
        now = self._clock()
        now_wall = time.time()
        uptime = now - self._t0
        covered = max(min(self.window_s, uptime), 1e-3)
        with self._lock:
            counters = {
                name: {
                    "total": entry[0],
                    "rate": entry[1].value(now) / covered,
                }
                for name, entry in sorted(self._counters.items())
            }
            gauges = dict(sorted(self._gauges.items()))
            hists = {}
            for name, entry in sorted(self._hists.items()):
                counts, total, sum_s, rolling = entry
                rcounts = rolling.counts(now)
                hists[name] = {
                    "count": total,
                    "sum_s": round(sum_s, 6),
                    "buckets": {str(b): c for b, c in sorted(counts.items())},
                    "rolling": {
                        str(b): c for b, c in sorted(rcounts.items())
                    },
                }
            collectors = list(self._collectors)
        collect = {}
        for name, fn in collectors:
            try:
                collect[name] = fn()
            except Exception as e:  # a broken collector must not kill export
                collect[name] = {"error": repr(e)}
        return {
            "schema": SNAPSHOT_SCHEMA,
            "rank": self.rank,
            "role": self.role,
            "pid": os.getpid(),
            "t": now_wall,
            "t0": self._t0_wall,
            "uptime_s": round(uptime, 6),
            "window_s": self.window_s,
            "covered_s": round(covered, 6),
            "counters": counters,
            "gauges": gauges,
            "hists": hists,
            "collect": collect,
        }


class _NullRegistry:
    """The disabled fast path: one shared no-op registry, so a publish
    site costs a getattr + an identity check + a no-op method call when
    live telemetry is off (the ``NULL_SPAN`` idiom; pinned by the
    micro-benchmark in tests/test_live.py)."""

    __slots__ = ()

    def inc(self, name: str, value: float = 1.0) -> None:
        pass

    def set_gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, seconds: float) -> None:
        pass

    def add_collector(self, name: str, fn) -> None:
        pass


NULL_REGISTRY = _NullRegistry()


def live_registry(obj: Any):
    """Instrumentation hook: the live :class:`MetricsRegistry` when
    ``obj`` (a transport, a server — anything carrying ``obs_registry``)
    has one armed, the shared no-op otherwise. Safe to call in loops
    unconditionally — the disabled path is a getattr and a check."""
    reg = getattr(obj, "obs_registry", None)
    if reg is None:
        return NULL_REGISTRY
    return reg


class LiveExporter:
    """Background snapshot writer: every ``interval_s`` (and once at
    start and once at close, so even sub-interval runs leave a
    snapshot), the registry's state lands atomically in
    ``<live_dir>/rank_<r>.json`` — write-to-temp + ``os.replace``, a
    reader never sees a torn file. ``seq`` increments per write (the
    monotonic heartbeat the dead-rank alert watches, via the wall-clock
    ``t`` it stamps alongside). Write errors are counted, never raised —
    a full disk must not kill training."""

    def __init__(
        self,
        registry: MetricsRegistry,
        live_dir: str,
        interval_s: float = 1.0,
        start: bool = True,
    ):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        os.makedirs(live_dir, exist_ok=True)
        self.registry = registry
        self.interval_s = float(interval_s)
        self.path = os.path.join(live_dir, f"rank_{registry.rank}.json")
        self.write_errors = 0
        self._seq = 0
        # write() runs on the export thread AND on close()'s caller; the
        # join() in close() has a timeout, so it is not a guaranteed fence
        self._write_lock = make_lock(
            f"obs.LiveExporter._write_lock[{registry.rank}]"
        )
        self._stop = threading.Event()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run,
            name=f"mpit-live-export-{registry.rank}",
            daemon=True,
        )
        if start:
            self._thread.start()

    def _run(self) -> None:
        self.write()  # first heartbeat immediately, not one interval in
        while not self._stop.wait(self.interval_s):
            self.write()

    def write(self) -> None:
        snap = self.registry.snapshot()
        with self._write_lock:
            self._seq += 1
            snap["seq"] = self._seq
            snap["interval_s"] = self.interval_s
            tmp = f"{self.path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w") as f:
                    json.dump(snap, f)
                os.replace(tmp, self.path)
            except OSError:
                self.write_errors += 1
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

    def close(self) -> None:
        """Stop the thread and write one final snapshot (the run's last
        state must be on disk even when the run was shorter than one
        interval). Idempotent."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        self.write()


# ---------------------------------------------------------------------------
# Reading side: snapshot validation and cross-rank aggregation (the
# `python -m mpit_tpu_torch.obs live` backend).


def validate_snapshot(snap: Any) -> list[str]:
    """Schema problems for one parsed snapshot (empty list = valid).
    This is the contract the checked-in golden snapshot is gated
    against in scripts/lint.sh."""
    problems: list[str] = []
    if not isinstance(snap, dict):
        return ["snapshot is not a JSON object"]

    def _num(key, minimum=None):
        v = snap.get(key)
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            problems.append(f"{key}: missing or not a number")
            return
        if minimum is not None and v < minimum:
            problems.append(f"{key}: {v} < {minimum}")

    if snap.get("schema") != SNAPSHOT_SCHEMA:
        problems.append(
            f"schema: {snap.get('schema')!r} != {SNAPSHOT_SCHEMA}"
        )
    _num("rank", 0)
    if not isinstance(snap.get("role"), str):
        problems.append("role: missing or not a string")
    _num("t")
    _num("t0")
    _num("uptime_s", 0.0)
    _num("window_s", 1e-9)
    _num("seq", 1)
    _num("interval_s", 1e-9)
    for section, leaf in (
        ("counters", ("total", "rate")),
        ("hists", ("count", "sum_s", "buckets", "rolling")),
    ):
        table = snap.get(section)
        if not isinstance(table, dict):
            problems.append(f"{section}: missing or not an object")
            continue
        for name, entry in table.items():
            if not isinstance(entry, dict):
                problems.append(f"{section}[{name}]: not an object")
                continue
            for k in leaf:
                if k not in entry:
                    problems.append(f"{section}[{name}]: missing {k!r}")
    for section in ("gauges", "collect"):
        if not isinstance(snap.get(section), dict):
            problems.append(f"{section}: missing or not an object")
    return problems


def find_live_dir(path: str) -> str:
    """Accept either the run dir (``MPIT_OBS_DIR`` — snapshots under its
    ``live/``) or the live dir itself."""
    sub = os.path.join(path, "live")
    if os.path.isdir(sub):
        return sub
    return path


def read_snapshots(live_dir: str) -> dict[int, dict]:
    """rank -> parsed snapshot for every readable, schema-valid
    ``rank_*.json`` (torn/foreign files are skipped — one bad rank must
    not sink the dashboard)."""
    out: dict[int, dict] = {}
    for path in sorted(glob.glob(os.path.join(live_dir, "rank_*.json"))):
        try:
            with open(path) as f:
                snap = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        if validate_snapshot(snap):
            continue
        out[int(snap["rank"])] = snap
    return out


def _counter(snap: dict, name: str) -> dict:
    return snap.get("counters", {}).get(name, {"total": 0.0, "rate": 0.0})


def _gauge(snap: dict, name: str):
    return snap.get("gauges", {}).get(name)


def compute_fraction(snap: dict) -> Optional[float]:
    """Rolling compute-seconds-per-second for a training rank (None when
    the rank publishes no compute) — the straggler alert's input."""
    c = snap.get("counters", {}).get(M_COMPUTE_S)
    if c is None:
        return None
    return float(c["rate"])


def aggregate(snapshots: Mapping[int, dict]) -> dict:
    """Cross-rank live report: per-rank health/throughput rows plus run
    totals. ``now`` is the freshest snapshot's wall-clock — staleness is
    *relative*, so a post-mortem aggregation still shows which rank fell
    silent first."""
    if not snapshots:
        return {"now": None, "ranks": {}, "run": None, "serve": None}
    now = max(s["t"] for s in snapshots.values())
    ranks: dict[int, dict] = {}
    serve_rows = []
    for rank, snap in sorted(snapshots.items()):
        wire = snap.get("collect", {}).get("wire", {})
        chaos = snap.get("collect", {}).get("chaos", {})
        cf = compute_fraction(snap)
        wf = _counter(snap, M_EXCHANGE_S)["rate"] if cf is not None else None
        row = {
            "role": snap.get("role", "?"),
            "age_s": round(now - snap["t"], 3),
            "seq": snap.get("seq"),
            "uptime_s": snap.get("uptime_s"),
            "interval_s": snap.get("interval_s"),
            "throughput": round(_counter(snap, M_SAMPLES)["rate"], 3),
            "samples": _counter(snap, M_SAMPLES)["total"],
            "rounds": _counter(snap, M_ROUNDS)["total"],
            "queue_depth": wire.get("queue_depth"),
            "faults": {
                k: v for k, v in chaos.items() if isinstance(v, int)
            },
            "serve_faults": _counter(snap, M_SERVE_FAULTS)["total"],
        }
        if cf is not None and wf is not None:
            row["phases"] = {
                "compute": round(cf, 4),
                "wire": round(wf, 4),
                "other": round(max(0.0, 1.0 - cf - wf), 4),
            }
        exch = snap.get("hists", {}).get(M_EXCHANGE_LAT)
        if exch is not None:
            buckets = exch["rolling"] or exch["buckets"]
            row["exchange_ms"] = {
                "p50": percentile_ms(buckets, 0.50),
                "p90": percentile_ms(buckets, 0.90),
                "p99": percentile_ms(buckets, 0.99),
            }
        # training-dynamics rows (docs/OBSERVABILITY.md "dynamics"):
        # server ranks publish the staleness hist (units, not time —
        # hence /1e3 undoing percentile_ms's ms scaling), client ranks
        # the per-round quality gauges
        stal = snap.get("hists", {}).get(M_STALENESS)
        if stal is not None:
            buckets = stal["rolling"] or stal["buckets"]
            p50 = percentile_ms(buckets, 0.50)
            p99 = percentile_ms(buckets, 0.99)
            row["staleness"] = {
                "p50": None if p50 is None else round(p50 / 1e3, 3),
                "p99": None if p99 is None else round(p99 / 1e3, 3),
            }
        elastic = _gauge(snap, M_ELASTIC_DIST)
        if elastic is not None:
            row["dynamics"] = {
                "elastic_dist": elastic,
                "push_norm": _gauge(snap, M_PUSH_NORM),
                "param_norm": _gauge(snap, M_PARAM_NORM),
                "norm_ratio": _gauge(snap, M_NORM_RATIO),
            }
        # flight-recorder health (collector fragment from the rank's
        # BlackBox): ring occupancy + dump count, so an operator can see
        # the recorder is armed — and that an incident already dumped —
        # without touching the run dir
        bb = snap.get("collect", {}).get("blackbox")
        if isinstance(bb, dict) and "records" in bb:
            row["blackbox"] = {
                "records": bb.get("records"),
                "dumps": bb.get("dumps"),
                "last_trigger": bb.get("last_trigger"),
            }
        if snap.get("role") == "serve":
            finished = _counter(snap, M_REQ_FINISHED)
            misses = _counter(snap, M_SLO_MISSES)
            miss_frac = (
                misses["rate"] / finished["rate"]
                if finished["rate"] > 0 else 0.0
            )
            srow = {
                "waiting": _gauge(snap, M_WAITING),
                "occupied": _gauge(snap, M_OCCUPIED),
                "rps": round(finished["rate"], 3),
                "tokens_per_s": round(_counter(snap, M_TOKENS)["rate"], 3),
                "finished": finished["total"],
                "cancelled": _counter(snap, M_REQ_CANCELLED)["total"],
                "slo_miss_fraction": round(miss_frac, 4),
            }
            ttft = snap.get("hists", {}).get(M_TTFT)
            if ttft is not None:
                buckets = ttft["rolling"] or ttft["buckets"]
                srow["ttft_p50_ms"] = percentile_ms(buckets, 0.50)
                srow["ttft_p99_ms"] = percentile_ms(buckets, 0.99)
            row["serve"] = srow
            serve_rows.append(srow)
        ranks[rank] = row
    fracs = [
        r["phases"]["compute"] for r in ranks.values() if "phases" in r
    ]
    run = {
        "ranks": len(ranks),
        "throughput": round(sum(r["throughput"] for r in ranks.values()), 3),
        "max_age_s": round(max(r["age_s"] for r in ranks.values()), 3),
        "compute_fraction_spread": (
            round(max(fracs) - min(fracs), 4) if len(fracs) >= 2 else None
        ),
    }
    serve = None
    if serve_rows:
        serve = {
            "rps": round(sum(r["rps"] for r in serve_rows), 3),
            "waiting": sum(r["waiting"] or 0 for r in serve_rows),
            "slo_miss_fraction": round(
                max(r["slo_miss_fraction"] for r in serve_rows), 4
            ),
        }
    return {"now": now, "ranks": ranks, "run": run, "serve": serve}
