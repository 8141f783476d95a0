"""Merge per-rank obs journals into one Chrome-trace/Perfetto timeline.

A copy of ``mpit_tpu/obs/merge.py`` for the port: the port's CLI and
:mod:`~mpit_tpu_torch.obs.dynamics` read journals through it.

Input: the ``obs_rank<r>.jsonl`` journals that
:class:`~mpit_tpu_torch.obs.telemetry.TelemetryTransport` writes, optionally plus
a chaos fault log persisted by :func:`mpit_tpu_torch.obs.core.write_fault_log`.
Output: the Chrome Trace Event JSON object format (``{"traceEvents":
[...]}``), which https://ui.perfetto.dev opens directly.

Rendering:

- each transport rank is one Perfetto *process* track (``pid`` = rank);
- ``send``/``isend`` and ``recv`` become complete (``ph: "X"``) slices —
  a send's duration is its time in the transport call, a recv's slice
  spans the receiver's blocked wait;
- every traced send emits a *flow* (``ph: "s"`` → ``ph: "f"``, id = the
  send's span id) that Perfetto draws as an arrow from the send slice to
  the matching recv slice on the destination rank — the cross-rank trace
  made visible;
- ``span_b``/``span_e`` regions (the trainer's per-exchange spans) become
  nested B/E slices on their rank's track;
- chaos faults become instant events (``ph: "i"``) on the track of the
  rank that suffered them (the sending rank — every injected fault is
  sender-side, docs/ROBUSTNESS.md). FaultEvents deliberately carry no
  timestamp (replay-comparability), so placement joins the fault's
  ``(src, dst, tag, n)`` stream coordinates against the telemetry send
  events, whose stream index is in lockstep with the chaos schedule's;
- serving journals (``models/serving.py`` under load, docs/SERVING.md)
  add two thread tracks: ``tid 1`` holds the scheduler's ``prefill``/
  ``segment`` work slices (events carry end time + ``dur``, like recv)
  and ``serve_fault`` instants, ``tid 2`` holds one async span per
  request (``ph: "b"/"n"/"e"``, id = rid) from enqueue through admit /
  first token to finish or cancel — queueing time visible per request;
- training-dynamics records (docs/OBSERVABILITY.md "dynamics") become
  Perfetto counter tracks (``ph: "C"``): an ``elastic_dist`` lane per
  client rank and one ``staleness src <r>`` lane per pushing client on
  each server rank — update quality rendered on the same timeline as
  the wire traffic that caused it.

This module reads only files — it must import neither jax nor the
transport stack, so the CLI stays fast and safe to run anywhere.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Iterable, Optional

# protocol tag names for display; sources of truth are
# mpit_tpu_torch/parallel/pserver.py (1-10) and
# mpit_tpu_torch/fleet/replica.py (11-15) — kept literal here so the
# merger imports nothing heavier than the standard library
TAG_NAMES = {
    1: "FETCH",
    2: "PUSH_EASGD",
    3: "PUSH_DELTA",
    4: "PARAM",
    5: "STOP",
    6: "HEARTBEAT",
    7: "JOIN",
    8: "LEAVE",
    9: "SHARD_MAP",
    10: "RESHARD",
    11: "ROUTE",
    12: "REPLY",
    13: "WEIGHT_SUB",
    14: "WEIGHT_PUSH",
    15: "FLEET_STOP",
}


def _tag_name(tag) -> str:
    return TAG_NAMES.get(tag, str(tag))


def read_journal(path: str) -> list[dict]:
    """Records of one JSONL journal (malformed lines are skipped — a
    journal truncated by a killed rank must not sink the whole merge;
    a directory — e.g. the ``blackbox/`` or ``live/`` subdir a listing
    of the run dir sweeps up — reads as empty)."""
    out = []
    if os.path.isdir(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def expand_journal_paths(paths: Iterable[str]) -> list[str]:
    """Each path may be a journal file or a directory of
    ``obs_rank*.jsonl``; returns the flat sorted file list."""
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "obs_rank*.jsonl"))))
        else:
            out.append(p)
    return out


def read_fault_log(path: str) -> list[dict]:
    """Fault records from one JSONL file, or from every ``faults*.jsonl``
    in a directory (process-mode runs write one fault log per rank —
    faults are recorded sender-side, so the per-rank union is the whole
    schedule)."""
    if os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, "faults*.jsonl")))
    else:
        paths = [path]
    return [
        r for p in paths for r in read_journal(p) if r.get("ev") == "fault"
    ]


def _rec_rank(rec: dict):
    return rec.get("rank", rec.get("process", 0))


def _rec_time(rec: dict) -> Optional[float]:
    # precise "t" preferred; "ts" (1 ms resolution) is the fallback for
    # hand-written or foreign MetricsLogger streams
    return rec.get("t", rec.get("ts"))


def merge_to_chrome_trace(
    journal_paths: Iterable[str],
    faults_path: Optional[str] = None,
    alerts_path: Optional[str] = None,
) -> dict:
    """Chrome-trace JSON object from per-rank journals (+ optional chaos
    fault log and live-plane ``alerts.jsonl``). Wall-clock timestamps
    are rebased to the earliest event; events within a rank keep journal
    order (monotonic per rank by the Journal's construction)."""
    journal_paths = expand_journal_paths(journal_paths)
    per_rank: dict[int, list[dict]] = {}
    for path in journal_paths:
        for rec in read_journal(path):
            if _rec_time(rec) is None or "ev" not in rec:
                continue
            per_rank.setdefault(_rec_rank(rec), []).append(rec)

    t0 = min(
        (_rec_time(r) for recs in per_rank.values() for r in recs),
        default=0.0,
    )

    def us(t: float) -> float:
        return round((t - t0) * 1e6, 1)

    events: list[dict] = []
    # (src_rank, dst, tag, n) -> send timestamp in µs, the fault join key
    send_index: dict[tuple, float] = {}

    for rank in sorted(per_rank):
        events.append({
            "ph": "M", "name": "process_name", "pid": rank, "tid": 0,
            "args": {"name": f"rank {rank}"},
        })
        for rec in per_rank[rank]:
            t = _rec_time(rec)
            ev = rec["ev"]
            if ev in ("send", "isend"):
                ts = us(t)
                dur = max(rec.get("dur", 0.0) * 1e6, 1.0)
                args = {
                    k: rec[k]
                    for k in ("dst", "n", "bytes", "qdepth", "err", "trace")
                    if k in rec
                }
                args["clk"] = rec.get("step")
                name = f"{ev} {_tag_name(rec.get('mtag'))}"
                events.append({
                    "ph": "X", "name": name, "cat": "wire",
                    "pid": rank, "tid": 0, "ts": ts, "dur": dur,
                    "args": args,
                })
                if "span" in rec:
                    events.append({
                        "ph": "s", "id": f"{rec['span']:x}", "name": "msg",
                        "cat": "flow", "pid": rank, "tid": 0, "ts": ts,
                    })
                key = (rank, rec.get("dst"), rec.get("mtag"), rec.get("n"))
                send_index.setdefault(key, ts)
            elif ev == "recv":
                wait = rec.get("wait", 0.0)
                end = us(t)
                ts = max(us(t - wait), 0.0)
                args = {
                    k: rec[k]
                    for k in ("src", "n", "bytes", "trace")
                    if k in rec
                }
                args["clk"] = rec.get("step")
                events.append({
                    "ph": "X",
                    "name": f"recv {_tag_name(rec.get('mtag'))}",
                    "cat": "wire", "pid": rank, "tid": 0, "ts": ts,
                    "dur": max(end - ts, 1.0), "args": args,
                })
                if "from_span" in rec:
                    # bind to the enclosing recv slice: arrow head lands
                    # where the wait ended
                    events.append({
                        "ph": "f", "bp": "e", "id": f"{rec['from_span']:x}",
                        "name": "msg", "cat": "flow", "pid": rank,
                        "tid": 0, "ts": end,
                    })
            elif ev == "span_b":
                events.append({
                    "ph": "B", "name": str(rec.get("name", "span")),
                    "cat": "span", "pid": rank, "tid": 0, "ts": us(t),
                    "args": {
                        k: rec[k]
                        for k in ("trace", "span", "parent", "step")
                        if k in rec
                    },
                })
            elif ev == "span_e":
                events.append({
                    "ph": "E", "name": str(rec.get("name", "span")),
                    "cat": "span", "pid": rank, "tid": 0, "ts": us(t),
                })
            elif ev in ("prefill", "segment"):
                # serving work slices: t is stamped at END of the
                # operation, dur carries its extent (the recv idiom)
                dur = max(rec.get("dur", 0.0) * 1e6, 1.0)
                ts = max(us(t) - dur, 0.0)
                if ev == "prefill":
                    name = f"prefill x{rec.get('k', '?')}"
                    keys = ("k", "bucket")
                else:
                    name = (
                        "spec segment" if rec.get("spec") else "segment"
                    )
                    keys = ("seg", "occupied", "nslots", "waiting")
                events.append({
                    "ph": "X", "name": name, "cat": "serve",
                    "pid": rank, "tid": 1, "ts": ts, "dur": dur,
                    "args": {k: rec[k] for k in keys if k in rec},
                })
            elif ev == "req_enqueue":
                # request lifecycles as async spans keyed by rid: one
                # lane per in-flight request in Perfetto, enqueue ->
                # admit -> first token -> finish/cancel
                rid = rec.get("rid")
                events.append({
                    "ph": "b", "name": f"req {rid}", "cat": "request",
                    "id": str(rid), "pid": rank, "tid": 2, "ts": us(t),
                    "args": {
                        k: rec[k]
                        for k in ("p_len", "max_new", "slo_ms")
                        if k in rec
                    },
                })
            elif ev in ("req_admit", "req_first_token"):
                rid = rec.get("rid")
                events.append({
                    "ph": "n", "name": ev[4:], "cat": "request",
                    "id": str(rid), "pid": rank, "tid": 2, "ts": us(t),
                    "args": (
                        {"slot": rec["slot"]} if "slot" in rec else {}
                    ),
                })
            elif ev in ("req_finish", "req_cancel"):
                rid = rec.get("rid")
                events.append({
                    "ph": "e", "name": f"req {rid}", "cat": "request",
                    "id": str(rid), "pid": rank, "tid": 2, "ts": us(t),
                    "args": {
                        k: rec[k]
                        for k in ("reason", "gen", "where")
                        if k in rec
                    },
                })
            elif ev == "serve_fault":
                events.append({
                    "ph": "i", "s": "p",
                    "name": f"fault {rec.get('kind', '?')}",
                    "cat": "chaos", "pid": rank, "tid": 1, "ts": us(t),
                    "args": {
                        k: rec[k]
                        for k in ("boundary", "delay")
                        if k in rec
                    },
                })
            elif ev == "dynamics":
                # training-dynamics counter track (per client rank):
                # Perfetto renders ph "C" as a value-over-time lane, so
                # the elastic distance ‖x_local − x̃‖ trajectory sits
                # directly under the rank's wire/span slices
                events.append({
                    "ph": "C", "name": "elastic_dist", "cat": "dynamics",
                    "pid": rank, "tid": 0, "ts": us(t),
                    "args": {"value": rec.get("elastic", 0.0)},
                })
            elif ev == "push_stale":
                # per-source staleness counter track on the server rank:
                # one lane per pushing client, so a delayed client's
                # elevated staleness is visually attributable
                events.append({
                    "ph": "C",
                    "name": f"staleness src {rec.get('src')}",
                    "cat": "dynamics", "pid": rank, "tid": 0,
                    "ts": us(t),
                    "args": {"value": rec.get("staleness", 0)},
                })
            elif ev == "journal_cap":
                # truncation evidence (cap footer, written incrementally):
                # where the journal stopped/evicted is itself a clue
                events.append({
                    "ph": "i", "s": "p", "name": "journal truncated",
                    "cat": "obs", "pid": rank, "tid": 0, "ts": us(t),
                    "args": {
                        k: rec[k]
                        for k in (
                            "cap", "dropped_records", "mode",
                            "evicted_records",
                        ) if k in rec
                    },
                })
            elif ev == "blackbox":
                # flight-recorder dump header — marks where a window was
                # frozen and why (merging dump files gives the incident
                # trace the postmortem --perfetto flag asks for)
                events.append({
                    "ph": "i", "s": "p",
                    "name": f"blackbox dump ({rec.get('trigger', '?')})",
                    "cat": "obs", "pid": rank, "tid": 0, "ts": us(t),
                    "args": {
                        k: rec[k]
                        for k in (
                            "trigger", "incident", "records", "evicted",
                            "gen", "t_first", "t_last",
                        ) if k in rec
                    },
                })

    if faults_path is not None:
        for fault in read_fault_log(faults_path):
            key = (fault["src"], fault["dst"], fault["tag"], fault["n"])
            ts = send_index.get(key)
            args = {
                "dst": fault["dst"],
                "mtag": _tag_name(fault["tag"]),
                "n": fault["n"],
            }
            if ts is None:
                # no matching telemetry send (sampled out, or the journal
                # died first): pin at the timeline origin, visibly marked
                ts = 0.0
                args["unplaced"] = True
            events.append({
                "ph": "i", "s": "p", "name": f"fault {fault['kind']}",
                "cat": "chaos", "pid": fault["src"], "tid": 0, "ts": ts,
                "args": args,
            })

    if alerts_path is not None:
        # live-plane alerts join by (rank, wall-clock): unlike chaos
        # faults (no timestamp — joined through the send stream index)
        # an alert record carries the aggregator's wall-clock `t`, which
        # shares the journals' timebase, so it places directly. Alerts
        # raised after the last journal event (a dead rank is noticed
        # only once its journal went quiet) land past the timeline end —
        # that is the honest position, not an artifact.
        for rec in read_journal(alerts_path):
            if rec.get("ev") != "alert" or rec.get("t") is None:
                continue
            events.append({
                "ph": "i", "s": "p",
                "name": f"alert {rec.get('kind', '?')}",
                "cat": "alert", "pid": rec.get("rank", 0), "tid": 0,
                "ts": max(us(rec["t"]), 0.0),
                "args": rec.get("detail", {}),
            })

    events.sort(key=lambda e: (e.get("ts", 0.0), e["pid"]))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def trace_ids_by_rank(journal_paths: Iterable[str]) -> dict[int, set]:
    """trace-id sets per rank — the cross-rank assertion helper (a trace
    spanning client and server appears in >= 2 ranks' sets)."""
    out: dict[int, set] = {}
    for path in expand_journal_paths(journal_paths):
        for rec in read_journal(path):
            if "trace" in rec:
                out.setdefault(_rec_rank(rec), set()).add(rec["trace"])
    return out


def _lat_bucket(seconds: float) -> int:
    # ceil(log2(µs)); bucket b holds (2^(b-1), 2^b] µs — kept in lockstep
    # with mpit_tpu_torch.obs.telemetry._lat_bucket, replicated here so the
    # merger stays importable without the transport stack
    return max(0, int(seconds * 1e6)).bit_length()


def _stream_stats(journal_paths: Iterable[str]) -> dict:
    """(rank, dir, peer, tag) -> {msgs, bytes, hist} from the journals:
    ``dir`` is "send"/"recv", ``peer`` the remote rank, ``hist`` the
    log2-µs latency histogram (send duration / recv blocked wait)."""
    out: dict[tuple, dict] = {}
    for path in expand_journal_paths(journal_paths):
        for rec in read_journal(path):
            ev = rec.get("ev")
            if ev in ("send", "isend"):
                key = (_rec_rank(rec), "send", rec.get("dst"),
                       rec.get("mtag"))
                lat = rec.get("dur")
            elif ev == "recv":
                key = (_rec_rank(rec), "recv", rec.get("src"),
                       rec.get("mtag"))
                lat = rec.get("wait")
            else:
                continue
            s = out.setdefault(key, {"msgs": 0, "bytes": 0, "hist": {}})
            s["msgs"] += 1
            s["bytes"] += rec.get("bytes", 0)
            if lat is not None:
                b = _lat_bucket(lat)
                s["hist"][b] = s["hist"].get(b, 0) + 1
    return out


def _hist_p50(hist: dict) -> Optional[int]:
    """Median latency bucket — the scalar each stream's histograms are
    compared by (a whole-bucket shift = a 2x latency regression)."""
    total = sum(hist.values())
    if not total:
        return None
    seen = 0
    for b in sorted(hist):
        seen += hist[b]
        if 2 * seen >= total:
            return b
    return max(hist)


def diff_summaries(
    run_a: Iterable[str], run_b: Iterable[str]
) -> list[dict]:
    """Per-(rank, dir, peer, tag) stream comparison of two runs — message
    and byte counts plus the median latency bucket. One row per stream
    present in either run, sorted; ``delta_*`` is b - a (missing stream =
    zeros/None). Rows where nothing moved carry ``same: True`` so callers
    can filter to the interesting ones."""
    a, b = _stream_stats(run_a), _stream_stats(run_b)
    rows = []
    for key in sorted(set(a) | set(b), key=str):
        rank, direction, peer, tag = key
        sa = a.get(key, {"msgs": 0, "bytes": 0, "hist": {}})
        sb = b.get(key, {"msgs": 0, "bytes": 0, "hist": {}})
        pa, pb = _hist_p50(sa["hist"]), _hist_p50(sb["hist"])
        rows.append({
            "rank": rank,
            "dir": direction,
            "peer": peer,
            "tag": tag,
            "tag_name": _tag_name(tag),
            "msgs_a": sa["msgs"], "msgs_b": sb["msgs"],
            "delta_msgs": sb["msgs"] - sa["msgs"],
            "bytes_a": sa["bytes"], "bytes_b": sb["bytes"],
            "delta_bytes": sb["bytes"] - sa["bytes"],
            "p50_bucket_a": pa, "p50_bucket_b": pb,
            "delta_p50_bucket": (
                pb - pa if pa is not None and pb is not None else None
            ),
            "same": sa["msgs"] == sb["msgs"]
            and sa["bytes"] == sb["bytes"]
            and pa == pb,
        })
    return rows


def summarize(journal_paths: Iterable[str]) -> dict:
    """Per-rank event/byte tallies for the ``summary`` subcommand."""
    out: dict[int, dict] = {}
    for path in expand_journal_paths(journal_paths):
        for rec in read_journal(path):
            if "ev" not in rec:
                continue
            r = out.setdefault(
                _rec_rank(rec),
                {"events": 0, "sends": 0, "recvs": 0, "bytes": 0,
                 "traces": set()},
            )
            r["events"] += 1
            if rec["ev"] in ("send", "isend"):
                r["sends"] += 1
                r["bytes"] += rec.get("bytes", 0)
            elif rec["ev"] == "recv":
                r["recvs"] += 1
            if "trace" in rec:
                r["traces"].add(rec["trace"])
    return {
        rank: {**v, "traces": len(v["traces"])}
        for rank, v in sorted(out.items())
    }


def _merge_intervals(intervals: list) -> list:
    """Sorted disjoint union of (start, end) intervals."""
    merged: list = []
    for b, e in sorted(i for i in intervals if i[1] > i[0]):
        if merged and b <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((b, e))
    return merged


def _overlap(start: float, end: float, merged: list) -> float:
    """Length of [start, end] covered by the sorted disjoint intervals."""
    total = 0.0
    for b, e in merged:
        if e <= start:
            continue
        if b >= end:
            break
        total += min(e, end) - max(b, start)
    return total


def roofline(journal_paths: Iterable[str]) -> dict:
    """Per-rank and per-run compute/wire/idle/overhead attribution.

    The roofline join (docs/OBSERVABILITY.md), in the spirit of the
    MVAPICH DNN-training characterization (PAPERS.md, arXiv:1810.11112):

    - **compute** — wall-clock inside ``"compute"`` spans, which the
      training loop closes with proof-of-completion blocking so the
      figure is real device time, not dispatch time;
    - **wire** — every journaled send's in-transport duration, plus recv
      waits that fall *inside* one of the rank's spans (a client blocked
      in ``fetch()`` mid-exchange is waiting on the wire);
    - **idle** — recv waits *outside* any span: a server parked in its
      dispatch loop, or a client between protocol phases;
    - **overhead** — the remainder of the rank's observation window
      (Python, journaling, untraced host work).

    Fractions are normalized by ``max(window, compute + wire + idle)`` so
    they sum to exactly 1.0 even when sampled intervals overlap. Ranks
    that never open a span are reported as role ``"server"`` (the PS
    servers run no local step); span-opening ranks are ``"clients"`` and
    the slowest of them (by compute seconds, when the spread is > 5%) is
    flagged as the straggler.
    """
    per_rank: dict[int, list[dict]] = {}
    for path in expand_journal_paths(journal_paths):
        for rec in read_journal(path):
            if "ev" not in rec or _rec_time(rec) is None:
                continue
            per_rank.setdefault(_rec_rank(rec), []).append(rec)

    ranks: dict[int, dict] = {}
    for rank, recs in sorted(per_rank.items()):
        times = [_rec_time(r) for r in recs]
        window = max(times) - min(times) if len(times) > 1 else 0.0
        open_spans: dict = {}  # span id -> (name, t_begin)
        spans: list = []  # (begin, end) of every closed span
        compute_s = 0.0
        exch: list = []
        sends = recvs = nbytes = 0
        wire_s = idle_s = 0.0
        waits: list = []  # (begin, end) recv waits, classified below
        for rec in recs:
            ev, t = rec["ev"], _rec_time(rec)
            if ev == "span_b":
                open_spans[rec.get("span")] = (rec.get("name"), t)
            elif ev == "span_e":
                opened = open_spans.pop(rec.get("span"), None)
                if opened is None:
                    continue
                name, t_b = opened
                spans.append((t_b, t))
                if name == "compute":
                    compute_s += t - t_b
                elif name == "exchange":
                    exch.append(t - t_b)
            elif ev in ("send", "isend"):
                sends += 1
                nbytes += rec.get("bytes", 0)
                wire_s += rec.get("dur", 0.0)
            elif ev == "recv":
                recvs += 1
                nbytes += rec.get("bytes", 0)
                wait = rec.get("wait", 0.0)
                if wait > 0:
                    waits.append((t - wait, t))
        merged = _merge_intervals(spans)
        for b, e in waits:
            in_span = _overlap(b, e, merged)
            wire_s += in_span
            idle_s += (e - b) - in_span
        denom = max(window, compute_s + wire_s + idle_s)
        overhead_s = denom - (compute_s + wire_s + idle_s)
        ranks[rank] = {
            "role": "client" if spans or open_spans else "server",
            "window_s": window,
            "compute_s": compute_s,
            "wire_s": wire_s,
            "idle_s": idle_s,
            "overhead_s": overhead_s,
            "phases": {
                "compute": compute_s / denom if denom else 0.0,
                "wire": wire_s / denom if denom else 0.0,
                "idle": idle_s / denom if denom else 0.0,
                "overhead": overhead_s / denom if denom else 1.0,
            },
            "sends": sends,
            "recvs": recvs,
            "bytes": nbytes,
            "exchanges": len(exch),
            "exchange_mean_s": sum(exch) / len(exch) if exch else None,
        }

    if not ranks:
        return {"ranks": {}, "run": None, "straggler": None}

    tot = {
        k: sum(r[k] for r in ranks.values())
        for k in ("compute_s", "wire_s", "idle_s", "overhead_s")
    }
    denom = sum(
        max(r["window_s"], r["compute_s"] + r["wire_s"] + r["idle_s"])
        for r in ranks.values()
    )
    run = {
        **tot,
        "window_s": max(r["window_s"] for r in ranks.values()),
        "phases": {
            "compute": tot["compute_s"] / denom if denom else 0.0,
            "wire": tot["wire_s"] / denom if denom else 0.0,
            "idle": tot["idle_s"] / denom if denom else 0.0,
            "overhead": tot["overhead_s"] / denom if denom else 1.0,
        },
        "ranks": len(ranks),
        "clients": sum(1 for r in ranks.values() if r["role"] == "client"),
        "bytes": sum(r["bytes"] for r in ranks.values()),
    }

    straggler = None
    clients = {
        rk: r["compute_s"] for rk, r in ranks.items()
        if r["role"] == "client" and r["compute_s"] > 0
    }
    if len(clients) >= 2:
        lo, hi = min(clients.values()), max(clients.values())
        if hi > 1.05 * lo:
            straggler = max(clients, key=lambda rk: clients[rk])

    return {"ranks": ranks, "run": run, "straggler": straggler}
