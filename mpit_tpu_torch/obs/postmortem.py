"""Cross-rank post-mortem over black-box flight-recorder dumps.

A copy of ``mpit_tpu/obs/postmortem.py`` for the port's CLI.

``python -m mpit_tpu_torch.obs postmortem <dir>`` assembles the incident
report a human would otherwise stitch together by hand from N per-rank
dump files:

- **aligns** the per-rank dump windows on a shared timeline (relative
  wall offsets from the earliest dumped record) and cross-checks the
  alignment with Lamport clocks — every traced ``recv`` carries the
  sender's clock (``rclk``), which pairs it with the send record
  bearing the same stamp;
- **names the first-mover**: who stalled or died first. Membership
  events (``launch.py`` records the kill signal / child exit code) are
  the primary citation; absent those, the dead-rank staleness idea from
  the alert engine is applied *retrospectively* — each rank's
  "last heard from" is the freshest record it dumped OR any other rank
  received from it, and the rank that went silent earliest (relative to
  the freshest rank, beyond the median-gap threshold) is named;
- **reconstructs the last K exchange rounds** per client: each PUSH
  send (stream index ``n``) is joined against the server dumps' recvs
  of the same stream — acked vs dropped — and overlaid with the
  staleness the server measured for that client, the client's own
  elastic distance / norm-ratio dynamics, and the wire phase split
  (serialize / queue-wait / write) of each push;
- **overlays** chaos faults (dump-embedded fault schedules and
  ``faults*.jsonl``), live-plane alerts, and membership churn.

Exit codes: 0 clean, 1 incident found, 2 no dumps. ``--json`` emits the
full report; ``--perfetto`` additionally writes an incident-window
Chrome trace of the dumps via :mod:`mpit_tpu_torch.obs.merge`.

``<dir>`` is the run dir (``MPIT_OBS_DIR``) — dumps are read from its
``blackbox/`` subdir, or from ``<dir>`` itself when it directly holds
``rank_*.jsonl`` (the golden-fixture layout). Stdlib-only, like every
reader in this package.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

from mpit_tpu_torch.obs.merge import TAG_NAMES, read_fault_log

#: PUSH streams (client -> server parameter updates) — the exchange
#: rounds the report reconstructs
_PUSH_TAGS = (2, 3)
#: staleness threshold for the retrospective first-mover call: a rank
#: is "gone" when its silence exceeds this multiple of the median
#: cross-rank record gap (mirrors AlertConfig.staleness_factor)
_SILENCE_FACTOR = 3.0
_SILENCE_FLOOR_S = 0.05


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
                    continue  # torn tail of a killed writer
    except OSError:
        pass
    return out


def dump_paths(path: str) -> list:
    """The dump files for a run dir: ``<dir>/blackbox/rank_*.jsonl``
    (current + per-generation archives), or ``<dir>/rank_*.jsonl`` when
    the dir itself is a dump dir."""
    for d in (os.path.join(path, "blackbox"), path):
        found = sorted(glob.glob(os.path.join(d, "rank_*.jsonl")))
        if found:
            return found
    return []


def load_dumps(path: str) -> dict:
    """Parse dump files into per-(rank, gen) streams. Each file holds
    one or more segments (``ev: "blackbox"`` header, then records);
    overlapping segments (an incident dump followed by the close dump
    of the same window) are deduplicated on (clk, ev, t)."""
    ranks: dict = {}
    for p in dump_paths(path):
        for rec in _read_jsonl(p):
            rank = rec.get("rank")
            if rank is None:
                continue
            if rec.get("ev") == "blackbox":
                key = (rank, rec.get("gen", 0))
                slot = ranks.setdefault(
                    key, {"headers": [], "records": [], "_seen": set()}
                )
                slot["headers"].append(rec)
                continue
            gen = rec.get("gen", None)
            # records don't carry gen; attach to the rank's latest
            # opened segment (dump files are written header-first)
            key = None
            for k in ranks:
                if k[0] == rank and (gen is None or k[1] == gen):
                    key = k
            if key is None:
                key = (rank, 0)
                ranks[key] = {"headers": [], "records": [], "_seen": set()}
            slot = ranks[key]
            sig = (rec.get("step"), rec.get("ev"), rec.get("t"))
            if sig in slot["_seen"]:
                continue
            slot["_seen"].add(sig)
            slot["records"].append(rec)
    for slot in ranks.values():
        slot.pop("_seen")
        slot["records"].sort(key=lambda r: (r.get("t") or 0.0))
    return ranks


def _membership(path: str) -> list:
    """Supervisor membership transitions (``ev: "membership"``, with the
    transition in ``kind``: spawn/kill/exit/respawn/done). ``t`` is
    monotonic-relative (ordering within the file); ``wt`` is the wall
    clock stamp that joins the dump timeline."""
    return [
        r for r in _read_jsonl(os.path.join(path, "membership.jsonl"))
        if r.get("ev") == "membership"
    ]


def _alerts(path: str) -> list:
    for cand in (
        os.path.join(path, "live", "alerts.jsonl"),
        os.path.join(path, "alerts.jsonl"),
    ):
        recs = _read_jsonl(cand)
        if recs:
            return [r for r in recs if r.get("ev") == "alert"]
    return []


def _median(vals: list) -> float:
    s = sorted(vals)
    return s[len(s) // 2] if s else 0.0


def _last_heard(ranks: dict) -> dict:
    """rank -> latest wall-clock anyone (itself included) has evidence
    of it being alive: its own dumped records, plus recvs FROM it in
    other ranks' dumps."""
    heard: dict = {}

    def _note(rank, t):
        if rank is None or t is None:
            return
        if rank not in heard or t > heard[rank]:
            heard[rank] = t

    for (rank, _gen), slot in ranks.items():
        for rec in slot["records"]:
            _note(rank, rec.get("t"))
            if rec.get("ev") == "recv":
                _note(rec.get("src"), rec.get("t"))
    return heard


def _first_mover(ranks: dict, membership: list, alerts: list) -> dict:
    """Name who moved first, best evidence wins: a supervisor-recorded
    kill/abnormal-exit, else the earliest dead_rank alert, else the
    retrospective staleness call over the dumps."""
    churn = [
        m for m in membership
        if m.get("kind") in ("kill", "leave")
        or (m.get("kind") == "exit" and m.get("code", 0) != 0)
    ]
    if churn:
        first = min(churn, key=lambda m: m.get("t", 0.0))
        why = f"membership: {first['kind']}"
        if first.get("signal"):
            why += f" by {first['signal']}"
        if first.get("code") is not None:
            why += f" (exit code {first['code']})"
        return {
            "rank": first.get("rank"),
            "gen": first.get("gen"),
            "source": "membership",
            "why": why,
            "event": first,
        }
    dead = [a for a in alerts if a.get("kind") == "dead_rank"]
    if dead:
        first = min(dead, key=lambda a: a.get("t", 0.0))
        return {
            "rank": first.get("rank"),
            "source": "alert",
            "why": "earliest dead_rank alert",
            "event": first,
        }
    heard = _last_heard(ranks)
    if len(heard) < 2:
        return {"rank": None, "source": None, "why": "no cross-rank evidence"}
    now = max(heard.values())
    # threshold from the observed record cadence, alert-engine style
    ts = sorted(
        t for slot in ranks.values() for t in
        (r.get("t") for r in slot["records"]) if t is not None
    )
    gaps = [b - a for a, b in zip(ts, ts[1:]) if b > a]
    limit = max(_SILENCE_FLOOR_S, _SILENCE_FACTOR * _median(gaps))
    rank, t = min(heard.items(), key=lambda kv: kv[1])
    silence = now - t
    if silence <= limit:
        return {
            "rank": None, "source": None,
            "why": f"no rank silent beyond {limit:.3f}s",
        }
    return {
        "rank": rank,
        "source": "staleness",
        "why": (
            f"silent {silence:.3f}s before the freshest rank "
            f"(threshold {limit:.3f}s)"
        ),
        "silence_s": round(silence, 3),
        "threshold_s": round(limit, 3),
    }


def _exchange_rounds(ranks: dict, k: int) -> dict:
    """Per client rank: the last ``k`` PUSH rounds, each send joined
    (by per-stream index ``n``) against the destination server's
    dumped recvs — acked / dropped / unknown (no server dump)."""
    # (src, dst, tag) -> set of n the server actually received
    acked: dict = {}
    server_dumped: set = set()
    # (src, server) -> that server's recv records from src, in order —
    # the ONLY surviving view of a SIGKILLed client's final pushes
    recv_view: dict = {}
    # (src, server) -> server-side staleness sequence for that client
    staleness: dict = {}
    for (rank, _gen), slot in ranks.items():
        for rec in slot["records"]:
            ev = rec.get("ev")
            if ev == "recv" and rec.get("mtag") in _PUSH_TAGS:
                server_dumped.add(rank)
                key = (rec.get("src"), rank, rec.get("mtag"))
                acked.setdefault(key, set()).add(rec.get("n"))
                recv_view.setdefault(
                    (rec.get("src"), rank), []
                ).append(rec)
            elif ev == "push_stale":
                staleness.setdefault(
                    (rec.get("src"), rank), []
                ).append({
                    "t": rec.get("t"),
                    "staleness": rec.get("staleness"),
                    "version": rec.get("version"),
                    "epoch": rec.get("epoch"),
                })
    out: dict = {}
    for (rank, gen), slot in ranks.items():
        pushes = []
        dyn = []
        for rec in slot["records"]:
            ev = rec.get("ev")
            if ev in ("send", "isend") and rec.get("mtag") in _PUSH_TAGS:
                dst = rec.get("dst")
                n = rec.get("n")
                row = {
                    "n": n,
                    "dst": dst,
                    "tag": TAG_NAMES.get(rec.get("mtag"), rec.get("mtag")),
                    "t": rec.get("t"),
                    "clk": rec.get("step"),
                    "bytes": rec.get("bytes"),
                    "dur_ms": (
                        round(rec["dur"] * 1e3, 3)
                        if rec.get("dur") is not None else None
                    ),
                }
                phases = {
                    key: round(rec[f] * 1e3, 3)
                    for key, f in (
                        ("ser_ms", "ser"), ("qw_ms", "qw"), ("wr_ms", "wr"),
                    ) if rec.get(f) is not None
                }
                if phases:
                    row["phases"] = phases
                if dst in server_dumped:
                    row["acked"] = (
                        n in acked.get((rank, dst, rec.get("mtag")), set())
                    )
                else:
                    row["acked"] = None  # server window not captured
                pushes.append(row)
            elif ev == "dynamics":
                dyn.append({
                    "round": rec.get("round"),
                    "t": rec.get("t"),
                    "elastic": rec.get("elastic"),
                    "ratio": rec.get("ratio"),
                    "push_norm": rec.get("push_norm"),
                })
        if not pushes:
            continue
        pushes = pushes[-k:]
        entry: dict = {"gen": gen, "pushes": pushes}
        if dyn:
            entry["dynamics"] = dyn[-k:]
        seen = {
            str(server): seq[-k:]
            for (src, server), seq in staleness.items() if src == rank
        }
        if seen:
            entry["staleness_at_server"] = seen
        out.setdefault(str(rank), entry)
    # a SIGKILLed client leaves no dump of its own — reconstruct its
    # final rounds from the SURVIVING servers' recv windows (received
    # by definition; what it sent-but-lost died with it)
    dumped = {rank for (rank, _gen) in ranks}
    for (src, server), recs in sorted(recv_view.items(), key=str):
        if src is None or src in dumped:
            continue
        entry = out.setdefault(
            str(src), {"gen": None, "view": "server", "pushes": []}
        )
        if entry.get("view") != "server":
            continue
        for rec in recs:
            entry["pushes"].append({
                "n": rec.get("n"),
                "dst": server,
                "tag": TAG_NAMES.get(rec.get("mtag"), rec.get("mtag")),
                "t": rec.get("t"),
                "clk": rec.get("rclk"),
                "bytes": rec.get("bytes"),
                "dur_ms": None,
                "acked": True,
            })
        seen = {
            str(sv): seq[-k:]
            for (s, sv), seq in staleness.items() if s == src
        }
        if seen:
            entry["staleness_at_server"] = seen
    for entry in out.values():
        if entry.get("view") == "server":
            entry["pushes"].sort(key=lambda p: (p["t"] or 0.0))
            entry["pushes"] = entry["pushes"][-k:]
    return out


def analyze(path: str, k_rounds: int = 5) -> Optional[dict]:
    """Build the full post-mortem report for a run dir; None when no
    dump records exist (exit 2 at the CLI)."""
    ranks = load_dumps(path)
    if not any(slot["records"] for slot in ranks.values()):
        return None
    membership = _membership(path)
    alerts = _alerts(path)
    all_ts = [
        r["t"] for slot in ranks.values()
        for r in slot["records"] if r.get("t") is not None
    ]
    t0 = min(all_ts)

    windows: dict = {}
    for (rank, gen), slot in sorted(ranks.items()):
        recs = slot["records"]
        hdr = slot["headers"][-1] if slot["headers"] else {}
        triggers = sorted({
            h.get("trigger") for h in slot["headers"] if h.get("trigger")
        })
        incidents = sorted({
            h["incident"] for h in slot["headers"] if h.get("incident")
        })
        win = {
            "gen": gen,
            "records": len(recs),
            "evicted": hdr.get("evicted", 0),
            "triggers": triggers,
            "window_s": [
                round(recs[0]["t"] - t0, 3),
                round(recs[-1]["t"] - t0, 3),
            ] if recs else None,
            "last_clk": max(
                (r.get("step", 0) for r in recs), default=0
            ),
        }
        if incidents:
            win["incidents"] = incidents
        slo_misses = sum(
            1 for r in recs
            if r.get("ev") == "req_finish" and r.get("slo_miss")
        )
        if slo_misses:
            win["slo_misses"] = slo_misses
        windows[str(rank)] = win

    heard = _last_heard(ranks)
    mover = _first_mover(ranks, membership, alerts)
    exchanges = _exchange_rounds(ranks, k_rounds)

    # clock alignment check: recv records pair with their send via the
    # sender's Lamport stamp; the wall offset of each pair bounds the
    # cross-rank clock skew (one machine → ~µs; it is evidence either way)
    sends: dict = {}
    for (rank, _gen), slot in ranks.items():
        for r in slot["records"]:
            if r.get("ev") in ("send", "isend"):
                sends[(rank, r.get("step"))] = r.get("t")
    skews = []
    for (rank, _gen), slot in ranks.items():
        for r in slot["records"]:
            if r.get("ev") == "recv" and r.get("rclk") is not None:
                st = sends.get((r.get("src"), r.get("rclk")))
                if st is not None and r.get("t") is not None:
                    skews.append(r["t"] - st)
    clock = {
        "paired_messages": len(skews),
        "skew_median_ms": (
            round(_median(skews) * 1e3, 3) if skews else None
        ),
    }

    churn = [
        m for m in membership
        if m.get("kind") in ("kill", "exit", "respawn", "leave", "join")
    ]
    faults = [
        r for slot in ranks.values() for r in slot["records"]
        if r.get("x_source") == "faults" or r.get("ev") == "fault"
    ]
    if not faults:
        faults = read_fault_log(path) or []
    dropped = sum(
        1 for entry in exchanges.values()
        for p in entry["pushes"] if p.get("acked") is False
    )

    findings = []
    if mover.get("rank") is not None:
        findings.append(
            f"first-mover: rank {mover['rank']} ({mover['why']})"
        )
    if dropped:
        findings.append(
            f"{dropped} push(es) sent but never received by a dumped "
            "server window"
        )
    for a in alerts:
        findings.append(f"alert {a.get('kind')} on rank {a.get('rank')}")
    for m in churn:
        if m.get("kind") in ("kill", "exit", "leave"):
            note = f"membership: rank {m.get('rank')} {m['kind']}"
            if m.get("signal"):
                note += f" ({m['signal']})"
            if m.get("kind") == "exit" and m.get("code") is not None:
                note += f" code {m['code']}"
            findings.append(note)
    if faults:
        findings.append(f"{len(faults)} chaos fault(s) in the window")

    incident = bool(
        mover.get("rank") is not None
        or dropped
        or alerts
        or any(
            m.get("kind") in ("kill", "leave")
            or (m.get("kind") == "exit" and m.get("code", 0) != 0)
            for m in churn
        )
    )
    return {
        "dir": path,
        "t0": t0,
        "verdict": "incident" if incident else "clean",
        "ranks": windows,
        "last_heard_s": {
            str(r): round(t - t0, 3) for r, t in sorted(heard.items())
        },
        "first_mover": mover,
        "exchanges": exchanges,
        "clock": clock,
        "membership": churn,
        "alerts": alerts,
        "faults_n": len(faults),
        "findings": findings,
    }


def format_report(report: dict) -> str:
    """The human rendering (the --json shape is the report itself)."""
    lines = []
    verdict = report["verdict"].upper()
    mover = report["first_mover"]
    lines.append(
        f"post-mortem: {verdict} — {len(report['ranks'])} dumped "
        f"window(s) under {report['dir']}"
    )
    if mover.get("rank") is not None:
        lines.append(f"first-mover: rank {mover['rank']} — {mover['why']}")
    else:
        lines.append(f"first-mover: none ({mover['why']})")
    lines.append(f"{'rank':>4} {'gen':>3} {'recs':>5} {'evict':>5} "
                 f"{'window (rel s)':>16} {'clk':>6}  triggers")
    for rank, w in sorted(report["ranks"].items(), key=lambda kv: kv[0]):
        win = (
            f"{w['window_s'][0]:.3f}..{w['window_s'][1]:.3f}"
            if w.get("window_s") else "-"
        )
        lines.append(
            f"{rank:>4} {w['gen']:>3} {w['records']:>5} "
            f"{w['evicted']:>5} {win:>16} {w['last_clk']:>6}  "
            + ",".join(w["triggers"] or ["-"])
        )
    for rank, entry in sorted(report["exchanges"].items()):
        via = (
            " (server view — its own window died with it)"
            if entry.get("view") == "server" else ""
        )
        lines.append(f"rank {rank} — last {len(entry['pushes'])} "
                     f"push round(s){via}:")
        for p in entry["pushes"]:
            ack = {True: "acked", False: "DROPPED", None: "unknown"}[
                p["acked"]
            ]
            ph = p.get("phases")
            phs = (
                " ser/qw/wr "
                + "/".join(
                    str(ph.get(k, "-"))
                    for k in ("ser_ms", "qw_ms", "wr_ms")
                ) + "ms"
                if ph else ""
            )
            dur = f"{p['dur_ms']}ms" if p.get("dur_ms") is not None else "-"
            lines.append(
                f"   n={p['n']} -> rank {p['dst']} {p['tag']} "
                f"{p['bytes']}B {dur} {ack}{phs}"
            )
        for server, seq in sorted(
            entry.get("staleness_at_server", {}).items()
        ):
            vals = ",".join(str(s["staleness"]) for s in seq)
            lines.append(
                f"   staleness at server {server}: [{vals}] "
                f"(version {seq[-1]['version']})"
            )
        dyn = entry.get("dynamics")
        if dyn:
            d = dyn[-1]
            lines.append(
                f"   dynamics @round {d['round']}: elastic "
                f"{d['elastic']} ratio {d['ratio']}"
            )
    clock = report["clock"]
    if clock["paired_messages"]:
        lines.append(
            f"clock: {clock['paired_messages']} send/recv pair(s) "
            f"aligned via Lamport stamps, median wall skew "
            f"{clock['skew_median_ms']}ms"
        )
    for f in report["findings"]:
        lines.append(f"finding: {f}")
    return "\n".join(lines)
