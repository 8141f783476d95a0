"""CLI: merge per-rank obs journals into a Perfetto-loadable trace.

The port's copy of ``mpit_tpu/obs/__main__.py``: the same commands, output
and exit codes, with no JAX on the machine that reads the run.

    python -m mpit_tpu_torch.obs merge RUN_DIR [-o trace.json] [--faults f.jsonl]
    python -m mpit_tpu_torch.obs summary RUN_DIR
    python -m mpit_tpu_torch.obs summary --diff RUN_A RUN_B
    python -m mpit_tpu_torch.obs roofline RUN_DIR [--json]
    python -m mpit_tpu_torch.obs slo RUN_DIR [--gate slo.json] [--json]
    python -m mpit_tpu_torch.obs dynamics RUN_DIR [--gate dynamics.json] [--json]
    python -m mpit_tpu_torch.obs live RUN_DIR [--once] [--json] [--validate]
    python -m mpit_tpu_torch.obs postmortem RUN_DIR [--json] [--perfetto t.json]

``RUN_DIR`` is the ``MPIT_OBS_DIR`` of the run (or explicit journal
files). ``merge`` writes Chrome-trace JSON — open it at
https://ui.perfetto.dev (or chrome://tracing). With ``--faults`` (or a
``faults.jsonl`` sitting in the run dir) chaos faults render as instant
events on the rank that suffered them; live-plane alerts
(``live/alerts.jsonl``) render the same way. ``summary --diff`` compares
two runs stream by stream — per-(peer, tag) message/byte counters and
the median log2-µs latency bucket — and prints only the streams that
moved. ``roofline`` joins the journals into a per-rank and per-run
compute/wire/idle/overhead breakdown (fractions sum to 1.0; the slowest
client is flagged as straggler). ``slo`` reduces the serving lifecycle
events (``models/serving.py`` under the loadgen harness — see
docs/SERVING.md) to TTFT/TPOT/e2e percentiles, goodput, queue depth and
occupancy; ``--gate slo.json`` checks them against ceilings/floors.
``dynamics`` reduces the training-dynamics records
(docs/OBSERVABILITY.md "dynamics") to per-client staleness percentiles,
elastic-distance trajectories with a monotone-growth divergence
verdict, and update/param norm ratios; ``--gate dynamics.json`` checks
the run roll-up (``staleness_p99_max``, ``elastic_dist_final_max``,
``norm_ratio_max``, ``allow_diverging``).
``live`` reads the in-run snapshots a ``MPIT_OBS_LIVE=1`` run exports
(``live/rank_<r>.json``), renders a refreshing cross-rank dashboard
(``--once --json`` for scripting), and runs the online alert engine
(dead-rank, straggler, SLO burn) appending ``live/alerts.jsonl`` —
each firing also requests a black-box dump on every rank of the run
(``--no-dump`` to observe without touching the run dir).
``postmortem`` assembles the cross-rank incident report from the
black-box dumps (``blackbox/rank_*.jsonl``): first-mover, last
exchange rounds acked/dropped, staleness/elastic/wire-phase overlays,
membership + chaos churn — see docs/OBSERVABILITY.md "Black box".
Exit codes: 0 ok, 1 gate violation / new alerts / invalid snapshot /
incident found, 2 usage/empty.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from mpit_tpu_torch.obs.merge import (
    diff_summaries,
    expand_journal_paths,
    merge_to_chrome_trace,
    roofline,
    summarize,
    trace_ids_by_rank,
)


def _print_roofline(report: dict) -> None:
    hdr = (
        f"{'rank':>4} {'role':>6} {'window':>9} {'compute':>8} "
        f"{'wire':>8} {'idle':>8} {'ovhd':>8} {'exch':>5} {'bytes':>10}"
    )
    print(hdr)
    for rank, row in report["ranks"].items():
        ph = row["phases"]
        mark = " <- straggler" if rank == report["straggler"] else ""
        print(
            f"{rank:>4} {row['role']:>6} {row['window_s']:>8.3f}s "
            f"{ph['compute']:>7.1%} {ph['wire']:>7.1%} "
            f"{ph['idle']:>7.1%} {ph['overhead']:>7.1%} "
            f"{row['exchanges']:>5} {row['bytes']:>10}{mark}"
        )
    run = report["run"]
    ph = run["phases"]
    print(
        f" run: {run['clients']} client(s) / "
        f"{run['ranks'] - run['clients']} server(s), "
        f"window {run['window_s']:.3f}s — compute {ph['compute']:.1%}, "
        f"wire {ph['wire']:.1%}, idle {ph['idle']:.1%}, "
        f"overhead {ph['overhead']:.1%}"
    )


def _print_diff(rows) -> None:
    moved = [r for r in rows if not r["same"]]
    for r in moved:
        lat = ""
        if r["delta_p50_bucket"] is not None:
            lat = (
                f", p50 bucket {r['p50_bucket_a']} -> "
                f"{r['p50_bucket_b']}"
            )
        print(
            f"rank {r['rank']} {r['dir']} "
            f"{'->' if r['dir'] == 'send' else '<-'} peer {r['peer']} "
            f"{r['tag_name']}: msgs {r['msgs_a']} -> {r['msgs_b']} "
            f"({r['delta_msgs']:+d}), bytes {r['bytes_a']} -> "
            f"{r['bytes_b']} ({r['delta_bytes']:+d}){lat}"
        )
    print(
        f"{len(moved)} stream(s) changed, "
        f"{len(rows) - len(moved)} unchanged"
    )


def _fmt_ms(v) -> str:
    return "-" if v is None else f"{v:.1f}"


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _print_dynamics(report: dict) -> None:
    run = report["run"]
    verdict = "DIVERGING" if run["diverging"] else "stable"
    print(
        f"dynamics: {run['clients']} client(s) / {run['servers']} "
        f"server(s) — staleness p99 {_fmt(run['staleness_p99'])}, "
        f"elastic final {_fmt(run['elastic_dist_final'])}, "
        f"norm ratio {_fmt(run['norm_ratio'])} — {verdict}"
    )
    if report["staleness"]:
        print(f"{'src':>4} {'pushes':>7} {'p50':>5} {'p99':>5} "
              f"{'max':>5} {'mean':>7}")
        for src, row in report["staleness"].items():
            print(
                f"{src:>4} {row['pushes']:>7} {_fmt(row['p50']):>5} "
                f"{_fmt(row['p99']):>5} {_fmt(row['max']):>5} "
                f"{row['mean']:>7.2f}"
            )
    if report["clients"]:
        print(f"{'rank':>4} {'algo':>8} {'rounds':>7} {'elastic':>9} "
              f"{'(first->final)':>16} {'push':>9} {'ratio':>7}  verdict")
        for rank, row in report["clients"].items():
            el = row.get("elastic")
            span = (
                f"{_fmt(el['first'])}->{_fmt(el['final'])}"
                if el is not None else "-"
            )
            print(
                f"{rank:>4} {str(row.get('algo')):>8} "
                f"{row['rounds']:>7} "
                f"{_fmt(el['final'] if el else None):>9} {span:>16} "
                f"{_fmt(row.get('push_norm')):>9} "
                f"{_fmt(row.get('norm_ratio')):>7}  "
                + ("DIVERGING" if row.get("diverging") else "stable")
            )
    for rank, row in report["servers"].items():
        mono = "monotonic" if row["monotonic"] else "NON-MONOTONIC"
        print(
            f" server rank {rank}: {row['param_replies']} PARAM "
            f"replies, version {row['first_version']} -> "
            f"{row['final_version']} ({mono})"
        )


def _print_live(report: dict, live_dir: str, fired: list) -> None:
    run = report["run"]
    print(
        f"live: {run['ranks']} rank(s) under {live_dir} — "
        f"throughput {run['throughput']:.1f} samples/s, "
        f"max heartbeat age {run['max_age_s']:.1f}s"
    )
    hdr = (
        f"{'rank':>4} {'role':>6} {'age':>6} {'seq':>5} {'thr/s':>8} "
        f"{'queue':>5} {'compute':>8} {'wire':>6} {'other':>6} "
        f"{'exch p50/p90/p99 ms':>20}  faults"
    )
    print(hdr)
    for rank, row in report["ranks"].items():
        ph = row.get("phases")
        exch = row.get("exchange_ms")
        q = row.get("queue_depth")
        faults = ",".join(
            f"{k}:{v}" for k, v in sorted(row.get("faults", {}).items())
        ) or "-"
        print(
            f"{rank:>4} {row['role']:>6} {row['age_s']:>5.1f}s "
            f"{row['seq']:>5} {row['throughput']:>8.1f} "
            f"{'-' if q is None else q:>5} "
            + (
                f"{ph['compute']:>7.1%} {ph['wire']:>5.1%} "
                f"{ph['other']:>5.1%} "
                if ph is not None else f"{'-':>7} {'-':>5} {'-':>5} "
            )
            + (
                f"{_fmt_ms(exch['p50']):>6}/{_fmt_ms(exch['p90'])}"
                f"/{_fmt_ms(exch['p99']):<7}"
                if exch is not None else f"{'-':>20}"
            )
            + f"  {faults}"
        )
        srow = row.get("serve")
        if srow is not None:
            print(
                f"     serve: waiting {srow['waiting']} "
                f"occupied {srow['occupied']} rps {srow['rps']:.1f} "
                f"tokens/s {srow['tokens_per_s']:.1f} "
                f"slo-miss {srow['slo_miss_fraction']:.1%} "
                f"ttft p50 {_fmt_ms(srow.get('ttft_p50_ms'))}ms "
                f"p99 {_fmt_ms(srow.get('ttft_p99_ms'))}ms"
            )
        stal = row.get("staleness")
        dyn = row.get("dynamics")
        if stal is not None or dyn is not None:
            parts = []
            if stal is not None:
                parts.append("staleness p50/p99 "
                             f"{_fmt(stal['p50'])}/{_fmt(stal['p99'])}")
            if dyn is not None:
                parts.append(f"elastic {_fmt(dyn['elastic_dist'])}")
                parts.append(f"push {_fmt(dyn['push_norm'])}")
                parts.append(f"ratio {_fmt(dyn['norm_ratio'])}")
            print("     dynamics: " + "  ".join(parts))
    for rec in fired:
        print(
            f"ALERT {rec['kind']} rank {rec['rank']}: "
            f"{json.dumps(rec['detail'])}"
        )


def _cmd_live(ns) -> int:
    import time as _time

    from mpit_tpu_torch.obs import alerts as alerts_mod
    from mpit_tpu_torch.obs import live as live_mod

    live_dir = live_mod.find_live_dir(ns.path)

    if ns.validate:
        paths = sorted(glob.glob(os.path.join(live_dir, "rank_*.json")))
        if not paths:
            print(f"no rank_*.json snapshots under {live_dir}",
                  file=sys.stderr)
            return 2
        bad = 0
        for path in paths:
            try:
                with open(path) as f:
                    snap = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                print(f"{path}: unreadable: {e}", file=sys.stderr)
                bad += 1
                continue
            problems = live_mod.validate_snapshot(snap)
            for prob in problems:
                print(f"{path}: {prob}", file=sys.stderr)
            bad += bool(problems)
        print(f"validated {len(paths)} snapshot(s), {bad} invalid")
        return 1 if bad else 0

    engine = None
    if not ns.no_alerts:
        kwargs = {
            k: v for k, v in (
                ("staleness_factor", ns.staleness_factor),
                ("straggler_spread", ns.straggler_spread),
                ("burn_threshold", ns.burn_threshold),
                ("slo_target", ns.slo_target),
            ) if v is not None
        }
        on_fire = None
        if not ns.no_dump:
            from mpit_tpu_torch.obs import blackbox as blackbox_mod

            # live_dir is <run dir>/live — the dump request goes in the
            # run dir, where every rank's watcher thread polls for it
            run_dir = os.path.dirname(os.path.abspath(live_dir))

            def on_fire(rec):
                blackbox_mod.request_dump(
                    run_dir,
                    f"alert:{rec.get('kind')}",
                    f"{rec.get('kind')}-rank{rec.get('rank')}",
                )

        engine = alerts_mod.AlertEngine(
            os.path.join(live_dir, "alerts.jsonl"),
            alerts_mod.AlertConfig(**kwargs),
            on_fire=on_fire,
        )

    deadline = (
        _time.monotonic() + ns.max_seconds
        if ns.max_seconds is not None else None
    )
    try:
        while True:
            snaps = live_mod.read_snapshots(live_dir)
            if not snaps:
                if ns.once:
                    print(f"no rank_*.json snapshots under {live_dir} "
                          "(is MPIT_OBS_LIVE armed?)", file=sys.stderr)
                    return 2
                print(f"waiting for snapshots under {live_dir} ...",
                      file=sys.stderr)
            else:
                fired = engine.evaluate(snaps) if engine is not None else []
                report = live_mod.aggregate(snaps)
                report["alerts_fired"] = fired
                if ns.json:
                    json.dump(report, sys.stdout)
                    print()
                else:
                    if not ns.once:
                        # clear + home, full-refresh dashboard
                        sys.stdout.write("\x1b[2J\x1b[H")
                    _print_live(report, live_dir, fired)
                    sys.stdout.flush()
                if ns.once:
                    return 1 if fired else 0
            if deadline is not None and _time.monotonic() >= deadline:
                return 0
            _time.sleep(ns.refresh)
    except KeyboardInterrupt:
        return 0


def _cmd_postmortem(ns) -> int:
    from mpit_tpu_torch.obs import postmortem as pm

    report = pm.analyze(ns.path, k_rounds=ns.rounds)
    if report is None:
        print(f"no black-box dumps under {ns.path} (expected "
              "blackbox/rank_*.jsonl — did any trigger fire?)",
              file=sys.stderr)
        return 2
    if ns.json:
        json.dump(report, sys.stdout)
        print()
    else:
        print(pm.format_report(report))
    if ns.perfetto is not None:
        faults = None
        if glob.glob(os.path.join(ns.path, "faults*.jsonl")):
            faults = ns.path
        alerts = None
        for cand in (
            os.path.join(ns.path, "live", "alerts.jsonl"),
            os.path.join(ns.path, "alerts.jsonl"),
        ):
            if os.path.exists(cand):
                alerts = cand
                break
        trace = merge_to_chrome_trace(
            pm.dump_paths(ns.path), faults_path=faults, alerts_path=alerts
        )
        with open(ns.perfetto, "w") as f:
            json.dump(trace, f)
        print(f"wrote {ns.perfetto}: {len(trace['traceEvents'])} "
              "incident-window events", file=sys.stderr)
    return 1 if report["verdict"] == "incident" else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.obs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    mp = sub.add_parser("merge", help="journals -> Chrome-trace JSON")
    mp.add_argument("paths", nargs="+",
                    help="run dir (MPIT_OBS_DIR) or journal files")
    mp.add_argument("-o", "--out", default=None,
                    help="output file (default: <first dir>/trace.json)")
    mp.add_argument("--faults", default=None,
                    help="chaos fault log JSONL (or a directory of "
                         "faults*.jsonl, process mode) to overlay "
                         "(default: <run dir>/faults*.jsonl when present)")
    mp.add_argument("--alerts", default=None,
                    help="live-plane alerts.jsonl to overlay as instant "
                         "markers (default: <run dir>/live/alerts.jsonl "
                         "or <run dir>/alerts.jsonl when present)")

    sp = sub.add_parser("summary", help="per-rank event tallies")
    sp.add_argument("paths", nargs="+")
    sp.add_argument(
        "--diff",
        action="store_true",
        help="compare exactly two runs stream-by-stream (per-(peer, tag) "
        "counters + median latency bucket)",
    )

    rp = sub.add_parser(
        "roofline",
        help="per-rank compute/wire/idle/overhead attribution",
    )
    rp.add_argument("paths", nargs="+",
                    help="run dir (MPIT_OBS_DIR) or journal files")
    rp.add_argument("--json", action="store_true",
                    help="emit the full report as JSON instead of a table")

    lp = sub.add_parser(
        "slo",
        help="serving scorecard: TTFT/TPOT/e2e percentiles, goodput",
    )
    lp.add_argument("paths", nargs="+",
                    help="run dir (the server's ObsConfig.dir) or "
                         "journal files")
    lp.add_argument("--gate", default=None,
                    help="JSON gate file of ceilings/floors (e.g. "
                         '{"ttft_p99_ms": 250, "goodput_min": 0.95}); '
                         "violations exit 1")
    lp.add_argument("--json", action="store_true",
                    help="emit the report (plus any violations) as JSON")
    lp.add_argument("--default-slo-ms", type=float, default=None,
                    help="e2e SLO applied to requests submitted without "
                         "one (default: such requests meet vacuously)")

    dp = sub.add_parser(
        "dynamics",
        help="training-dynamics report: staleness, elastic distance, "
             "update/param norm ratios, divergence verdict",
    )
    dp.add_argument("paths", nargs="+",
                    help="run dir (MPIT_OBS_DIR) or journal files")
    dp.add_argument("--gate", default=None,
                    help="JSON gate file (keys: staleness_p99_max, "
                         "elastic_dist_final_max, norm_ratio_max, "
                         "allow_diverging); violations exit 1")
    dp.add_argument("--json", action="store_true",
                    help="emit the report (plus any violations) as JSON")

    vp = sub.add_parser(
        "live",
        help="live dashboard + alerts over live/rank_*.json snapshots",
    )
    vp.add_argument("path",
                    help="run dir (MPIT_OBS_DIR) or its live/ subdir")
    vp.add_argument("--once", action="store_true",
                    help="one pass instead of a refreshing dashboard "
                         "(exit 1 if new alerts fired)")
    vp.add_argument("--json", action="store_true",
                    help="emit the aggregate report as JSON (implies "
                         "machine-readable; pairs with --once)")
    vp.add_argument("--refresh", type=float, default=2.0,
                    help="dashboard refresh interval, seconds (default 2)")
    vp.add_argument("--max-seconds", type=float, default=None,
                    help="stop the refreshing dashboard after this long")
    vp.add_argument("--no-alerts", action="store_true",
                    help="display only: skip the alert engine (nothing "
                         "appended to alerts.jsonl)")
    vp.add_argument("--no-dump", action="store_true",
                    help="alerts fire without requesting black-box dumps "
                         "(observe without writing into the run dir)")
    vp.add_argument("--staleness-factor", type=float, default=None,
                    help="dead-rank threshold as a multiple of each "
                         "rank's export interval (default 3)")
    vp.add_argument("--straggler-spread", type=float, default=None,
                    help="compute-fraction min-max spread that flags a "
                         "straggler (default 0.25)")
    vp.add_argument("--burn-threshold", type=float, default=None,
                    help="SLO burn rate that alerts (default 1.0 = "
                         "error budget consumed as fast as it accrues)")
    vp.add_argument("--slo-target", type=float, default=None,
                    help="SLO attainment target the burn rate is "
                         "normalized against (default 0.95)")
    vp.add_argument("--validate", action="store_true",
                    help="strict-validate every snapshot against the "
                         "versioned schema and exit (the lint.sh golden "
                         "gate)")

    pp = sub.add_parser(
        "postmortem",
        help="cross-rank incident report from black-box dumps",
    )
    pp.add_argument("path",
                    help="run dir (MPIT_OBS_DIR) holding "
                         "blackbox/rank_*.jsonl, or a dump dir itself")
    pp.add_argument("--json", action="store_true",
                    help="emit the full report as JSON")
    pp.add_argument("--rounds", type=int, default=5,
                    help="exchange rounds reconstructed per rank "
                         "(default 5)")
    pp.add_argument("--perfetto", default=None, metavar="OUT",
                    help="also write an incident-window Chrome trace of "
                         "the dumps (open at https://ui.perfetto.dev)")

    ns = p.parse_args(argv)

    # live and postmortem read their own layouts (rank_*.json snapshots
    # / blackbox dumps), not obs_rank*.jsonl journals — dispatch them
    # before the journal-expansion gate below
    if ns.cmd == "live":
        return _cmd_live(ns)
    if ns.cmd == "postmortem":
        return _cmd_postmortem(ns)

    if ns.cmd == "summary" and ns.diff:
        if len(ns.paths) != 2:
            print("summary --diff takes exactly two run dirs",
                  file=sys.stderr)
            return 2
        a, b = ns.paths
        if not expand_journal_paths([a]) or not expand_journal_paths([b]):
            print(f"no obs_rank*.jsonl journals under {a} or {b}",
                  file=sys.stderr)
            return 2
        _print_diff(diff_summaries([a], [b]))
        return 0

    journals = expand_journal_paths(ns.paths)
    if not journals:
        print(f"no obs_rank*.jsonl journals under {ns.paths}",
              file=sys.stderr)
        return 2

    if ns.cmd == "slo":
        from mpit_tpu_torch.loadgen.slo import (
            aggregate_paths, evaluate_gate, format_report, load_gate,
        )

        report = aggregate_paths(
            journals, default_slo_ms=ns.default_slo_ms
        )
        if report["requests"]["submitted"] == 0:
            print("journals carry no request lifecycle events "
                  "(serve with obs=ObsConfig(dir=...))", file=sys.stderr)
            return 2
        violations = []
        if ns.gate is not None:
            try:
                gate = load_gate(ns.gate)
            except (OSError, ValueError) as e:
                print(f"bad gate file {ns.gate}: {e}", file=sys.stderr)
                return 2
            violations = evaluate_gate(report, gate)
        if ns.json:
            json.dump({**report, "violations": violations}, sys.stdout)
            print()
        else:
            print(format_report(report))
            for v in violations:
                print(f"SLO VIOLATION: {v}")
        if violations:
            return 1
        return 0

    if ns.cmd == "dynamics":
        from mpit_tpu_torch.obs.dynamics import (
            aggregate_dynamics, check_dynamics_gate, load_gate,
        )

        report = aggregate_dynamics(journals)
        if report["run"] is None:
            print("journals carry no training-dynamics records "
                  "(train with obs armed — docs/OBSERVABILITY.md "
                  "\"dynamics\")", file=sys.stderr)
            return 2
        violations = []
        if ns.gate is not None:
            try:
                gate = load_gate(ns.gate)
            except (OSError, ValueError) as e:
                print(f"bad gate file {ns.gate}: {e}", file=sys.stderr)
                return 2
            violations = check_dynamics_gate(report, gate)
        if ns.json:
            json.dump({**report, "violations": violations}, sys.stdout)
            print()
        else:
            _print_dynamics(report)
            for v in violations:
                print(f"DYNAMICS VIOLATION: {v}")
        if violations:
            return 1
        return 0

    if ns.cmd == "roofline":
        report = roofline(journals)
        if report["run"] is None:
            print("journals carry no timed events", file=sys.stderr)
            return 2
        if ns.json:
            json.dump(report, sys.stdout, indent=2, default=str)
            print()
        else:
            _print_roofline(report)
        return 0

    if ns.cmd == "summary":
        for rank, row in summarize(journals).items():
            print(
                f"rank {rank}: {row['events']} events "
                f"({row['sends']} sends / {row['recvs']} recvs, "
                f"{row['bytes']} bytes, {row['traces']} traces)"
            )
        return 0

    first_dir = next((q for q in ns.paths if os.path.isdir(q)), None)
    faults = ns.faults
    if faults is None and first_dir is not None:
        candidate = os.path.join(first_dir, "faults.jsonl")
        if os.path.exists(candidate):
            faults = candidate
        elif glob.glob(os.path.join(first_dir, "faults*.jsonl")):
            # process-mode runs write one fault log per rank; the dir
            # form hands all of them to read_fault_log
            faults = first_dir
    alerts = ns.alerts
    if alerts is None and first_dir is not None:
        for candidate in (
            os.path.join(first_dir, "live", "alerts.jsonl"),
            os.path.join(first_dir, "alerts.jsonl"),
        ):
            if os.path.exists(candidate):
                alerts = candidate
                break
    out_path = ns.out or os.path.join(first_dir or ".", "trace.json")

    trace = merge_to_chrome_trace(
        journals, faults_path=faults, alerts_path=alerts
    )
    with open(out_path, "w") as f:
        json.dump(trace, f)

    by_rank = trace_ids_by_rank(journals)
    all_traces = set().union(*by_rank.values()) if by_rank else set()
    cross = sum(
        1 for t in all_traces
        if sum(1 for ids in by_rank.values() if t in ids) >= 2
    )
    n_faults = sum(1 for e in trace["traceEvents"] if e.get("cat") == "chaos")
    n_alerts = sum(1 for e in trace["traceEvents"] if e.get("cat") == "alert")
    print(
        f"wrote {out_path}: {len(trace['traceEvents'])} events from "
        f"{len(by_rank) or len(journals)} rank(s), {len(all_traces)} "
        f"trace(s) ({cross} cross-rank), {n_faults} fault marker(s), "
        f"{n_alerts} alert marker(s) — open in https://ui.perfetto.dev"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
