"""CLI for the distributed-correctness linter.

``python -m mpit_tpu_torch.analysis [options] [path ...]``

The reference's CLI (``python -m mpit_tpu.analysis``) for the port, with
the same subcommands, flags, messages and exit codes; it imports neither
JAX nor the reference package, so it runs on the card's machine.

Scans the given files/directories (default: the installed ``mpit_tpu_torch``
package) with rules MPT001–MPT022 — including the cross-module passes
(pickle wire-format drift, protocol-role pairing, wrapper-chain signature
drift) and the explicit-state model check of the extracted PS protocol
(MPT009–011, :mod:`mpit_tpu_torch.analysis.mcheck`), all without importing
anything — subtracts the port's baseline (``analysis/baseline.json``), and
exits 0 when nothing new was found. ``--write-baseline`` refreshes the baseline from the
current scan (review the diff — every line you accept is a violation you
are signing off on). ``--fix`` first rewrites the mechanically-fixable
MPT002 sites (known literal tag → ``TAG_*`` name + import) in place,
then lints the result.

Subcommands:

``python -m mpit_tpu_torch.analysis mcheck [--package PATH]``
    Run only the protocol model checks and print per-configuration state
    counts — the exhaustiveness receipt behind MPT009–011, plus the
    ``fleet-route`` configuration (MPT019: no routed request lost under
    a single replica kill) when the serving-fleet roles are in the scan.

``python -m mpit_tpu_torch.analysis conform <obs-dir> [--package PATH]``
    Replay an observability run (``obs_rank*.jsonl`` + ``faults*.jsonl``)
    against the extracted protocol; report TC201–TC203 violations.

``python -m mpit_tpu_torch.analysis threads [--package PATH] [--owner X]``
    Print the whole-program concurrency model behind MPT013–015: every
    thread root, the state shared across roots, and the lockset each
    root holds at each access. ``--owner PServer`` narrows to one
    class/module's state (shared or not); ``--json`` emits the
    machine-readable form the threading-model doc is generated from.

``python -m mpit_tpu_torch.analysis schema [--json|--check|--update-lock]``
    Print the inferred per-tag payload-schema table behind MPT016–018
    (sender construction shapes vs receiver consumption patterns, plus
    the snapshot write/read key sets). ``--check`` diffs it against the
    checked-in ``wire-schema.lock.json`` at the repo root — the port's
    frames are the reference's byte for byte, so one lock binds both —
    and exits 1 on undeclared drift; ``--update-lock --lock PATH``
    writes the scan's schema to PATH (never to the shared lock, which the
    reference's CLI regenerates) — protocol-shape changes are *declared*,
    never silent.

``python -m mpit_tpu_torch.analysis numerics [--package PATH] [--json]``
    Print the whole-program precision-dataflow model behind MPT020–022:
    every quantize site with its error-feedback verdict (paired /
    ef-off[reason] / escapes / unpaired), dequantize mode/scale
    provenance, reductions whose operand is quantized codes, and the
    per-wire-tag precision ledger vs the lockfile's precision column.

``python -m mpit_tpu_torch.analysis fuzz [--corpus PATH] [--examples N]``
    The differential codec fuzz gate: seeded strategies over the
    structural payload grammar drive encode→decode roundtrips,
    framed-vs-pickle differential equality, and frame mutations that
    must always land on WireDecodeError — never a wrong value.
    ``--corpus`` additionally replays the checked-in regression corpus;
    ``--regen-corpus`` rebuilds it deterministically.

Exit codes (every mode, regardless of output format): 0 clean (vs
baseline), 1 new findings / violations, 2 usage or input error.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from mpit_tpu_torch.analysis import findings as findings_mod
from mpit_tpu_torch.analysis import lint


def _default_scan_path() -> str:
    return str(Path(__file__).resolve().parent.parent)


def _load_project(package: str):
    modules = []
    for ap, rel in lint.collect_files([package]):
        ctx = lint.load_module(ap, rel)
        if ctx is not None:
            modules.append(ctx)
    return lint.Project(modules=modules, config=lint.Config())


def _main_mcheck(argv) -> int:
    from mpit_tpu_torch.analysis import mcheck, protocol

    parser = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.analysis mcheck",
        description="Exhaustively model-check the extracted PS protocol "
        "under single-fault schedules (MPT009-MPT011).",
    )
    parser.add_argument(
        "--package",
        default=_default_scan_path(),
        help="package to extract the protocol from (default: mpit_tpu_torch)",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    args = parser.parse_args(argv)
    if not Path(args.package).exists():
        print(f"error: no such path: {args.package}", file=sys.stderr)
        return 2
    project = _load_project(args.package)
    sem = protocol.extract_semantics(project)
    if sem is None or not sem.has_fault_machinery:
        print(
            "error: no fault-tolerant protocol pair extracted from "
            f"{args.package} (need marked roles with attempt ids or a "
            "dedup window)",
            file=sys.stderr,
        )
        return 2
    results = mcheck.check_all(mcheck.from_protocol(sem))
    fsem = protocol.extract_fleet_semantics(project)
    if fsem is not None:
        results.append(
            mcheck.check_fleet(mcheck.fleet_from_protocol(fsem))
        )
    bad = False
    if args.json:
        print(json.dumps([
            {
                "config": r.config.label,
                "states": r.states,
                "fault_points": r.fault_points,
                "violations": r.violations,
                "truncated": r.truncated,
            }
            for r in results
        ], indent=2))
        bad = any(not r.ok for r in results)
    else:
        for r in results:
            status = "ok" if r.ok else "FAIL"
            print(
                f"{status}: {r.config.label}: {r.states} states, "
                f"{r.fault_points} single-fault schedules explored"
            )
            for rule in sorted(r.violations):
                print(f"  {rule}: {r.violations[rule]}")
            if r.truncated:
                print("  truncated: state bound hit, result inconclusive")
            bad = bad or not r.ok
    return 1 if bad else 0


def _main_conform(argv) -> int:
    from mpit_tpu_torch.analysis import conformance

    parser = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.analysis conform",
        description="Replay obs journals against the extracted protocol "
        "(TC201-TC204).",
    )
    parser.add_argument(
        "obs_dir",
        nargs="+",
        help="directories with obs_rank*.jsonl journals (and, for "
        "chaos runs, faults*.jsonl), or single journal files; several "
        "run dirs share one protocol extraction, each is audited "
        "separately",
    )
    parser.add_argument(
        "--faults",
        metavar="PATH",
        help="chaos fault log (default: faults*.jsonl inside obs_dir)",
    )
    parser.add_argument(
        "--strict",
        action="store_true",
        help="ignore membership.jsonl: audit an elastic run's journals "
        "with no churned-rank licensing (TC201/TC202 relaxations off)",
    )
    parser.add_argument(
        "--package",
        default=_default_scan_path(),
        help="package to extract the protocol from (default: mpit_tpu_torch)",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    args = parser.parse_args(argv)
    for d in args.obs_dir:
        if not Path(d).exists():
            print(f"error: no such path: {d}", file=sys.stderr)
            return 2
    if not Path(args.package).exists():
        print(f"error: no such path: {args.package}", file=sys.stderr)
        return 2
    project = _load_project(args.package)  # extracted once, audited per dir
    docs = []
    bad = False
    for d in args.obs_dir:
        report = conformance.check_conformance(
            d, project, faults_path=args.faults,
            elastic=False if args.strict else None,
        )
        if not report.journals:
            print(
                f"error: no obs_rank*.jsonl journals under {d}",
                file=sys.stderr,
            )
            return 2
        bad = bad or bool(report.violations)
        if args.json:
            docs.append({
                "obs_dir": d,
                "journals": [str(p) for p in report.journals],
                "events": report.events,
                "sends": report.sends,
                "recvs": report.recvs,
                "faults": report.faults,
                "churned": report.churned,
                "truncated": report.truncated,
                "violations": [
                    {"rule": v.rule, "detail": v.detail}
                    for v in report.violations
                ],
            })
        else:
            for v in report.violations:
                print(v)
            where = f" [{d}]" if len(args.obs_dir) > 1 else ""
            elastic_note = (
                f", elastic churn on rank(s) {report.churned}"
                if report.churned else ""
            )
            trunc_note = (
                f", truncated journal(s) on rank(s) {report.truncated}"
                if report.truncated else ""
            )
            print(
                f"{len(report.violations)} violation(s) in "
                f"{len(report.journals)} journal(s): {report.sends} "
                f"send(s), {report.recvs} recv(s), "
                f"{report.faults} fault record(s)"
                + elastic_note + trunc_note + where
            )
    if args.json:
        # single-dir invocations keep the original flat document shape
        print(json.dumps(docs[0] if len(docs) == 1 else docs, indent=2))
    return 1 if bad else 0


def _fmt_locksets(locksets) -> str:
    return " | ".join(
        "{" + ", ".join(ls) + "}" if ls else "{}" for ls in locksets
    )


def _main_threads(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.analysis threads",
        description="Dump the whole-program concurrency model "
        "(thread roots, cross-root shared state, per-access locksets) "
        "that rules MPT013-MPT015 consume.",
    )
    parser.add_argument(
        "--package",
        default=_default_scan_path(),
        help="package to analyze (default: mpit_tpu_torch)",
    )
    parser.add_argument(
        "--owner",
        metavar="SUFFIX",
        help="list ALL tracked state of one owner (class or module "
        "dotted-name suffix, e.g. PServer), shared across roots or not",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    args = parser.parse_args(argv)
    if not Path(args.package).exists():
        print(f"error: no such path: {args.package}", file=sys.stderr)
        return 2
    model = _load_project(args.package).threads

    def _root_block(per_root):
        out = {}
        for root, e in sorted(per_root.items()):
            out[root] = {
                "reads": e["reads"],
                "writes": e["writes"],
                "locksets": sorted(
                    sorted(l.short() for l in ls) for ls in e["locksets"]
                ),
            }
        return out

    if args.owner:
        states = model.owner_state(args.owner)
        doc = {
            "owner": args.owner,
            "state": [
                {
                    "state": s.label(),
                    "kind": s.kind,
                    "shared": len(per_root) >= 2,
                    "roots": _root_block(per_root),
                }
                for s, per_root in sorted(
                    states.items(), key=lambda kv: kv[0].label()
                )
            ],
        }
        if args.json:
            print(json.dumps(doc, indent=2))
        else:
            for ent in doc["state"]:
                mark = "shared" if ent["shared"] else "single-root"
                print(f"{ent['state']}  [{mark}]")
                for root, e in ent["roots"].items():
                    print(
                        f"    {root}: {e['reads']}r/{e['writes']}w  "
                        f"{_fmt_locksets(e['locksets'])}"
                    )
        return 0

    doc = model.to_json()
    if args.json:
        print(json.dumps(doc, indent=2))
        return 0
    print(f"{len(doc['roots'])} thread root(s):")
    for r in doc["roots"]:
        note = "" if r["resolved"] else "  [unresolved target]"
        print(f"  {r['name']}  <- {r['target']} @ {r['spawned_at']}{note}")
    print(f"\n{len(doc['shared_state'])} cross-root shared state(s):")
    for ent in doc["shared_state"]:
        print(f"  {ent['state']}")
        for root, e in ent["roots"].items():
            print(
                f"    {root}: {e['reads']}r/{e['writes']}w  "
                f"{_fmt_locksets(e['locksets'])}"
            )
    print(f"\n{len(doc['lock_edges'])} lock-order edge(s):")
    for edge in doc["lock_edges"]:
        print(f"  {edge}")
    return 0


def _default_lock_path(package: str):
    root = lint.find_repo_root(Path(package))
    if root is None:
        return None
    from mpit_tpu_torch.analysis import schema as schema_mod

    return root / schema_mod.SCHEMA_LOCK_FILENAME


def _schema_drift_lines(locked: dict, inferred: dict) -> list:
    """Human-readable per-tag drift between the lock and the scan."""
    out = []
    ltags = locked.get("tags", {})
    itags = inferred.get("tags", {})
    for key in sorted(set(ltags) | set(itags), key=int):
        lt, it = ltags.get(key), itags.get(key)
        name = (it or lt or {}).get("name") or f"tag {key}"
        if lt is None:
            out.append(f"  {name} ({key}): not in lock (new tag)")
            continue
        if it is None:
            out.append(f"  {name} ({key}): in lock but no longer inferred")
            continue
        for side in ("sender", "receiver", "precision"):
            if lt.get(side) != it.get(side):
                out.append(
                    f"  {name} ({key}) {side}: lock {lt.get(side)} != "
                    f"inferred {it.get(side)}"
                )
    lsnap = locked.get("snapshot", {})
    isnap = inferred.get("snapshot", {})
    for side in ("writes", "reads"):
        if lsnap.get(side) != isnap.get(side):
            out.append(
                f"  snapshot {side}: lock {lsnap.get(side)} != "
                f"inferred {isnap.get(side)}"
            )
    if locked.get("version") != inferred.get("version"):
        out.append(
            f"  lock version {locked.get('version')!r} != "
            f"{inferred.get('version')!r}"
        )
    return out


def _main_schema(argv) -> int:
    from mpit_tpu_torch.analysis import schema as schema_mod

    parser = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.analysis schema",
        description="Infer the per-tag wire payload schemas (MPT016-018"
        " model) and diff them against wire-schema.lock.json.",
    )
    parser.add_argument(
        "--package",
        default=_default_scan_path(),
        help="package to analyze (default: mpit_tpu_torch)",
    )
    parser.add_argument(
        "--lock",
        metavar="PATH",
        help="lock file (default: wire-schema.lock.json at the repo root)",
    )
    parser.add_argument(
        "--check",
        action="store_true",
        help="exit 1 when the inferred schema drifts from the lock",
    )
    parser.add_argument(
        "--update-lock",
        action="store_true",
        help="write the current scan's schema to --lock PATH (declaring "
        "the protocol change) and exit 0; the shared root lock is the "
        "reference CLI's to regenerate",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    args = parser.parse_args(argv)
    if not Path(args.package).exists():
        print(f"error: no such path: {args.package}", file=sys.stderr)
        return 2
    model = _load_project(args.package).schema
    doc = model.to_json()
    lock_path = (
        Path(args.lock) if args.lock else _default_lock_path(args.package)
    )

    if args.update_lock:
        if not args.lock:
            print(
                "error: --update-lock writes only to an explicit --lock "
                "PATH (the root lock is shared with the reference)",
                file=sys.stderr,
            )
            return 2
        with open(lock_path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"wrote {len(doc['tags'])} tag schema(s) to {lock_path}")
        return 0

    if args.check:
        if lock_path is None or not lock_path.exists():
            print(
                f"error: no schema lock at {lock_path} — generate it "
                "with --update-lock",
                file=sys.stderr,
            )
            return 2
        with open(lock_path) as f:
            locked = json.load(f)
        drift = _schema_drift_lines(locked, doc)
        if not drift:
            print(
                f"wire schema: {len(doc['tags'])} tag(s) match "
                f"{lock_path.name}"
            )
            return 0
        print(f"wire schema drifted from {lock_path}:")
        for line in drift:
            print(line)
        print(
            "declare the protocol change with: python -m "
            "mpit_tpu.analysis schema --update-lock (the lock is shared: "
            "the port's frames change with the reference's)"
        )
        return 1

    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0
    for key in sorted(doc["tags"], key=int):
        ent = doc["tags"][key]
        name = ent["name"] or f"tag {key}"
        print(f"{name} ({key})")
        print(f"  sender:   {', '.join(ent['sender']) or '(none seen)'}")
        print(f"  receiver: {', '.join(ent['receiver']) or '(none seen)'}")
        if ent.get("precision"):
            print(f"  precision: {', '.join(ent['precision'])}")
    snap = doc["snapshot"]
    print(
        f"snapshot: writes {snap['writes'] or '(none)'} / "
        f"reads {snap['reads'] or '(none)'}"
    )
    return 0


def _main_numerics(argv) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.analysis numerics",
        description="Dump the whole-program precision-dataflow model "
        "(quantize sites with error-feedback verdicts, dequantize "
        "provenance, code-operand reductions, per-tag wire precision) "
        "that rules MPT020-MPT022 consume.",
    )
    parser.add_argument(
        "--package",
        default=_default_scan_path(),
        help="package to analyze (default: mpit_tpu_torch)",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    args = parser.parse_args(argv)
    if not Path(args.package).exists():
        print(f"error: no such path: {args.package}", file=sys.stderr)
        return 2
    doc = _load_project(args.package).numerics.to_json()
    if args.json:
        print(json.dumps(doc, indent=2))
        return 0
    print(f"{len(doc['quant_sites'])} quantize site(s):")
    for q in doc["quant_sites"]:
        reason = (
            f"  ({q['ef_off_reason']})" if "ef_off_reason" in q else ""
        )
        print(
            f"  {q['site']}  {q['func']}[{q['mode']}]  "
            f"ef={q['ef']}{reason}  <{q['symbol']}>"
        )
    print(f"\n{len(doc['dequant_sites'])} dequantize site(s):")
    for d in doc["dequant_sites"]:
        print(
            f"  {d['site']}  {d['func']}[declared={d['declared_mode']} "
            f"codes={d['codes_mode']} scale={d['scale']}]  "
            f"<{d['symbol']}>"
        )
    print(
        f"\n{len(doc['reduce_sites'])} code-operand reduction(s):"
        + ("" if doc["reduce_sites"] else "  (clean)")
    )
    for r in doc["reduce_sites"]:
        print(f"  {r['site']}  {r['func']}({r['operand']})  <{r['symbol']}>")
    if doc["tags"]:
        print(f"\n{len(doc['tags'])} wire tag(s) with a precision pin:")
        for key in sorted(doc["tags"], key=int):
            ent = doc["tags"][key]
            mark = "" if ent["inferred"] == ent["locked"] else "  DRIFT"
            print(
                f"  {ent['name']} ({key}): inferred {ent['inferred']} / "
                f"locked {ent['locked']}{mark}"
            )
    return 0


def _main_fuzz(argv) -> int:
    from mpit_tpu_torch.transport import fuzz

    parser = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.analysis fuzz",
        description="Differential codec fuzz gate: roundtrip + "
        "framed-vs-pickle equality over the structural payload grammar, "
        "plus frame mutations that must always land on WireDecodeError.",
    )
    parser.add_argument(
        "--seed", type=int, default=0, help="PRNG seed (default: 0)"
    )
    parser.add_argument(
        "--examples",
        type=int,
        default=10000,
        help="generated examples (default: 10000)",
    )
    parser.add_argument(
        "--corpus",
        metavar="PATH",
        help="also replay this regression corpus (jsonl)",
    )
    parser.add_argument(
        "--regen-corpus",
        metavar="PATH",
        help="deterministically rebuild the regression corpus and exit",
    )
    parser.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    args = parser.parse_args(argv)

    if args.regen_corpus:
        n = fuzz.write_corpus(args.regen_corpus, seed=args.seed)
        print(f"wrote {n} corpus entries to {args.regen_corpus}")
        return 0

    report = fuzz.run_fuzz(seed=args.seed, examples=args.examples)
    if args.corpus:
        if not Path(args.corpus).exists():
            print(
                f"error: no such corpus: {args.corpus}", file=sys.stderr
            )
            return 2
        report.merge(fuzz.replay_corpus(args.corpus))
    if args.json:
        print(json.dumps(report.to_json(), indent=2))
    else:
        print(report.summary())
        for line in report.failures[:10]:
            print(f"  FAIL {line}")
    return 1 if report.failures else 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # subcommands keep the plain lint invocation's flag surface intact
    # (paths are positional, so a literal first arg dispatches cleanly)
    if argv and argv[0] == "mcheck":
        return _main_mcheck(argv[1:])
    if argv and argv[0] == "conform":
        return _main_conform(argv[1:])
    if argv and argv[0] == "threads":
        return _main_threads(argv[1:])
    if argv and argv[0] == "schema":
        return _main_schema(argv[1:])
    if argv and argv[0] == "numerics":
        return _main_numerics(argv[1:])
    if argv and argv[0] == "fuzz":
        return _main_fuzz(argv[1:])
    parser = argparse.ArgumentParser(
        prog="python -m mpit_tpu_torch.analysis",
        description="Distributed-correctness linter of the port (rules "
        "MPT001-MPT022).",
    )
    parser.add_argument(
        "paths",
        nargs="*",
        help="files/directories to scan (default: the mpit_tpu_torch package)",
    )
    parser.add_argument(
        "--format",
        choices=("text", "json"),
        default="text",
        help="output format (default: text)",
    )
    parser.add_argument(
        "--json",
        dest="format",
        action="store_const",
        const="json",
        help="shorthand for --format json (same 0/1/2 exit gate — the "
        "baseline gate never depends on the output format)",
    )
    parser.add_argument(
        "--baseline",
        metavar="PATH",
        help="baseline file (default: mpit_tpu_torch/analysis/"
        "baseline.json, or $MPIT_ANALYSIS_BASELINE)",
    )
    parser.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding, ignoring any baseline",
    )
    parser.add_argument(
        "--write-baseline",
        action="store_true",
        help="write the current findings as the new baseline and exit 0",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="print the rule table and exit",
    )
    parser.add_argument(
        "--fix",
        action="store_true",
        help="rewrite fixable MPT002 sites (known literal tag -> TAG_* "
        "constant + import) in place before linting",
    )
    parser.add_argument(
        "--only",
        metavar="RULES",
        help="run only these comma-separated rule ids (e.g. "
        "--only MPT013,MPT014) — rule modules owning none of them are "
        "skipped entirely, so one rule iterates without the full pass",
    )
    args = parser.parse_args(argv)

    if args.list_rules:
        from mpit_tpu_torch.analysis.rules import RULE_DOCS

        for rule_id in sorted(RULE_DOCS):
            slug, doc = RULE_DOCS[rule_id]
            print(f"{rule_id}  {slug:<26} {doc}")
        return 0

    paths = args.paths or [_default_scan_path()]
    for p in paths:
        if not Path(p).exists():
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    if args.fix:
        from mpit_tpu_torch.analysis import fixes

        had_error = False
        for r in fixes.fix_paths(paths):
            if r.error:
                had_error = True
                print(f"fix: {r.path}: {r.error}", file=sys.stderr)
                continue
            detail = f"rewrote {r.replaced} literal tag site(s)"
            if r.imported:
                detail += f", imported {', '.join(r.imported)}"
            if r.skipped:
                detail += f", left {r.skipped} suppressed site(s)"
            print(f"fix: {r.path}: {detail}")
        if had_error:
            return 2

    config = None
    if args.only:
        only = [r.strip() for r in args.only.split(",") if r.strip()]
        from mpit_tpu_torch.analysis.rules import RULE_DOCS

        unknown = [r for r in only if r not in RULE_DOCS]
        if unknown:
            print(
                f"error: unknown rule id(s): {', '.join(unknown)} "
                "(see --list-rules)",
                file=sys.stderr,
            )
            return 2
        config = lint.Config(only_rules=only)

    all_findings = lint.run_lint(paths, config)

    baseline_path = None
    if not args.no_baseline:
        baseline_path = (
            Path(args.baseline)
            if args.baseline
            else lint.default_baseline_path(paths[0])
        )

    if args.write_baseline:
        if baseline_path is None:
            print(
                "error: no baseline path (pass --baseline or run inside "
                "the repo)",
                file=sys.stderr,
            )
            return 2
        findings_mod.write_baseline(baseline_path, all_findings)
        print(
            f"wrote {len(all_findings)} finding(s) to {baseline_path}"
        )
        return 0

    baseline = None
    if baseline_path is not None:
        try:
            baseline = findings_mod.load_baseline(baseline_path)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    new = findings_mod.new_findings(all_findings, baseline)

    if args.format == "json":
        print(
            json.dumps(
                {
                    "findings": [f.to_dict() for f in new],
                    "total_scanned": len(all_findings),
                    "baselined": len(all_findings) - len(new),
                },
                indent=2,
            )
        )
    else:
        for f in new:
            print(f.format())
        suffix = (
            f" ({len(all_findings) - len(new)} baselined)"
            if baseline
            else ""
        )
        print(f"{len(new)} new finding(s){suffix}")
    return 1 if new else 0


if __name__ == "__main__":
    sys.exit(main())
