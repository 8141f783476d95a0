"""MPT013-015: whole-program race, lock-order and blocking-under-lock
rules, all consumers of the concurrency model in
:mod:`mpit_tpu_torch.analysis.threads` (``project.threads``).

MPT013 is an Eraser-style lockset check: state written from one thread
root and touched from another, where some cross-root access pair shares
NO lock, has no consistent protection discipline — the access can
interleave. Init-phase accesses (``__init__`` bodies, closure setup
before the first ``Thread()`` spawn) and constant stop-flag stores are
exempt, matching the classic algorithm's initialization state.

MPT014 is the static twin of runtime RT101: a cycle in the held→acquired
lock graph across ALL call paths and thread roots means two threads can
enter the cycle from different edges and deadlock, even if no single
test run (which is all RT101 sees) ever interleaves them.

MPT015 escalates MPT006 to call-graph depth: a blocking call is flagged
when a lock acquired in an ANCESTOR frame is still held — the shape
MPT006 structurally cannot see, and the one that actually bites (the
leaf function looks innocent in isolation). Same-frame cases remain
MPT006's jurisdiction, so the two rules never double-report.
"""

from __future__ import annotations

from mpit_tpu_torch.analysis.findings import Finding

RULES = {
    "MPT013": (
        "unlocked cross-thread shared state",
        "state written from >=2 thread roots with an empty/inconsistent "
        "lockset can interleave — protect it or confine it to one thread",
    ),
    "MPT014": (
        "static lock-order cycle",
        "two call paths acquire the same locks in opposite orders — "
        "threads entering from different edges deadlock",
    ),
    "MPT015": (
        "blocking call under a caller's lock",
        "an indefinitely-blocking call runs while a lock acquired in an "
        "ancestor frame is held — stalls every thread contending for it",
    ),
}


def _fmt_lockset(ls) -> str:
    if not ls:
        return "{}"
    return "{" + ", ".join(sorted(l.short() for l in ls)) + "}"


def _mpt013(model):
    for state, per_root in sorted(
        model.shared_state().items(), key=lambda kv: kv[0].label()
    ):
        writes = {r: e for r, e in per_root.items() if e["writes"]}
        if not writes:
            continue
        if all(e["all_const_writes"] for e in writes.values()):
            continue  # pure flag stores: GIL-atomic by design
        # find a cross-root pair with an empty lockset intersection —
        # preferring an UNLOCKED write as the anchor (the actionable side)
        def _ls_key(ls):
            return (len(ls), sorted(l.label() for l in ls))

        def _w_order(item):
            root, entry = item
            return (min(len(ls) for ls in entry["write_locksets"]), root)

        offender = None
        for wroot, wentry in sorted(writes.items(), key=_w_order):
            for oroot, oentry in sorted(per_root.items()):
                if oroot == wroot:
                    continue
                for wls in sorted(wentry["write_locksets"], key=_ls_key):
                    for ols in sorted(oentry["locksets"], key=_ls_key):
                        if not (wls & ols):
                            offender = (wroot, wls, oroot, ols, wentry)
                            break
                    if offender:
                        break
                if offender:
                    break
            if offender:
                break
        if offender is None:
            continue
        wroot, wls, oroot, ols, wentry = offender
        anchor = wentry["write_example"] or wentry["example"]
        yield anchor, (
            f"{state.label()} is written from thread root "
            f"'{wroot}' holding {_fmt_lockset(wls)} and accessed from "
            f"'{oroot}' holding {_fmt_lockset(ols)} — no common lock; "
            "guard both sides with one lock or confine the state to a "
            "single thread"
        )


def _mpt014(model):
    for path, edges in model.lock_cycles():
        names = " -> ".join(l.short() for l in path + [path[0]])
        anchor = edges[0]
        others = "; ".join(
            f"{e.held.short()}->{e.acquired.short()} at "
            f"{e.mod.rel}:{e.node.lineno} ({e.symbol}, root '{e.root}')"
            for e in edges
        )
        yield anchor, (
            f"lock-order cycle {names}: {others} — fix by imposing one "
            "global acquisition order (see RT101 for the runtime twin)"
        )


def _mpt015(model):
    seen = set()
    for site in model.blocking:
        lock = sorted(site.cross_locks, key=lambda l: l.label())[0]
        key = (site.mod.rel, site.node.lineno, site.call, lock)
        if key in seen:
            continue
        seen.add(key)
        yield site, (
            f"blocking call '{site.call}()' runs while holding "
            f"{_fmt_lockset(site.cross_locks)} acquired in a CALLER frame "
            f"(thread root '{site.root}') — the critical section spans "
            "this whole call chain; move the blocking call outside it"
        )


def run(project):
    model = project.threads
    for anchor, message in _mpt013(model):
        yield _finding(project, "MPT013", anchor.mod, anchor.node, message)
    for anchor, message in _mpt014(model):
        yield _finding(project, "MPT014", anchor.mod, anchor.node, message)
    for site, message in _mpt015(model):
        yield _finding(project, "MPT015", site.mod, site.node, message)


def _finding(project, rule, mod, node, message) -> Finding:
    return mod.finding(rule, node, message)
