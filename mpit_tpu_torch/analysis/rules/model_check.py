"""MPT009/MPT010/MPT011 — model-checked protocol safety properties.

Where MPT008 pairs tag alphabets, these rules run the explicit-state
model checker (:mod:`mpit_tpu_torch.analysis.mcheck`) over the fault-handling
semantics that :func:`mpit_tpu_torch.analysis.protocol.extract_semantics`
lifts out of the marked role modules — the attempt-id echo/check, the
reply-wait timeout, and the dedup window's exact admit boundary — and
exhaustively explore every single-fault message interleaving of the
lint-tier configurations (1 client x 1 server, EASGD and Downpour step
orders, window 1, bounded rounds; the hazards are per-client-per-server,
and tests/test_mcheck.py runs the 2-client acceptance pair):

- **MPT009** exactly-once push application: some reachable fault
  schedule makes one server apply the same ``(client, seq)`` push twice
  (classically: the dedup boundary uses ``<`` where ``<=`` is needed, so
  a duplicated copy delivered after the window slid is re-admitted);
- **MPT010** deadlock freedom: some reachable state has no enabled
  transition yet the run isn't finished (a blocking recv with no escape
  — e.g. a dropped request and no timeout on the reply wait);
- **MPT011** stale-attempt isolation: a reply generated for a timed-out
  attempt is assembled into a newer fetch (no attempt id on the wire, or
  an echoed id the client never compares).

Conservatism: roles without fault machinery (no attempt echo AND no
dedup window — e.g. the tiny lint fixtures) are protocol sketches, not
fault-tolerant PS implementations, and are skipped entirely; a dedup
admit whose shape the extractor can't parse (``dedup_opaque``) is
assumed correct rather than guessed at. Whatever the checker reports is
a real trace of the extracted model, and the finding message carries the
violating configuration plus the explored state count as the
exhaustiveness receipt.

Results are memoized on the extracted semantics (frozen dataclasses), so
repeated ``run_lint`` calls in one process — the test suite, ``--fix``
re-checks — pay for the exploration once.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Optional

from mpit_tpu_torch.analysis import mcheck, protocol

RULES = {
    "MPT009": (
        "push-applied-twice",
        "a fault schedule exists where the dedup window admits the same "
        "(client, seq) push twice — exactly-once application is violated",
    ),
    "MPT010": (
        "protocol-deadlock",
        "a fault schedule reaches a state where every role is blocked "
        "and no message can unblock them",
    ),
    "MPT011": (
        "stale-reply-assembled",
        "a reply from a timed-out attempt can be assembled into a newer "
        "fetch — attempt ids are missing or never checked",
    ),
}

# extracted-semantics -> list[CheckResult]; ProtocolSemantics is frozen
# and hashable, so identical protocols (every run_lint over this repo)
# share one exploration per process
_CACHE: dict = {}


def _anchor(rel: str, line: int, col: int) -> ast.AST:
    node = ast.Constant(0)
    node.lineno, node.col_offset = line, col
    return node


def _emit(by_rel, rel, line, col, symbol, rule, message):
    mod = by_rel.get(rel)
    if mod is not None:
        f = mod.finding(rule, _anchor(rel, line, col), message)
        # the synthetic anchor has no parents entry; the extraction
        # already carries the real enclosing symbol
        yield dataclasses.replace(f, symbol=symbol)


def _site(sem: protocol.ProtocolSemantics, rule: str):
    """(rel, line, col, symbol) to pin each property's finding to: the
    dedup admit for exactly-once, the client's reply recv for deadlock
    and (when an echo exists but isn't compared) staleness, the server's
    reply send when no attempt id is on the wire at all."""
    if rule == "MPT009" and sem.dedup is not None:
        d = sem.dedup
        return d.rel, d.line, d.col, d.symbol
    if rule == "MPT011" and not sem.attempt_echoed:
        op = sem.reply_send
    else:
        op = sem.reply_recv
    return op.rel, op.line, op.col, op.symbol


def results_for(sem: protocol.ProtocolSemantics) -> list:
    if sem not in _CACHE:
        # quick: the default and sharded configs run their 1-client
        # lint-tier variants (hundreds of states each) — the 2-client
        # exhaustive runs are test_mcheck.py's acceptance job, not the
        # pre-commit scan's
        _CACHE[sem] = mcheck.check_all(
            mcheck.from_protocol(sem), quick=True
        )
    return _CACHE[sem]


def run(project) -> Iterable:
    sem: Optional[protocol.ProtocolSemantics] = protocol.extract_semantics(
        project
    )
    if sem is None or not sem.has_fault_machinery:
        return
    by_rel = {m.rel: m for m in project.modules}
    reported = set()
    for res in results_for(sem):
        for rule in sorted(res.violations):
            if rule in reported:
                continue  # first violating configuration wins
            reported.add(rule)
            rel, line, col, symbol = _site(sem, rule)
            yield from _emit(
                by_rel,
                rel,
                line,
                col,
                symbol,
                rule,
                res.violations[rule]
                + f" (exhaustive: {res.states} states, "
                f"{res.fault_points} single-fault schedules)",
            )
        if res.truncated:
            rel, line, col, symbol = _site(sem, "MPT010")
            yield from _emit(
                by_rel,
                rel,
                line,
                col,
                symbol,
                "MPT010",
                f"[{res.config.label}] state space exceeded "
                f"{res.config.max_states} states — exploration truncated, "
                "deadlock freedom NOT established",
            )
            break
