"""MPT019 — model-checked fleet routing: no request lost under a kill.

The serving fleet (``mpit_tpu_torch/fleet/``) speaks its own conversation —
ROUTE/REPLY between the router and its replicas — with its own failure
mode: a replica killed mid-request takes consumed-but-unreplied work
with it, and the request is lost unless the router both *notices* (a
timeout on its reply recv) and *recovers* (a redispatch send of the
route tag). :func:`mpit_tpu_torch.analysis.protocol.extract_fleet_semantics`
lifts those two facts out of the marked fleet roles;
:func:`mpit_tpu_torch.analysis.mcheck.check_fleet` exhaustively explores the
fleet-route configuration (1 router x 2 replicas, bounded requests, one
replica kill allowed anywhere except the last survivor) and reports any
reachable state where a routed request is stranded on a dead replica
with no enabled recovery — the model form of the soak gate's "every
``req_route`` reaches ``req_finish`` or ``req_redispatch``" invariant.

Conservatism mirrors MPT009–011: no fleet roles in the scan set (or an
unextractable pair) means skip, never guess; a reported violation is a
real trace of the extracted model, and the finding carries the explored
state count as its exhaustiveness receipt. Results are memoized on the
frozen semantics, so the suite's repeated ``run_lint`` calls pay for the
exploration once per process.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Optional

from mpit_tpu_torch.analysis import mcheck, protocol

RULES = {
    "MPT019": (
        "fleet-request-lost",
        "a single-replica-kill schedule exists where a routed serving "
        "request is neither finished nor redispatched — admitted work "
        "is silently lost",
    ),
}

# frozen FleetModelSemantics -> CheckResult, one exploration per process
_CACHE: dict = {}


def _anchor(line: int, col: int) -> ast.AST:
    node = ast.Constant(0)
    node.lineno, node.col_offset = line, col
    return node


def results_for(fsem: protocol.FleetSemantics) -> mcheck.CheckResult:
    key = mcheck.fleet_from_protocol(fsem)
    if key not in _CACHE:
        _CACHE[key] = mcheck.check_fleet(key, mcheck.fleet_config(quick=True))
    return _CACHE[key]


def run(project) -> Iterable:
    fsem: Optional[protocol.FleetSemantics] = (
        protocol.extract_fleet_semantics(project)
    )
    if fsem is None or fsem.route_send is None:
        return
    res = results_for(fsem)
    by_rel = {m.rel: m for m in project.modules}
    op = fsem.route_send  # the router's route dispatch pins the finding
    mod = by_rel.get(op.rel)
    if mod is None:
        return
    messages = [
        res.violations[rule]
        + f" (exhaustive: {res.states} states, "
        f"{res.fault_points} single-fault schedules)"
        for rule in sorted(res.violations)
    ]
    if res.truncated:
        messages.append(
            f"[{res.config.label}] state space exceeded "
            f"{res.config.max_states} states — exploration truncated, "
            "lost-request freedom NOT established"
        )
    for message in messages:
        f = mod.finding(
            "MPT019", _anchor(op.line, op.col), message
        )
        yield dataclasses.replace(f, symbol=op.symbol)
