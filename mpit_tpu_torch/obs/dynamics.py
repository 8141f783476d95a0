"""Training-dynamics aggregation — staleness, elastic distance, quality.

A copy of ``mpit_tpu/obs/dynamics.py`` for the port.

The post-mortem half of the dynamics plane (docs/OBSERVABILITY.md
"dynamics"). Three journal record kinds feed it:

- ``dynamics`` (client ranks, one per exchange, written by
  ``parallel/ps_roles._record_dynamics``): elastic distance
  ‖x_local − x̃‖, push/fetch-delta norms, param norm, update/param
  ratio;
- ``push_stale`` (server ranks, one per applied versioned push):
  ``staleness`` = center updates applied between the pushing client's
  fetch and its push landing, attributed per source rank;
- ``param_version`` (server ranks, one per PARAM reply): the center
  version stamped into the reply — the monotonicity evidence
  conformance rule TC204 replays.

:func:`aggregate_dynamics` reduces them into per-client elastic
trajectories with a monotone-growth divergence verdict, per-source
staleness percentiles (exact — journals carry exact integer staleness,
no bucketing), per-server version progressions, and a run roll-up whose
scalars (``staleness_p99``, ``elastic_dist_final``, ``norm_ratio``)
ride in every ``bench.py`` mnist-ps JSON line next to ``samples/s`` —
the before/after quality instrument for the ROADMAP fast-wire item.

:func:`check_dynamics_gate` turns the roll-up into a CI verdict against
a small JSON gate file (the ``obs slo`` pattern)::

    {"staleness_p99_max": 8, "elastic_dist_final_max": 50.0,
     "norm_ratio_max": 0.5, "allow_diverging": false}

Unknown gate keys fail loudly — a typo'd threshold must not silently
gate nothing. Like the rest of the reader side this module is
stdlib-only: no jax, no transport imports; safe for the lint.sh gate.
"""

from __future__ import annotations

import json
from typing import Iterable, Mapping, Optional

from mpit_tpu_torch.obs.merge import (
    _rec_rank,
    expand_journal_paths,
    read_journal,
)

# post-mortem divergence verdict — deliberately the same shape as the
# live AlertEngine rule (strictly increasing across N observations AND
# overall growth beyond a factor), so the dashboard and the report agree
DIVERGENCE_WINDOWS = 4
DIVERGENCE_FACTOR = 2.0

# trajectory points carried in the report per client (the verdict uses
# the full series; the report tail is for humans and plots)
_TRAJECTORY_TAIL = 64

_GATE_KEYS = {
    "staleness_p99_max": (int, float),
    "elastic_dist_final_max": (int, float),
    "norm_ratio_max": (int, float),
    "allow_diverging": (bool,),
}


def _exact_percentile(counts: Mapping[int, int], q: float) -> Optional[int]:
    """q-th percentile (0..1) of a ``{value: count}`` tally — exact, the
    journals carry exact integer staleness (no geometric bucketing)."""
    total = sum(counts.values())
    if total == 0:
        return None
    need = q * total
    seen = 0
    for v in sorted(counts):
        seen += counts[v]
        if seen >= need:
            return v
    return max(counts)


def diverging(
    trajectory: list,
    windows: int = DIVERGENCE_WINDOWS,
    factor: float = DIVERGENCE_FACTOR,
) -> bool:
    """Monotone-growth verdict over an elastic-distance series: the last
    ``windows`` points are strictly increasing AND grew by more than
    ``factor`` overall. A healthy EASGD run's elastic distance
    equilibrates (the center keeps pulling workers back); sustained
    strict growth is the exploration term winning — divergence."""
    tail = trajectory[-windows:]
    if len(tail) < windows or tail[0] <= 0:
        return False
    return all(b > a for a, b in zip(tail, tail[1:])) and (
        tail[-1] / tail[0] > factor
    )


def aggregate_dynamics(journal_paths: Iterable[str]) -> dict:
    """Cross-rank dynamics report from obs journals (files or dirs of
    ``obs_rank*.jsonl``). Empty journals (a run with the dynamics plane
    never armed, or pre-dynamics journals) yield ``run: None`` — the CLI
    maps that to exit 2, distinct from a gate violation."""
    clients: dict[int, dict] = {}
    trajectories: dict[int, list] = {}
    staleness: dict[int, dict] = {}
    servers: dict[int, dict] = {}
    last_gv: dict[int, tuple] = {}  # per-server (gen, version) high-water

    for path in expand_journal_paths(journal_paths):
        for rec in read_journal(path):
            ev = rec.get("ev")
            rank = _rec_rank(rec)
            if ev == "dynamics":
                row = clients.setdefault(rank, {
                    "rounds": 0, "algo": rec.get("algo"),
                    "push_norm": None, "param_norm": None,
                    "fetch_delta": None, "norm_ratio": None,
                })
                row["rounds"] += 1
                # journals are per-rank monotone, so last write wins =
                # final exchange
                for k in ("push_norm", "param_norm", "fetch_delta"):
                    if k in rec:
                        row[k] = rec[k]
                if "ratio" in rec:
                    row["norm_ratio"] = rec["ratio"]
                if "elastic" in rec:
                    trajectories.setdefault(rank, []).append(
                        rec["elastic"]
                    )
            elif ev == "push_stale":
                src = rec.get("src")
                s = rec.get("staleness")
                if src is None or not isinstance(s, (int, float)):
                    continue
                st = staleness.setdefault(
                    src, {"pushes": 0, "sum": 0, "counts": {}}
                )
                st["pushes"] += 1
                st["sum"] += s
                st["counts"][int(s)] = st["counts"].get(int(s), 0) + 1
            elif ev == "param_version":
                v = rec.get("version")
                if not isinstance(v, int):
                    continue
                # restart generation (elastic runs): a restored server
                # resumes from its last snapshot, so versions may step
                # back across a gen bump — monotonicity is per (gen,
                # version) lexicographic order, mirroring TC204
                g = rec.get("gen", 0)
                if not isinstance(g, int):
                    g = 0
                srv = servers.setdefault(rank, {
                    "param_replies": 0, "first_version": v,
                    "final_version": v, "monotonic": True,
                    "restores": 0,
                })
                srv["param_replies"] += 1
                pg, pv = last_gv.get(rank, (g, v))
                if (g, v) < (pg, pv):
                    srv["monotonic"] = False
                if g > pg:
                    srv["restores"] += g - pg
                last_gv[rank] = max(last_gv.get(rank, (g, v)), (g, v))
                srv["final_version"] = max(srv["final_version"], v)

    for rank, traj in trajectories.items():
        row = clients[rank]
        row["elastic"] = {
            "first": traj[0],
            "final": traj[-1],
            "max": max(traj),
            "mean": sum(traj) / len(traj),
        }
        row["diverging"] = diverging(traj)
        row["trajectory"] = traj[-_TRAJECTORY_TAIL:]

    stal_rows: dict[int, dict] = {}
    for src, st in sorted(staleness.items()):
        stal_rows[src] = {
            "pushes": st["pushes"],
            "mean": st["sum"] / st["pushes"],
            "p50": _exact_percentile(st["counts"], 0.50),
            "p99": _exact_percentile(st["counts"], 0.99),
            "max": max(st["counts"]),
        }

    run = None
    if clients or stal_rows or servers:
        finals = [
            c["elastic"]["final"] for c in clients.values()
            if "elastic" in c
        ]
        ratios = [
            c["norm_ratio"] for c in clients.values()
            if c.get("norm_ratio") is not None
        ]
        p99s = [r["p99"] for r in stal_rows.values() if r["p99"] is not None]
        run = {
            "clients": len(clients),
            "servers": len(servers),
            "staleness_p99": max(p99s) if p99s else None,
            "elastic_dist_final": max(finals) if finals else None,
            "norm_ratio": max(ratios) if ratios else None,
            "diverging": any(
                c.get("diverging") for c in clients.values()
            ),
            "versions_monotonic": all(
                s["monotonic"] for s in servers.values()
            ) if servers else None,
        }

    return {
        "clients": {r: clients[r] for r in sorted(clients)},
        "staleness": stal_rows,
        "servers": {r: servers[r] for r in sorted(servers)},
        "run": run,
    }


def load_gate(path: str) -> dict:
    """Parse + validate a dynamics gate file. Raises ``ValueError`` for
    unknown keys or mistyped values (a typo'd threshold must fail the
    gate run loudly, not silently check nothing), ``OSError`` for an
    unreadable file."""
    with open(path) as f:
        gate = json.load(f)
    if not isinstance(gate, dict):
        raise ValueError("dynamics gate must be a JSON object")
    for key, value in gate.items():
        types = _GATE_KEYS.get(key)
        if types is None:
            raise ValueError(
                f"unknown dynamics gate key {key!r} "
                f"(known: {sorted(_GATE_KEYS)})"
            )
        if types == (bool,):
            ok = isinstance(value, bool)
        else:
            # bool is an int subclass — reject it for numeric thresholds
            ok = isinstance(value, types) and not isinstance(value, bool)
        if not ok:
            raise ValueError(
                f"dynamics gate key {key!r}: expected "
                f"{'/'.join(t.__name__ for t in types)}, got {value!r}"
            )
    return gate


def check_dynamics_gate(report: dict, gate: Mapping) -> list[str]:
    """Violation strings (empty = pass) for an aggregated report against
    a parsed gate. A threshold whose metric is absent from the report is
    a violation — a gate on staleness over journals that carry none
    means the instrumentation regressed, which is exactly what the gate
    exists to catch."""
    run = report.get("run") or {}
    out: list[str] = []

    def _bound(key: str, metric: str) -> None:
        if key not in gate:
            return
        value = run.get(metric)
        if value is None:
            out.append(
                f"{metric}: absent from the report but gated by {key}"
            )
        elif value > gate[key]:
            out.append(f"{metric}: {value} > {key}={gate[key]}")

    _bound("staleness_p99_max", "staleness_p99")
    _bound("elastic_dist_final_max", "elastic_dist_final")
    _bound("norm_ratio_max", "norm_ratio")
    if not gate.get("allow_diverging", False) and run.get("diverging"):
        ranks = [
            r for r, c in report.get("clients", {}).items()
            if c.get("diverging")
        ]
        out.append(f"diverging: client rank(s) {ranks} — elastic "
                   "distance growing monotonically beyond "
                   f"{DIVERGENCE_FACTOR}x over {DIVERGENCE_WINDOWS} "
                   "exchanges")
    return out
