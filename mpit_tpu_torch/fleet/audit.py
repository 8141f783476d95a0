"""Journal-verified fleet guarantees: zero-lost routing, monotonic
weight versions, kill postmortem; the port's counterpart of
``mpit_tpu/fleet/audit.py``.

The router's lifecycle journal is written to be *checked*, not just
read: every admitted request leaves ``req_enqueue`` + ``req_route``
records, every recovery leaves ``req_redispatch``, every completion
``req_finish``. :func:`audit_lifecycle` replays those records into the
invariant the fleet soak gates on — **every routed request reaches
``req_finish``, either directly or through an explicit
``req_redispatch`` chain** — and reports the violations by rid, so a
failing soak names its lost requests instead of a percentage.

Stdlib-only (journals are JSONL) — auditable anywhere.
"""

from __future__ import annotations

from typing import Iterable

from mpit_tpu_torch.obs.merge import expand_journal_paths, read_journal

#: router-journal lifecycle events, in the order a healthy rid sees them
LIFECYCLE_EVENTS = (
    "req_enqueue",
    "req_route",
    "req_redispatch",
    "req_finish",
    "req_shed",
)


def audit_lifecycle(paths: Iterable[str]) -> dict:
    """Audit one fleet run's ROUTER journal(s).

    Returns::

        {
          "admitted": n,            # req_enqueue records
          "routed": n,              # rids with >= 1 req_route
          "finished": n,            # rids with a req_finish
          "redispatched": n,        # rids that needed >= 1 redispatch
          "shed": n,                # admission rejections (not losses)
          "lost": [rid, ...],       # routed but never finished — THE bug
          "unrouted": [rid, ...],   # admitted but never routed
          "replicas_finished": {replica: count},
          "versions_by_replica": {replica: [version, ...]},  # reply order
          "versions_monotonic": bool,
          "dead_replicas": [rank, ...],   # named by redispatch records
          "ok": bool,               # no lost, no unrouted
        }
    """
    enqueued: set = set()
    routed: set = set()
    finished: set = set()
    redispatched: set = set()
    shed = 0
    dead: set = set()
    by_replica_finished: dict = {}
    versions: dict = {}
    for path in expand_journal_paths(list(paths)):
        for rec in read_journal(path):
            ev = rec.get("ev")
            rid = rec.get("rid")
            if ev == "req_enqueue":
                enqueued.add(rid)
            elif ev == "req_route":
                routed.add(rid)
            elif ev == "req_redispatch":
                redispatched.add(rid)
                routed.add(rid)
                if "from_replica" in rec:
                    dead.add(rec["from_replica"])
            elif ev == "req_finish":
                finished.add(rid)
                replica = rec.get("replica")
                if replica is not None:
                    by_replica_finished[replica] = (
                        by_replica_finished.get(replica, 0) + 1
                    )
                    if "serving_weights_version" in rec:
                        versions.setdefault(replica, []).append(
                            rec["serving_weights_version"]
                        )
            elif ev == "req_shed":
                shed += 1
    lost = sorted(routed - finished)
    unrouted = sorted(enqueued - routed)
    monotonic = all(
        all(a <= b for a, b in zip(vs, vs[1:]))
        for vs in versions.values()
    )
    return {
        "admitted": len(enqueued),
        "routed": len(routed),
        "finished": len(finished),
        "redispatched": len(redispatched),
        "shed": shed,
        "lost": lost,
        "unrouted": unrouted,
        "replicas_finished": {
            int(k): v for k, v in sorted(by_replica_finished.items())
        },
        "versions_by_replica": {
            int(k): v for k, v in sorted(versions.items())
        },
        "versions_monotonic": monotonic,
        "dead_replicas": sorted(dead),
        "ok": not lost and not unrouted,
    }


def format_audit(audit: dict) -> str:
    """One human-readable block (the soak's postmortem paragraph)."""
    lines = [
        f"admitted={audit['admitted']} routed={audit['routed']} "
        f"finished={audit['finished']} "
        f"redispatched={audit['redispatched']} shed={audit['shed']}",
    ]
    if audit["dead_replicas"]:
        outcome = (
            f"{audit['redispatched']} request(s) re-dispatched, none lost"
            if audit["ok"] else f"{len(audit['lost'])} request(s) LOST"
        )
        lines.append(
            "killed replica(s): "
            + ", ".join(str(r) for r in audit["dead_replicas"])
            + " — " + outcome
        )
    for replica, count in audit["replicas_finished"].items():
        vs = audit["versions_by_replica"].get(replica, [])
        span = f" versions {vs[0]}..{vs[-1]}" if vs else ""
        lines.append(f"  replica {replica}: {count} finished{span}")
    if not audit["versions_monotonic"]:
        lines.append("  VERSION REGRESSION: a replica's stamped "
                     "serving_weights_version moved backward")
    if audit["lost"]:
        lines.append(f"  LOST rids: {audit['lost']}")
    if audit["unrouted"]:
        lines.append(f"  UNROUTED rids: {audit['unrouted']}")
    lines.append("audit: " + ("OK" if audit["ok"] else "FAILED"))
    return "\n".join(lines)
