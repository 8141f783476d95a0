# mpit-analysis: protocol-role[serving_router->serving_replica]
"""Request router: admission, dispatch policy, lifecycle journal; the
port's counterpart of ``mpit_tpu/fleet/router.py``.

One router owns the fleet's front door. Every admitted request is
journaled ``req_enqueue`` → ``req_route`` → (``req_redispatch`` →)* →
``req_finish``: the routing journal is the audit trail the zero-lost
guarantee is *checked against* (:mod:`mpit_tpu_torch.fleet.audit`), not just
telemetry. Shed requests are journaled as ``req_shed`` without an
enqueue, so ``obs slo`` over the router journal counts goodput over
admitted requests only and sheds never look like losses.

Dispatch policies (:func:`choose_replica`, pure and seeded — a failing
run replays its exact routing):

- ``least``: lowest queue depth, ties broken by lowest rank;
- ``p2c``: power-of-two-choices — two seeded candidate draws per rid
  via the shared :func:`~mpit_tpu_torch.transport.chaos._mix` hash, the
  less-loaded of the two wins (ties again by rank). The classic
  load-balancing result: two random probes get within a constant factor
  of least-loaded while only ever reading two gauges.

Load per replica is the router's own outstanding count, optionally
fused with the replica-exported live-plane queue-depth gauges
(:func:`live_loads`) — the gauges see work the router already handed
over, the outstanding count sees work the gauge exporter hasn't
snapshotted yet; the max of the two is the conservative view.

Replica death: the router never blocks on a dead replica — replies are
drained with a timeout, and :meth:`Router.mark_dead` re-dispatches the
dead replica's outstanding requests to survivors (``req_redispatch``).
A late reply from a request that was re-dispatched is dropped by rid
bookkeeping (first finish wins; the journal shows both paths).
"""

from __future__ import annotations

import os
from typing import Optional

from mpit_tpu_torch.fleet.replica import (
    TAG_FLEET_STOP,
    TAG_REPLY,
    TAG_ROUTE,
    TAG_WEIGHT_SUB,
)
from mpit_tpu_torch.obs.live import (
    M_FLEET_OUTSTANDING,
    M_FLEET_REDISPATCHED,
    M_FLEET_REPLICAS,
    M_FLEET_ROUTED,
    M_FLEET_SHED,
    NULL_REGISTRY,
)
from mpit_tpu_torch.transport.base import RecvTimeout
from mpit_tpu_torch.transport.chaos import _mix

#: domain separator: router candidate draws must not collide with wire-
#: or serve-chaos draws made from the same user seed
_FLEET_STREAM = 0xF1EE7

POLICIES = ("least", "p2c")


def choose_replica(policy: str, seed: int, rid: int, loads: dict) -> int:
    """The dispatch decision, as a pure function of ``(policy, seed,
    rid, loads)`` — rank → load for every *alive* candidate. Determinism
    is the replay contract: same inputs, same replica, any process."""
    if not loads:
        raise ValueError("no alive replicas to route to")
    ranks = sorted(loads)
    if policy == "least":
        return min(ranks, key=lambda r: (loads[r], r))
    if policy == "p2c":
        a = ranks[_mix(seed, _FLEET_STREAM, rid, 0) % len(ranks)]
        b = ranks[_mix(seed, _FLEET_STREAM, rid, 1) % len(ranks)]
        return a if (loads[a], a) <= (loads[b], b) else b
    raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")


def live_loads(live_dir: str, alive) -> dict:
    """Queue-depth view from the replicas' live-plane snapshots: rank →
    ``load.pending`` gauge (0 for ranks that haven't exported yet). The
    router fuses this with its own outstanding counts — see module
    docstring."""
    from mpit_tpu_torch.obs.live import M_LOAD_PENDING, read_snapshots

    snaps = read_snapshots(live_dir)
    out = {}
    for rank in alive:
        gauges = snaps.get(rank, {}).get("gauges", {})
        out[rank] = float(gauges.get(M_LOAD_PENDING, 0.0))
    return out


class _RouterObs:
    """The router's lifecycle journal: the ``_ServeObs`` layout (one
    ``obs_rank<r>.jsonl`` in MetricsLogger format, Lamport-stamped) so
    merge/summary/slo read it unchanged — but *router-plane* events.
    Kept separate from the replica journals on purpose: router rids and
    per-replica server rids are different namespaces, and aggregating
    them together would double-count every request."""

    __slots__ = ("journal", "clock")

    def __init__(self, obs_dir: str, rank: int = 0):
        from mpit_tpu_torch.obs.core import Journal, LogicalClock

        os.makedirs(obs_dir, exist_ok=True)
        self.journal = Journal(
            os.path.join(obs_dir, f"obs_rank{rank}.jsonl"), rank
        )
        self.clock = LogicalClock()

    def event(self, ev: str, **fields) -> None:
        self.journal.event(ev, self.clock.tick(), **fields)

    def close(self) -> None:
        self.journal.close()


class Router:
    """Admission + dispatch over one transport rank.

    ``transport``: the router's rank (replies and weight subscriptions
    arrive here). ``replicas``: the replica ranks initially alive.
    ``policy``/``seed``: the :func:`choose_replica` inputs (env default
    ``MPIT_FLEET_POLICY``). ``max_outstanding``: admission cap across
    the whole fleet — submits past it are shed, journaled, and return
    None (env default ``MPIT_FLEET_MAX_OUTSTANDING``, 0 = unlimited).
    ``obs_dir``: where the lifecycle journal lands (None = no journal).
    ``registry``: a live-plane MetricsRegistry (defaults to the no-op
    null registry)."""

    def __init__(
        self,
        transport,
        replicas,
        policy: Optional[str] = None,
        seed: int = 0,
        max_outstanding: Optional[int] = None,
        obs_dir: Optional[str] = None,
        registry=None,
        live_dir: Optional[str] = None,
    ):
        if policy is None:
            policy = os.environ.get("MPIT_FLEET_POLICY", "p2c")
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}"
            )
        if max_outstanding is None:
            max_outstanding = int(
                os.environ.get("MPIT_FLEET_MAX_OUTSTANDING", "0")
            )
        self.transport = transport
        self.alive = set(int(r) for r in replicas)
        self.dead: set = set()
        self.policy = policy
        self.seed = int(seed)
        self.max_outstanding = int(max_outstanding)
        self.live_dir = live_dir
        self._obs = _RouterObs(obs_dir) if obs_dir else None
        self._reg = registry if registry is not None else NULL_REGISTRY
        self._next_rid = 0
        #: rid -> replica rank currently responsible for it
        self.assigned: dict[int, int] = {}
        #: rid -> the submitted request fields (what a redispatch resends)
        self._requests: dict[int, tuple] = {}
        self.results: dict[int, dict] = {}
        self.shed = 0
        self.redispatched = 0
        self._reg.set_gauge(M_FLEET_REPLICAS, len(self.alive))

    # -- admission + dispatch ----------------------------------------------

    @property
    def outstanding(self) -> int:
        return len(self.assigned)

    def _loads(self) -> dict:
        counts = {r: 0 for r in sorted(self.alive)}
        for rank in self.assigned.values():
            if rank in counts:
                counts[rank] += 1
        if self.live_dir:
            for rank, depth in live_loads(self.live_dir, self.alive).items():
                counts[rank] = max(counts[rank], int(depth))
        return counts

    def submit(
        self, prompt, max_new: int, slo_ms: Optional[float] = None
    ) -> Optional[int]:
        """Admit one request and route it; None when shed at admission
        (fleet saturated per ``max_outstanding``)."""
        if (
            self.max_outstanding > 0
            and self.outstanding >= self.max_outstanding
        ):
            self.shed += 1
            self._reg.inc(M_FLEET_SHED)
            if self._obs is not None:
                self._obs.event("req_shed", outstanding=self.outstanding)
            return None
        rid = self._next_rid
        self._next_rid += 1
        prompt = [int(t) for t in prompt]
        slo = float(slo_ms) if slo_ms is not None else 0.0
        self._requests[rid] = (prompt, int(max_new), slo)
        if self._obs is not None:
            self._obs.event(
                "req_enqueue", rid=rid, p_len=len(prompt),
                max_new=int(max_new),
                **({"slo_ms": slo} if slo > 0 else {}),
            )
        replica = choose_replica(self.policy, self.seed, rid, self._loads())
        self._route(rid, replica)
        return rid

    def _route(self, rid: int, replica: int) -> None:
        prompt, max_new, slo = self._requests[rid]
        self.assigned[rid] = replica
        self.transport.send(
            replica, TAG_ROUTE, (rid, prompt, max_new, slo)
        )
        self._reg.inc(M_FLEET_ROUTED)
        self._reg.set_gauge(M_FLEET_OUTSTANDING, self.outstanding)
        if self._obs is not None:
            self._obs.event("req_route", rid=rid, replica=replica)

    def redispatch(self, rid: int, to: int) -> None:
        """Re-route one outstanding request after its assignee died.
        Journaled as ``req_redispatch`` — the explicit not-lost marker
        the lifecycle audit requires between a dead ``req_route`` and
        the eventual ``req_finish``."""
        src = self.assigned.get(rid)
        self.redispatched += 1
        self._reg.inc(M_FLEET_REDISPATCHED)
        if self._obs is not None:
            self._obs.event(
                "req_redispatch",
                rid=rid,
                replica=to,
                **({} if src is None else {"from_replica": src}),
            )
        prompt, max_new, slo = self._requests[rid]
        self.assigned[rid] = to
        self.transport.send(to, TAG_ROUTE, (rid, prompt, max_new, slo))
        self._reg.inc(M_FLEET_ROUTED)

    def mark_dead(self, rank: int) -> list:
        """Retire a replica and re-dispatch everything it still owed.
        Returns the re-dispatched rids (empty when it owed nothing)."""
        rank = int(rank)
        if rank not in self.alive:
            return []
        self.alive.discard(rank)
        self.dead.add(rank)
        self._reg.set_gauge(M_FLEET_REPLICAS, len(self.alive))
        orphans = sorted(
            rid for rid, r in self.assigned.items() if r == rank
        )
        for rid in orphans:
            loads = self._loads()
            if not loads:
                break  # nobody left — the audit will name these lost
            self.redispatch(rid, choose_replica(
                self.policy, self.seed, rid, loads
            ))
        return orphans

    def add_replica(self, rank: int) -> None:
        """Admit a (re)spawned replica into the routing set (the
        controller's spawn path lands here)."""
        rank = int(rank)
        self.dead.discard(rank)
        self.alive.add(rank)
        self._reg.set_gauge(M_FLEET_REPLICAS, len(self.alive))

    # -- reply + subscription intake ---------------------------------------

    def poll(self, timeout: float = 0.0) -> Optional[int]:
        """Consume at most one REPLY; returns its rid (None on timeout).
        A reply for a rid this replica no longer owns (re-dispatched,
        first finish already recorded) is dropped — exactly-once finish
        per rid is the journal invariant."""
        try:
            msg = self.transport.recv(tag=TAG_REPLY, timeout=timeout)
        except RecvTimeout:
            return None
        rank, rid, tokens, version = msg.payload
        if rid not in self.assigned:
            return None  # late duplicate from a superseded dispatch
        if self.assigned.get(rid) != rank and rank in self.dead:
            return None  # zombie reply from a retired replica
        del self.assigned[rid]
        self.results[rid] = {
            "tokens": [int(t) for t in tokens],
            "replica": int(rank),
            "serving_weights_version": int(version),
        }
        self._reg.set_gauge(M_FLEET_OUTSTANDING, self.outstanding)
        if self._obs is not None:
            _p, max_new, _slo = self._requests.get(rid, ([], 0, 0.0))
            self._obs.event(
                "req_finish",
                rid=rid,
                gen=max(0, len(tokens) - len(_p)),
                reason="fleet",
                replica=int(rank),
                serving_weights_version=int(version),
            )
        return rid

    def poll_weight_subs(self, publisher) -> int:
        """Drain queued WEIGHT_SUBs into the publisher; returns how many
        were answered with a push."""
        pushed = 0
        while True:
            try:
                msg = self.transport.recv(tag=TAG_WEIGHT_SUB, timeout=0.0)
            except RecvTimeout:
                return pushed
            rank, have_version = msg.payload
            if publisher.on_sub(int(rank), int(have_version)) is not None:
                pushed += 1

    # -- teardown ----------------------------------------------------------

    def stop(self) -> None:
        """FLEET_STOP to every live replica (dead ones get nothing — the
        tag would park in a mailbox nobody drains)."""
        for rank in sorted(self.alive):
            self.transport.send(rank, TAG_FLEET_STOP, 0)

    def close(self) -> None:
        if self._obs is not None:
            self._obs.close()
