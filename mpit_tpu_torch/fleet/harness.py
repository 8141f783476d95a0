"""In-process fleet harness: N replica threads + one router loop; the
port's counterpart of ``mpit_tpu/fleet/harness.py``.

The fleet analogue of :class:`mpit_tpu_torch.loadgen.harness.LoadHarness` —
and the single-host test/soak vehicle for every fleet guarantee. Ranks
are threads over one :class:`~mpit_tpu_torch.transport.inproc.Broker` (rank 0
= router, 1..N = replicas; the multi-process runner in
``fleet/__main__.py`` swaps in ``SocketTransport`` with the same
protocol). The router loop is single-threaded and open-loop: arrivals
come due on the workload's schedule regardless of fleet capacity, so
overload shows up in e2e latency — the measurement — not in silently
throttled offered load.

Chaos: a :class:`~mpit_tpu_torch.loadgen.chaos.ServeChaos` ``kill_after``
boundary kills ``kill_rank`` — the in-process SIGKILL is the replica's
``killed`` flag, which drops any not-yet-sent replies and exits the
dispatch loop, so requests the replica had already consumed become
exactly the orphans redispatch exists for. Death is *detected*, not
assumed: the router loop watches thread liveness (the process-level
runner watches waitpid) and feeds a synthesized ``dead_rank`` alert to
the controller (when armed) or calls ``mark_dead`` directly.

Cancellations are not routed (the fleet wire has no CANCEL lane yet);
run fleet workloads with ``cancel_prob=0``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

from mpit_tpu_torch.fleet.controller import FleetController
from mpit_tpu_torch.fleet.replica import ReplicaServer
from mpit_tpu_torch.fleet.router import Router
from mpit_tpu_torch.fleet.weights import WeightPublisher
from mpit_tpu_torch.transport.inproc import Broker


@dataclasses.dataclass
class FleetReport:
    """Outcome of one fleet run. ``results``: rid → ``{tokens, replica,
    serving_weights_version}``; ``replica_summaries``: each replica
    loop's exit summary; ``controller_log``: the actions taken;
    ``dead_ranks`` (the port's addition): the replicas the router retired
    as dead, whether or not they owed it anything."""

    results: dict
    submitted: int
    shed: int
    redispatched: int
    killed_ranks: list
    spawned_ranks: list
    boundaries: int
    wall_s: float
    replica_summaries: list
    controller_log: list
    weights_pushed: dict
    dead_ranks: list = dataclasses.field(default_factory=list)


class FleetHarness:
    """Run one workload against an in-process fleet.

    ``server_factory(rank)``: builds the replica's ``Server`` (give each
    rank its own obs dir — replica journals carry TTFT, the router
    journal carries admission/e2e; never aggregate the two together).
    ``n_replicas``: initial fleet size; ``spares``: extra ranks the
    controller may spawn into. ``source``: a weight source to publish
    from (replicas subscribe at startup); ``refresh_boundaries``: router
    boundaries at which the source is bumped via ``refresh_params_fn``
    and rolled across the fleet. ``chaos``+``kill_rank``: the replica
    kill leg. ``use_controller``: route death through the alert→action
    path (and allow spawn into spares) instead of bare ``mark_dead``."""

    def __init__(
        self,
        server_factory: Callable,
        requests: list,
        n_replicas: int = 3,
        spares: int = 0,
        policy: Optional[str] = None,
        seed: int = 0,
        obs_dir: Optional[str] = None,
        max_outstanding: int = 0,
        chaos=None,
        kill_rank: Optional[int] = None,
        source=None,
        quant: str = "off",
        refresh_boundaries: tuple = (),
        refresh_params_fn: Optional[Callable] = None,
        use_controller: bool = False,
        poll_s: float = 0.005,
        idle_sleep: float = 0.001,
    ):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.server_factory = server_factory
        self.requests = sorted(requests, key=lambda r: r.arrival_s)
        self.n_replicas = int(n_replicas)
        self.spares = int(spares)
        self.policy = policy
        self.seed = int(seed)
        self.obs_dir = obs_dir
        self.max_outstanding = int(max_outstanding)
        self.chaos = chaos
        self.kill_rank = kill_rank if kill_rank is not None else 1
        self.source = source
        self.quant = quant
        self.refresh_boundaries = set(refresh_boundaries)
        self.refresh_params_fn = refresh_params_fn
        self.use_controller = use_controller
        self.poll_s = float(poll_s)
        self.idle_sleep = float(idle_sleep)
        self._replicas: dict[int, ReplicaServer] = {}
        self._threads: dict[int, threading.Thread] = {}
        self._summaries: list = []

    # -- replica lifecycle (the process-backed runner in ``__main__``
    # overrides these four hooks; the router loop is shared) -----------------

    def _make_world(self, size: int) -> None:
        """Bind ``self._transports[rank]`` for every rank in the world."""
        self._broker = Broker(size)
        self._transports = self._broker.transports()

    def _replica_dead(self, rank: int) -> bool:
        """A replica that stopped serving without being told to — the
        in-process waitpid is thread liveness."""
        t = self._threads.get(rank)
        rep = self._replicas.get(rank)
        return (
            t is not None
            and not t.is_alive()
            and not (rep is not None and rep.stopped)
        )

    def _join_replicas(self) -> None:
        for t in self._threads.values():
            t.join(timeout=10.0)
        for rep in self._replicas.values():
            rep.close()

    def _spawn_replica(self, rank: int) -> None:
        rep = ReplicaServer(
            self.server_factory(rank),
            self._transports[rank],
            router_rank=0,
            poll_s=self.poll_s,
        )
        self._replicas[rank] = rep
        t = threading.Thread(
            target=lambda: self._summaries.append(rep.run()),
            name=f"mpit-fleet-replica-{rank}",
            daemon=True,
        )
        self._threads[rank] = t
        t.start()
        rep.subscribe_weights()

    def _kill_replica(self, rank: int) -> None:
        rep = self._replicas.get(rank)
        if rep is not None:
            rep.killed = True

    # -- the router loop ---------------------------------------------------

    def run(self) -> FleetReport:
        size = 1 + self.n_replicas + self.spares
        self._make_world(size)
        initial = list(range(1, self.n_replicas + 1))
        all_ranks = list(range(1, size))
        router = Router(
            self._transports[0],
            initial,
            policy=self.policy,
            seed=self.seed,
            max_outstanding=self.max_outstanding,
            obs_dir=self.obs_dir,
        )
        publisher = (
            WeightPublisher(self._transports[0], self.source, self.quant)
            if self.source is not None else None
        )
        controller = (
            FleetController(
                router, all_ranks,
                max_replicas=self.n_replicas,
                spawn=self._spawn_replica,
            )
            if self.use_controller else None
        )
        for rank in initial:
            self._spawn_replica(rank)

        reqs = self.requests
        t0 = time.perf_counter()
        i = 0
        boundary = 0
        killed_ranks: list = []
        while True:
            now = time.perf_counter() - t0
            while i < len(reqs) and reqs[i].arrival_s <= now:
                r = reqs[i]
                r.rid = router.submit(
                    list(r.prompt), r.max_new, slo_ms=r.slo_ms
                )
                i += 1
            if self.chaos is not None and router.alive:
                fault = self.chaos.draw(boundary)
                if fault is not None and fault[0] == "kill":
                    if self.kill_rank in router.alive and (
                        self.kill_rank not in killed_ranks
                    ):
                        killed_ranks.append(self.kill_rank)
                        self._kill_replica(self.kill_rank)
                elif fault is not None and fault[0] == "delay":
                    time.sleep(fault[1])
            # death detection: a replica that exited without a STOP
            for rank in sorted(router.alive):
                if self._replica_dead(rank):
                    alert = {
                        "ev": "alert", "kind": "dead_rank",
                        "rank": rank, "t": time.time(),
                        "detail": "replica loop exited",
                    }
                    if controller is not None:
                        controller.step([alert])
                    else:
                        router.mark_dead(rank)
            if publisher is not None:
                router.poll_weight_subs(publisher)
                if boundary in self.refresh_boundaries:
                    self.refresh_boundaries.discard(boundary)
                    if self.refresh_params_fn is not None:
                        self.source.bump(
                            self.refresh_params_fn(self.source.version + 1)
                        )
                    publisher.push_all(sorted(router.alive))
            # drain every queued reply, then wait briefly for the next
            while router.poll(timeout=0.0) is not None:
                pass
            boundary += 1
            if i >= len(reqs) and router.outstanding == 0:
                break
            if not router.alive and router.outstanding:
                break  # whole fleet dead — the audit names the losses
            if router.outstanding == 0:
                gap = reqs[i].arrival_s - (time.perf_counter() - t0)
                if gap > 0:
                    time.sleep(min(self.idle_sleep, gap))
            else:
                router.poll(timeout=self.poll_s)
        router.stop()
        self._join_replicas()
        router.close()
        return FleetReport(
            results=dict(router.results),
            submitted=i,
            shed=router.shed,
            redispatched=router.redispatched,
            killed_ranks=killed_ranks,
            spawned_ranks=sorted(
                (router.alive | router.dead) - set(initial)
            ),
            boundaries=boundary,
            wall_s=time.perf_counter() - t0,
            replica_summaries=list(self._summaries),
            controller_log=list(controller.log) if controller else [],
            weights_pushed=dict(publisher.pushed) if publisher else {},
            dead_ranks=sorted(router.dead),
        )
