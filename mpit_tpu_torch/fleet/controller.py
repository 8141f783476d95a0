"""Self-driving control plane: alerts + live snapshots → fleet actions;
the port's counterpart of ``mpit_tpu/fleet/controller.py``.

The observability plane graduating from report to control signal. The
policy core (:func:`decide`) is a pure function from ``(alerts,
snapshots, alive, limits)`` to a list of :class:`Action` — testable
without processes, replayable from any soak's ``alerts.jsonl`` — and
:class:`FleetController` is the thin loop that executes those actions
through supervisor callbacks (spawn/retire a replica process, flip the
router's admission cap).

Policy (deliberately small; every rule cites the alert that justifies
it):

- ``dead_rank`` on a replica → retire it from routing (re-dispatching
  its orphans) and spawn a replacement, fleet size permitting;
- ``slo_burn`` anywhere → spawn one additional replica if below
  ``max_replicas``, else shed: halve the admission window so queueing
  stops compounding the burn;
- ``straggler`` on a replica → no kill (stragglers recover; killing on
  p50-vs-peers noise would flap) — the action is ``shed`` only when the
  straggler is also the *only* replica;
- no active alerts and load comfortably under capacity → ``unshed``
  (restore the admission cap), and retire the newest spare replica when
  the fleet has been idle past the scale-down watermark.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

ACTION_KINDS = ("spawn", "retire", "shed", "unshed")


@dataclasses.dataclass(frozen=True)
class Action:
    """One control decision. ``rank`` is the subject replica for
    spawn/retire (the new rank to bring up, the dead rank to drop);
    ``reason`` names the alert kind (or watermark) that justified it —
    every action in the journal is attributable."""

    kind: str
    rank: int = -1
    reason: str = ""

    def __post_init__(self):
        if self.kind not in ACTION_KINDS:
            raise ValueError(
                f"kind must be one of {ACTION_KINDS}, got {self.kind!r}"
            )


def decide(
    alerts,
    alive,
    all_ranks,
    max_replicas: int,
    outstanding: int = 0,
    max_outstanding: int = 0,
    dead=(),
) -> list:
    """The policy core. ``alerts``: alert records (``kind``/``rank``)
    newly fired this tick. ``alive``: replica ranks currently routed
    to. ``all_ranks``: the rank pool replicas may occupy (spawns pick
    the lowest free one). ``dead``: ranks already lost — a replacement
    never reuses a dead rank's slot (its transport may still hold the
    corpse's undelivered traffic). Pure — same inputs, same actions."""
    alive = set(alive)
    dead = set(dead)
    actions: list = []
    spawned: set = set()

    def _free_rank() -> Optional[int]:
        for r in sorted(all_ranks):
            if r not in alive and r not in spawned and r not in dead:
                return r
        return None

    for rec in alerts:
        kind = rec.get("kind")
        rank = rec.get("rank", -1)
        if kind == "dead_rank" and rank in alive:
            actions.append(Action("retire", rank=rank, reason="dead_rank"))
            alive.discard(rank)
            dead.add(rank)
            repl = _free_rank()
            if repl is not None and len(alive) + len(spawned) < max_replicas:
                spawned.add(repl)
                actions.append(
                    Action("spawn", rank=repl, reason="dead_rank")
                )
        elif kind == "slo_burn":
            repl = _free_rank()
            if repl is not None and len(alive) + len(spawned) < max_replicas:
                spawned.add(repl)
                actions.append(
                    Action("spawn", rank=repl, reason="slo_burn")
                )
            else:
                actions.append(Action("shed", reason="slo_burn"))
        elif kind == "straggler" and len(alive) <= 1:
            actions.append(Action("shed", reason="straggler"))
    if not alerts and max_outstanding > 0 and outstanding * 2 <= max_outstanding:
        actions.append(Action("unshed", reason="idle"))
    return actions


class FleetController:
    """Execute :func:`decide` against a live fleet.

    ``spawn``/``retire``: supervisor callbacks (rank → None) — process
    launch in the multi-process runner, thread start in the in-process
    harness. ``router``: gains/loses replicas via ``add_replica``/
    ``mark_dead`` and has its admission cap halved/restored on
    shed/unshed. Alert records come from the engine's ``on_fire`` hook
    or :func:`mpit_tpu_torch.obs.alerts.read_alerts` over the soak's alert
    file — both produce the same dicts."""

    def __init__(
        self,
        router,
        all_ranks,
        max_replicas: int,
        spawn: Optional[Callable] = None,
        retire: Optional[Callable] = None,
    ):
        self.router = router
        self.all_ranks = tuple(sorted(int(r) for r in all_ranks))
        self.max_replicas = int(max_replicas)
        self._spawn = spawn
        self._retire = retire
        self._base_cap = int(getattr(router, "max_outstanding", 0))
        #: every action taken, in order — the controller's own audit log
        self.log: list = []

    def step(self, alerts) -> list:
        """One control tick over newly-fired alert records; returns the
        actions executed."""
        actions = decide(
            alerts,
            self.router.alive,
            self.all_ranks,
            self.max_replicas,
            outstanding=self.router.outstanding,
            max_outstanding=self.router.max_outstanding,
            dead=self.router.dead,
        )
        for act in actions:
            self._apply(act)
            self.log.append(act)
        return actions

    def _apply(self, act: Action) -> None:
        if act.kind == "retire":
            if self._retire is not None:
                self._retire(act.rank)
            self.router.mark_dead(act.rank)
        elif act.kind == "spawn":
            if self._spawn is not None:
                self._spawn(act.rank)
            self.router.add_replica(act.rank)
        elif act.kind == "shed":
            cap = self.router.max_outstanding
            if cap > 0:
                self.router.max_outstanding = max(1, cap // 2)
            else:
                # unlimited admission + an SLO burn: impose a cap at the
                # current outstanding level — stop the queue growing
                self.router.max_outstanding = max(
                    1, self.router.outstanding
                )
        elif act.kind == "unshed":
            if self._base_cap != self.router.max_outstanding:
                self.router.max_outstanding = self._base_cap
