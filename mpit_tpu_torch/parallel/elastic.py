"""Elastic membership for the parameter-server world.

A copy of ``mpit_tpu/parallel/elastic.py`` (numpy-free, host-only).

Tracks which client ranks a :class:`~mpit_tpu_torch.parallel.pserver.PServer`
is serving as clients JOIN, REJOIN, get REPLACED, LEAVE, die, and stop
— replacing the seed-era implicit model where a rank landing in
``dead_clients`` stayed dead forever. The membership view is epoch
bumped: every change increments ``view_epoch``, so journals and
snapshots can order membership transitions without wall clocks.

State machine per rank (driven by :meth:`register` / :meth:`leave` and
the server's watchdog/STOP handling, which mutate the ``dead`` /
``stopped`` sets this object owns):

    unknown ──JOIN──────────────► active          ("join")
    active  ──same-epoch JOIN───► active          ("rejoin": a preempted
                                                   client reconnected)
    active  ──new-epoch JOIN────► active          ("replace": a fresh
                                                   process took the rank;
                                                   dead/stopped cleared)
    active  ──LEAVE─────────────► left            (planned departure)
    active  ──watchdog timeout──► dead            (revivable: any later
                                                   message clears it)

The client's push-identity ``epoch`` (``PClient._epoch``, a random
64-bit value) doubles as the incarnation id here: a replacement process
on a reused rank has a new epoch, which is also what gives it a fresh
``(src, epoch)`` dedup slot on the server — membership and exactly-once
share one notion of identity.

Teardown: the serve loop runs until every *expected* rank is accounted
for (stopped, dead, or left) and at least ``min_quorum`` ranks are —
the same condition as the seed's ``len(stopped | dead) >= num_clients``
when membership never changes, but correct when ranks join or leave
mid-run.

Naming note: :mod:`mpit_tpu_torch.ops.elastic` is unrelated machinery —
the fused EASGD "elastic update" CUDA kernel (the algorithm's elastic
*force*, not elastic *membership*). This module is the membership
layer the ROADMAP's elastic item describes.
"""

from __future__ import annotations

from typing import Iterable, Optional


class ElasticMembership:
    """Mutable membership view for one PServer shard.

    The server aliases ``dead_clients`` / ``_stopped`` to the ``dead``
    and ``stopped`` sets owned here, so existing watchdog and STOP
    handling (and the tests and trainers that read those sets) keep
    working unchanged; :meth:`load_state` therefore mutates the sets in
    place and never rebinds them.
    """

    def __init__(self, num_clients: int, client_ranks: Optional[Iterable[int]] = None):
        # the quorum floor: how many clients the run was launched with;
        # a mid-run join can raise the bar via `expected`, never lower it
        self.min_quorum = num_clients
        self.expected: set[int] = set(client_ranks or ())
        self.dead: set[int] = set()
        self.stopped: set[int] = set()
        self.left: set[int] = set()
        self.epochs: dict[int, int] = {}
        self.view_epoch = 0

    def register(self, rank: int, epoch: int) -> str:
        """A JOIN envelope arrived from ``rank`` with push-identity
        ``epoch``; returns the transition kind: ``"join"`` (first
        contact), ``"rejoin"`` (same epoch — a preempted client
        reconnected), or ``"replace"`` (new epoch — a fresh process
        owns the rank now)."""
        prev = self.epochs.get(rank)
        if prev is None:
            kind = "join"
        elif prev == epoch:
            kind = "rejoin"
        else:
            kind = "replace"
        self.expected.add(rank)
        self.epochs[rank] = epoch
        # any register makes the rank active again: it owes a future
        # STOP (or LEAVE/watchdog expiry) before teardown can complete
        self.dead.discard(rank)
        self.left.discard(rank)
        self.stopped.discard(rank)
        self.view_epoch += 1
        return kind

    def leave(self, rank: int) -> None:
        """A LEAVE envelope: planned departure (preemption notice) —
        the rank stops counting toward teardown without waiting for
        the watchdog to declare it dead."""
        self.left.add(rank)
        self.view_epoch += 1

    def teardown_complete(self) -> bool:
        """Every expected rank accounted for, and at least the launch
        quorum of ranks overall — the serve loop's exit condition."""
        accounted = self.stopped | self.dead | self.left
        return (
            len(accounted) >= self.min_quorum
            and self.expected <= accounted
        )

    # -- snapshot round-trip (msgpack-friendly plain types) ---------------

    def state(self) -> dict:
        return {
            "min_quorum": self.min_quorum,
            "expected": sorted(self.expected),
            "dead": sorted(self.dead),
            "stopped": sorted(self.stopped),
            "left": sorted(self.left),
            "epochs": [[r, e] for r, e in sorted(self.epochs.items())],
            "view_epoch": self.view_epoch,
        }

    def load_state(self, state: dict) -> None:
        self.min_quorum = int(state.get("min_quorum", self.min_quorum))
        for name in ("expected", "dead", "stopped", "left"):
            target = getattr(self, name)
            target.clear()
            # msgpack ints, not device scalars: cold restore path
            target.update(int(r) for r in state.get(name, ()))  # mpit-analysis: ignore[MPT005]
        self.epochs.clear()
        self.epochs.update(
            {int(r): int(e) for r, e in state.get("epochs", ())}
        )
        self.view_epoch = int(state.get("view_epoch", 0))
