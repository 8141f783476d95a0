"""Explicit-state model checker for the PS fetch/push protocol.

The linter's MPT008 pairs tags; this module goes further and *verifies*
the protocol semantics that :func:`mpit_tpu_torch.analysis.protocol
.extract_semantics` lifts out of the marked modules (attempt-id echo +
check, reply-wait timeout, the dedup window's exact boundary) by
exhaustively exploring every message interleaving of a small
configuration under the chaos fault vocabulary:

- ``drop``       — the message is never delivered;
- ``dup``        — delivered twice, the second copy out of order;
- ``reorder``    — delivered, but possibly out of stream order;
- ``stale``      — a reply delayed past the requester's timeout (it can
                   still arrive later, racing the retry's fresh reply).

At most ONE fault is injected per run, but the *choice* of fault is part
of the state space: at every send the checker branches into the clean
send plus every applicable (kind, message) fault, so a single
breadth-bounded exploration covers the fault-free baseline and every
single-fault schedule at once, with all shared prefixes/suffixes
deduplicated through the visited set. STOP messages are never faulted —
teardown loss is the watchdog's jurisdiction (docs/ROBUSTNESS.md), not
the exchange protocol's.

Verified safety properties (reported as lint rules by
``rules/model_check.py``):

- **MPT009** exactly-once push application: no ``(client, seq)`` push is
  ever applied twice by one server (the dedup window's contract);
- **MPT010** deadlock freedom: no reachable state where nobody can move
  yet the run isn't finished (every blocking recv has an escape);
- **MPT011** stale-attempt isolation: a reply generated for attempt *i*
  is never accepted by a client whose live attempt is *j* ≠ *i* (the
  mis-assembled-fetch bug the attempt-id echo exists to prevent).

The model is deliberately small and immutable: states are nested tuples,
transitions are pure functions, and the whole exploration is a stack +
visited-set loop. Client steps and the server's handle-and-reply are
atomic (matching the implementation: both run under one dispatch
iteration), messages are FIFO per ``(kind, src, dst)`` stream except
where a fault marked them reorderable, and a client's timeout transition
is enabled exactly when no in-flight message could still satisfy its
wait (or the only candidate reply is stale-delayed) — the model's
version of "the timer really would fire first".
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# message kinds (single chars: states hash millions of times)
K_REQ, K_REP, K_PUSH, K_STOP = "Q", "P", "U", "S"
# message flag bits
RE = 1  # reorderable: may be delivered ahead of/behind its stream
STALE = 2  # a reply delayed past the requester's timeout

FAULT_KINDS = ("drop", "dup", "reorder", "stale")

_KIND_LABEL = {K_REQ: "REQ", K_REP: "REPLY", K_PUSH: "PUSH", K_STOP: "STOP"}


@dataclasses.dataclass(frozen=True)
class DedupModel:
    """The admit predicate's modeled bits (window size comes from the
    config — exploring a 1024-wide window would need 1025 rounds to
    exercise the boundary, so the model shrinks it instead)."""

    rejects_at_boundary: bool
    checks_seen: bool
    prunes_seen: bool


@dataclasses.dataclass(frozen=True)
class ModelSemantics:
    """What the checked protocol does about faults (see
    ``protocol.ProtocolSemantics``; this is its model-facing projection,
    constructible directly in tests)."""

    attempt_echoed: bool
    attempt_checked: bool
    reply_recv_timeout: bool
    has_push: bool
    dedup: Optional[DedupModel]
    dedup_opaque: bool = False  # dedup exists but unmodelable: assume ok
    #: the window is keyed per client incarnation (the ``(src, epoch)``
    #: idiom) — a replacement client gets a fresh dedup slot
    dedup_keyed_by_epoch: bool = False
    #: the server's shard snapshot persists the dedup window WITH the
    #: center/applied state (True), without it (False — the
    #: crash-consistency bug the elastic config exists to catch), or
    #: there is no snapshot machinery at all (None — restart schedules
    #: still run, modeling restart-from-nothing)
    snapshot_includes_dedup: Optional[bool] = None
    #: a shard HANDOFF ships the dedup entries along with the shard data
    #: (True), ships the data but forgets the window (False — the
    #: exactly-once-across-handoff bug the sharded config exists to
    #: catch), or the protocol has no handoff machinery at all (None —
    #: the sharded configuration is skipped)
    handoff_carries_dedup: Optional[bool] = None


def from_protocol(sem) -> ModelSemantics:
    """ModelSemantics from a ``protocol.ProtocolSemantics``."""
    dedup = None
    keyed = False
    if sem.dedup is not None:
        dedup = DedupModel(
            rejects_at_boundary=sem.dedup.rejects_at_boundary,
            checks_seen=sem.dedup.checks_seen,
            prunes_seen=sem.dedup.prunes_seen,
        )
        keyed = sem.dedup.keyed_by_epoch
    return ModelSemantics(
        attempt_echoed=sem.attempt_echoed,
        attempt_checked=sem.attempt_checked,
        reply_recv_timeout=sem.reply_recv_timeout,
        has_push=bool(sem.push_tags),
        dedup=dedup,
        dedup_opaque=sem.dedup_opaque,
        dedup_keyed_by_epoch=keyed,
        snapshot_includes_dedup=sem.snapshot_includes_dedup,
        handoff_carries_dedup=getattr(sem, "handoff_includes_dedup", None),
    )


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One exploration's bounds. The defaults are the acceptance
    configuration: 2 clients x 1 server, 2 rounds, dedup window 1 (the
    smallest window with a boundary), 1 retry."""

    algo: str = "easgd"
    script: tuple = ("fetch", "push")  # one round's client steps
    clients: int = 2
    servers: int = 1
    rounds: int = 2
    window: int = 1
    max_retries: int = 1
    kinds: tuple = FAULT_KINDS
    max_states: int = 500_000
    #: elastic membership mode: clients carry an incarnation counter and
    #: may be REPLACED mid-run (preemption + respawn from step 0, fresh
    #: epoch), servers may snapshot and CRASH-RESTORE — a second,
    #: independent single-fault budget on top of the network one
    elastic: bool = False
    #: sharded-ownership mode (implies the elastic crash machinery):
    #: parameters live in ``shards`` ring-placed shards whose ownership
    #: can move between servers mid-run via a HANDOFF transition (its
    #: own one-shot budget, independent of both fault budgets); pushes
    #: are routed to the shard's CURRENT owner at delivery — the model's
    #: version of the client-side reshard repair
    sharded: bool = False
    shards: int = 2
    #: spend the network-fault budget on PUSH messages only (REQ/REP
    #: fault coverage is the base configs' jurisdiction) — the sharded
    #: config uses this to keep handoff x crash x fault exhaustive
    fault_push_only: bool = False

    @property
    def label(self) -> str:
        return (
            f"{self.algo}, {self.clients} client(s) x "
            f"{self.servers} server(s), {self.rounds} round(s)"
        )


def default_configs(has_push: bool, quick: bool = False) -> tuple:
    """The two shipped-protocol configurations: EASGD (fetch -> push)
    and Downpour (push -> fetch). A push-less protocol gets a single
    fetch-only config (the scripts would coincide).

    ``quick=True`` drops to 1 client (~300-400 states each vs ~12-20k):
    the single-fault hazards these configs witness — the dedup boundary
    re-admit, the stale reply, the block-forever recv — are all
    per-client-per-server, so one client keeps every seeded-mutation
    witness (verified per fixture in tests/test_analysis.py) while the
    pre-commit scan stays cheap; test_mcheck.py runs the 2-client
    acceptance pair."""
    clients = 1 if quick else 2
    if not has_push:
        return (
            ModelConfig(algo="fetch-only", script=("fetch",),
                        clients=clients),
        )
    return (
        ModelConfig(algo="easgd", script=("fetch", "push"),
                    clients=clients),
        ModelConfig(algo="downpour", script=("push", "fetch"),
                    clients=clients),
    )


def elastic_config() -> ModelConfig:
    """The membership-churn configuration: 1 client whose process can be
    replaced mid-run + 1 server that can snapshot and crash-restore.
    One client is enough — the elastic hazards (a replacement's re-used
    seqs vs the predecessor's window; a restored server's dedup vs its
    restored applied set) are per-client-per-server, and the second
    fault budget already multiplies the interleavings."""
    return ModelConfig(
        algo="easgd-elastic",
        script=("fetch", "push"),
        clients=1,
        servers=1,
        rounds=2,
        elastic=True,
    )


def sharded_config(quick: bool = False) -> ModelConfig:
    """The shard-ownership configuration: 2 clients x 2 servers, 2 ring
    shards (initially one per server), with a one-shot HANDOFF budget on
    top of the network-fault and crash-restore budgets. Two servers are
    the minimum with somewhere for a shard to move; two clients make the
    handed-off dedup state multi-sourced. Client REPLACE is disabled
    here (the elastic config already owns that hazard) to keep the
    handoff x crash x fault product exhaustive within budget.

    ``quick=True`` is the lint-tier variant (1 client, ~1k states vs
    ~100k): every handoff hazard that is per-client-per-server — the
    dedup window forgotten in transit, the replayed push after the
    move — still has a witness, so the pre-commit scan stays inside its
    wall-clock budget while test_mcheck.py owns the full 2-client
    exhaustive acceptance run."""
    return ModelConfig(
        algo="easgd-sharded",
        script=("fetch", "push"),
        clients=1 if quick else 2,
        servers=2,
        rounds=1,
        kinds=("drop", "dup"),
        elastic=True,
        sharded=True,
        shards=2,
        fault_push_only=True,
    )


@dataclasses.dataclass
class CheckResult:
    config: ModelConfig
    states: int  # distinct states explored
    fault_points: int  # distinct (kind, message) single-fault schedules
    violations: dict  # rule id -> witness message
    truncated: bool  # hit max_states (result then inconclusive)

    @property
    def ok(self) -> bool:
        return not self.violations and not self.truncated


# -- transitions ------------------------------------------------------------
#
# state  = (clients, servers, net, fault_available)
# client = (stage, waiting, attempt, retries, pending_servers)
#          stage 0..n_stages-1 = script step; n_stages = send STOP;
#          n_stages+1 = done
# server = (stops, applied, dedup) with dedup = ((high, seen), ...) per
#          client; applied = frozenset of (client, seq)
# msg    = (kind, src, dst, a, b, flags)
#          REQ: a=attempt          REP: a=true_attempt, b=echo (-1 none)
#          PUSH: a=seq             STOP: —
#
# elastic mode (cfg.elastic) extends every shape by one slot:
# state  = (clients, servers, net, fault_available, elastic_available)
# client = (stage, waiting, attempt, retries, pending, inc) — inc is the
#          incarnation (the model's epoch); a REPLACE resets the client
#          to stage 0 with inc+1 (a respawned process re-runs from step
#          0) while attempt ids keep counting up (the implementation
#          seeds them from the fresh epoch, so a replacement's ids are
#          disjoint from its predecessor's by construction)
# server = (stops, applied, dedup, snap) — applied keyed (c, inc, seq);
#          dedup[c] is a TUPLE of per-inc windows when the extracted
#          window is epoch-keyed, else a 1-tuple shared window; snap is
#          None until the server takes its (applied, dedup-or-None)
#          shard snapshot, after which CRASH restores from it (stops
#          survive a crash: the membership view is in the snapshot)
# PUSH   = (K_PUSH, c, s, seq, inc, flags) — the b slot carries inc


def _canon(net) -> tuple:
    """Canonical network order. Delivery semantics only constrain the
    relative order WITHIN a non-reorderable (kind, src, dst) stream;
    interleavings across streams (and among reorderable messages) are
    equivalent, so states are stored with streams sorted by key and the
    reorderable pool sorted — collapsing k! permutations of k independent
    sends into one state."""
    if len(net) <= 1:
        return net
    streams: dict = {}
    loose = []
    for m in net:
        if m[5] & RE:
            loose.append(m)
        else:
            streams.setdefault((m[0], m[1], m[2]), []).append(m)
    out = []
    for key in sorted(streams):
        out.extend(streams[key])
    out.extend(sorted(loose))
    return tuple(out)


def _deliverable(net) -> list:
    """Indices deliverable now: the head non-reorderable message of each
    (kind, src, dst) stream, plus every reorderable message."""
    out = []
    seen_head = set()
    for i, m in enumerate(net):
        if m[5] & RE:
            out.append(i)
            continue
        key = (m[0], m[1], m[2])
        if key not in seen_head:
            out.append(i)
            seen_head.add(key)
    return out


def _variants(msgs, avail, kinds, points) -> list:
    """Fault branching for one atomic multi-send: the clean send, plus —
    when the single-fault budget is unspent — each applicable fault on
    each message. Returns [(messages_to_enqueue, fault_still_available)].
    """
    base = tuple(msgs)
    out = [(base, avail)]
    if not avail:
        return out
    for i, m in enumerate(msgs):
        if m[0] == K_STOP:
            continue  # teardown is never faulted (see module docstring)
        for kind in kinds:
            if kind == "drop":
                repl = ()
            elif kind == "dup":
                repl = (m, m[:5] + (m[5] | RE,))
            elif kind == "reorder":
                repl = (m[:5] + (m[5] | RE,),)
            elif kind == "stale" and m[0] == K_REP:
                repl = (m[:5] + (m[5] | RE | STALE,),)
            else:
                continue
            points.add((kind, m[:5]))
            out.append((base[:i] + repl + base[i + 1:], False))
    return out


def _set(tup, i, v):
    return tup[:i] + (v,) + tup[i + 1:]


def _apply_push(servers, s, c, seq, sem, cfg, viol):
    """One server consuming one push: run the modeled admit predicate,
    then the exactly-once assertion on the applied set."""
    stops, applied, dedup = servers[s]
    ds = dedup
    if sem.dedup is not None:
        high, seen = dedup[c]
        bound = high - cfg.window
        if sem.dedup.rejects_at_boundary:
            reject = seq <= bound
        else:
            reject = seq < bound
        if not reject and sem.dedup.checks_seen and seq in seen:
            reject = True
        admitted = not reject
        if admitted:
            seen2 = seen | {seq}
            if seq > high:
                if sem.dedup.prunes_seen and len(seen2) > cfg.window:
                    floor = seq - cfg.window
                    seen2 = frozenset(x for x in seen2 if x > floor)
                ds = _set(dedup, c, (seq, frozenset(seen2)))
            else:
                ds = _set(dedup, c, (high, frozenset(seen2)))
    elif sem.dedup_opaque:
        # unmodelable dedup machinery: assume it deduplicates correctly
        # (resolve-or-skip — never report what we couldn't model)
        admitted = (c, seq) not in applied
    else:
        admitted = True  # no dedup at all: every delivery applies
    if admitted:
        if (c, seq) in applied:
            viol.setdefault(
                "MPT009",
                f"[{cfg.label}] push (client {c}, seq {seq}) applied "
                "TWICE by one server: a duplicated/reordered copy passed "
                "the dedup admit after the window slid past it",
            )
        applied = applied | {(c, seq)}
    return _set(servers, s, (stops, applied, ds))


def _fresh_dedup(cfg) -> tuple:
    """Elastic-mode zero dedup state: one empty window per client (the
    keyed variant grows extra per-incarnation windows lazily)."""
    return tuple(((0, frozenset()),) for _ in range(cfg.clients))


def _apply_push_elastic(servers, s, c, seq, inc, sem, cfg, viol):
    """Elastic-mode push application: the window is selected per
    incarnation when the extracted dedup is epoch-keyed (a replacement
    gets a fresh slot), shared otherwise — where a replacement's
    re-used seqs collide with its predecessor's seen-set, the
    wrongful-rejection half of MPT009."""
    stops, applied, dedup, snap = servers[s]
    key = (c, inc, seq)
    keyed = sem.dedup_keyed_by_epoch
    ds = dedup
    if sem.dedup is not None:
        windows = dedup[c]
        idx = inc if keyed else 0
        while len(windows) <= idx:
            windows = windows + ((0, frozenset()),)
        high, seen = windows[idx]
        bound = high - cfg.window
        if sem.dedup.rejects_at_boundary:
            reject = seq <= bound
        else:
            reject = seq < bound
        if not reject and sem.dedup.checks_seen and seq in seen:
            reject = True
        admitted = not reject
        if admitted:
            seen2 = seen | {seq}
            if seq > high:
                if sem.dedup.prunes_seen and len(seen2) > cfg.window:
                    floor = seq - cfg.window
                    seen2 = frozenset(x for x in seen2 if x > floor)
                windows = _set(windows, idx, (seq, frozenset(seen2)))
            else:
                windows = _set(windows, idx, (high, frozenset(seen2)))
        ds = _set(dedup, c, windows)
    elif sem.dedup_opaque:
        admitted = key not in applied
    else:
        admitted = True
    if admitted:
        if key in applied:
            viol.setdefault(
                "MPT009",
                f"[{cfg.label}] push (client {c}, incarnation {inc}, "
                f"seq {seq}) applied TWICE by one server: a redelivered "
                "copy passed the dedup admit after a crash-restore lost "
                "the window state that had recorded it",
            )
        applied = applied | {key}
    elif (
        sem.dedup is not None
        and not keyed
        and key not in applied
        and any(t[0] == c and t[2] == seq and t[1] != inc for t in applied)
    ):
        # the window is NOT keyed by incarnation: this fresh push was
        # swallowed because a PREVIOUS incarnation of the client used
        # the same seq — a replacement silently loses its first pushes
        viol.setdefault(
            "MPT009",
            f"[{cfg.label}] push (client {c}, incarnation {inc}, seq "
            f"{seq}) wrongfully REJECTED: the dedup window is not keyed "
            "by client epoch, so the replacement process's push was "
            "mistaken for its predecessor's replay and dropped",
        )
    return _set(servers, s, (stops, applied, ds, snap))


def _starved(net, c, att, pending, sem) -> bool:
    """Would the client's reply wait really time out? True when some
    pending server has neither a live same-attempt REQ in flight nor a
    reply that this client would take; stale-delayed replies don't count
    (being delayed past the timeout is their definition)."""
    distinguishes = sem.attempt_echoed and sem.attempt_checked
    satisfied = set()
    for m in net:
        if m[0] == K_REQ and m[1] == c and m[3] == att:
            satisfied.add(m[2])
        elif m[0] == K_REP and m[2] == c and not (m[5] & STALE):
            if not distinguishes or m[4] == att:
                satisfied.add(m[1])
    return any(s not in satisfied for s in pending)


def _successors(state, sem, cfg, viol, points) -> list:
    clients, servers, net, avail = state
    out = []
    deliv = _deliverable(net)
    steps = len(cfg.script)
    n_stages = cfg.rounds * steps
    all_clients = frozenset(range(cfg.clients))

    # -- server deliveries (handle + reply are one atomic step)
    for i in deliv:
        m = net[i]
        kind = m[0]
        if kind == K_REP:
            continue
        s = m[2]
        stops = servers[s][0]
        if stops == all_clients:
            continue  # server exited its loop; late messages park
        rest = net[:i] + net[i + 1:]
        if kind == K_REQ:
            c, att = m[1], m[3]
            echo = att if sem.attempt_echoed else -1
            rep = (K_REP, s, c, att, echo, 0)
            for added, av2 in _variants([rep], avail, cfg.kinds, points):
                out.append((clients, servers, rest + added, av2))
        elif kind == K_PUSH:
            srv2 = _apply_push(servers, s, m[1], m[3], sem, cfg, viol)
            out.append((clients, srv2, rest, avail))
        else:  # STOP
            srv2 = _set(
                servers, s, (stops | {m[1]}, servers[s][1], servers[s][2])
            )
            out.append((clients, srv2, rest, avail))

    # -- client moves
    for c, cl in enumerate(clients):
        stage, waiting, att, retries, pending = cl
        if stage > n_stages:
            continue  # done
        if waiting:
            for i in deliv:
                m = net[i]
                if m[0] != K_REP or m[2] != c:
                    continue
                rest = net[:i] + net[i + 1:]
                true_att, s = m[3], m[1]
                if true_att != att:
                    if sem.attempt_echoed and sem.attempt_checked:
                        # stale reply detected and dropped (consumed)
                        out.append((clients, servers, rest, avail))
                        continue
                    viol.setdefault(
                        "MPT011",
                        f"[{cfg.label}] client {c} assembled a reply "
                        f"generated for attempt {true_att} into its live "
                        f"attempt {att} — "
                        + (
                            "the echoed attempt id is never compared "
                            "to the live one"
                            if sem.attempt_echoed
                            else "replies carry no attempt id, so stale "
                            "ones are indistinguishable from fresh"
                        ),
                    )
                pend2 = pending - {s}
                if pend2:
                    cl2 = (stage, True, att, retries, pend2)
                else:
                    cl2 = (stage + 1, False, att, 0, frozenset())
                out.append((_set(clients, c, cl2), servers, rest, avail))
            if sem.reply_recv_timeout and _starved(
                net, c, att, pending, sem
            ):
                if retries < cfg.max_retries:
                    att2 = att + 1
                    reqs = [
                        (K_REQ, c, s, att2, 0, 0) for s in sorted(pending)
                    ]
                    cl2 = (stage, True, att2, retries + 1, pending)
                    for added, av2 in _variants(
                        reqs, avail, cfg.kinds, points
                    ):
                        out.append(
                            (_set(clients, c, cl2), servers, net + added,
                             av2)
                        )
                else:
                    # retries exhausted: skip the round (the ps_roles
                    # graceful-degradation path), resume next round
                    stage2 = (stage // steps + 1) * steps
                    cl2 = (stage2, False, att, 0, frozenset())
                    out.append(
                        (_set(clients, c, cl2), servers, net, avail)
                    )
            continue
        if stage == n_stages:
            msgs = tuple(
                (K_STOP, c, s, 0, 0, 0) for s in range(cfg.servers)
            )
            cl2 = (stage + 1, False, att, 0, frozenset())
            out.append((_set(clients, c, cl2), servers, net + msgs, avail))
        elif cfg.script[stage % steps] == "fetch":
            att2 = att + 1
            reqs = [(K_REQ, c, s, att2, 0, 0) for s in range(cfg.servers)]
            cl2 = (
                stage, True, att2, 0, frozenset(range(cfg.servers))
            )
            for added, av2 in _variants(reqs, avail, cfg.kinds, points):
                out.append((_set(clients, c, cl2), servers, net + added,
                            av2))
        else:  # push
            seq = stage // steps + 1
            msgs = [(K_PUSH, c, s, seq, 0, 0) for s in range(cfg.servers)]
            cl2 = (stage + 1, False, att, 0, frozenset())
            for added, av2 in _variants(msgs, avail, cfg.kinds, points):
                out.append((_set(clients, c, cl2), servers, net + added,
                            av2))
    return out


def _successors_elastic(state, sem, cfg, viol, points) -> list:
    """Elastic-mode successor relation: the base protocol moves (with
    incarnation-aware pushes) plus three membership transitions —
    server SNAPSHOT (persist applied+window, once), server CRASH-RESTORE
    (roll back to the snapshot, or to nothing; spends the elastic fault
    budget), and client REPLACE (preempt + respawn from step 0 with a
    fresh incarnation; spends the same budget)."""
    clients, servers, net, avail, eavail = state
    out = []
    deliv = _deliverable(net)
    steps = len(cfg.script)
    n_stages = cfg.rounds * steps
    all_clients = frozenset(range(cfg.clients))

    # -- server deliveries (handle + reply are one atomic step)
    for i in deliv:
        m = net[i]
        kind = m[0]
        if kind == K_REP:
            continue
        s = m[2]
        stops = servers[s][0]
        if stops == all_clients:
            continue  # server exited its loop; late messages park
        rest = net[:i] + net[i + 1:]
        if kind == K_REQ:
            c, att = m[1], m[3]
            echo = att if sem.attempt_echoed else -1
            rep = (K_REP, s, c, att, echo, 0)
            for added, av2 in _variants([rep], avail, cfg.kinds, points):
                out.append((clients, servers, rest + added, av2, eavail))
        elif kind == K_PUSH:
            srv2 = _apply_push_elastic(
                servers, s, m[1], m[3], m[4], sem, cfg, viol
            )
            out.append((clients, srv2, rest, avail, eavail))
        else:  # STOP
            srv2 = _set(
                servers, s, (stops | {m[1]},) + servers[s][1:]
            )
            out.append((clients, srv2, rest, avail, eavail))

    # -- membership transitions
    for s, sv in enumerate(servers):
        stops, applied, dedup, snap = sv
        if stops == all_clients:
            continue  # server done — nothing left to snapshot or lose
        if snap is None and sem.snapshot_includes_dedup is not None:
            # take THE shard snapshot (once per run keeps the state
            # space tight; one snapshot point is enough to exhibit any
            # snapshot-consistency bug)
            snap2 = (
                applied,
                dedup if sem.snapshot_includes_dedup else None,
            )
            out.append((
                clients, _set(servers, s, (stops, applied, dedup, snap2)),
                net, avail, eavail,
            ))
        if eavail:
            # crash + restore: everything since the snapshot (or since
            # boot) rolls back TOGETHER — applied-and-unpersisted pushes
            # disappear from `applied` because the center they mutated
            # rolled back with them, so their redelivery re-applying is
            # correct, not a double-apply. The membership view (stops)
            # is in the snapshot, so it survives.
            if snap is not None:
                r_applied, r_dedup = snap
                if r_dedup is None:
                    r_dedup = _fresh_dedup(cfg)
            else:
                r_applied, r_dedup = frozenset(), _fresh_dedup(cfg)
            out.append((
                clients,
                _set(servers, s, (stops, r_applied, r_dedup, snap)),
                net, avail, False,
            ))
    if eavail:
        for c, cl in enumerate(clients):
            if cl[0] > n_stages:
                continue  # already done — nothing left to preempt
            # REPLACE: the process is killed and respawned — it re-runs
            # from step 0 (seq numbering restarts) under a fresh
            # incarnation; attempt ids keep counting (epoch-seeded
            # disjointness in the implementation)
            cl2 = (0, False, cl[2], 0, frozenset(), cl[5] + 1)
            out.append(
                (_set(clients, c, cl2), servers, net, avail, False)
            )

    # -- client moves
    for c, cl in enumerate(clients):
        stage, waiting, att, retries, pending, inc = cl
        if stage > n_stages:
            continue  # done
        if waiting:
            for i in deliv:
                m = net[i]
                if m[0] != K_REP or m[2] != c:
                    continue
                rest = net[:i] + net[i + 1:]
                true_att, s = m[3], m[1]
                if true_att != att:
                    if sem.attempt_echoed and sem.attempt_checked:
                        # stale reply detected and dropped (consumed)
                        out.append(
                            (clients, servers, rest, avail, eavail)
                        )
                        continue
                    viol.setdefault(
                        "MPT011",
                        f"[{cfg.label}] client {c} assembled a reply "
                        f"generated for attempt {true_att} into its live "
                        f"attempt {att} — "
                        + (
                            "the echoed attempt id is never compared "
                            "to the live one"
                            if sem.attempt_echoed
                            else "replies carry no attempt id, so stale "
                            "ones are indistinguishable from fresh"
                        ),
                    )
                pend2 = pending - {s}
                if pend2:
                    cl2 = (stage, True, att, retries, pend2, inc)
                else:
                    cl2 = (stage + 1, False, att, 0, frozenset(), inc)
                out.append(
                    (_set(clients, c, cl2), servers, rest, avail, eavail)
                )
            if sem.reply_recv_timeout and _starved(
                net, c, att, pending, sem
            ):
                if retries < cfg.max_retries:
                    att2 = att + 1
                    reqs = [
                        (K_REQ, c, s, att2, 0, 0) for s in sorted(pending)
                    ]
                    cl2 = (stage, True, att2, retries + 1, pending, inc)
                    for added, av2 in _variants(
                        reqs, avail, cfg.kinds, points
                    ):
                        out.append((
                            _set(clients, c, cl2), servers, net + added,
                            av2, eavail,
                        ))
                else:
                    # retries exhausted: skip the round (the ps_roles
                    # graceful-degradation path), resume next round
                    stage2 = (stage // steps + 1) * steps
                    cl2 = (stage2, False, att, 0, frozenset(), inc)
                    out.append(
                        (_set(clients, c, cl2), servers, net, avail,
                         eavail)
                    )
            continue
        if stage == n_stages:
            msgs = tuple(
                (K_STOP, c, s, 0, 0, 0) for s in range(cfg.servers)
            )
            cl2 = (stage + 1, False, att, 0, frozenset(), inc)
            out.append(
                (_set(clients, c, cl2), servers, net + msgs, avail,
                 eavail)
            )
        elif cfg.script[stage % steps] == "fetch":
            att2 = att + 1
            reqs = [(K_REQ, c, s, att2, 0, 0) for s in range(cfg.servers)]
            cl2 = (
                stage, True, att2, 0, frozenset(range(cfg.servers)), inc
            )
            for added, av2 in _variants(reqs, avail, cfg.kinds, points):
                out.append((
                    _set(clients, c, cl2), servers, net + added, av2,
                    eavail,
                ))
        else:  # push
            seq = stage // steps + 1
            msgs = [
                (K_PUSH, c, s, seq, inc, 0) for s in range(cfg.servers)
            ]
            cl2 = (stage + 1, False, att, 0, frozenset(), inc)
            for added, av2 in _variants(msgs, avail, cfg.kinds, points):
                out.append((
                    _set(clients, c, cl2), servers, net + added, av2,
                    eavail,
                ))
    return out


# sharded mode (cfg.sharded) reshapes the elastic state:
# state  = (clients, servers, net, fault_avail, crash_avail,
#           handoff_avail, owners)
#          owners[h] = server index currently owning shard h; HANDOFF
#          moves one shard to another server (own one-shot budget)
# server = (stops, applied, dedup) — applied keyed (c, inc, shard,
#          seq); dedup is a sorted tuple-map of ((c, inc, shard) ->
#          (high, seen)) windows, created lazily — per-shard windows
#          travel with the shard on handoff (or are forgotten, the
#          seeded handoff_carries_dedup=False bug). CRASH restores from
#          NOTHING: snapshot-at-any-point timing multiplies the state
#          space ~8x and its consistency hazard is already exhausted by
#          elastic_config, so this config keeps only the restart — the
#          shard data (and thus `applied`) rolls back with the center,
#          which is exactly the real restore's semantics for shards the
#          snapshot predates
# PUSH   = (K_PUSH, c, dst, seq, (inc, shard), flags) — one per shard,
#          addressed to the owner AT SEND time but applied by the owner
#          AT DELIVERY time (the client-side reshard repair re-routes
#          in-flight traffic; dst only keys the FIFO stream)
# client REPLACE is disabled here (elastic_config owns that hazard)


def _dmap_get(dmap, key):
    for k, v in dmap:
        if k == key:
            return v
    return (0, frozenset())


def _dmap_set(dmap, key, val) -> tuple:
    out = [kv for kv in dmap if kv[0] != key]
    out.append((key, val))
    out.sort(key=lambda kv: kv[0])
    return tuple(out)


def _apply_push_sharded(servers, s, c, seq, inc, h, sem, cfg, viol):
    """Sharded push application at shard ``h``'s current owner ``s``:
    the admit window is selected per (client, incarnation, shard) — the
    model twin of the implementation's one-admit-per-envelope dedup
    surviving shard collapse — and the exactly-once assertion keys the
    applied set the same way."""
    stops, applied, dedup = servers[s]
    keyed = sem.dedup_keyed_by_epoch
    widx = inc if keyed else 0
    akey = (c, inc, h, seq)
    ds = dedup
    if sem.dedup is not None:
        high, seen = _dmap_get(dedup, (c, widx, h))
        bound = high - cfg.window
        if sem.dedup.rejects_at_boundary:
            reject = seq <= bound
        else:
            reject = seq < bound
        if not reject and sem.dedup.checks_seen and seq in seen:
            reject = True
        admitted = not reject
        if admitted:
            seen2 = seen | {seq}
            if seq > high:
                if sem.dedup.prunes_seen and len(seen2) > cfg.window:
                    floor = seq - cfg.window
                    seen2 = frozenset(x for x in seen2 if x > floor)
                ds = _dmap_set(dedup, (c, widx, h), (seq, frozenset(seen2)))
            else:
                ds = _dmap_set(dedup, (c, widx, h), (high, frozenset(seen2)))
    elif sem.dedup_opaque:
        admitted = akey not in applied
    else:
        admitted = True
    if admitted:
        if akey in applied:
            viol.setdefault(
                "MPT009",
                f"[{cfg.label}] push (client {c}, shard {h}, seq {seq}) "
                "applied TWICE: a redelivered copy passed the dedup admit "
                "at the shard's new owner because the handoff shipped the "
                "shard data without its dedup window",
            )
        applied = applied | {akey}
    elif (
        sem.dedup is not None
        and not keyed
        and akey not in applied
        and any(
            t[0] == c and t[2] == h and t[3] == seq and t[1] != inc
            for t in applied
        )
    ):
        viol.setdefault(
            "MPT009",
            f"[{cfg.label}] push (client {c}, incarnation {inc}, shard "
            f"{h}, seq {seq}) wrongfully REJECTED: the dedup window is "
            "not keyed by client epoch, so the replacement's push was "
            "mistaken for its predecessor's replay and dropped",
        )
    return _set(servers, s, (stops, applied, ds))


def _successors_sharded(state, sem, cfg, viol, points) -> list:
    """Sharded-mode successor relation: the elastic protocol moves (with
    delivery-time push re-routing to the shard's current owner) plus the
    HANDOFF transition — one shard's ownership moves to another server,
    carrying its applied entries (the shard data embodies them) and,
    per the extracted ``handoff_carries_dedup``, its dedup windows."""
    clients, servers, net, avail, eavail, havail, owners = state
    out = []
    deliv = _deliverable(net)
    steps = len(cfg.script)
    n_stages = cfg.rounds * steps
    all_clients = frozenset(range(cfg.clients))

    def _send_variants(msgs, av):
        if cfg.fault_push_only and not any(m[0] == K_PUSH for m in msgs):
            return [(tuple(msgs), av)]
        return _variants(msgs, av, cfg.kinds, points)

    # -- server deliveries (handle + reply are one atomic step)
    for i in deliv:
        m = net[i]
        kind = m[0]
        if kind == K_REP:
            continue
        rest = net[:i] + net[i + 1:]
        if kind == K_PUSH:
            inc, h = m[4]
            tgt = owners[h]  # re-routed to the CURRENT owner
            if servers[tgt][0] == all_clients:
                continue  # owner exited its loop; late pushes park
            srv2 = _apply_push_sharded(
                servers, tgt, m[1], m[3], inc, h, sem, cfg, viol
            )
            out.append(
                (clients, srv2, rest, avail, eavail, havail, owners)
            )
            continue
        s = m[2]
        stops = servers[s][0]
        if stops == all_clients:
            continue  # server exited its loop; late messages park
        if kind == K_REQ:
            c, att = m[1], m[3]
            echo = att if sem.attempt_echoed else -1
            rep = (K_REP, s, c, att, echo, 0)
            for added, av2 in _send_variants([rep], avail):
                out.append(
                    (clients, servers, rest + added, av2, eavail,
                     havail, owners)
                )
        else:  # STOP
            srv2 = _set(servers, s, (stops | {m[1]},) + servers[s][1:])
            out.append(
                (clients, srv2, rest, avail, eavail, havail, owners)
            )

    # -- handoff: one shard's ownership moves to another live server
    if havail:
        for h, owner in enumerate(owners):
            o_stops, o_applied, o_dedup = servers[owner]
            if o_stops == all_clients:
                continue  # old owner already exited — nothing to hand off
            for s2 in range(cfg.servers):
                if s2 == owner or servers[s2][0] == all_clients:
                    continue
                moved = frozenset(t for t in o_applied if t[2] == h)
                moved_d = tuple(
                    kv for kv in o_dedup if kv[0][2] == h
                )
                kept_d = tuple(kv for kv in o_dedup if kv[0][2] != h)
                d_stops, d_applied, d_dedup = servers[s2]
                if sem.handoff_carries_dedup is False:
                    nd = d_dedup  # the window is forgotten in transit
                else:
                    nd = d_dedup
                    for k, v in moved_d:
                        nd = _dmap_set(nd, k, v)
                srv2 = _set(
                    servers, owner, (o_stops, o_applied - moved, kept_d)
                )
                srv2 = _set(
                    srv2, s2, (d_stops, d_applied | moved, nd)
                )
                out.append((
                    clients, srv2, net, avail, eavail, False,
                    _set(owners, h, s2),
                ))

    # -- crash-restore (restart-from-nothing; REPLACE and snapshot
    # timing are elastic_config's jurisdiction — see the shape comment)
    if eavail:
        for s, sv in enumerate(servers):
            stops = sv[0]
            if stops == all_clients:
                continue
            out.append((
                clients,
                _set(servers, s, (stops, frozenset(), ())),
                net, avail, False, havail, owners,
            ))

    # -- client moves
    for c, cl in enumerate(clients):
        stage, waiting, att, retries, pending, inc = cl
        if stage > n_stages:
            continue  # done
        if waiting:
            for i in deliv:
                m = net[i]
                if m[0] != K_REP or m[2] != c:
                    continue
                rest = net[:i] + net[i + 1:]
                true_att, s = m[3], m[1]
                if true_att != att:
                    if sem.attempt_echoed and sem.attempt_checked:
                        out.append(
                            (clients, servers, rest, avail, eavail,
                             havail, owners)
                        )
                        continue
                    viol.setdefault(
                        "MPT011",
                        f"[{cfg.label}] client {c} assembled a reply "
                        f"generated for attempt {true_att} into its live "
                        f"attempt {att} — "
                        + (
                            "the echoed attempt id is never compared "
                            "to the live one"
                            if sem.attempt_echoed
                            else "replies carry no attempt id, so stale "
                            "ones are indistinguishable from fresh"
                        ),
                    )
                pend2 = pending - {s}
                if pend2:
                    cl2 = (stage, True, att, retries, pend2, inc)
                else:
                    cl2 = (stage + 1, False, att, 0, frozenset(), inc)
                out.append((
                    _set(clients, c, cl2), servers, rest, avail, eavail,
                    havail, owners,
                ))
            if sem.reply_recv_timeout and _starved(
                net, c, att, pending, sem
            ):
                if retries < cfg.max_retries:
                    att2 = att + 1
                    reqs = [
                        (K_REQ, c, s, att2, 0, 0) for s in sorted(pending)
                    ]
                    cl2 = (stage, True, att2, retries + 1, pending, inc)
                    for added, av2 in _send_variants(reqs, avail):
                        out.append((
                            _set(clients, c, cl2), servers, net + added,
                            av2, eavail, havail, owners,
                        ))
                else:
                    stage2 = (stage // steps + 1) * steps
                    cl2 = (stage2, False, att, 0, frozenset(), inc)
                    out.append((
                        _set(clients, c, cl2), servers, net, avail,
                        eavail, havail, owners,
                    ))
            continue
        if stage == n_stages:
            msgs = tuple(
                (K_STOP, c, s, 0, 0, 0) for s in range(cfg.servers)
            )
            cl2 = (stage + 1, False, att, 0, frozenset(), inc)
            out.append((
                _set(clients, c, cl2), servers, net + msgs, avail,
                eavail, havail, owners,
            ))
        elif cfg.script[stage % steps] == "fetch":
            att2 = att + 1
            reqs = [(K_REQ, c, s, att2, 0, 0) for s in range(cfg.servers)]
            cl2 = (
                stage, True, att2, 0, frozenset(range(cfg.servers)), inc
            )
            for added, av2 in _send_variants(reqs, avail):
                out.append((
                    _set(clients, c, cl2), servers, net + added, av2,
                    eavail, havail, owners,
                ))
        else:  # push: one message per shard, addressed by current view
            seq = stage // steps + 1
            msgs = [
                (K_PUSH, c, owners[h], seq, (inc, h), 0)
                for h in range(cfg.shards)
            ]
            cl2 = (stage + 1, False, att, 0, frozenset(), inc)
            for added, av2 in _send_variants(msgs, avail):
                out.append((
                    _set(clients, c, cl2), servers, net + added, av2,
                    eavail, havail, owners,
                ))
    return out


def _terminal(state, cfg) -> bool:
    clients, servers = state[0], state[1]
    n_stages = cfg.rounds * len(cfg.script)
    all_clients = frozenset(range(cfg.clients))
    return all(cl[0] > n_stages for cl in clients) and all(
        sv[0] == all_clients for sv in servers
    )


def _describe_stuck(state, cfg) -> str:
    clients, servers, net = state[0], state[1], state[2]
    blocked = [
        f"client {c} waiting on server(s) {sorted(cl[4])} "
        f"(attempt {cl[2]})"
        for c, cl in enumerate(clients)
        if cl[1]
    ]
    waiting_servers = [
        f"server {s} missing STOP from {sorted(frozenset(range(cfg.clients)) - sv[0])}"
        for s, sv in enumerate(servers)
        if sv[0] != frozenset(range(cfg.clients))
    ]
    inflight = ", ".join(
        f"{_KIND_LABEL[m[0]]} {m[1]}->{m[2]}" for m in net
    ) or "none"
    return (
        f"[{cfg.label}] reachable state where nothing can move: "
        + "; ".join(blocked + waiting_servers)
        + f" (in flight: {inflight})"
    )


def check(sem: ModelSemantics, cfg: Optional[ModelConfig] = None
          ) -> CheckResult:
    """Exhaustively explore one configuration. Every violation dict entry
    carries its first witness; ``states`` is the visited-set size (the
    exhaustiveness receipt the CLI prints)."""
    cfg = cfg or ModelConfig()
    if cfg.sharded:
        clients0 = tuple(
            (0, False, 0, 0, frozenset(), 0) for _ in range(cfg.clients)
        )
        servers0 = tuple(
            (frozenset(), frozenset(), ()) for _ in range(cfg.servers)
        )
        owners0 = tuple(h % cfg.servers for h in range(cfg.shards))
        init = (clients0, servers0, (), True, True, True, owners0)
        succ_fn = _successors_sharded
    elif cfg.elastic:
        clients0 = tuple(
            (0, False, 0, 0, frozenset(), 0) for _ in range(cfg.clients)
        )
        servers0 = tuple(
            (frozenset(), frozenset(), _fresh_dedup(cfg), None)
            for _ in range(cfg.servers)
        )
        init = (clients0, servers0, (), True, True)
        succ_fn = _successors_elastic
    else:
        clients0 = tuple(
            (0, False, 0, 0, frozenset()) for _ in range(cfg.clients)
        )
        servers0 = tuple(
            (
                frozenset(),
                frozenset(),
                tuple((0, frozenset()) for _ in range(cfg.clients)),
            )
            for _ in range(cfg.servers)
        )
        init = (clients0, servers0, (), True)
        succ_fn = _successors
    visited = {init}
    stack = [init]
    viol: dict = {}
    points: set = set()
    truncated = False
    while stack:
        if viol:
            # a witness is in hand — further exploration can only find
            # MORE schedules for the same (first-witness) verdict, so a
            # failing run stops here (a CLEAN run is unaffected: it
            # explores to fixpoint, which is what `states` certifies)
            break
        st = stack.pop()
        succ = succ_fn(st, sem, cfg, viol, points)
        if not succ:
            if not _terminal(st, cfg):
                viol.setdefault("MPT010", _describe_stuck(st, cfg))
            continue
        for s2 in succ:
            s2 = s2[:2] + (_canon(s2[2]),) + s2[3:]
            if s2 in visited:
                continue
            if len(visited) >= cfg.max_states:
                truncated = True
                continue
            visited.add(s2)
            stack.append(s2)
    return CheckResult(
        config=cfg,
        states=len(visited),
        fault_points=len(points),
        violations=viol,
        truncated=truncated,
    )


def check_all(sem: ModelSemantics, configs=None, quick: bool = False) -> list:
    """One CheckResult per configuration (default: the acceptance pair,
    plus the elastic-membership configuration when the protocol has the
    machinery it exercises — an epoch-keyed dedup window or shard
    snapshot persistence; a bare dedup'd protocol with neither would
    fail elastic schedules it never claims to survive). ``quick`` swaps
    the default and sharded configurations for their 1-client lint-tier
    variants (see :func:`default_configs` / :func:`sharded_config`; the
    elastic configuration is already 1-client)."""
    if configs is None:
        configs = default_configs(sem.has_push, quick)
        if sem.dedup is not None and (
            sem.dedup_keyed_by_epoch
            or sem.snapshot_includes_dedup is not None
        ):
            configs = tuple(configs) + (elastic_config(),)
        if (
            sem.dedup is not None
            and sem.handoff_carries_dedup is not None
        ):
            # the protocol has shard-handoff machinery: verify
            # exactly-once across ownership moves too
            configs = tuple(configs) + (sharded_config(quick),)
    return [check(sem, cfg) for cfg in configs]


# ---------------------------------------------------------------------------
# the serving-fleet routing model (MPT019)
#
# A different conversation from the PS pair, so a different model: one
# router admits R requests and routes each to one of S replicas; a
# replica that receives a ROUTE answers with a REPLY; the single fault
# is a replica KILL (at most one, never the last replica standing),
# which silently discards every message to or from the dead rank —
# including a consumed-but-unreplied request, the orphan the redispatch
# path exists for. The property checked is the soak gate's invariant in
# model form: **no admitted request is both lost and unacked** — every
# routed request reaches finished in every schedule, with the kill
# allowed anywhere. Recovery requires BOTH extracted facts: a
# redispatch send path (``redispatch_on_death``) and a timeout on the
# router's reply recv (``reply_recv_timeout`` — a router blocked forever
# on a dead replica's reply never reaches its redispatch code).
#
# state = (reqs, alive, net, kill_available)
#   req   = (status, assignee)   status 0 unrouted / 1 routed / 2 done;
#           assignee = replica rank (model index), -1 while unrouted
#   alive = tuple of bools per replica
#   msg   = the shared 6-tuple shape: (K_REQ, -1, s, rid, 0, 0) for
#           ROUTE, (K_REP, s, -1, rid, 0, 0) for REPLY (router = -1) —
#           _canon/_deliverable apply unchanged
#
# The weight lanes (13/14) and STOP are not modeled: they carry no
# request-lifecycle obligation (installs are idempotent, teardown is
# never faulted — same stance as the PS model's STOP).


@dataclasses.dataclass(frozen=True)
class FleetModelSemantics:
    """The two extracted facts the fleet model branches on."""

    redispatch_on_death: bool = True
    reply_timeout: bool = True

    @property
    def can_recover(self) -> bool:
        return self.redispatch_on_death and self.reply_timeout


def fleet_from_protocol(fsem) -> FleetModelSemantics:
    """FleetModelSemantics from a ``protocol.FleetSemantics``."""
    return FleetModelSemantics(
        redispatch_on_death=fsem.redispatch_on_death,
        reply_timeout=fsem.reply_recv_timeout,
    )


def fleet_config(quick: bool = False) -> ModelConfig:
    """The fleet acceptance configuration: 1 router x 2 replicas (the
    minimum where a kill leaves a survivor to redispatch to), 3 requests
    (2 quick) — enough that the kill can land before, between and after
    routes. ``script``/``window``/``kinds`` are unused by the fleet
    explorer; ``rounds`` counts requests."""
    return ModelConfig(
        algo="fleet-route",
        script=("route",),
        clients=1,
        servers=2,
        rounds=2 if quick else 3,
        kinds=(),
    )


def _fleet_terminal(state) -> bool:
    return all(r[0] == 2 for r in state[0])


def _fleet_successors(state, fsem, cfg, viol, points):
    reqs, alive, net, kill_avail = state
    out = []
    # admit+route the next unrouted request (admission order) to each
    # live replica — the policy is nondeterministic here; every policy's
    # choice is some schedule
    for rid, (status, _a) in enumerate(reqs):
        if status == 0:
            for s, up in enumerate(alive):
                if up:
                    out.append((
                        _set(reqs, rid, (1, s)),
                        alive,
                        net + ((K_REQ, -1, s, rid, 0, 0),),
                        kill_avail,
                    ))
            break
    # deliveries
    for i in _deliverable(net):
        m = net[i]
        rest = net[:i] + net[i + 1:]
        kind, rid = m[0], m[3]
        if kind == K_REQ:
            s = m[2]
            if not alive[s]:  # raced a kill; the filter owns this
                out.append((reqs, alive, rest, kill_avail))
            else:  # replica consumes the route, its reply takes wing
                out.append((
                    reqs, alive,
                    rest + ((K_REP, s, -1, rid, 0, 0),),
                    kill_avail,
                ))
        elif kind == K_REP:
            status, assignee = reqs[rid]
            if status == 1 and assignee == m[1]:
                out.append((
                    _set(reqs, rid, (2, assignee)), alive, rest,
                    kill_avail,
                ))
            else:  # a redispatched rid's late original reply: dropped
                out.append((reqs, alive, rest, kill_avail))
    # the kill fault: one replica, never the last one standing; every
    # message to or from the dead rank dies with it (a consumed-but-
    # unreplied request becomes an orphan via its discarded REPLY)
    if kill_avail and sum(alive) >= 2:
        for s, up in enumerate(alive):
            if up:
                points.add(("kill", (s,)))
                out.append((
                    reqs,
                    _set(alive, s, False),
                    tuple(m for m in net if m[1] != s and m[2] != s),
                    False,
                ))
    # orphan recovery: the router's detect-timeout fires and the
    # redispatch path re-routes each dead-assigned request — only when
    # the implementation has both halves of that path
    if fsem.can_recover:
        for rid, (status, assignee) in enumerate(reqs):
            if status == 1 and assignee >= 0 and not alive[assignee]:
                for s, up in enumerate(alive):
                    if up:
                        out.append((
                            _set(reqs, rid, (1, s)),
                            alive,
                            net + ((K_REQ, -1, s, rid, 0, 0),),
                            kill_avail,
                        ))
    return out


def _fleet_describe_stuck(state, cfg) -> str:
    reqs, alive = state[0], state[1]
    lost = [
        f"request {rid} routed to dead replica {assignee}"
        for rid, (status, assignee) in enumerate(reqs)
        if status == 1 and assignee >= 0 and not alive[assignee]
    ]
    return (
        f"[{cfg.label}] a replica kill strands "
        + "; ".join(lost)
        + " with no recovery path — the request is lost but was never "
        "shed or nacked (redispatch-on-death + reply-recv timeout are "
        "the two halves the router needs)"
    )


def check_fleet(fsem: FleetModelSemantics,
                cfg: Optional[ModelConfig] = None) -> CheckResult:
    """Exhaustively explore the fleet-route configuration. A reachable
    state where nothing can move and some routed request is unfinished
    is the MPT019 violation (request lost under a single replica
    kill)."""
    cfg = cfg or fleet_config()
    init = (
        tuple((0, -1) for _ in range(cfg.rounds)),
        tuple(True for _ in range(cfg.servers)),
        (),
        True,
    )
    visited = {init}
    stack = [init]
    viol: dict = {}
    points: set = set()
    truncated = False
    while stack:
        if viol:
            break  # first witness wins, same stance as check()
        st = stack.pop()
        succ = _fleet_successors(st, fsem, cfg, viol, points)
        if not succ:
            if not _fleet_terminal(st):
                viol.setdefault(
                    "MPT019", _fleet_describe_stuck(st, cfg)
                )
            continue
        for s2 in succ:
            s2 = s2[:2] + (_canon(s2[2]),) + s2[3:]
            if s2 in visited:
                continue
            if len(visited) >= cfg.max_states:
                truncated = True
                continue
            visited.add(s2)
            stack.append(s2)
    return CheckResult(
        config=cfg,
        states=len(visited),
        fault_points=len(points),
        violations=viol,
        truncated=truncated,
    )
