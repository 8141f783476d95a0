"""pserver — host-async parameter-server actor (fidelity mode).

A copy of ``mpit_tpu/parallel/pserver.py``: numpy only, so the server's
arithmetic and its protocol are the reference's bit for bit
(``tests/test_torch_ps.py`` drives both servers with one script), and its
full shard snapshot is the reference's msgpack file byte for byte
(:mod:`mpit_tpu_torch.utils.checkpoint`).

Reference parity (SURVEY.md §2 comp. 3, §3(c)): the reference's ``pserver``
held the center parameter vector as a flat tensor and ran a blocking
``Recv(ANY_SOURCE)`` loop, dispatching on message tag (fetch / push / stop).
This is that actor: the center lives in host memory as a numpy chunk (the
server does O(bytes) axpy work, which is memory-bound host arithmetic),
clients' local steps run on the card, and the protocol runs over
``mpit_tpu_torch.transport`` (threads in-process, TCP across processes).

Sharding: with S servers, the flat parameter vector is split into S
contiguous chunks (``np.array_split`` boundaries); server s owns chunk s —
the reference's worker→server mapping generalized to BASELINE.json:9's
"16 workers / 4 pservers" config.

Protocol tags (client → server unless noted):
  FETCH       (attempt_id|None)  server replies PARAM to requester
  PUSH_EASGD  (envelope)         center += alpha * (x_chunk - center)
  PUSH_DELTA  (envelope)         center += server_lr * delta_chunk
  PARAM       ((attempt_id, version, chunk) | chunk)  server → client reply
  STOP        ()                 client detaches; server exits when all did
  HEARTBEAT   ()                 liveness only (refreshes the watchdog)
  JOIN        ((attempt_id, epoch))  membership handshake; server registers
                                 the (rank, epoch) pair in its elastic
                                 membership view and replies PARAM exactly
                                 like a FETCH would
  LEAVE       ()                 planned departure (preemption notice) —
                                 the rank stops counting toward teardown
                                 without waiting for the watchdog
  SHARD_MAP   ((ring_version, members))  new ring view (sharded mode,
                                 docs/ROBUSTNESS.md "Shard ownership &
                                 resharding"): the server hands off shards
                                 it no longer owns and marks newly-owned
                                 ones pending; stale/duplicate views
                                 (ring_version <= current) are idempotently
                                 ignored
  RESHARD     ((ring_version, shard, shard_version, chunk, dedup))
                                 server -> server slice handoff: the new
                                 owner materializes the shard at its static
                                 layout slot and absorbs the sender's dedup
                                 window so exactly-once survives the move

Fault-tolerant envelopes (docs/ROBUSTNESS.md): a FETCH carrying an
``attempt_id`` gets it echoed in the PARAM reply, so a client whose
earlier attempt timed out can discard the stale reply instead of
mis-assembling chunks across attempts. A push envelope is ``(epoch, seq,
basis_version, chunk)``: ``seq`` is the client's per-push counter and
``epoch`` its per-instance identity, deduplicated server-side in a
sliding window so a duplicated/retransmitted push applies **exactly
once** (rejects counted in ``counts["dup_dropped"]``); a *replacement*
client on a reused rank has a fresh epoch, so its restarted seq stream
is not mistaken for replays of its predecessor's.
``basis_version`` is the training-dynamics plane
(docs/OBSERVABILITY.md "dynamics"): the server keeps a monotonic
``version`` counter over its center chunk, bumped once per applied
push and stamped into every attempt-id'd PARAM reply; the client
echoes the version it last fetched into its push envelopes, so the
server can journal per-push **staleness** — how many other updates
landed between this client's fetch and its push applying, the
asynchrony quantity the EASGD analysis bounds. Both the
``(epoch, seq, chunk)`` 3-tuple and bare payloads (no envelope) keep
working — legacy envelopes just carry no basis, so their pushes apply
without a staleness record. A frame
mangled on the wire (chaos ``corrupt``/``truncate`` — a
``CorruptedPayload`` marker or a wrong-shape chunk) is dropped whole and
counted in ``counts["malformed_dropped"]``; it never consumes a dedup
slot and never reaches the apply path.

Failure detection (a do-better over the reference — SURVEY.md §5: 'a dead
rank hangs the job'): with ``client_timeout`` set, the server runs a
watchdog over per-client last-activity times; a client silent for longer
than the timeout is declared dead and no longer blocks teardown. Any
message — including the zero-cost HEARTBEAT a PClient can emit from a timer
thread during long local compute — refreshes liveness, and a late message
from a declared-dead client revives it.

Elastic membership + checkpointed recovery (docs/ROBUSTNESS.md "Elastic
membership"): JOIN/REJOIN/LEAVE envelopes drive the
:class:`~mpit_tpu_torch.parallel.elastic.ElasticMembership` view, so a
replacement process on a killed rank re-enters the run mid-flight
instead of staying in ``dead_clients`` forever. With a non-``.npy``
``ckpt_path``, :meth:`persist` writes a full shard snapshot (center +
version + restart generation + dedup window + membership, one atomic
msgpack file via ``utils/checkpoint.save_shard_state``) instead of the
legacy bare-center ``np.save``; a restarted server restores all of it,
so acked pushes are never double-applied across the restart (the dedup
window rolls back exactly as far as the center does) and the PARAM
version counter resumes monotone within the bumped generation ``gen``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional, Sequence

import numpy as np

from mpit_tpu_torch.analysis.runtime import (
    make_lock,
    note as _rt_note,
    note_numeric_array as _rt_numeric,
)
from mpit_tpu_torch.comm.topology import HashRing
from mpit_tpu_torch.obs.live import M_STALENESS, live_registry
from mpit_tpu_torch.parallel.elastic import ElasticMembership
from mpit_tpu_torch.transport import (
    ANY_SOURCE,
    ANY_TAG,
    CorruptedPayload,
    RecvTimeout,
    Transport,
)
from mpit_tpu_torch.transport.wire import (
    QuantArray,
    dequantize,
    quant_mode_from_env,
    quantize,
)

# mpit-analysis: protocol-role[server->client]
# (this module IS the server side of the PS wire protocol; the MPT008
# cross-module pass pairs every tag below against the client role's
# send/recv pattern in pclient.py / ps_roles.py)
TAG_FETCH = 1
TAG_PUSH_EASGD = 2
TAG_PUSH_DELTA = 3
TAG_PARAM = 4
TAG_STOP = 5
TAG_HEARTBEAT = 6
TAG_JOIN = 7
TAG_LEAVE = 8
TAG_SHARD_MAP = 9
TAG_RESHARD = 10


class _DedupWindow:
    """Per-(src, epoch) sliding window of seen push sequence numbers.

    ``admit`` is True exactly once per (src, epoch, seq): a retransmitted
    or chaos-duplicated push is rejected. A seq at or below ``high -
    size`` is *also* rejected — outside the window we can no longer tell
    a stale retransmit from a fresh push, and at-most-once is the safe
    side of that ambiguity (the client treats a lost push as a skipped
    round, never as corruption). Single-threaded by design: only the
    server's recv loop touches it."""

    def __init__(self, size: int = 1024):
        if size < 1:
            raise ValueError("dedup window size must be >= 1")
        self.size = size
        self._high: dict[tuple[int, int], int] = {}
        self._seen: dict[tuple[int, int], set[int]] = {}

    def admit(self, src: int, epoch: int, seq: int) -> bool:
        key = (src, epoch)
        high = self._high.get(key, 0)
        seen = self._seen.setdefault(key, set())
        if seq <= high - self.size or seq in seen:
            return False
        seen.add(seq)
        if seq > high:
            self._high[key] = seq
            if len(seen) > self.size:
                floor = seq - self.size
                self._seen[key] = {s for s in seen if s > floor}
        return True

    def absorb(self, entries) -> None:
        """Merge another window's :meth:`state` into this one (shard
        handoff): per (src, epoch) the high-water mark takes the max and
        the seen sets union, so a push the old owner already applied is
        still rejected by the new owner after the shard moves — the
        exactly-once guarantee travels WITH the shard, not with the
        server that happened to hold it."""
        for src, epoch, high, seen in entries:
            key = (int(src), int(epoch))  # mpit-analysis: ignore[MPT005]
            self._high[key] = max(self._high.get(key, 0), int(high))  # mpit-analysis: ignore[MPT005]
            s = self._seen.setdefault(key, set())
            s.update(int(x) for x in seen)  # mpit-analysis: ignore[MPT005]

    def state(self) -> list:
        """Snapshot as plain msgpack-friendly lists: one
        ``[src, epoch, high, sorted(seen)]`` entry per (src, epoch)."""
        return [
            [src, epoch, self._high.get((src, epoch), 0), sorted(seen)]
            for (src, epoch), seen in sorted(self._seen.items())
        ]

    def load_state(self, entries) -> None:
        """Restore from :meth:`state` output (int casts: msgpack hands
        back whatever width it stored)."""
        self._high.clear()
        self._seen.clear()
        # msgpack ints, not device scalars: cold restore path
        for src, epoch, high, seen in entries:
            key = (int(src), int(epoch))  # mpit-analysis: ignore[MPT005]
            self._high[key] = int(high)  # mpit-analysis: ignore[MPT005]
            self._seen[key] = {int(s) for s in seen}  # mpit-analysis: ignore[MPT005]


def partition_bounds(total: int, num_servers: int) -> list[tuple[int, int]]:
    """Contiguous chunk [start, end) per server (np.array_split boundaries:
    the first ``total % num_servers`` chunks get one extra element)."""
    q, r = divmod(total, num_servers)
    bounds, start = [], 0
    for i in range(num_servers):
        s = q + (1 if i < r else 0)
        bounds.append((start, start + s))
        start += s
    return bounds


class PServer:
    """One parameter-server actor owning a chunk of the flat center vector.

    Run ``start()`` in its own thread/process; it blocks in the recv loop
    until every expected client sent STOP (the reference's teardown,
    SURVEY.md §3(e)).
    """

    def __init__(
        self,
        transport: Transport,
        center_chunk: np.ndarray,
        num_clients: int,
        alpha: float = 0.5,
        server_lr: float = 1.0,
        client_ranks: Optional[Sequence[int]] = None,
        client_timeout: Optional[float] = None,
        ckpt_path: Optional[str] = None,
        ckpt_every: Optional[int] = 100,
        dedup_window: int = 1024,
        quant: Optional[str] = None,
        shard_map=None,
    ):
        """``client_timeout``: seconds of per-client silence before the
        watchdog declares it dead (requires ``client_ranks``); None keeps
        the reference's wait-forever semantics.

        ``ckpt_path``: elastic recovery (SURVEY.md §5 — optional
        do-better; the reference loses the center with the process).
        When set, the center chunk is persisted atomically every
        ``ckpt_every`` center updates (``None`` = only at clean
        teardown) and at clean teardown; a server constructed with an
        existing file RESTORES it (``self.restored``) instead of taking
        ``center_chunk``, so a restarted server resumes where the dead
        one left off. A shape mismatch (different model or server count)
        fails loudly — re-chunking across topologies is a layout change,
        not a resume.

        ``shard_map``: a :class:`~mpit_tpu_torch.comm.topology.ShardMap` opts
        this server into consistent-hash sharded ownership
        (docs/ROBUSTNESS.md "Shard ownership & resharding"):
        ``center_chunk`` must be the ascending concatenation of the
        shards the map assigns to ``transport.rank``, pushes/fetches
        carry per-shard parts, and TAG_SHARD_MAP / TAG_RESHARD move
        ownership live. ``None`` keeps the legacy single contiguous
        chunk."""
        self.transport = transport
        self.center = np.array(center_chunk, dtype=np.float32, copy=True)
        self._shard_map = shard_map
        # sharded-ownership state: `_owned` is the ascending
        # (sid, start, end) list of MATERIALIZED shards backing
        # self.center; `_pending` are shards the current ring assigns
        # here whose data has not arrived yet (via TAG_RESHARD from the
        # old owner, or adopted from the first full EASGD push) — a
        # pending shard occupies no memory, which is what keeps the
        # reshard peak at old-slice + incoming-slice
        self._owned: list[tuple[int, int, int]] = []
        self._pending: dict[int, tuple[int, int]] = {}
        # per-shard monotonic update counters (dynamics plane): bumped
        # with every applied part, stamped into sharded PARAM replies so
        # staleness stays attributable per shard across ownership moves
        self.shard_versions: dict[int, int] = {}
        if shard_map is not None:
            self._owned = list(shard_map.ranges_for(transport.rank))
            owned_size = sum(e - s for _, s, e in self._owned)
            if self.center.size != owned_size:
                raise ValueError(
                    f"center_chunk has {self.center.size} elements but the "
                    f"shard map assigns {owned_size} to rank "
                    f"{transport.rank}"
                )
            self.shard_versions = {sid: 0 for sid, _, _ in self._owned}
        self.num_clients = num_clients
        self.alpha = float(alpha)
        self.server_lr = float(server_lr)
        self.client_ranks = (
            list(client_ranks) if client_ranks is not None else None
        )
        if client_timeout is not None:
            if self.client_ranks is None:
                raise ValueError("client_timeout requires client_ranks")
            if client_timeout <= 0:
                raise ValueError(
                    "client_timeout must be positive (use None to disable)"
                )
        self.client_timeout = client_timeout
        # opt-in quantized PARAM replies (MPIT_WIRE_QUANT, docs/WIRE.md):
        # only attempt-id'd fetches get a quantized snapshot — an un-id'd
        # FETCH is by definition a legacy client, which may predate
        # QuantArray entirely
        if quant is None:
            quant = quant_mode_from_env()
        elif quant not in ("off", "bf16", "int8"):
            raise ValueError(f"quant must be off|bf16|int8, got {quant!r}")
        self.quant = quant
        self.counts = {"fetch": 0, "push_easgd": 0, "push_delta": 0,
                       "heartbeat": 0, "join": 0, "leave": 0,
                       "dup_dropped": 0, "malformed_dropped": 0,
                       "shard_map": 0, "reshard": 0, "handoff_sent": 0,
                       "adopted_shards": 0, "misrouted_parts": 0}
        # training-dynamics plane (docs/OBSERVABILITY.md "dynamics"):
        # monotonic center-update version — bumped per applied push,
        # stamped into attempt-id'd PARAM replies, echoed back by
        # clients as the fetch basis of their push envelopes
        self.version = 0
        # restart generation: bumped on every snapshot restore; stamped
        # into param_version journal records so `obs dynamics` and TC204
        # judge version monotonicity within a generation (a restore may
        # legitimately roll the counter back to the persisted value)
        self.gen = 0
        # per-src staleness accounting {src: {pushes, sum, max}} for
        # versioned pushes only (legacy envelopes carry no basis)
        self.staleness_by_src: dict[int, dict[str, int]] = {}
        self._dedup = _DedupWindow(dedup_window)
        self._membership = ElasticMembership(num_clients, client_ranks)
        # aliases into the membership view: the watchdog, the STOP
        # branch, trainers, and tests all mutate/read these sets
        # directly, and membership keeps owning the same objects
        self.dead_clients = self._membership.dead
        self._stopped = self._membership.stopped
        self.error: Optional[BaseException] = None
        self._lock = make_lock("PServer._lock")
        if ckpt_every is not None and ckpt_every < 1:
            raise ValueError(
                "ckpt_every must be >= 1 (None = persist only at teardown)"
            )
        self.ckpt_path = ckpt_path
        self.ckpt_every = None if ckpt_every is None else int(ckpt_every)
        self._updates_since_save = 0
        self.restored = False
        if ckpt_path is not None and os.path.exists(ckpt_path):
            with open(ckpt_path, "rb") as f:
                magic = f.read(6)
            if magic == b"\x93NUMPY":
                # legacy bare-center snapshot (ps_trainer's center_<r>.npy)
                with open(ckpt_path, "rb") as f:
                    saved = np.load(f)
                if saved.shape != self.center.shape:
                    raise ValueError(
                        f"persisted center chunk {ckpt_path!r} has shape "
                        f"{saved.shape}, this server owns "
                        f"{self.center.shape} — resuming across a "
                        "model/server-count change is not supported"
                    )
                self.center = saved.astype(np.float32, copy=True)
            else:
                self._restore_shard(ckpt_path)
            self.restored = True

    def _restore_shard(self, ckpt_path: str) -> None:
        """Restore a full shard snapshot (elastic recovery format): the
        center + version + dedup window + membership come back as one
        consistent cut, so an acked push either survives with the center
        it mutated or rolls back with it — never half."""
        from mpit_tpu_torch.utils.checkpoint import load_shard_state

        state = load_shard_state(ckpt_path)
        saved = np.asarray(state["center"], dtype=np.float32)
        shards = state.get("shards")
        if shards is None or self._shard_map is None:
            if saved.shape != self.center.shape:
                raise ValueError(
                    f"persisted shard snapshot {ckpt_path!r} has shape "
                    f"{saved.shape}, this server owns {self.center.shape} "
                    "— resuming across a model/server-count change is not "
                    "supported"
                )
        else:
            # sharded snapshot: the persisted ownership rows, not the
            # constructor's map, say what the center covers (ownership
            # may have moved between construction and the snapshot)
            owned = [
                (int(x[0]), int(x[1]), int(x[2]))  # mpit-analysis: ignore[MPT005]
                for x in shards
            ]
            if sum(e - s for _, s, e in owned) != saved.size:
                raise ValueError(
                    f"persisted shard snapshot {ckpt_path!r}: ownership "
                    "rows do not cover the persisted center"
                )
            self._owned = owned
            self._pending = {}
            self.shard_versions = {
                int(x[0]): int(x[3])  # mpit-analysis: ignore[MPT005]
                for x in shards
            }
        ring = state.get("ring")
        if ring is not None and self._shard_map is not None:
            rv = int(ring[0])  # mpit-analysis: ignore[MPT005]
            if rv > self._shard_map.ring.version:
                members = [int(m) for m in ring[1]]  # mpit-analysis: ignore[MPT005]
                self._shard_map = self._shard_map.with_ring(
                    HashRing(
                        members,
                        vnodes=self._shard_map.ring.vnodes,
                        version=rv,
                    )
                )
        self.center = saved.copy()
        self.version = int(state.get("version", 0))
        # a restore is a new generation: PARAM version records after the
        # restart carry gen+1 so monotonicity is judged per generation
        self.gen = int(state.get("gen", 0)) + 1
        dedup = state.get("dedup")
        if dedup is not None:
            self._dedup.load_state(dedup)
        membership = state.get("membership")
        if membership is not None:
            self._membership.load_state(membership)

    def _note(self, field: str, write: bool = True) -> None:
        """RT103 annotation: stamp an access to a shared field into the
        vector-clock sanitizer (no-op — one attr load — unless a
        race-mode runtime checker is armed, see MPIT_RT_RACE)."""
        _rt_note(f"PServer#{id(self)}.{field}", write)

    def start(self) -> None:
        """Recv loop; stores any exception in ``self.error`` (a daemon
        thread's traceback would otherwise vanish while clients block into
        RecvTimeout with the root cause lost)."""
        try:
            self._serve()
        except BaseException as e:
            self.error = e
            raise

    def _serve(self) -> None:
        watchdog = self.client_timeout is not None
        last_seen: dict[int, float] = {}
        if watchdog:
            now = time.monotonic()
            last_seen = {r: now for r in self.client_ranks}
        poll = self.client_timeout / 4 if watchdog else None

        # teardown when every expected rank is accounted for (stopped,
        # dead, or left) — equal to the seed's `len(stopped | dead) <
        # num_clients` loop when membership never changes, but correct
        # when ranks JOIN/LEAVE mid-run
        while not self._membership.teardown_complete():
            try:
                msg = self.transport.recv(ANY_SOURCE, ANY_TAG, timeout=poll)
            except RecvTimeout:
                self._expire(last_seen)
                continue
            if watchdog and msg.src in last_seen:
                last_seen[msg.src] = time.monotonic()
                # a late message from a declared-dead client revives it
                self._note("membership")
                self.dead_clients.discard(msg.src)
            if isinstance(msg.payload, CorruptedPayload):
                # an unparseable frame: in a real stack the tag itself
                # would be unreadable, so no dispatch — drop it (counted)
                # and let the sender's retry/timeout absorb the loss. It
                # still refreshed liveness above: garbage is a sign of
                # life.
                with self._lock:
                    self._note("counts")
                    self.counts["malformed_dropped"] += 1
                if watchdog:
                    self._expire(last_seen)
                continue
            if msg.tag == TAG_FETCH:
                with self._lock:
                    self._note("center", write=False)
                    self._note("version", write=False)
                    self._note("counts")
                    snapshot = self._reply_chunk()
                    version = self.version
                    self.counts["fetch"] += 1
                # echo the client's attempt id so a retrying fetch can
                # tell this reply from a stale one (None = legacy FETCH);
                # id'd replies also carry the center's update version —
                # the client echoes it back as its push basis so the
                # server can attribute per-push staleness
                if msg.payload is None:
                    reply = snapshot
                else:
                    reply = (msg.payload, version, self._quant_chunk(snapshot))
                self._journal_dynamics(
                    "param_version", dst=msg.src, version=version,
                    gen=self.gen,
                )
                self.transport.send(msg.src, TAG_PARAM, reply)
            elif msg.tag == TAG_PUSH_EASGD:
                if self._admit_push(msg):
                    # elastic move toward the client (SURVEY.md §3(c) push)
                    self._apply_update(msg, easgd=True)
                    self._maybe_persist()
            elif msg.tag == TAG_PUSH_DELTA:
                if self._admit_push(msg):
                    self._apply_update(msg, easgd=False)
                    self._maybe_persist()
            elif msg.tag == TAG_HEARTBEAT:
                with self._lock:
                    self._note("counts")
                    self.counts["heartbeat"] += 1
            elif msg.tag == TAG_JOIN:
                # membership handshake: register the (rank, epoch) pair
                # and answer with the same versioned PARAM a FETCH gets —
                # one reply tag keeps the wire protocol's single
                # request/reply shape (and the extracted model) intact
                parsed = self._parse_join(msg.payload)
                if parsed is None:
                    with self._lock:
                        self._note("counts")
                        self.counts["malformed_dropped"] += 1
                else:
                    attempt, client_epoch = parsed
                    self._note("membership")
                    kind = self._membership.register(msg.src, client_epoch)
                    with self._lock:
                        self._note("center", write=False)
                        self._note("version", write=False)
                        self._note("counts")
                        snapshot = self._reply_chunk()
                        version = self.version
                        self.counts["join"] += 1
                    if watchdog and msg.src not in last_seen:
                        # a brand-new rank: arm its watchdog slot
                        last_seen[msg.src] = time.monotonic()
                    reply = (attempt, version, self._quant_chunk(snapshot))
                    self._journal_dynamics(
                        "membership", src=msg.src, kind=kind,
                        view=self._membership.view_epoch, gen=self.gen,
                    )
                    self._journal_dynamics(
                        "param_version", dst=msg.src, version=version,
                        gen=self.gen,
                    )
                    self.transport.send(msg.src, TAG_PARAM, reply)
            elif msg.tag == TAG_LEAVE:
                self._note("membership")
                self._membership.leave(msg.src)
                with self._lock:
                    self._note("counts")
                    self.counts["leave"] += 1
                self._journal_dynamics(
                    "membership", src=msg.src, kind="leave",
                    view=self._membership.view_epoch, gen=self.gen,
                )
            elif msg.tag == TAG_STOP:
                self._note("membership")
                self._stopped.add(msg.src)
            elif msg.tag == TAG_SHARD_MAP:
                self._handle_shard_map(msg)
            elif msg.tag == TAG_RESHARD:
                self._handle_reshard(msg)
            else:
                raise ValueError(f"pserver: unknown tag {msg.tag}")
            if watchdog:
                self._expire(last_seen)
        self.persist()  # clean teardown: the final center is never lost

    def _parse_join(self, payload) -> Optional[tuple]:
        """``(attempt_id, epoch)`` from a JOIN envelope, or None for a
        malformed one (a chaos-mangled JOIN is dropped like any other
        unparseable frame; the client's join retry re-offers it)."""
        if (
            isinstance(payload, tuple)
            and len(payload) == 2
            and isinstance(payload[0], int)
            and isinstance(payload[1], int)
        ):
            return payload
        return None

    # ---- sharded ownership (docs/ROBUSTNESS.md "Shard ownership &
    # resharding"). All of the state below is confined to the server's
    # recv thread except `center`/`_owned`, which snapshot() readers see
    # under the lock.

    def _local_slices(self) -> list[tuple[int, int]]:
        """Local [start, end) into ``self.center`` per materialized
        shard, ascending (same order as ``self._owned``)."""
        out, off = [], 0
        for _, s, e in self._owned:
            out.append((off, off + (e - s)))
            off += e - s
        return out

    def _shard_slice(self, sid: int) -> Optional[tuple[int, int]]:
        for (osid, _, _), loc in zip(self._owned, self._local_slices()):
            if osid == sid:
                return loc
        return None

    def _materialize(self, sid: int, arr, version: int) -> None:
        """Install a pending shard's data at its static layout slot
        (caller holds the lock). The backing ``center`` array is rebuilt
        as the ascending concatenation — the only transient extra memory
        is the one incoming slice."""
        s, e = self._pending.pop(sid)
        pieces = [
            (gs, osid, ge, self.center[ls:le])
            for (osid, gs, ge), (ls, le) in zip(self._owned, self._local_slices())
        ]
        pieces.append((s, sid, e, np.asarray(arr, dtype=np.float32)))
        pieces.sort(key=lambda p: p[0])
        self._owned = [(p[1], p[0], p[2]) for p in pieces]
        self.center = np.concatenate([p[3] for p in pieces])
        self.shard_versions[sid] = int(version)

    def _drop_shard(self, sid: int) -> None:
        """Forget a handed-off shard (caller holds the lock): the slice
        leaves ``center`` immediately, so the old owner never holds a
        duplicate once the transfer is on the wire."""
        keep = [
            ((osid, s, e), self.center[ls:le])
            for (osid, s, e), (ls, le) in zip(self._owned, self._local_slices())
            if osid != sid
        ]
        self._owned = [k[0] for k in keep]
        self.center = (
            np.concatenate([k[1] for k in keep])
            if keep
            else np.zeros(0, dtype=np.float32)
        )
        self.shard_versions.pop(sid, None)

    def _reply_chunk(self):
        """PARAM reply body (caller holds the lock): the legacy
        contiguous copy, or — sharded — ``(sid, shard_version, slice)``
        parts the client places by the static layout, so a reply stays
        interpretable even when the client's ring view is behind."""
        if self._shard_map is None:
            return self.center.copy()
        return [
            (sid, int(self.shard_versions.get(sid, 0)), self.center[ls:le].copy())
            for (sid, _, _), (ls, le) in zip(self._owned, self._local_slices())
        ]

    def _quant_chunk(self, snapshot):
        if self.quant == "off":
            return snapshot
        # Param-fetch replies quantize a fresh center snapshot each
        # time, not an accumulating stream — no residual to carry.
        if isinstance(snapshot, list):
            return [
                # mpit-analysis: ef-off[fetch reply is a fresh snapshot]
                (sid, ver, quantize(arr, self.quant)) for sid, ver, arr in snapshot
            ]
        # mpit-analysis: ef-off[fetch reply is a fresh snapshot]
        return quantize(snapshot, self.quant)

    def _apply_update(self, msg, easgd: bool) -> None:
        """Apply an admitted push: the legacy whole-chunk axpy, or the
        per-shard parts of a sharded envelope."""
        with self._lock:
            self._note("center")
            self._note("version")
            self._note("counts")
            payload = msg.payload
            if isinstance(payload, list):
                self._apply_parts(payload, easgd)
            elif easgd:
                self.center += self.alpha * (np.asarray(payload) - self.center)
            else:
                self.center += self.server_lr * np.asarray(payload)
            self.counts["push_easgd" if easgd else "push_delta"] += 1
            self._updates_since_save += 1
            self.version += 1
            version = self.version
        self._record_push(msg, version)

    def _apply_parts(self, parts, easgd: bool) -> None:
        """Per-shard apply (caller holds the lock). An EASGD part for a
        *pending* shard seeds it (the payload IS the client's parameter
        values, so the first full push after a repair materializes the
        orphan slice — and the elastic pull below is then a no-op
        against an identical center). A DOWNPOUR delta cannot seed a
        shard and a part for a shard we do not own means the sender's
        ring view is behind; both are dropped and counted — the client
        re-offers to the current owner next round."""
        for sid, arr in parts:
            if sid in self._pending and easgd:
                self._materialize(sid, arr, self.shard_versions.get(sid, 0))
                self.counts["adopted_shards"] += 1
            loc = self._shard_slice(sid)
            if loc is None:
                self.counts["misrouted_parts"] += 1
                continue
            ls, le = loc
            if easgd:
                self.center[ls:le] += self.alpha * (arr - self.center[ls:le])
            else:
                self.center[ls:le] += self.server_lr * arr
            self.shard_versions[sid] = self.shard_versions.get(sid, 0) + 1

    def _parse_shard_map(self, payload) -> Optional[tuple]:
        """``(ring_version, members)`` from a SHARD_MAP envelope, or
        None for a malformed one."""
        if (
            isinstance(payload, (tuple, list))
            and len(payload) == 2
            and isinstance(payload[0], int)
            and isinstance(payload[1], (tuple, list))
            and len(payload[1]) > 0
            and all(isinstance(m, int) for m in payload[1])
        ):
            return int(payload[0]), tuple(int(m) for m in payload[1])
        return None

    def _handle_shard_map(self, msg) -> None:
        """Adopt a new ring view: hand off shards the new ring assigns
        elsewhere, mark newly-assigned ones pending. The ring version is
        the idempotency key — every repairing client derives the same
        ring from the same death, so the second and later announcements
        of one view are no-ops."""
        parsed = self._parse_shard_map(msg.payload)
        if parsed is None:
            with self._lock:
                self._note("counts")
                self.counts["malformed_dropped"] += 1
            return
        ring_version, members = parsed
        with self._lock:
            self._note("counts")
            self.counts["shard_map"] += 1
        if self._shard_map is None:
            return  # flat server: no ring to update
        if ring_version <= self._shard_map.ring.version:
            return  # stale or duplicate view
        new_ring = HashRing(
            members, vnodes=self._shard_map.ring.vnodes, version=ring_version
        )
        new_map = self._shard_map.with_ring(new_ring)
        mine = {sid for sid, _, _ in new_map.ranges_for(self.transport.rank)}
        held = {sid for sid, _, _ in self._owned}
        for sid in sorted(set(self._pending) - mine):
            del self._pending[sid]  # never arrived and no longer ours
        for sid in sorted(held - mine):
            self._handoff_shard(sid, new_map.assignment[sid], ring_version)
        for sid in sorted(mine - held - set(self._pending)):
            s, e = new_map.layout[sid]
            self._pending[sid] = (s, e)
        self._shard_map = new_map
        self._journal_dynamics(
            "shard_map", view=ring_version, src=msg.src,
            owned=len(self._owned), pending=len(self._pending), gen=self.gen,
        )

    def _handoff_shard(self, sid: int, dst: int, ring_version: int) -> None:
        """Graceful slice exchange to the shard's new owner: data +
        per-shard version + the dedup window travel together, so the new
        owner rejects replays of pushes the old owner already applied.
        The slice is dropped from ``center`` only after the transfer is
        accepted by the transport — a failed send keeps the shard here,
        and the next view announcement re-offers it (failure during
        failure-handling degrades to a retry, never to data loss)."""
        with self._lock:
            self._note("center", write=False)
            loc = self._shard_slice(sid)
            if loc is None:
                return
            ls, le = loc
            arr = self.center[ls:le].copy()
            ver = int(self.shard_versions.get(sid, 0))
            entries = self._dedup.state()
        payload = (ring_version, sid, ver, arr, entries)
        if not self._send_reshard(dst, payload):
            return
        with self._lock:
            self._note("center")
            self._note("counts")
            self._drop_shard(sid)
            self.counts["handoff_sent"] += 1
        self._journal_dynamics(
            "reshard", shard=sid, dst=dst, version=ver,
            view=ring_version, gen=self.gen,
        )

    def _send_reshard(self, dst: int, payload) -> bool:
        """Retry/backoff on the reshard transfer (the server-side twin
        of PClient._send_with_retry; the (ring_version, shard) pair in
        the payload plays the attempt-id role — the receiver ignores
        duplicates and stale versions)."""
        delay = 0.05
        for attempt in range(3):
            try:
                self.transport.send(dst, TAG_RESHARD, payload)
                return True
            except (ConnectionError, OSError):
                if attempt == 2:
                    return False
                time.sleep(delay)
                delay *= 2
        return False

    def _parse_reshard(self, payload) -> Optional[tuple]:
        """``(ring_version, shard, shard_version, chunk, dedup)`` from a
        RESHARD envelope, or None for a malformed one (a chaos-mangled
        transfer is dropped whole; the sender's re-offer repeats it)."""
        if not (
            isinstance(payload, (tuple, list))
            and len(payload) == 5
            and isinstance(payload[0], int)
            and isinstance(payload[1], int)
            and isinstance(payload[2], int)
            and isinstance(payload[4], (list, tuple))
        ):
            return None
        ring_version, sid, ver, chunk, entries = payload
        if self._shard_map is not None:
            if not (0 <= sid < self._shard_map.num_shards):
                return None
            try:
                arr = np.asarray(chunk, dtype=np.float32)
            except (TypeError, ValueError):
                return None
            s, e = self._shard_map.layout[sid]
            if arr.shape != (e - s,):
                return None
            chunk = arr
        return int(ring_version), int(sid), int(ver), chunk, entries

    def _handle_reshard(self, msg) -> None:
        """Install a handed-off shard: materialize the slice, take over
        its version counter, absorb the old owner's dedup window. A
        transfer for a shard that is not pending (duplicate, or a view
        we have since moved past) is idempotently ignored."""
        parsed = self._parse_reshard(msg.payload)
        if parsed is None:
            with self._lock:
                self._note("counts")
                self.counts["malformed_dropped"] += 1
            return
        ring_version, sid, ver, chunk, entries = parsed
        with self._lock:
            self._note("counts")
            self.counts["reshard"] += 1
        if self._shard_map is None or sid not in self._pending:
            return
        with self._lock:
            self._note("center")
            self._materialize(sid, chunk, ver)
            self.counts["adopted_shards"] += 1
        self._note("dedup")
        self._dedup.absorb(entries)
        self._journal_dynamics(
            "reshard", shard=sid, src=msg.src, version=ver,
            view=ring_version, gen=self.gen,
        )

    def owned_ranges(self) -> list:
        """Ascending ``(sid, start, end)`` of materialized shards
        (empty in legacy flat mode)."""
        with self._lock:
            return list(self._owned)

    def _admit_push(self, msg) -> bool:
        """Unwrap a push envelope, validate the chunk, and run the
        exactly-once check.

        ``(epoch, seq, basis_version, chunk)`` (and legacy ``(epoch,
        seq, chunk)``) envelopes are deduplicated per (src, epoch); the
        validated chunk is rebound onto ``msg.payload`` so the apply
        path below handles envelope and legacy bare-chunk pushes
        identically, and the basis version (when present) is stashed on
        the message for the post-apply staleness record. Returns False
        for a replay or a malformed chunk (both counted, never
        applied). Validation runs BEFORE the dedup admit: a
        chaos-truncated frame must not consume its (epoch, seq) slot —
        a clean retransmit of the same push should still be able to
        land."""
        payload = msg.payload
        basis: Optional[int] = None
        if (
            isinstance(payload, tuple)
            and len(payload) == 4
            and isinstance(payload[0], int)
            and isinstance(payload[1], int)
            and isinstance(payload[2], int)
        ):
            # versioned envelope: peel the fetch-basis version off and
            # fall through to the common (epoch, seq, chunk) handling —
            # dedup and validation are identical either way
            epoch, seq, basis, chunk = payload
            payload = (epoch, seq, chunk)
        if (
            isinstance(payload, tuple)
            and len(payload) == 3
            and isinstance(payload[0], int)
            and isinstance(payload[1], int)
        ):
            epoch, seq, chunk = payload
            arr = self._validate_chunk(chunk)
            if arr is None:
                with self._lock:
                    self._note("counts")
                    self.counts["malformed_dropped"] += 1
                return False
            msg.payload = arr
            # dedup is confined to the server thread — annotated so RT103
            # would catch any future second mutator
            self._note("dedup")
            if not self._dedup.admit(msg.src, epoch, seq):
                with self._lock:
                    self._note("counts")
                    self.counts["dup_dropped"] += 1
                return False
            msg.basis_version = basis
            msg.push_epoch = epoch
            return True
        arr = self._validate_chunk(payload)
        if arr is None:
            with self._lock:
                self._note("counts")
                self.counts["malformed_dropped"] += 1
            return False
        msg.payload = arr
        return True

    def _journal_dynamics(self, ev: str, **fields) -> None:
        """Write a training-dynamics record through the transport's obs
        tracer. No-op (one getattr) when the transport is not
        obs-wrapped or journaling is off — the disabled-cost contract
        of the rest of the obs plane."""
        tracer = getattr(self.transport, "obs_tracer", None)
        if tracer is None or tracer.journal is None:
            return
        tracer.journal.event(ev, tracer.clock.tick(), **fields)

    def _record_push(self, msg, version: int) -> None:
        """Account, journal, and live-publish an applied push's
        staleness when its envelope carried a fetch-basis version
        (legacy envelopes don't — they apply silently, as before).

        staleness = pre-apply version − basis version: the number of
        center updates that landed between this client's fetch and its
        push applying. 0 means the push coupled against exactly the
        center it fetched; under contention it grows with how many
        other clients' pushes raced in between — the per-(src, epoch)
        asynchrony signal ``obs dynamics`` aggregates."""
        basis = getattr(msg, "basis_version", None)
        if basis is None:
            return
        staleness = max(0, version - 1 - basis)
        with self._lock:
            self._note("staleness")
            st = self.staleness_by_src.setdefault(
                msg.src, {"pushes": 0, "sum": 0, "max": 0}
            )
            st["pushes"] += 1
            st["sum"] += staleness
            st["max"] = max(st["max"], staleness)
        self._journal_dynamics(
            "push_stale",
            src=msg.src,
            epoch=getattr(msg, "push_epoch", None),
            staleness=staleness,
            version=version,
        )
        # live histogram: one staleness unit recorded as one "second" —
        # the geometric buckets are unit-agnostic, so the dashboard's
        # percentile_ms/1000 recovers staleness units within bucket
        # resolution (~10%)
        live_registry(self.transport).observe(M_STALENESS, float(staleness))

    def _validate_chunk(self, chunk) -> Optional[np.ndarray]:
        """float32 view/copy of an update chunk, or None when the frame
        is malformed (chaos ``corrupt``/``truncate``, or just the wrong
        shape for this server's partition) — the safe side of
        at-most-once: an unparseable update is dropped whole, never
        partially or wrongly applied. Quantized chunks are dequantized
        here (a truncated QuantArray dequantizes to the wrong length and
        fails the shape check like any cut frame). Sharded-mode pushes
        carry ``(sid, chunk)`` parts instead of one contiguous chunk —
        each part is validated against its static layout slot."""
        if (
            self._shard_map is not None
            and isinstance(chunk, (list, tuple))
            and not isinstance(chunk, np.ndarray)
        ):
            return self._validate_parts(chunk)
        try:
            if isinstance(chunk, QuantArray):
                chunk = dequantize(chunk)
            arr = np.asarray(chunk, dtype=np.float32)
        except (TypeError, ValueError):
            return None
        if arr.shape != self.center.shape:
            return None
        # RT104: the server apply boundary — a NaN/Inf push admitted
        # here poisons the center for every subsequent fetch
        _rt_numeric("pserver.apply", arr)
        return arr

    def _validate_parts(self, parts) -> Optional[list]:
        """Validated ``[(sid, float32 array), ...]`` from a sharded push
        chunk, or None when any part is malformed — all-or-nothing, the
        same safe side of at-most-once as the contiguous path."""
        if len(parts) == 0:
            return None
        out = []
        for part in parts:
            if not (
                isinstance(part, (tuple, list))
                and len(part) == 2
                and isinstance(part[0], int)
            ):
                return None
            sid, chunk = part
            if not (0 <= sid < self._shard_map.num_shards):
                return None
            try:
                if isinstance(chunk, QuantArray):
                    chunk = dequantize(chunk)
                # wire payloads are host numpy (msgpack-decoded), never
                # device arrays — no host sync happens here
                arr = np.asarray(chunk, dtype=np.float32)  # mpit-analysis: ignore[MPT005]
            except (TypeError, ValueError):
                return None
            s, e = self._shard_map.layout[sid]
            if arr.shape != (e - s,):
                return None
            _rt_numeric("pserver.apply", arr)
            out.append((int(sid), arr))  # mpit-analysis: ignore[MPT005]
        return out

    def _maybe_persist(self) -> None:
        if (
            self.ckpt_path is None
            or self.ckpt_every is None  # teardown-only mode
            or self._updates_since_save < self.ckpt_every
        ):
            return
        self.persist()

    def _snapshot_state(self) -> dict:
        """One consistent cut of everything a restarted server needs:
        the keys below are the shard snapshot format — center, version,
        gen, dedup, and membership are persisted TOGETHER so a push that
        was applied but not yet persisted rolls back *with* the center
        it mutated (its redelivery then re-applies exactly once relative
        to the restored state)."""
        with self._lock:
            self._note("center", write=False)
            self._note("version", write=False)
            state = {
                "center": self.center.copy(),
                "version": int(self.version),
                "gen": int(self.gen),
                "dedup": self._dedup.state(),
                "membership": self._membership.state(),
                "shards": self._shards_state(),
                "ring": self._ring_state(),
            }
            self._updates_since_save = 0
        return state

    def _shards_state(self) -> Optional[list]:
        """Materialized shard ownership as ``[sid, start, end,
        shard_version]`` rows (None in legacy flat mode — the key is
        written either way so the snapshot schema has one shape)."""
        if self._shard_map is None:
            return None
        return [
            [int(sid), int(s), int(e), int(self.shard_versions.get(sid, 0))]
            for sid, s, e in self._owned
        ]

    def _ring_state(self) -> Optional[list]:
        if self._shard_map is None:
            return None
        return [
            int(self._shard_map.ring.version),
            list(self._shard_map.ring.members),
        ]

    def persist(self) -> None:
        """Atomically write the persistent snapshot (tmp + rename — a
        server killed mid-write leaves the previous snapshot intact).
        A ``.npy`` path keeps the legacy bare-center ``np.save`` format
        (ps_trainer's ``center_<rank>.npy`` resume contract); any other
        path gets the full shard snapshot, which is what elastic
        recovery restores from. Opened file handles keep ``np.save``
        from appending its own ``.npy``."""
        if self.ckpt_path is None:
            return
        if self.ckpt_path.endswith(".npy"):
            with self._lock:
                self._note("center", write=False)
                snap = self.center.copy()
                self._updates_since_save = 0
            tmp = self.ckpt_path + ".tmp"
            with open(tmp, "wb") as f:
                np.save(f, snap)
            os.replace(tmp, self.ckpt_path)
            return
        from mpit_tpu_torch.utils.checkpoint import save_shard_state

        save_shard_state(self.ckpt_path, self._snapshot_state())

    def _expire(self, last_seen: dict) -> None:
        now = time.monotonic()
        for r, seen in last_seen.items():
            if (
                r not in self._stopped
                and r not in self.dead_clients
                and now - seen > self.client_timeout
            ):
                self._note("membership")
                self.dead_clients.add(r)

    def snapshot(self) -> np.ndarray:
        with self._lock:
            self._note("center", write=False)
            return self.center.copy()


def spawn_server_thread(server: PServer) -> threading.Thread:
    def run():
        try:
            server.start()
        except BaseException:
            # already recorded in server.error by start(); swallowing here
            # keeps the thread exit clean (re-raising from a thread only
            # feeds the default excepthook noise) — direct/synchronous
            # server.start() callers still get the raise
            pass

    t = threading.Thread(target=run, daemon=True, name="mpit-pserver")
    t.start()
    return t
