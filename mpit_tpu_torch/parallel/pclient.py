"""pclient — worker-side stub for the host-async parameter server.

A copy of ``mpit_tpu/parallel/pclient.py``: numpy only, and its messages
are the reference's, so a port client and a reference server (or the
reverse) talk over one broker (``tests/test_torch_ps.py``).

Reference parity (SURVEY.md §2 comp. 4): the reference's ``pclient`` owned
the worker→server mapping, flattened the model (``getParameters()``), and
exposed async fetch/push used by goptim every τ steps. Same role here: it
splits the flat vector across the server partition (``partition_bounds``),
talks the tag protocol over ``mpit_tpu_torch.transport``, and leaves all
actual training math to the caller — compute stays on the card, only flat
numpy chunks cross the transport.

Fault tolerance (docs/ROBUSTNESS.md; the reference would simply hang):

- :meth:`fetch` retries with exponential backoff, and every FETCH carries
  a fresh *attempt id* that the server echoes in its PARAM reply — a
  stale reply belonging to a timed-out earlier attempt (or a
  chaos-duplicated one) is discarded instead of being mis-assembled into
  the wrong chunk slot.
- pushes carry an ``(epoch, seq, basis_version, chunk)`` envelope; the
  server's dedup window applies each (epoch, seq) exactly once, so send
  retries after a connection reset (and duplicated frames) can never
  double-apply. ``basis_version`` echoes the center version stamped
  into the last PARAM reply this client accepted from that server
  (``server_version``), which lets the server journal per-push
  staleness — the training-dynamics plane of docs/OBSERVABILITY.md.
- transient send failures (``ConnectionError``/``OSError``) are retried
  with the same backoff schedule before surfacing to the caller.
- a PARAM reply mangled on the wire (chaos ``corrupt``/``truncate``) is
  validated against the expected partition length and discarded
  (``corrupt_params_dropped``); the attempt's timeout then re-issues the
  FETCH — corruption degrades to the already-handled lost-reply case.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np

from mpit_tpu_torch.analysis.runtime import (
    active_checker as _rt_active,
    make_lock,
    note_residual_norm as _rt_residual,
)
from mpit_tpu_torch.parallel.pserver import (
    TAG_FETCH,
    TAG_HEARTBEAT,
    TAG_JOIN,
    TAG_LEAVE,
    TAG_PARAM,
    TAG_PUSH_DELTA,
    TAG_PUSH_EASGD,
    TAG_SHARD_MAP,
    TAG_STOP,
    partition_bounds,
)
from mpit_tpu_torch.transport import RecvTimeout, Transport
from mpit_tpu_torch.transport.wire import (
    QuantArray,
    dequantize,
    quant_mode_from_env,
    quantize,
)

# mpit-analysis: protocol-role[client->server]
# (the client side of the PS wire protocol — MPT008 pairs every send/recv
# here against the dispatch loop in pserver.py)


class PClient:
    """Client stub: fetch / push against a set of sharded pservers.

    ``server_ranks[s]`` owns flat chunk s of a ``param_size`` vector.

    ``heartbeat_interval``: when set, a daemon timer thread sends
    zero-payload HEARTBEATs to every server so the server watchdog
    (``PServer(client_timeout=...)``) doesn't declare this client dead
    during long local compute between exchanges. Stopped by :meth:`stop`.

    Retry knobs: ``timeout`` is the *per-attempt* PARAM wait;
    ``max_retries`` extra attempts follow the first, each preceded by an
    exponential backoff (``backoff_base * 2**k``, capped at
    ``backoff_max``). Worst-case fetch latency per server is therefore
    ``(max_retries + 1) * timeout`` plus the backoff sum.

    Accounting: ``push_sent[rank]`` counts chunks *successfully handed to
    the transport* per server — under fault injection that excludes
    resets (never delivered), so it is exactly the number the server
    should have applied (drops/blackholes excepted); the chaos acceptance
    test pins ``server.counts == client sends`` on it.
    """

    def __init__(
        self,
        transport: Transport,
        server_ranks: Sequence[int],
        param_size: int,
        timeout: Optional[float] = 60.0,
        heartbeat_interval: Optional[float] = None,
        max_retries: int = 3,
        backoff_base: float = 0.05,
        backoff_max: float = 2.0,
        quant: Optional[str] = None,
        shard_map=None,
    ):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        self.transport = transport
        self.server_ranks = list(server_ranks)
        self.param_size = int(param_size)
        # consistent-hash routing (docs/ROBUSTNESS.md "Shard ownership &
        # resharding"): with a ShardMap, chunk ownership comes from the
        # ring instead of positional partition_bounds, PARAM replies and
        # push envelopes carry per-shard parts, and a dead server is a
        # repair (reroute + fallback fill) instead of a lost round
        self._shard_map = shard_map
        # chunks repaired across reshards: every shard whose ownership
        # this client rerouted off a dead server (the re-offered chunks
        # land at the new owner next round instead of skipping it)
        self.repaired_chunks = 0
        # per-shard center versions from sharded PARAM replies — the
        # dynamics-plane staleness signal stays attributable per shard
        # even while ownership moves
        self.shard_versions: dict[int, int] = {}
        self._rank_shards: dict[int, list[tuple[int, int, int]]] = {}
        # guards the routing tables (server_ranks/ranks/_rank_chunks/...)
        # that `_repair_dead` rebuilds mid-run while the heartbeat thread
        # (and a supervising caller's stop/leave) iterate them
        self._route_lock = make_lock("PClient._route_lock")
        if shard_map is not None:
            if shard_map.param_size != self.param_size:
                raise ValueError(
                    f"shard_map covers {shard_map.param_size} params, "
                    f"client has {self.param_size}"
                )
            self.bounds = list(shard_map.layout)
            self._rank_chunks: dict[int, list[tuple[int, int]]] = {}
            self.ranks: list[int] = []
            self.rank_bounds: list[tuple[int, int]] = []
            self._build_ring_routing()
        else:
            self.bounds = partition_bounds(
                self.param_size, len(self.server_ranks)
            )
            # coalescing: a rank appearing k times in server_ranks owns k
            # chunks — group them per destination so each round sends ONE
            # message per distinct server (one framed scatter instead of
            # k sends, one FETCH/PARAM round trip instead of k). Adjacent
            # chunks merge into one contiguous slice; non-adjacent ones
            # (the common case under ring assignment) ride the same
            # message as separate slices.
            self.ranks = []
            self._rank_chunks = {}
            for rank, (start, end) in zip(self.server_ranks, self.bounds):
                chunks = self._rank_chunks.setdefault(rank, [])
                if rank not in self.ranks:
                    self.ranks.append(rank)
                if chunks and chunks[-1][1] == start:
                    chunks[-1] = (chunks[-1][0], end)
                else:
                    chunks.append((start, end))
            # bounding hull per rank, kept for observability/back-compat
            # (equals the merged chunk when a rank's slices are adjacent)
            self.rank_bounds = [
                (self._rank_chunks[r][0][0], self._rank_chunks[r][-1][1])
                for r in self.ranks
            ]
        if quant is None:
            quant = quant_mode_from_env()
        elif quant not in ("off", "bf16", "int8"):
            raise ValueError(f"quant must be off|bf16|int8, got {quant!r}")
        self.quant = quant
        # error feedback (EF/EF21 shape): the quantization residual of
        # each push is carried into the next one, so the quantizer's bias
        # cancels over rounds instead of accumulating into the center.
        # Keyed per (tag, rank): EASGD pushes params, Downpour pushes
        # deltas — different quantities, separate residual streams.
        self._residual: dict[tuple[int, int], np.ndarray] = {}
        self.timeout = timeout
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        # identity for the server-side dedup window: a replacement client
        # on a reused rank must not look like replays of its predecessor
        self._epoch = int.from_bytes(os.urandom(8), "big")
        # attempt ids are seeded from the epoch so a replacement process
        # on a reused rank can never match a PARAM reply parked in the
        # transport for its predecessor's attempt — same disjointness
        # the epoch gives the push dedup window, applied to fetches
        self._attempt_ids = itertools.count(((self._epoch & 0xFFFFFF) << 24) + 1)
        self._push_seq = itertools.count(1)
        self.push_sent: dict[int, int] = {r: 0 for r in self.server_ranks}
        # center version last seen per server (stamped into attempt-id'd
        # PARAM replies) — echoed as the fetch basis in push envelopes
        # so the server can attribute per-push staleness
        self.server_version: dict[int, int] = {}
        self.stale_params_dropped = 0
        self.corrupt_params_dropped = 0
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat_interval is not None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                args=(float(heartbeat_interval),),
                daemon=True,
                name="mpit-pclient-heartbeat",
            )
            self._hb_thread.start()

    def _heartbeat_loop(self, interval: float) -> None:
        while not self._hb_stop.wait(interval):
            with self._route_lock:
                targets = list(self.server_ranks)
            for rank in targets:
                try:
                    self.transport.send(rank, TAG_HEARTBEAT, None)
                except Exception:
                    # transient (e.g. a TCP blip mid-reconnect): liveness
                    # resumes next tick — one bad send must NOT silently
                    # kill the heartbeat and get a healthy client declared
                    # dead later. The interval bounds the retry rate; the
                    # thread exits only via stop().
                    pass

    # -- ring routing & repair --------------------------------------------

    def _build_ring_routing(self) -> None:
        """Derive per-server routing from the current shard map: which
        (sid, start, end) slices each live server owns, ascending. Also
        refreshes ``server_ranks``/``ranks`` so heartbeats, STOP/LEAVE
        fan-out, and scatters track the surviving membership."""
        sm = self._shard_map
        shards: dict[int, list[tuple[int, int, int]]] = {}
        for sid, (s, e) in enumerate(sm.layout):
            shards.setdefault(sm.assignment[sid], []).append((sid, s, e))
        with self._route_lock:
            self._rank_shards = {
                r: sorted(v, key=lambda t: t[1]) for r, v in shards.items()
            }
            self.ranks = sorted(self._rank_shards)
            self.server_ranks = list(self.ranks)
            self._rank_chunks = {
                r: [(s, e) for _, s, e in v]
                for r, v in self._rank_shards.items()
            }
            self.rank_bounds = [
                (self._rank_chunks[r][0][0], self._rank_chunks[r][-1][1])
                for r in self.ranks
            ]

    def _repair_dead(self, dead_rank: int) -> None:
        """Partial-scatter repair: reroute ownership off a dead server.

        The ring is deterministic, so every client that observes the
        same death derives the SAME successor view — the announcements
        they fan out to the survivors share a ring version, and the
        servers take the first one and idempotently ignore the rest.
        This client's next scatter re-offers the dead server's chunks
        to their new owners instead of skipping the round."""
        sm = self._shard_map
        if dead_rank not in sm.ring.members or len(sm.ring.members) <= 1:
            return
        new_ring = sm.ring.without(dead_rank)
        new_map = sm.with_ring(new_ring)
        moved = [
            sid
            for sid in range(sm.num_shards)
            if sm.assignment[sid] != new_map.assignment[sid]
        ]
        self._shard_map = new_map
        self._build_ring_routing()
        for r in self.ranks:
            self.push_sent.setdefault(r, 0)
        # quantization residuals are keyed per shard in ring mode, so
        # they survive the reroute; versions for moved shards restart at
        # the new owner's counter on the next fetch
        announce = (new_ring.version, list(new_ring.members))
        for r in list(self.ranks):
            try:
                self._send_with_retry(r, TAG_SHARD_MAP, announce)
            except (ConnectionError, OSError):
                # unreachable survivor: its own clients' repair rounds
                # (or ours, next fetch) re-announce the same view
                pass
        self.repaired_chunks += len(moved)
        self._journal(
            "reshard_repair", dead=dead_rank, view=new_ring.version,
            moved=len(moved),
        )

    def _journal(self, ev: str, **fields) -> None:
        """Dynamics-plane journal record via the transport's obs tracer
        (no-op unless obs-wrapped with journaling on — the same
        disabled-cost contract as the server's `_journal_dynamics`)."""
        tracer = getattr(self.transport, "obs_tracer", None)
        if tracer is None or tracer.journal is None:
            return
        tracer.journal.event(ev, tracer.clock.tick(), **fields)

    # -- retry plumbing ---------------------------------------------------

    def _backoff(self, attempt: int) -> None:
        time.sleep(min(self.backoff_base * (2 ** attempt), self.backoff_max))

    def _send_with_retry(self, rank: int, tag: int, payload) -> None:
        """Send, absorbing up to ``max_retries`` transient transport
        failures with backoff. Safe for at-most-once payloads only when
        the receiver deduplicates (push envelopes) or the message is
        idempotent (FETCH, STOP)."""
        for attempt in range(self.max_retries + 1):
            try:
                self.transport.send(rank, tag, payload)
                return
            except (ConnectionError, OSError):
                if attempt == self.max_retries:
                    raise
                self._backoff(attempt)

    def _send_fetch(self, rank: int) -> int:
        attempt_id = next(self._attempt_ids)
        self.transport.send(rank, TAG_FETCH, attempt_id)
        return attempt_id

    def _send_join(self, rank: int) -> int:
        attempt_id = next(self._attempt_ids)
        self.transport.send(rank, TAG_JOIN, (attempt_id, self._epoch))
        return attempt_id

    def _chunk_ok(self, chunk, expected: int) -> Optional[np.ndarray]:
        """float32 view of a PARAM chunk, or None when the reply is
        malformed (chaos ``corrupt`` replaced the frame, ``truncate`` cut
        the array short, or the shape just doesn't match this server's
        partition). Accepts, beyond a bare ndarray: a quantized
        :class:`QuantArray` (dequantized here) and a multi-chunk reply —
        a list of ndarray/QuantArray parts that concatenate to this
        server's merged partition (a sharded server answering one
        coalesced FETCH with its per-shard chunks in one message)."""
        try:
            if isinstance(chunk, QuantArray):
                arr = dequantize(chunk)
            elif isinstance(chunk, list):
                if not chunk:
                    return None
                arr = np.concatenate([
                    dequantize(p) if isinstance(p, QuantArray)
                    else np.asarray(p, dtype=np.float32)
                    for p in chunk
                ])
            else:
                arr = np.asarray(chunk, dtype=np.float32)
            arr = np.asarray(arr, dtype=np.float32)
        except (TypeError, ValueError):
            return None
        if arr.shape != (expected,):
            return None
        return arr

    def _parts_ok(self, chunk) -> Optional[list]:
        """``[(sid, shard_version, arr)]`` from a sharded PARAM reply,
        or None when malformed. Each part is validated against its
        static layout slot — placement never depends on the sender's
        ring view, so a reply stays interpretable even when ownership
        moved under us (the server replies with everything it owns; we
        take whatever arrives, wherever the layout says it lives)."""
        if not isinstance(chunk, list) or not chunk:
            return None
        out = []
        layout = self._shard_map.layout
        num_shards = self._shard_map.num_shards
        for part in chunk:
            if not (
                isinstance(part, (tuple, list))
                and len(part) == 3
                and isinstance(part[0], int)
            ):
                return None
            sid, ver, arr = part
            if not (0 <= sid < num_shards):
                return None
            try:
                if isinstance(arr, QuantArray):
                    arr = dequantize(arr)
                # wire payloads are host numpy (msgpack-decoded), never
                # device arrays — no host sync happens here
                a = np.asarray(arr, dtype=np.float32)  # mpit-analysis: ignore[MPT005]
            except (TypeError, ValueError):
                return None
            s, e = layout[sid]
            if a.shape != (e - s,):
                return None
            out.append((sid, ver if isinstance(ver, int) else 0, a))
        return out

    def _accept_chunk(self, chunk, expected: Optional[int]):
        """Validate a PARAM body: ``expected=None`` means a sharded
        parts reply, an int the legacy contiguous chunk of that size."""
        if expected is None:
            return self._parts_ok(chunk)
        return self._chunk_ok(chunk, expected)

    def _await_param(
        self, rank: int, attempt_id: Optional[int], expected: int,
        resend=None,
    ) -> np.ndarray:
        """Collect one server's PARAM chunk, retrying the whole
        FETCH→PARAM attempt on timeout or send failure. Replies tagged
        with an attempt id other than the live one are stale — consumed
        and discarded so they can never be assembled into this (or a
        later) fetch. Malformed replies (chaos corrupt/truncate) are
        likewise discarded — the wait continues and the per-attempt
        timeout re-issues the FETCH, so a mangled reply is a retriable
        failure, never a crash or a junk-assembled vector."""
        if resend is None:
            resend = self._send_fetch
        last_exc: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if attempt > 0:
                self._backoff(attempt - 1)
            if attempt_id is None:  # (re)issue this attempt's request
                try:
                    attempt_id = resend(rank)
                except (ConnectionError, OSError) as e:
                    last_exc = e
                    continue
            deadline = (
                None if self.timeout is None
                else time.monotonic() + self.timeout
            )
            while True:
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    last_exc = RecvTimeout(
                        f"PARAM from server {rank} not received within "
                        f"{self.timeout}s (attempt {attempt + 1})"
                    )
                    break
                try:
                    msg = self.transport.recv(
                        rank, TAG_PARAM, timeout=remaining
                    )
                except RecvTimeout as e:
                    last_exc = e
                    break
                payload = msg.payload
                if isinstance(payload, tuple) and len(payload) == 3:
                    # versioned reply (attempt_id, version, chunk) — the
                    # only shape today's server emits for id'd fetches
                    got_id, version, chunk = payload
                    if got_id != attempt_id:
                        self.stale_params_dropped += 1
                        continue  # a timed-out attempt's late reply
                    arr = self._accept_chunk(chunk, expected)
                    if arr is None:
                        # mangled on the wire: keep waiting; the timeout
                        # re-fetches (the server won't resend on its own)
                        self.corrupt_params_dropped += 1
                        continue
                    if isinstance(version, int):
                        # basis for this client's next push envelopes; a
                        # chaos-mangled non-int version just leaves the
                        # previous basis in place (staleness degrades to
                        # an overestimate, never a crash)
                        self.server_version[rank] = version
                    return arr
                if isinstance(payload, tuple) and len(payload) == 2:
                    # pre-version (attempt_id, chunk) reply — kept for
                    # hand-rolled protocol tests and mixed-version runs
                    got_id, chunk = payload
                    if got_id != attempt_id:
                        self.stale_params_dropped += 1
                        continue
                    arr = self._accept_chunk(chunk, expected)
                    if arr is None:
                        self.corrupt_params_dropped += 1
                        continue
                    return arr
                arr = self._accept_chunk(payload, expected)  # legacy un-id'd
                if arr is None:
                    self.corrupt_params_dropped += 1
                    continue
                return arr
            attempt_id = None  # attempt dead: the next one re-sends
        raise RecvTimeout(
            f"fetch from server {rank} failed after "
            f"{self.max_retries + 1} attempts"
        ) from last_exc

    # -- protocol ---------------------------------------------------------

    def fetch(self, fallback: Optional[np.ndarray] = None) -> np.ndarray:
        """Gather the full flat center from all servers (async fan-out:
        request every chunk before waiting on any — the reference's
        ``async_fetch_param`` shape, SURVEY.md §3(b)); per-server
        retry-with-backoff on timeout, attempt-id'd against stale
        replies.

        ``fallback`` (ring mode): the client's local flat params. When a
        server is declared dead mid-fetch, its shards are rerouted on
        the ring (partial-scatter repair) and any still-unsatisfied
        slice is filled from ``fallback`` for THIS round only — the next
        round fetches it from the new owner. Without a fallback a dead
        server raises, as in legacy mode."""
        return self._gather(self._send_fetch, fallback)

    def join(self, fallback: Optional[np.ndarray] = None) -> np.ndarray:
        """Announce this client's (rank, epoch) to every server and
        gather the full flat center — the elastic-membership entry
        point (docs/ROBUSTNESS.md). Same fan-out/retry/attempt-id shape
        as :meth:`fetch`, but the JOIN envelope also registers this
        process's push-identity epoch with the server's membership
        view: a fresh process on a reused rank is recorded as a
        "replace" (clean dedup slot, dead flag cleared), a reconnecting
        preempted one as a "rejoin" — instead of being mistaken for a
        replay of its predecessor."""
        return self._gather(self._send_join, fallback)

    def _gather(self, resend, fallback: Optional[np.ndarray]) -> np.ndarray:
        attempts: dict[int, Optional[int]] = {}
        for rank in list(self.ranks):
            try:
                attempts[rank] = resend(rank)
            except (ConnectionError, OSError):
                attempts[rank] = None  # the retry path re-sends
        out = np.empty(self.param_size, np.float32)
        if self._shard_map is None:
            for rank in self.ranks:
                chunks = self._rank_chunks[rank]
                total = sum(e - s for s, e in chunks)
                arr = self._await_param(
                    rank, attempts[rank], total, resend=resend
                )
                # split the coalesced reply back across this rank's
                # slices, ascending — the inverse of the scatter order
                off = 0
                for s, e in chunks:
                    out[s:e] = arr[off:off + (e - s)]
                    off += e - s
            return out
        # ring mode: parts replies carry (sid, version, slice); place by
        # the static layout, then repair around any dead server
        filled: set[int] = set()
        dead: list[int] = []
        for rank in list(self.ranks):
            try:
                parts = self._await_param(
                    rank, attempts.get(rank), None, resend=resend
                )
            except RecvTimeout:
                if fallback is None:
                    raise
                dead.append(rank)
                continue
            for sid, ver, arr in parts:
                s, e = self._shard_map.layout[sid]
                out[s:e] = arr
                filled.add(sid)
                self.shard_versions[sid] = ver
        for rank in dead:
            self._repair_dead(rank)
        missing = [
            sid
            for sid in range(self._shard_map.num_shards)
            if sid not in filled
        ]
        if missing:
            if fallback is None:
                raise RecvTimeout(
                    f"shards {missing} unavailable and no fallback given"
                )
            fb = np.asarray(fallback, np.float32)
            for sid in missing:
                s, e = self._shard_map.layout[sid]
                out[s:e] = fb[s:e]
        return out

    def push_easgd(self, flat_params: np.ndarray) -> None:
        """Push local params; each server does its elastic center move."""
        self._scatter(TAG_PUSH_EASGD, flat_params)

    def push_delta(self, flat_delta: np.ndarray) -> None:
        """Push an accumulated update (Downpour grad/delta apply)."""
        self._scatter(TAG_PUSH_DELTA, flat_delta)

    def stop(self) -> None:
        """Detach from every server (teardown protocol, SURVEY.md §3(e)).

        Attempts ALL servers even when some sends fail — skipping the
        rest would leave healthy servers waiting for a STOP that never
        comes (until their watchdog fires). Errors are collected and
        re-raised as one aggregate at the end."""
        self._shutdown_heartbeat()
        self._detach_all(TAG_STOP, "STOP")

    def leave(self) -> None:
        """Planned departure (preemption notice): tell every server this
        rank is going away WITHOUT counting as a normal STOP — the
        membership view moves it to ``left`` immediately instead of
        waiting for the watchdog to declare it dead. Same all-servers /
        aggregate-errors contract as :meth:`stop`."""
        self._shutdown_heartbeat()
        self._detach_all(TAG_LEAVE, "LEAVE")

    def _shutdown_heartbeat(self) -> None:
        """Signal and join the heartbeat timer thread; idempotent so
        stop()/leave() can be called more than once (or after each
        other) without a second join on a dead thread."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None

    def _detach_all(self, tag: int, what: str) -> None:
        errors: list[tuple[int, BaseException]] = []
        with self._route_lock:
            targets = list(self.server_ranks)
        for rank in targets:
            try:
                self._send_with_retry(rank, tag, None)
            except Exception as e:
                errors.append((rank, e))
        if errors:
            raise RuntimeError(
                f"{what} failed for server rank(s) "
                f"{[r for r, _ in errors]}: "
                f"{'; '.join(repr(e) for _, e in errors)}"
            ) from errors[0][1]

    def _scatter(self, tag: int, flat: np.ndarray) -> None:
        flat = np.asarray(flat, np.float32)
        if flat.shape != (self.param_size,):
            raise ValueError(
                f"flat vector shape {flat.shape} != ({self.param_size},)"
            )
        # one seq per logical push: every server's chunk shares it, and a
        # send retry re-offers the same (epoch, seq) — the server window
        # turns at-least-once delivery into exactly-once application.
        # Each chunk carries that server's last-fetched center version
        # as its staleness basis (0 = never fetched a versioned reply).
        seq = next(self._push_seq)
        # RT104 boundedness probe: one norm per EF-residual update when
        # the numerics sanitizer is armed, zero host work otherwise
        rt_checker = _rt_active()
        rt_numerics = rt_checker is not None and getattr(
            rt_checker, "numerics", False
        )
        if self._shard_map is not None:
            # ring mode: one envelope per live server carrying its
            # (sid, chunk) parts — after a repair the re-offered shards
            # simply route to their new owner under the same seq
            # discipline. Residuals are keyed per shard so error
            # feedback survives ownership moves.
            for rank in list(self.ranks):
                parts = []
                for sid, s, e in self._rank_shards[rank]:
                    chunk = flat[s:e]
                    if self.quant != "off":
                        key = (tag, sid)
                        res = self._residual.get(key)
                        comp = chunk if res is None else chunk + res
                        q = quantize(comp, self.quant)
                        new_res = comp - dequantize(q)
                        self._residual[key] = new_res
                        if rt_numerics:
                            _rt_residual(
                                f"pclient.ef[{tag}:{sid}]",
                                # host numpy, sanitizer-gated — no
                                # device sync happens here
                                float(np.linalg.norm(new_res)),  # mpit-analysis: ignore[MPT005]
                            )
                        parts.append((sid, q))
                    else:
                        parts.append((sid, chunk))
                self._send_with_retry(
                    rank, tag,
                    (
                        self._epoch, seq,
                        self.server_version.get(rank, 0),
                        parts,
                    ),
                )
                self.push_sent[rank] = self.push_sent.get(rank, 0) + 1
            return
        for rank in self.ranks:
            pieces = [flat[s:e] for s, e in self._rank_chunks[rank]]
            chunk = pieces[0] if len(pieces) == 1 else np.concatenate(pieces)
            if self.quant != "off":
                # error feedback: compensate this push with the residual
                # the previous quantized push left behind, then carry the
                # new residual forward — the bias cancels over rounds.
                # The residual is folded in BEFORE send-retry, so a
                # retried (deduplicated) send re-offers identical bytes.
                key = (tag, rank)
                res = self._residual.get(key)
                comp = chunk if res is None else chunk + res
                q = quantize(comp, self.quant)
                new_res = comp - dequantize(q)
                self._residual[key] = new_res
                if rt_numerics:
                    _rt_residual(
                        f"pclient.ef[{tag}:{rank}]",
                        # host numpy, sanitizer-gated — no device sync
                        float(np.linalg.norm(new_res)),  # mpit-analysis: ignore[MPT005]
                    )
                payload_chunk = q
            else:
                payload_chunk = chunk
            self._send_with_retry(
                rank, tag,
                (
                    self._epoch, seq,
                    self.server_version.get(rank, 0),
                    payload_chunk,
                ),
            )
            self.push_sent[rank] += 1
