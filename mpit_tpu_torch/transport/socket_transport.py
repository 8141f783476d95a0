"""TCP transport: ranks are processes, tagged delivery over sockets.

A copy of ``mpit_tpu/transport/socket_transport.py``, wire-compatible with
it in both directions: a port rank and a reference rank negotiate, frame
and fall back to pickle with each other as two ranks of one package do
(``tests/test_torch_socket.py``). Pickles are read with
:func:`mpit_tpu_torch.transport.wire.loads`, which maps the reference's
``QuantArray`` and ``CorruptedPayload`` to the port's classes.

The control plane for the host-async PS mode across processes and hosts
(the reference's multi-node MPI case, SURVEY.md §2 distributed-backend row):
the PS protocol's tagged messages, as in process mode
(``python -m mpit_tpu_torch.launch``).

Wire format: 8-byte big-endian length prefix, then ONE of two frame bodies,
distinguished per-frame by the first two bytes:

* **framed** (``transport/wire.py``, magic ``b"MW"``): a CRC-guarded binary
  header (src, tag, envelope scalars, dtype/shape) followed by raw ndarray
  bytes. The sender builds the frame from ``memoryview``s of the arrays —
  no copy, no pickle — and writes it with vectorized ``sendmsg``; the
  receiver reads the array bytes straight into a preallocated buffer with
  ``recv_into`` and wraps it zero-copy. Every frame writer must pin
  ``WIRE_FORMAT_VERSION`` by name (lint rule MPT007).
* **pickle** (``WIRE_PICKLE_PROTOCOL``, the canonical pin every pickle wire
  writer must name — lint rule MPT007) of (src, tag, payload). Pickle
  protocol ≥2 streams start ``b"\\x80"``, which can never collide with the
  framed magic. This is the fallback for payloads the binary codec cannot
  express and for mixed-version peers.

Negotiation: the *receiver* advertises — every accepted connection gets a
4-byte HELLO carrying the receiver's framed-format version before any
frames flow. The sender reads it (with a short timeout) right after
connect; no HELLO ⇒ pickle-only peer. Legacy receivers never send HELLO
(so new senders fall back), and legacy senders never read their outbound
socket (so the unread HELLO is harmless) — both mixed pairings keep
working. ``MPIT_WIRE_NEGOTIATE=0`` makes this transport behave like such a
legacy peer (no HELLO sent or awaited, pickle only).

Reconnect semantics: TCP gives FIFO within one connection; across a sender
reconnect, a straggler frame from the old connection could otherwise be
enqueued *after* frames of the new one and break per-(src,tag) FIFO. The
receiver therefore orders connections by accept sequence and, once a frame
from a src arrives on a newer connection, drops late frames from that src's
older connections — order is preserved at the cost of dropping stragglers,
which matches MPI's model (a broken connection loses in-flight traffic; a
dead rank is fatal, SURVEY.md §5 failure-detection row) rather than silently
reordering. The fence is entirely receiver-side accept ordering, so a fully
*restarted* sender (fresh transport object) keeps working — its new
connection is by construction newer than any it had before.

Rendezvous: ``MPIT_TRANSPORT_HOSTS="host0:port0,host1:port1,..."`` (index =
rank), or ``addresses=`` in the constructor; defaults to
``127.0.0.1:(base_port+rank)`` for single-host multi-process runs.
"""

from __future__ import annotations

import collections
import errno
import os
import pickle
import socket
import struct
import threading
import time
from typing import Any, Optional, Sequence

from mpit_tpu_torch.analysis.runtime import make_condition, make_lock
from mpit_tpu_torch.transport import wire
from mpit_tpu_torch.transport.base import (
    ANY_SOURCE,
    ANY_TAG,
    CorruptedPayload,
    Message,
    SendHandle,
    Transport,
)
from mpit_tpu_torch.transport.inproc import Broker
from mpit_tpu_torch.transport.wire import WIRE_FORMAT_VERSION

_LEN = struct.Struct(">Q")

# The wire's ONE pickle protocol. Readers auto-detect (the id is embedded
# in the stream), but every WRITER must pin this — an unpinned dumps rides
# the interpreter default, which moves across Python versions, and a
# mixed-version peer then sees unparseable frames on an otherwise healthy
# socket. Every dumps feeding a frame (here and in mpit_tpu_torch/native) must
# name this constant; the MPT007 lint rule enforces exactly that.
WIRE_PICKLE_PROTOCOL = 5

# sendmsg iovec count is bounded by IOV_MAX (1024 on Linux); a coalesced
# scatter frame stays far below this, but cap defensively anyway
_SENDMSG_MAX_BUFFERS = 512


def _addresses(size: int, base_port: int) -> list[tuple[str, int]]:
    env = os.environ.get("MPIT_TRANSPORT_HOSTS")
    if env:
        out = []
        for part in env.split(","):
            host, port = part.rsplit(":", 1)
            out.append((host, int(port)))
        if len(out) != size:
            raise ValueError(
                f"MPIT_TRANSPORT_HOSTS has {len(out)} entries, need {size}"
            )
        return out
    return [("127.0.0.1", base_port + r) for r in range(size)]


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _recv_into_exact(sock: socket.socket, buf: bytearray) -> None:
    """Fill ``buf`` completely from the socket — the zero-copy receive:
    bytes land directly in the buffer the decoded arrays will view."""
    view = memoryview(buf)
    got = 0
    while got < len(buf):
        n = sock.recv_into(view[got:])
        if n == 0:
            raise ConnectionError("peer closed")
        got += n


def _drain_exact(sock: socket.socket, n: int) -> None:
    """Consume and discard n bytes (skip the rest of an undecodable frame
    so the length-prefixed stream stays in sync)."""
    left = n
    while left > 0:
        chunk = sock.recv(min(left, 65536))
        if not chunk:
            raise ConnectionError("peer closed")
        left -= len(chunk)


class _OutMessage:
    """One queued outbound message, format-deferred.

    The framed buffers are built eagerly at isend time (zero-copy: they
    alias the caller's arrays, which MPI buffer semantics say are frozen
    until the send completes) — but whether the *framed* or *pickle* bytes
    actually hit the socket is decided by the drainer, after negotiation
    has revealed what the peer speaks. The pickle frame is built lazily and
    cached so an evict-retry does not re-serialize."""

    __slots__ = ("src", "tag", "payload", "buffers", "_pickled")

    def __init__(self, src: int, tag: int, payload: Any, buffers):
        self.src = src
        self.tag = tag
        self.payload = payload
        self.buffers = buffers  # list of buffers, or None (unencodable)
        self._pickled: Optional[bytes] = None

    def pickle_frame(self) -> bytes:
        if self._pickled is None:
            blob = pickle.dumps(
                wire.to_reference_names((self.src, self.tag, self.payload)),
                protocol=WIRE_PICKLE_PROTOCOL,
            )
            self._pickled = _LEN.pack(len(blob)) + blob
        return self._pickled

    def framed_buffers(self) -> list:
        """Length-prefixed buffer list for sendmsg. The prefix is fused
        onto the (small) header buffer; the array views ride untouched."""
        total = wire.frame_nbytes(self.buffers)
        return [_LEN.pack(total) + self.buffers[0], *self.buffers[1:]]


class SocketTransport(Transport):
    def __init__(
        self,
        rank: int,
        size: int,
        base_port: int = 29_500,
        addresses: Optional[Sequence[tuple[str, int]]] = None,
        connect_retry_s: float = 30.0,
        wire_format: Optional[str] = None,
    ):
        """``connect_retry_s``: window during which a refused outbound
        connection is retried — under a process launcher the peers come up
        at different times (mpirun gave the reference this for free).
        ``wire_format``: "framed" (default) or "pickle"; None reads
        ``MPIT_WIRE_FORMAT``."""
        self.rank = rank
        self.size = size
        self.connect_retry_s = float(connect_retry_s)
        self._addrs = (
            list(addresses) if addresses is not None else _addresses(size, base_port)
        )
        if wire_format is None:
            wire_format = wire.wire_format_from_env()
        elif wire_format not in ("framed", "pickle"):
            raise ValueError(f"wire_format must be framed|pickle, got {wire_format!r}")
        self._wire_format = wire_format
        self._negotiate = wire.negotiate_enabled_from_env()
        self._hello_timeout = wire.negotiate_timeout_from_env()
        # per-dst negotiation outcome: True once the peer's HELLO proved it
        # decodes framed; absent/False ⇒ pickle only
        self._peer_framed: dict[int, bool] = {}
        # local mailbox reuses the broker's matching logic (1 "rank" = me)
        self._mailbox = Broker(1)
        # reconnect fencing: newest accept-ordered connection seq per src
        self._accept_seq = 0
        self._src_seq: dict[int, int] = {}
        self._src_seq_lock = make_lock("SocketTransport._src_seq_lock")
        self._out: dict[int, socket.socket] = {}
        self._out_cache_lock = make_lock(
            "SocketTransport._out_cache_lock"
        )  # guards the dict only
        # per-destination lock: a slow connect/send to one rank must not
        # serialize traffic to healthy ranks
        self._dst_locks: dict[int, Any] = {}
        # per-destination outbound queues drained by lazily-created sender
        # threads: isend returns immediately, and because send() rides the
        # same queue, send/isend to one dst stay FIFO (the MPI order rule)
        self._send_queues: dict[int, "_SendQueue"] = {}
        # inbound wire-phase accounting per (src, tag): body-transfer and
        # deserialize seconds (the header wait is idle between messages and
        # deliberately NOT counted). Harvested by obs telemetry summaries.
        self._rx_phases: dict[tuple[int, int], dict] = {}
        self._rx_lock = make_lock("SocketTransport._rx_lock")
        # exact on-wire byte totals (length prefixes included), both
        # directions — ground truth the obs summaries are asserted against
        self._tx_wire_bytes = 0
        self._rx_wire_bytes = 0
        self._rx_corrupt_dropped = 0
        self._byte_lock = make_lock("SocketTransport._byte_lock")
        self._closing = threading.Event()

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._listener.bind(self._addrs[rank])
        except OSError as e:
            raise OSError(
                f"rank {rank}: cannot bind {self._addrs[rank]} ({e}). "
                "If launched via mpit_tpu_torch.launch, another process likely "
                "took the port between reservation and startup — relaunch."
            ) from e
        self._listener.listen(size)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept_thread.start()

    # -- wire -------------------------------------------------------------

    def _accept_loop(self):
        while not self._closing.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            if self._negotiate:
                # receiver-advertises: tell the peer what we decode before
                # any frames flow (legacy receivers skip this, so a new
                # sender's HELLO wait times out ⇒ pickle fallback)
                try:
                    conn.sendall(wire.encode_hello())
                except OSError:
                    try:
                        conn.close()
                    except OSError:
                        pass
                    continue
            with self._src_seq_lock:
                self._accept_seq += 1
                seq = self._accept_seq
            threading.Thread(
                target=self._read_loop, args=(conn, seq), daemon=True
            ).start()

    def _read_loop(self, conn: socket.socket, seq: int):
        try:
            while not self._closing.is_set():
                # phase split: the header wait is inter-message idle (the
                # reader blocks here between frames) and is NOT a phase;
                # body streaming is payload-transfer, decode is deserialize
                (length,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
                t_h = time.perf_counter()
                msg = self._read_body(conn, length)
                with self._byte_lock:
                    self._rx_wire_bytes += _LEN.size + length
                if msg is None:
                    continue
                src, tag, payload, t_b, t_d = msg
                with self._rx_lock:
                    d = self._rx_phases.get((src, tag))
                    if d is None:
                        d = self._rx_phases[(src, tag)] = {
                            "transfer": 0.0, "deserialize": 0.0, "msgs": 0,
                        }
                    d["transfer"] += t_b - t_h
                    d["deserialize"] += t_d - t_b
                    d["msgs"] += 1
                with self._src_seq_lock:
                    latest = self._src_seq.get(src, 0)
                    if seq < latest:
                        continue  # straggler from before src's reconnect
                    self._src_seq[src] = seq
                self._mailbox.put(
                    Message(
                        src=src,
                        dst=0,
                        tag=tag,
                        payload=payload,
                        wire_nbytes=_LEN.size + length,
                    )
                )
        except (ConnectionError, OSError):
            return

    def _read_body(self, conn: socket.socket, length: int):
        """Read one frame body of ``length`` bytes; dispatch on magic.

        Returns (src, tag, payload, t_body_done, t_decode_done), or None
        for an undecodable framed body that was consumed and counted but
        yielded nothing deliverable (stream coordinates unknown)."""
        if length < wire.PREAMBLE_SIZE:
            body = _recv_exact(conn, length)
            t_b = time.perf_counter()
            src, tag, payload = wire.loads(body)
            return src, tag, payload, t_b, time.perf_counter()
        head = _recv_exact(conn, wire.PREAMBLE_SIZE)
        if head[:2] != wire.MAGIC:
            body = head + _recv_exact(conn, length - wire.PREAMBLE_SIZE)
            t_b = time.perf_counter()
            src, tag, payload = wire.loads(body)
            return src, tag, payload, t_b, time.perf_counter()
        consumed = wire.PREAMBLE_SIZE
        try:
            _version, flags, hlen, hcrc = wire.split_preamble(head)
            if wire.PREAMBLE_SIZE + hlen > length:
                raise wire.WireDecodeError("header length exceeds frame")
            header = _recv_exact(conn, hlen)
            consumed += hlen
            body = bytearray(length - consumed)
            _recv_into_exact(conn, body)
            consumed = length
            t_b = time.perf_counter()
            src, tag, payload = wire.decode_frame(flags, hcrc, header, body)
            return src, tag, payload, t_b, time.perf_counter()
        except wire.WireDecodeError as e:
            # a corrupted frame degrades exactly like a chaos `corrupt`
            # fault: deliver a CorruptedPayload marker so the receiving
            # role's malformed_dropped path absorbs it. Skip the rest of
            # the frame first — the stream must stay length-synced.
            if consumed < length:
                _drain_exact(conn, length - consumed)
            with self._byte_lock:
                self._rx_corrupt_dropped += 1
            t_b = time.perf_counter()
            src = e.src if e.src is not None else -1
            tag = e.tag if e.tag is not None else -1
            return src, tag, CorruptedPayload(src=src, tag=tag), t_b, t_b

    def _dst_lock(self, dst: int):
        with self._out_cache_lock:
            lock = self._dst_locks.get(dst)
            if lock is None:
                lock = self._dst_locks[dst] = make_lock(
                    f"SocketTransport._dst_locks[{dst}]"
                )
            return lock

    def _connection(self, dst: int) -> socket.socket:
        """Cached outbound socket; caller must hold the dst lock."""
        with self._out_cache_lock:
            sock = self._out.get(dst)
        if sock is None:
            sock = self._connect_with_retry(dst)
            framed_peer = False
            if self._wire_format == "framed" and self._negotiate:
                framed_peer = self._await_hello(sock)
            # back to blocking mode: a mid-frame timeout would desync the
            # length-prefixed stream for every later frame
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._out_cache_lock:
                self._out[dst] = sock
                self._peer_framed[dst] = framed_peer
        return sock

    def _await_hello(self, sock: socket.socket) -> bool:
        """Read the receiver's HELLO off a fresh outbound connection. A
        legacy peer sends nothing — the timeout is the negative signal —
        and nothing else ever arrives on this socket (frames only flow
        inbound→listener), so the read cannot swallow real traffic."""
        try:
            sock.settimeout(self._hello_timeout)
            data = _recv_exact(sock, wire.HELLO_SIZE)
        except (ConnectionError, OSError):
            return False
        peer_version = wire.decode_hello(data)
        return peer_version is not None and peer_version >= 1

    # transient connect failures retried within the window alongside a
    # clean refusal: real cross-host startup skew surfaces as timeouts and
    # unreachable-host/network errors while routes and peers come up,
    # not only as ECONNREFUSED
    _TRANSIENT_CONNECT_ERRNOS = frozenset(
        {errno.ETIMEDOUT, errno.EHOSTUNREACH, errno.ENETUNREACH}
    )

    def _connect_with_retry(self, dst: int) -> socket.socket:
        import time as _time

        deadline = _time.monotonic() + self.connect_retry_s
        while True:
            try:
                return socket.create_connection(self._addrs[dst], timeout=30)
            except OSError as e:
                transient = (
                    isinstance(e, (ConnectionRefusedError, TimeoutError))
                    or e.errno in self._TRANSIENT_CONNECT_ERRNOS
                )
                if (
                    not transient
                    or _time.monotonic() >= deadline
                    or self._closing.is_set()
                ):
                    raise
                _time.sleep(0.1)  # peer not reachable yet (startup skew)

    def _evict(self, dst: int) -> None:
        with self._out_cache_lock:
            sock = self._out.pop(dst, None)
            self._peer_framed.pop(dst, None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def _write_frame(self, dst: int, frame: bytes) -> None:
        """Write pre-serialized pickle bytes (legacy entry point)."""
        with self._dst_lock(dst):
            try:
                self._connection(dst).sendall(frame)
            except (ConnectionError, OSError):
                # stale cached socket (peer restarted): reconnect once. The
                # receiver's accept-order fence drops any stragglers still in
                # flight on the old connection. Whole-frame retry is safe —
                # the reader discards a connection on any partial frame.
                self._evict(dst)
                self._connection(dst).sendall(frame)
        with self._byte_lock:
            self._tx_wire_bytes += len(frame)

    def _write_msg(self, dst: int, item: _OutMessage) -> int:
        """Write one queued message in the best format the peer speaks;
        returns exact bytes written. Called only from the dst's drainer."""
        with self._dst_lock(dst):
            try:
                self._connection(dst)  # negotiates on a fresh connect
                n = self._send_item(dst, item)
            except (ConnectionError, OSError):
                # stale cached socket (peer restarted): reconnect once,
                # re-negotiating. Whole-message resend is safe — the
                # receiver discards a connection on any partial frame, and
                # the accept-order fence drops old-connection stragglers.
                self._evict(dst)
                self._connection(dst)
                n = self._send_item(dst, item)
        with self._byte_lock:
            self._tx_wire_bytes += n
        return n

    def _send_item(self, dst: int, item: _OutMessage) -> int:
        # under the dst lock the cached entries are stable, but the DICTS
        # are shared with close()/other drainers — reads take the cache
        # lock like every other access
        with self._out_cache_lock:
            sock = self._out[dst]
            peer_framed = self._peer_framed.get(dst)
        if item.buffers is not None and peer_framed:
            return self._sendmsg_all(sock, item.framed_buffers())
        frame = item.pickle_frame()
        sock.sendall(frame)
        return len(frame)

    @staticmethod
    def _sendmsg_all(sock: socket.socket, buffers: list) -> int:
        """Vectorized write of the framed buffer list (writev semantics):
        the kernel gathers header bytes + raw array views in one syscall
        per batch — the arrays are never copied into a Python-level frame."""
        bufs = [
            b if isinstance(b, memoryview) else memoryview(b) for b in buffers
        ]
        total = sum(b.nbytes for b in bufs)
        if not hasattr(sock, "sendmsg"):  # exotic platform fallback
            for b in bufs:
                sock.sendall(b)
            return total
        while bufs:
            sent = sock.sendmsg(bufs[:_SENDMSG_MAX_BUFFERS])
            while bufs and sent >= bufs[0].nbytes:
                sent -= bufs[0].nbytes
                bufs.pop(0)
            if bufs and sent:
                bufs[0] = bufs[0][sent:]  # partial write: advance in place
        return total

    def _send_queue(self, dst: int) -> "_SendQueue":
        with self._out_cache_lock:
            q = self._send_queues.get(dst)
            if q is None:
                q = self._send_queues[dst] = _SendQueue(self, dst)
            return q

    # -- Transport API ----------------------------------------------------

    def send(self, dst: int, tag: int, payload: Any) -> None:
        self.isend(dst, tag, payload).wait()

    def isend(self, dst: int, tag: int, payload: Any) -> SendHandle:
        """Genuinely asynchronous: the frame (captured NOW — per MPI buffer
        semantics the payload must not be mutated until the send completes)
        is handed to the dst's sender thread; the handle completes when it
        is written, with its ``phases`` split (serialize / queue_wait /
        write) and exact ``wire_nbytes`` stamped. Framed encoding is
        zero-copy (the buffers alias the payload's arrays); payloads the
        codec cannot express — and all traffic to pickle-only peers — ride
        the pickle fallback."""
        t0 = time.perf_counter()
        buffers = None
        if self._wire_format == "framed":
            buffers = wire.encode_frame(
                self.rank, tag, payload, version=WIRE_FORMAT_VERSION
            )
        item = _OutMessage(self.rank, tag, payload, buffers)
        serialize_s = time.perf_counter() - t0
        return self._send_queue(dst).enqueue(item, serialize_s=serialize_s)

    def rx_phases(self) -> dict:
        """Snapshot of inbound phase seconds per ``"src:tag"`` stream
        (obs telemetry folds this into its summary)."""
        with self._rx_lock:
            return {
                f"{src}:{tag}": dict(v)
                for (src, tag), v in sorted(self._rx_phases.items())
            }

    def wire_byte_counts(self) -> dict:
        """Exact socket-level byte totals: {"tx", "rx", "rx_corrupt_dropped"}.
        Ground truth for the obs-summary == socket-bytes assertion."""
        with self._byte_lock:
            return {
                "tx": self._tx_wire_bytes,
                "rx": self._rx_wire_bytes,
                "rx_corrupt_dropped": self._rx_corrupt_dropped,
            }

    def recv(
        self,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        timeout: Optional[float] = None,
    ) -> Message:
        msg = self._mailbox.get(0, src, tag, timeout)
        return Message(
            src=msg.src,
            dst=self.rank,
            tag=msg.tag,
            payload=msg.payload,
            wire_nbytes=msg.wire_nbytes,
        )

    def probe(
        self,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        timeout: Optional[float] = 0,
    ) -> bool:
        if timeout == 0:
            return self._mailbox.peek(0, src, tag)
        return self._mailbox.peek_wait(0, src, tag, timeout)

    def close(self) -> None:
        self._closing.set()
        with self._out_cache_lock:
            queues = list(self._send_queues.values())
        for q in queues:
            q.shutdown()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._out_cache_lock:
            for sock in self._out.values():
                try:
                    sock.close()
                except OSError:
                    pass
            self._out.clear()


class _SendQueue:
    """One destination's outbound message queue + its sender thread.

    FIFO by construction (single drainer), which is what lets send() and
    isend() interleave without breaking MPI's per-(src, dst, tag) order
    guarantee. Write errors are parked on the message's SendHandle — a sync
    send() re-raises them from wait(); a fire-and-forget isend keeps them
    inspectable instead of crashing a daemon thread."""

    def __init__(self, transport: "SocketTransport", dst: int):
        self._transport = transport
        self._dst = dst
        self._cond = make_condition(f"socket._SendQueue.cond[{dst}]")
        # deque: the drainer pops from the front on every message — a list's
        # pop(0) is O(n) and melts under backlog (a slow peer + isend burst)
        # items are (msg, handle, enqueue perf_counter) — the timestamp
        # is what turns into the handle's queue_wait phase on dequeue
        self._items: collections.deque[tuple[_OutMessage, SendHandle, float]] = (
            collections.deque()
        )
        self._stopped = False
        self._thread = threading.Thread(
            target=self._drain,
            name=f"mpit-send-r{transport.rank}-d{dst}",
            daemon=True,
        )
        self._thread.start()

    def enqueue(self, item: _OutMessage, serialize_s: float = 0.0) -> SendHandle:
        h = SendHandle()
        h.phases = {"serialize": serialize_s}
        with self._cond:
            if self._stopped:
                h.set_error(ConnectionError("transport closed"))
                return h
            self._items.append((item, h, time.perf_counter()))
            self._cond.notify()
        return h

    def shutdown(self) -> None:
        with self._cond:
            self._stopped = True
            pending = self._items
            self._items = collections.deque()
            self._cond.notify()
        for _item, h, _enq_t in pending:
            h.set_error(ConnectionError("transport closed with send pending"))

    def _drain(self) -> None:
        while True:
            with self._cond:
                while not self._items and not self._stopped:
                    self._cond.wait()
                if self._stopped and not self._items:
                    return
                item, h, enq_t = self._items.popleft()
            # queue_wait is the socket-wait phase a sync send() spends
            # behind earlier messages to the same dst; write is the payload
            # transfer into the kernel. Stamped BEFORE set_done so a
            # waiter observing done() always sees the full split.
            t_w = time.perf_counter()
            try:
                nbytes = self._transport._write_msg(self._dst, item)
            except BaseException as e:
                h.set_error(e)
            else:
                h.phases["queue_wait"] = t_w - enq_t
                h.phases["write"] = time.perf_counter() - t_w
                h.wire_nbytes = nbytes
                h.set_done()
