"""Transport interface: mpiT's Send/Recv/Isend/Irecv/Probe surface.

A copy of ``mpit_tpu/transport/base.py``, with :class:`CorruptedPayload`
from ``mpit_tpu/transport/chaos.py`` beside it: the fault injector
(:mod:`~mpit_tpu_torch.transport.chaos`) and the socket transport deliver
it, the wire codec maps the reference's pickles of it here, and the PS
server drops it.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Optional

ANY_SOURCE = -1
ANY_TAG = -1


class RecvTimeout(Exception):
    """recv()/probe() deadline expired (the reference would simply hang —
    SURVEY.md §5 failure detection: 'a dead rank hangs the job')."""


@dataclasses.dataclass
class Message:
    src: int
    dst: int
    tag: int
    payload: Any
    # exact on-wire byte count (length prefix + frame) stamped by byte-
    # counting transports (SocketTransport); None for reference-passing
    # transports, where obs telemetry falls back to its estimate
    wire_nbytes: Optional[int] = None

    def matches(self, src: int, tag: int) -> bool:
        return (src == ANY_SOURCE or src == self.src) and (
            tag == ANY_TAG or tag == self.tag
        )


class SendHandle:
    """Handle returned by isend (mpiT's ``Isend``/``Wait`` pair).

    Completes immediately for queued local delivery; socket isends complete
    when the frame is written by the background sender. A failed async send
    parks its exception here and re-raises it from :meth:`wait` — errors
    must reach the caller, not die in a worker thread."""

    def __init__(self):
        self._done = threading.Event()
        self._error: Optional[BaseException] = None
        # wire-phase wall-clock split (seconds), stamped by phase-aware
        # transports (SocketTransport: serialize / queue_wait / write)
        # BEFORE the handle completes; valid only once done() is true.
        # Transports without a phase breakdown leave it None.
        self.phases: Optional[dict] = None
        # exact bytes written for this send (length prefix included),
        # stamped alongside ``phases`` by byte-counting transports
        self.wire_nbytes: Optional[int] = None

    def set_done(self):
        self._done.set()

    def set_error(self, exc: BaseException):
        self._error = exc
        self._done.set()

    def done(self) -> bool:
        """Non-blocking completion check (MPI_Test parity)."""
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        ok = self._done.wait(timeout)
        if not ok:
            raise RecvTimeout("isend not complete before timeout")
        if self._error is not None:
            raise self._error
        return True


class RecvHandle:
    """Handle returned by irecv; wait() yields the Message."""

    def __init__(self, fetch):
        self._fetch = fetch
        self._msg: Optional[Message] = None

    def wait(self, timeout: Optional[float] = None) -> Message:
        if self._msg is None:
            self._msg = self._fetch(timeout)
        return self._msg


@dataclasses.dataclass(frozen=True)
class CorruptedPayload:
    """What a ``corrupt`` fault delivers in place of the real payload: the
    frame-layer model of an unparseable frame. Receivers drop the message
    and let the sender's retry/timeout path absorb the loss; ``np.asarray``
    on it raises, so an unhardened apply path fails loudly rather than
    training on junk. Carries its stream coordinates for debuggability
    only — protocol code must not dispatch on them."""

    src: int = -1
    dst: int = -1
    tag: int = -1
    n: int = -1


class Transport:
    """Abstract tagged p2p transport for one rank.

    mpiT surface mapping: Send/Recv/Isend/Irecv/Wait/Probe with tags and
    ANY_SOURCE (SURVEY.md §2 L2 row). ``rank``/``size`` here are *transport*
    ranks (host actors: pservers + pclients), distinct from the device-mesh
    worker ids of the collective trainers.
    """

    rank: int
    size: int

    def send(self, dst: int, tag: int, payload: Any) -> None:
        raise NotImplementedError

    def recv(
        self,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        timeout: Optional[float] = None,
    ) -> Message:
        raise NotImplementedError

    def isend(self, dst: int, tag: int, payload: Any) -> SendHandle:
        h = SendHandle()
        self.send(dst, tag, payload)
        h.set_done()
        return h

    def irecv(self, src: int = ANY_SOURCE, tag: int = ANY_TAG) -> RecvHandle:
        return RecvHandle(lambda timeout: self.recv(src, tag, timeout))

    def probe(
        self,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        timeout: Optional[float] = 0,
    ) -> bool:
        """Is a matching message waiting (without consuming it)?

        ``timeout=0`` polls (MPI_Iprobe), ``timeout=None`` blocks until a
        match arrives (MPI_Probe), ``timeout>0`` waits at most that long.
        Returns False on expiry rather than raising — probing for absence
        is a legitimate outcome, unlike an expired recv."""
        raise NotImplementedError

    def close(self) -> None:
        pass
