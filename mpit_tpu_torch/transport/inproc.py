"""In-process transport: ranks are threads, delivery via a shared broker.

A copy of ``mpit_tpu/transport/inproc.py``. It replaces single-host
``mpirun -n N``: the reference simulated a cluster with N co-located MPI
processes (SURVEY.md §4); here N actors are threads around one card, and
the broker provides MPI-like tagged mailboxes. The broker hands payload
objects from thread to thread, so no byte is framed or copied.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Optional

from mpit_tpu_torch.analysis import runtime as _rt
from mpit_tpu_torch.transport.base import (
    ANY_SOURCE,
    ANY_TAG,
    Message,
    RecvTimeout,
    Transport,
)


class Broker:
    """Shared mailbox set for ``size`` ranks with MPI-like matching."""

    def __init__(self, size: int):
        self.size = size
        self._queues = [collections.deque() for _ in range(size)]
        self._conds = [
            _rt.make_condition(f"Broker.cond[{i}]") for i in range(size)
        ]

    def _note(self, dst: int) -> None:
        """RT103 annotation: every mailbox mutation is stamped into the
        vector-clock sanitizer when one is armed (no-op otherwise)."""
        _rt.note(f"Broker#{id(self)}.q{dst}", True)

    def put(self, msg: Message) -> None:
        if not 0 <= msg.dst < self.size:
            raise ValueError(f"dst {msg.dst} out of range (size {self.size})")
        cond = self._conds[msg.dst]
        with cond:
            self._note(msg.dst)
            self._queues[msg.dst].append(msg)
            cond.notify_all()

    def get(
        self,
        dst: int,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        timeout: Optional[float] = None,
    ) -> Message:
        cond = self._conds[dst]
        deadline = None if timeout is None else time.monotonic() + timeout
        # RT102 instrumentation: register this recv as a waiter so the
        # runtime checker can flag two protocol roles racing for one tag
        checker = _rt.active_checker()
        token = (
            checker.on_recv_enter(self, dst, src, tag)
            if checker is not None
            else None
        )
        try:
            with cond:
                while True:
                    q = self._queues[dst]
                    # scan in arrival order: preserves per-(src,tag) FIFO,
                    # and gives ANY_SOURCE the MPI arrival-order semantics
                    for i, msg in enumerate(q):
                        if msg.matches(src, tag):
                            self._note(dst)
                            del q[i]
                            return msg
                    if deadline is None:
                        cond.wait()
                    else:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0 or not cond.wait(remaining):
                            raise RecvTimeout(
                                f"rank {dst}: no message from src={src} "
                                f"tag={tag} within {timeout}s"
                            )
        finally:
            if token is not None:
                checker.on_recv_exit(token)

    def peek(self, dst: int, src: int = ANY_SOURCE, tag: int = ANY_TAG) -> bool:
        with self._conds[dst]:
            return any(m.matches(src, tag) for m in self._queues[dst])

    def peek_wait(
        self,
        dst: int,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        timeout: Optional[float] = None,
    ) -> bool:
        """Blocking peek: wait (up to ``timeout``; None = forever) for a
        matching message WITHOUT consuming it. False on expiry."""
        cond = self._conds[dst]
        deadline = None if timeout is None else time.monotonic() + timeout
        with cond:
            while True:
                if any(m.matches(src, tag) for m in self._queues[dst]):
                    return True
                if deadline is None:
                    cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not cond.wait(remaining):
                        return False

    def transports(self) -> list["InProcTransport"]:
        return [InProcTransport(self, r) for r in range(self.size)]


class InProcTransport(Transport):
    def __init__(self, broker: Broker, rank: int):
        self.broker = broker
        self.rank = rank
        self.size = broker.size

    def send(self, dst: int, tag: int, payload: Any) -> None:
        self.broker.put(Message(src=self.rank, dst=dst, tag=tag, payload=payload))

    def recv(
        self,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        timeout: Optional[float] = None,
    ) -> Message:
        return self.broker.get(self.rank, src, tag, timeout)

    def probe(
        self,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        timeout: Optional[float] = 0,
    ) -> bool:
        if timeout == 0:
            return self.broker.peek(self.rank, src, tag)
        return self.broker.peek_wait(self.rank, src, tag, timeout)
