"""mpit_tpu_torch.native — C++ message core for the host-async PS transport.

A copy of ``mpit_tpu/native/``: C++ owns the mailboxes, the (src, tag)
wildcard matching and the condition-variable blocking
(``src/tagged_broker.cpp``, a copy of the reference's source); Python binds
it with ctypes behind the :class:`~mpit_tpu_torch.transport.Transport`
interface, so ``PServer``/``PClient`` run unchanged on either broker. A
blocking recv releases the GIL for its whole wait, so server and client
threads overlap. The library is built with the host C++ compiler at first
use (:mod:`mpit_tpu_torch.native.build`). ``transport="auto"`` takes this
broker wherever it builds, as the reference does.
"""

from __future__ import annotations

import contextlib
import ctypes
import pickle
from typing import Any, Optional

from mpit_tpu_torch.analysis.runtime import make_condition
from mpit_tpu_torch.native.build import NativeUnavailable, ensure_built, lib_path
from mpit_tpu_torch.transport import wire
from mpit_tpu_torch.transport.base import (
    ANY_SOURCE,
    ANY_TAG,
    Message,
    RecvTimeout,
    Transport,
)
from mpit_tpu_torch.transport.socket_transport import WIRE_PICKLE_PROTOCOL

__all__ = [
    "NativeBroker",
    "NativeTransport",
    "NativeUnavailable",
    "is_available",
    "ensure_built",
    "lib_path",
]

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.mpit_broker_create.argtypes = [ctypes.c_int]
        lib.mpit_broker_create.restype = ctypes.c_void_p
        lib.mpit_broker_shutdown.argtypes = [ctypes.c_void_p]
        lib.mpit_broker_destroy.argtypes = [ctypes.c_void_p]
        lib.mpit_broker_send.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.mpit_broker_send.restype = ctypes.c_int
        lib.mpit_broker_recv.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double,
        ]
        lib.mpit_broker_recv.restype = ctypes.c_int64
        lib.mpit_broker_probe.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.mpit_broker_probe.restype = ctypes.c_int
        lib.mpit_broker_probe_wait.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double,
        ]
        lib.mpit_broker_probe_wait.restype = ctypes.c_int
        lib.mpit_lease_free.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.mpit_lease_free.restype = ctypes.c_int
        lib.mpit_lease_info.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.mpit_lease_info.restype = ctypes.c_int
        lib.mpit_lease_copy_free.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
        ]
        lib.mpit_lease_copy_free.restype = ctypes.c_int
        _lib = lib
    return _lib


def is_available() -> bool:
    """True when the native library exists (or can be built) AND loads.

    This is a capability probe feeding the transport="auto" fallback, so it
    swallows *any* failure — a wrong-arch prebuilt .so (OSError from CDLL),
    a broken $CXX, missing sources — not just NativeUnavailable."""
    try:
        _load()
        return True
    except Exception:
        return False


class NativeBroker:
    """size-rank broker backed by the C++ library (same surface as
    :class:`mpit_tpu_torch.transport.Broker`)."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError("broker needs at least one rank")
        self._lib = _load()
        self.size = size
        self._h = self._lib.mpit_broker_create(size)
        if not self._h:
            raise RuntimeError("mpit_broker_create failed")
        # close() protocol: every C call runs inside _op(), counted under
        # _cv's lock; close() flips _closing (no new entries), wakes parked
        # receivers via C-side shutdown, waits for the count to drain, and
        # only then frees the C object — so no thread can ever touch a
        # dangling handle (the C-side ops counter alone cannot guarantee
        # that; see tagged_broker.cpp teardown comments).
        self._cv = make_condition("NativeBroker._cv")
        self._active = 0
        self._closing = False

    def transports(self) -> list["NativeTransport"]:
        return [NativeTransport(self, r) for r in range(self.size)]

    # internal ops used by NativeTransport ---------------------------------

    @contextlib.contextmanager
    def _op(self):
        with self._cv:
            if self._closing:
                raise RuntimeError("native broker closed")
            self._active += 1
        try:
            yield
        finally:
            with self._cv:
                self._active -= 1
                self._cv.notify_all()

    def _send(self, src: int, dst: int, tag: int, payload: Any) -> None:
        if not 0 <= dst < self.size:
            raise ValueError(f"dst {dst} out of range [0, {self.size})")
        # same pin as the socket wire: both brokers serve one protocol,
        # and a drifted writer corrupts frames for mixed-version peers
        blob = pickle.dumps(payload, protocol=WIRE_PICKLE_PROTOCOL)
        with self._op():
            rc = self._lib.mpit_broker_send(
                self._h, src, dst, tag, blob, len(blob)
            )
        if rc != 0:
            raise RuntimeError(f"native send failed (rc={rc})")

    def _recv(
        self, rank: int, src: int, tag: int, timeout: Optional[float]
    ) -> Message:
        t = -1.0 if timeout is None else float(timeout)
        with self._op():
            lease = self._lib.mpit_broker_recv(self._h, rank, src, tag, t)
            if lease >= 0:
                # any failure between acquiring the lease and copy_free must
                # drop the lease C-side, or the parked message leaks for the
                # broker's lifetime (copy_free is the only other release)
                try:
                    m_src = ctypes.c_int()
                    m_tag = ctypes.c_int()
                    m_len = ctypes.c_uint64()
                    if self._lib.mpit_lease_info(
                        self._h, lease, ctypes.byref(m_src),
                        ctypes.byref(m_tag), ctypes.byref(m_len),
                    ) != 0:
                        raise RuntimeError("native lease vanished")
                    buf = ctypes.create_string_buffer(max(m_len.value, 1))
                    if self._lib.mpit_lease_copy_free(
                        self._h, lease, buf
                    ) != 0:
                        raise RuntimeError("native lease copy failed")
                except BaseException:
                    self._lib.mpit_lease_free(self._h, lease)
                    raise
        if lease == -1:
            raise RecvTimeout(
                f"no message from src={src} tag={tag} within {timeout}s"
            )
        if lease == -3:
            raise RuntimeError("native broker closed during recv")
        if lease < 0:
            raise RuntimeError(f"native recv failed (rc={lease})")
        payload = (
            wire.loads(buf.raw[: m_len.value]) if m_len.value else None
        )
        return Message(
            src=m_src.value, dst=rank, tag=m_tag.value, payload=payload
        )

    def _probe(
        self, rank: int, src: int, tag: int, timeout: Optional[float] = 0
    ) -> bool:
        if timeout == 0:
            with self._op():
                rc = self._lib.mpit_broker_probe(self._h, rank, src, tag)
            if rc < 0:
                raise RuntimeError(f"native probe failed (rc={rc})")
            return bool(rc)
        t = -1.0 if timeout is None else float(timeout)
        with self._op():
            rc = self._lib.mpit_broker_probe_wait(self._h, rank, src, tag, t)
        if rc == -3:
            raise RuntimeError("native broker closed during probe")
        if rc < 0:
            raise RuntimeError(f"native probe_wait failed (rc={rc})")
        return bool(rc)

    def close(self) -> None:
        """Idempotent; safe while receivers are parked in recv (they are
        woken and raise 'broker closed')."""
        with self._cv:
            if self._closing:
                return
            self._closing = True
            h = self._h
        if h:
            self._lib.mpit_broker_shutdown(h)
            with self._cv:
                while self._active:
                    self._cv.wait()
                self._h = None
            self._lib.mpit_broker_destroy(h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeTransport(Transport):
    """One rank's endpoint on a :class:`NativeBroker` (drop-in for
    :class:`InProcTransport`)."""

    def __init__(self, broker: NativeBroker, rank: int):
        self._broker = broker
        self.rank = rank
        self.size = broker.size

    def send(self, dst: int, tag: int, payload: Any) -> None:
        self._broker._send(self.rank, dst, tag, payload)

    def recv(
        self,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        timeout: Optional[float] = None,
    ) -> Message:
        return self._broker._recv(self.rank, src, tag, timeout)

    def probe(
        self,
        src: int = ANY_SOURCE,
        tag: int = ANY_TAG,
        timeout: Optional[float] = 0,
    ) -> bool:
        return self._broker._probe(self.rank, src, tag, timeout)
