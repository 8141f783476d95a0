"""wire — versioned zero-copy binary framing for the PS hot path.

A copy of ``mpit_tpu/transport/wire.py``: frames are byte-equal to the
reference's for the same ``(src, tag, payload)`` and decode to the same
values, with the same :class:`WireDecodeError` verdicts
(``tests/test_torch_wire.py``). The layout, after the transport's 8-byte
length prefix::

    magic "MW"  (2)   — a protocol>=2 pickle stream starts with 0x80
    version     (1)   — WIRE_FORMAT_VERSION; readers reject newer frames
    flags       (1)   — bit0: body byte order (1 = little-endian host)
    header_len  (4be)
    header_crc  (4be) — crc32 over the structural header only
    header      (header_len bytes: None/bool/int/float/str/bytes/tuple/
                 list, plus ndarray and QuantArray descriptors)
    body        (raw array buffers, concatenated in header order)

:func:`encode_frame` returns the header plus memoryviews over the
caller's arrays (nothing copied); :func:`decode_frame` returns
``np.frombuffer`` views into the received body. A payload the codec
cannot express (a chaos :class:`CorruptedPayload`) makes
:func:`encode_frame` return None, and the transport pickles that message.

Pickles on the wire name the reference's classes
(``mpit_tpu.quant.QuantArray``, ``mpit_tpu.transport.chaos.
CorruptedPayload``), in both directions. :func:`loads` reads every pickle
the port receives: a restricted unpickler maps those two names to the
port's classes and refuses any other ``mpit_tpu`` name with
:class:`WireDecodeError`, so the JAX package is never imported.
A pickle of the port writes its two classes under the reference's names
(through ``importlib.import_module`` and ``getattr``, so the writer need
not import them) once :func:`to_reference_names` has marked them, and a
peer of the reference reads its own classes back.

Every frame writer pins ``version=WIRE_FORMAT_VERSION`` by name (lint rule
MPT007). The quantization kernels live in :mod:`mpit_tpu_torch.quant`
and are re-exported here.
"""

from __future__ import annotations

import dataclasses
import importlib
import io
import os
import pickle
import struct
import sys
import types
import zlib
from typing import Any, Optional

import numpy as np

from mpit_tpu_torch.quant import (  # noqa: F401  (re-exports: wire API surface)
    QUANT_MODES,
    QuantArray,
    dequantize,
    quantize,
)
from mpit_tpu_torch.transport.base import CorruptedPayload

# The wire format's ONE version number. Readers accept any frame at or
# below their own version; every frame WRITER must pin this constant by
# name in its encode_frame call — a literal would be silently stranded
# by a future bump (the MPT007 lint rule enforces the pin, exactly as it
# does for WIRE_PICKLE_PROTOCOL on the pickle path).
WIRE_FORMAT_VERSION = 1

MAGIC = b"MW"
_PREAMBLE = struct.Struct(">2sBBII")  # magic, version, flags, hlen, hcrc
PREAMBLE_SIZE = _PREAMBLE.size
_FLAG_LITTLE_ENDIAN = 0x01

_HELLO = struct.Struct(">2ssB")  # magic, "H", advertised version
HELLO_SIZE = _HELLO.size

_U32 = struct.Struct(">I")
_F64 = struct.Struct(">d")
_F32 = struct.Struct(">f")

# structural type codes
_T_NONE = 0x00
_T_TRUE = 0x01
_T_FALSE = 0x02
_T_INT = 0x03
_T_FLOAT = 0x04
_T_STR = 0x05
_T_BYTES = 0x06
_T_TUPLE = 0x07
_T_LIST = 0x08
_T_NDARRAY = 0x09
_T_QUANT = 0x0A

# fixed dtype registry — codes are part of the wire format; append only
_DTYPE_CODES = {
    np.dtype(np.float32): 1,
    np.dtype(np.float64): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.int32): 4,
    np.dtype(np.int8): 5,
    np.dtype(np.uint8): 6,
    np.dtype(np.uint16): 7,
    np.dtype(np.bool_): 8,
    np.dtype(np.int16): 9,
    np.dtype(np.uint32): 10,
    np.dtype(np.uint64): 11,
    np.dtype(np.float16): 12,
}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}

_QUANT_MODE_CODES = {"bf16": 1, "int8": 2}
_CODE_QUANT_MODES = {v: k for k, v in _QUANT_MODE_CODES.items()}

_MAX_DIMS = 16
# header sanity bound: the structural part of a PS message is tiny (tens
# of bytes); a multi-megabyte header length is a corrupted preamble, not
# a real message — reject before allocating
MAX_HEADER_LEN = 1 << 20


class WireDecodeError(Exception):
    """A framed body failed its integrity checks (bad magic inside a
    declared-framed frame, header CRC mismatch, unknown type/dtype code,
    or declared-vs-actual body length disagreement). Carries the frame's
    ``src``/``tag`` when the header decoded far enough to know them, so
    the transport can still route the corruption marker to the right
    stream (None otherwise)."""

    def __init__(self, message: str, src: Optional[int] = None,
                 tag: Optional[int] = None):
        super().__init__(message)
        self.src = src
        self.tag = tag


# -- env knobs ------------------------------------------------------------


def wire_format_from_env(env=os.environ) -> str:
    """``MPIT_WIRE_FORMAT``: ``framed`` (default — the hot path) or
    ``pickle`` (the historical format; the before-side of the bench
    comparison, and a kill switch)."""
    fmt = env.get("MPIT_WIRE_FORMAT", "framed").strip().lower()
    if fmt not in ("framed", "pickle"):
        raise ValueError(
            f"MPIT_WIRE_FORMAT={fmt!r}: expected 'framed' or 'pickle'"
        )
    return fmt


def quant_mode_from_env(env=os.environ) -> str:
    """``MPIT_WIRE_QUANT``: ``off`` (default), ``bf16``, or ``int8``."""
    mode = env.get("MPIT_WIRE_QUANT", "off").strip().lower()
    if mode not in QUANT_MODES:
        raise ValueError(
            f"MPIT_WIRE_QUANT={mode!r}: expected one of {QUANT_MODES}"
        )
    return mode


def negotiate_enabled_from_env(env=os.environ) -> bool:
    """``MPIT_WIRE_NEGOTIATE=0`` disables the hello exchange entirely —
    the transport then behaves like a pickle-only peer on both sides
    (no hello sent on accept, none awaited after connect, nothing
    framed). This is the mixed-version test lever AND the emergency
    lever for a peer whose stack chokes on unexpected reverse-direction
    bytes."""
    return env.get("MPIT_WIRE_NEGOTIATE", "1").strip() != "0"


def negotiate_timeout_from_env(env=os.environ) -> float:
    """``MPIT_WIRE_NEGOTIATE_TIMEOUT_S``: how long a sender waits for
    the receiver's hello before concluding the peer is pickle-only
    (default 2s; paid once per connection, and only by mixed-version
    pairs — a framed receiver sends its hello at accept time, so the
    wait is one RTT in the common case)."""
    return float(env.get("MPIT_WIRE_NEGOTIATE_TIMEOUT_S", "2.0"))


# -- hello ----------------------------------------------------------------


def encode_hello(version: int = WIRE_FORMAT_VERSION) -> bytes:
    """The receiver-side capability advertisement written on every
    accepted connection."""
    return _HELLO.pack(MAGIC, b"H", version)


def decode_hello(data: bytes) -> Optional[int]:
    """Advertised wire version, or None when ``data`` is not a hello."""
    if len(data) != HELLO_SIZE:
        return None
    try:
        magic, h, version = _HELLO.unpack(data)
    except struct.error:
        return None
    if magic != MAGIC or h != b"H":
        return None
    return version


# -- encode ---------------------------------------------------------------


class _Unencodable(Exception):
    pass


def _encode_value(value: Any, header: bytearray, body: list) -> None:
    if value is None:
        header.append(_T_NONE)
    elif value is True:
        header.append(_T_TRUE)
    elif value is False:
        header.append(_T_FALSE)
    elif type(value) is int:
        mag = abs(value)
        raw = mag.to_bytes((mag.bit_length() + 7) // 8 or 1, "big")
        header.append(_T_INT)
        header.append(1 if value < 0 else 0)
        header += _U32.pack(len(raw))
        header += raw
    elif type(value) is float:
        header.append(_T_FLOAT)
        header += _F64.pack(value)
    elif type(value) is str:
        raw = value.encode("utf-8")
        header.append(_T_STR)
        header += _U32.pack(len(raw))
        header += raw
    elif type(value) is bytes:
        header.append(_T_BYTES)
        header += _U32.pack(len(value))
        header += value
    elif type(value) is tuple or type(value) is list:
        header.append(_T_TUPLE if type(value) is tuple else _T_LIST)
        header += _U32.pack(len(value))
        for item in value:
            _encode_value(item, header, body)
    elif type(value) is np.ndarray:
        code = _DTYPE_CODES.get(value.dtype)
        if code is None or value.ndim > _MAX_DIMS:
            raise _Unencodable
        a = np.ascontiguousarray(value)
        header.append(_T_NDARRAY)
        header.append(code)
        header.append(a.ndim)
        for dim in a.shape:
            header += _U32.pack(dim)
        # memoryview.cast rejects zero-in-shape views; an empty array's
        # body is empty regardless
        body.append(a.data.cast("B") if a.size else b"")
    elif type(value) is QuantArray:
        mode = _QUANT_MODE_CODES.get(value.mode)
        data = value.data
        if (
            mode is None
            or type(data) is not np.ndarray
            or data.ndim > _MAX_DIMS
        ):
            raise _Unencodable
        expected = np.uint16 if value.mode == "bf16" else np.int8
        a = np.ascontiguousarray(data, dtype=expected)
        header.append(_T_QUANT)
        header.append(mode)
        header += _F32.pack(value.scale)
        header.append(a.ndim)
        for dim in a.shape:
            header += _U32.pack(dim)
        body.append(a.data.cast("B") if a.size else b"")
    else:
        # numpy scalars, dataclasses (CorruptedPayload), arbitrary
        # objects: not this codec's business — the caller pickles them
        raise _Unencodable


def encode_frame(
    src: int, tag: int, payload: Any, *, version: int
) -> Optional[list]:
    """Zero-copy frame body for one message, as a buffer list
    ``[preamble+header bytes, array view, ...]`` ready for a vectorized
    write (``sendmsg``), or None when the payload contains something the
    structural codec cannot express (the caller falls back to pickle).

    ``version`` is keyword-required and must name
    :data:`WIRE_FORMAT_VERSION` at every call site (lint rule MPT007).
    """
    if not 0 <= version <= 255:
        raise ValueError(f"wire version {version} out of range")
    header = bytearray()
    body: list = []
    try:
        _encode_value(src, header, body)
        _encode_value(tag, header, body)
        _encode_value(payload, header, body)
    except _Unencodable:
        return None
    if len(header) > MAX_HEADER_LEN:
        return None  # degenerate payload (huge nesting): pickle handles it
    flags = _FLAG_LITTLE_ENDIAN if sys.byteorder == "little" else 0
    preamble = _PREAMBLE.pack(
        MAGIC, version, flags, len(header), zlib.crc32(bytes(header))
    )
    return [preamble + bytes(header), *body]


def frame_nbytes(buffers: list) -> int:
    """Total body length of an :func:`encode_frame` buffer list."""
    return sum(
        b.nbytes if isinstance(b, memoryview) else len(b) for b in buffers
    )


# -- decode ---------------------------------------------------------------


class _Decoder:
    def __init__(self, header: memoryview, body: memoryview):
        self.header = header
        self.h = 0
        self.body = body
        self.b = 0

    def _take(self, n: int) -> memoryview:
        if self.h + n > len(self.header):
            raise WireDecodeError("structural header truncated")
        out = self.header[self.h:self.h + n]
        self.h += n
        return out

    def _u32(self) -> int:
        return _U32.unpack(self._take(4))[0]

    def _array_buffer(self, dtype: np.dtype, shape: tuple) -> np.ndarray:
        count = 1
        for dim in shape:
            count *= dim
        nbytes = count * dtype.itemsize
        if self.b + nbytes > len(self.body):
            raise WireDecodeError(
                "frame body shorter than its declared arrays"
            )
        arr = np.frombuffer(
            self.body, dtype=dtype, count=count, offset=self.b
        ).reshape(shape)
        self.b += nbytes
        return arr

    def value(self) -> Any:
        code = self._take(1)[0]
        if code == _T_NONE:
            return None
        if code == _T_TRUE:
            return True
        if code == _T_FALSE:
            return False
        if code == _T_INT:
            neg = self._take(1)[0]
            raw = self._take(self._u32())
            mag = int.from_bytes(raw, "big")
            return -mag if neg else mag
        if code == _T_FLOAT:
            return _F64.unpack(self._take(8))[0]
        if code == _T_STR:
            return str(self._take(self._u32()), "utf-8")
        if code == _T_BYTES:
            return bytes(self._take(self._u32()))
        if code in (_T_TUPLE, _T_LIST):
            n = self._u32()
            if n > len(self.header):  # cheap bound: each item is >= 1 byte
                raise WireDecodeError("container length exceeds header")
            items = [self.value() for _ in range(n)]
            return tuple(items) if code == _T_TUPLE else items
        if code == _T_NDARRAY:
            dtype = _CODE_DTYPES.get(self._take(1)[0])
            ndim = self._take(1)[0]
            if dtype is None or ndim > _MAX_DIMS:
                raise WireDecodeError("unknown dtype code or ndim")
            shape = tuple(self._u32() for _ in range(ndim))
            return self._array_buffer(dtype, shape)
        if code == _T_QUANT:
            mode = _CODE_QUANT_MODES.get(self._take(1)[0])
            if mode is None:
                raise WireDecodeError("unknown quantization mode code")
            scale = _F32.unpack(self._take(4))[0]
            ndim = self._take(1)[0]
            if ndim > _MAX_DIMS:
                raise WireDecodeError("quant array ndim out of range")
            shape = tuple(self._u32() for _ in range(ndim))
            dtype = np.dtype(np.uint16 if mode == "bf16" else np.int8)
            return QuantArray(mode, scale, self._array_buffer(dtype, shape))
        raise WireDecodeError(f"unknown structural type code 0x{code:02x}")


def split_preamble(preamble: bytes) -> tuple[int, int, int, int]:
    """(version, flags, header_len, header_crc) from a frame's first
    :data:`PREAMBLE_SIZE` bytes; raises :class:`WireDecodeError` on a
    non-framed or future-versioned preamble."""
    try:
        magic, version, flags, hlen, hcrc = _PREAMBLE.unpack(preamble)
    except struct.error as e:
        raise WireDecodeError(f"short preamble: {e}") from e
    if magic != MAGIC:
        raise WireDecodeError("bad magic in declared-framed frame")
    if version > WIRE_FORMAT_VERSION:
        raise WireDecodeError(
            f"frame version {version} is newer than this reader "
            f"({WIRE_FORMAT_VERSION})"
        )
    if hlen > MAX_HEADER_LEN:
        raise WireDecodeError(f"header length {hlen} exceeds sanity bound")
    return version, flags, hlen, hcrc


def decode_frame(
    flags: int, header_crc: int, header: bytes, body
) -> tuple[int, int, Any]:
    """(src, tag, payload) from a validated-preamble frame. ``body`` is
    any buffer (typically the transport's ``recv_into`` target); returned
    arrays are views into it. Integrity checks, in order: header CRC32,
    body byte order, structural decode, exact body-length consumption —
    any failure raises :class:`WireDecodeError` (with src/tag attached
    once known, so the caller can still route a corruption marker)."""
    if zlib.crc32(header) != header_crc:
        raise WireDecodeError("header CRC mismatch")
    little = bool(flags & _FLAG_LITTLE_ENDIAN)
    if little != (sys.byteorder == "little"):
        # a cross-endian peer would need byte-swapped views; no such host
        # exists in this deployment, so refuse rather than mis-decode
        raise WireDecodeError("frame byte order does not match this host")
    dec = _Decoder(memoryview(header), memoryview(body))
    src = tag = None
    try:
        src = dec.value()
        tag = dec.value()
        if type(src) is not int or type(tag) is not int:
            raise WireDecodeError("frame src/tag are not ints")
        payload = dec.value()
    except WireDecodeError as e:
        e.src = src if type(src) is int else None
        e.tag = tag if type(tag) is int else None
        raise
    if dec.h != len(dec.header):
        raise WireDecodeError(
            "structural header has trailing bytes", src=src, tag=tag
        )
    if dec.b != len(dec.body):
        raise WireDecodeError(
            f"frame body length mismatch: declared arrays consume "
            f"{dec.b} bytes, body holds {len(dec.body)}",
            src=src, tag=tag,
        )
    return src, tag, payload


# -- pickles --------------------------------------------------------------

# the reference's classes on the wire, by the names its pickles give
# them, and the port's counterparts
_REFERENCE_CLASSES = {
    ("mpit_tpu.quant", "QuantArray"): QuantArray,
    ("mpit_tpu.transport.chaos", "CorruptedPayload"): CorruptedPayload,
}
_REFERENCE_NAMES = {cls: key for key, cls in _REFERENCE_CLASSES.items()}


def _reference_module(name: str) -> types.SimpleNamespace:
    """What ``importlib.import_module(name)`` in a pickle gives the port:
    the port's counterparts of the reference module's wire classes."""
    classes = {
        cls_name: cls
        for (module, cls_name), cls in _REFERENCE_CLASSES.items()
        if module == name
    }
    if not classes:
        raise WireDecodeError(f"pickle imports {name}, which the wire never names")
    return types.SimpleNamespace(**classes)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) == ("importlib", "import_module"):
            return _reference_module
        if module == "mpit_tpu" or module.startswith("mpit_tpu."):
            cls = _REFERENCE_CLASSES.get((module, name))
            if cls is None:
                raise WireDecodeError(
                    f"pickle names {module}.{name}, which has no "
                    "counterpart in mpit_tpu_torch"
                )
            return cls
        try:
            return super().find_class(module, name)
        except ModuleNotFoundError:
            # numpy 2 pickles name numpy._core, which numpy 1 calls numpy.core
            if module.startswith("numpy._core"):
                return super().find_class(
                    "numpy.core" + module[len("numpy._core"):], name
                )
            raise


def loads(data) -> Any:
    """``pickle.loads`` for bytes from a peer of either package: the
    reference's ``QuantArray`` and ``CorruptedPayload`` become the port's,
    any other ``mpit_tpu`` name raises :class:`WireDecodeError`."""
    return _Unpickler(io.BytesIO(data)).load()


class _ReferenceClass:
    """The reference's ``module.name`` in a pickle: it pickles as
    ``getattr(importlib.import_module(module), name)``, so the writer
    need not import it."""

    def __init__(self, module: str, name: str):
        self.module = module
        self.name = name

    def __reduce__(self):
        return getattr, (_ReferenceModule(self.module), self.name)

    def __call__(self, *args):  # pickle wants a callable; never called
        raise TypeError("a pickling placeholder")


class _ReferenceModule:
    def __init__(self, module: str):
        self.module = module

    def __reduce__(self):
        return importlib.import_module, (self.module,)


class _AsReference:
    """A port ``QuantArray`` or ``CorruptedPayload`` that pickles as the
    reference's class with the same fields."""

    def __init__(self, value):
        self.value = value

    def __reduce__(self):
        v = self.value
        fields = tuple(getattr(v, f.name) for f in dataclasses.fields(v))
        return _ReferenceClass(*_REFERENCE_NAMES[type(v)]), fields


def to_reference_names(obj: Any) -> Any:
    """``obj`` ready for ``pickle.dumps`` on the wire: every port
    ``QuantArray`` and ``CorruptedPayload`` inside its tuples, lists and
    dicts pickles as the reference's class, so a peer of either package
    reads it as its own (the port through :func:`loads`)."""
    t = type(obj)
    if t in _REFERENCE_NAMES:
        return _AsReference(obj)
    if t is tuple or t is list:
        return t(to_reference_names(v) for v in obj)
    if t is dict:
        return {k: to_reference_names(v) for k, v in obj.items()}
    return obj
