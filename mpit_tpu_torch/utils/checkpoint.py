"""Shard snapshots of the parameter server, in flax's msgpack format.

Counterpart of ``mpit_tpu/utils/checkpoint.py:132-176``
(``save_shard_state``/``load_shard_state``), the shard functions only:
whole-trainer checkpoints are ROADMAP.md item A5b. The reference writes
the snapshot with ``flax.serialization.msgpack_serialize``; the machine
with the card has neither flax nor ``msgpack``, so this module carries
the small part of both that a snapshot needs: dict, list, int, float, str,
bytes, bool and None, ndarrays as flax's extension type 1 (``(shape,
dtype name, C-order bytes)``, itself msgpack-packed) and numpy scalars as
type 3. Maps are written with their keys sorted, as flax's tree copy
leaves them, and arrays above 1 GiB in flax's chunked form. The bytes
equal flax's for the same state, so each package reads the other's files
(``tests/test_torch_ps.py``).
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import Any

import numpy as np

# flax.serialization._MsgpackExtType
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
# flax.serialization.MAX_CHUNK_SIZE: msgpack's 2**31 - 1 bytes per object
_MAX_CHUNK_SIZE = 2**30
_CHUNKED = "__msgpack_chunked_array__"


def _len_prefix(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes``; None where the type has no 8-bit form)."""
    if n < fix_max:
        out.append(fix | n)
    elif codes[0] is not None and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack object of length {n} is too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v > 0:
        for code, fmt, top in ((0xCC, ">BB", 1 << 8), (0xCD, ">BH", 1 << 16),
                               (0xCE, ">BI", 1 << 32), (0xCF, ">BQ", 1 << 64)):
            if v < top:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    else:
        for code, fmt, low in ((0xD0, ">Bb", -(1 << 7)), (0xD1, ">Bh", -(1 << 15)),
                               (0xD2, ">Bi", -(1 << 31)), (0xD3, ">Bq", -(1 << 63))):
            if v >= low:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(len(data))
    if fixed is not None:
        out.append(fixed)
    else:
        _len_prefix(out, len(data), 0, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype.name, bytes))``."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(
            "Object and structured dtypes not supported "
            "for serialization of ndarrays."
        )
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, v: Any) -> None:
    t = type(v)
    if v is None:
        out.append(0xC0)
    elif v is False:
        out.append(0xC2)
    elif v is True:
        out.append(0xC3)
    elif t is int:
        _pack_int(out, v)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, v)
    elif t is str:
        raw = v.encode("utf-8")
        _len_prefix(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif t is bytes:
        _len_prefix(out, len(v), 0, 0, (0xC4, 0xC5, 0xC6))
        out += v
    elif t is list:
        _len_prefix(out, len(v), 0x90, 16, (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item)
    elif t is dict:
        _len_prefix(out, len(v), 0x80, 16, (None, 0xDE, 0xDF))
        for key, item in v.items():
            _pack(out, key)
            _pack(out, item)
    elif isinstance(v, np.ndarray):
        _pack_ext(out, _EXT_NDARRAY, _ndarray_bytes(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(v)))
    else:
        raise TypeError(f"can not serialize {t.__name__!r} object")


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: an array above the limit as flat pieces."""
    size = max(1, int(_MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {
        _CHUNKED: True,
        "shape": {str(i): d for i, d in enumerate(arr.shape)},
        "chunks": {str(i): flat[s:s + size]
                   for i, s in enumerate(range(0, flat.size, size))},
    }


def _canonical(v: Any, top: bool = True) -> Any:
    """The tree flax packs: dicts with sorted keys (its tree copy sorts
    them), oversized arrays chunked where flax chunks them (dict values
    and the top level)."""
    if isinstance(v, dict):
        return {k: _canonical(v[k], top=True) for k in sorted(v)}
    if isinstance(v, list):
        return [_canonical(item, top=False) for item in v]
    if (
        top
        and isinstance(v, np.ndarray)
        and v.size * v.dtype.itemsize > _MAX_CHUNK_SIZE
    ):
        return _chunk(v)
    return v


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(tree)``."""
    out = bytearray()
    _pack(out, _canonical(tree))
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.i = 0

    def take(self, n: int) -> memoryview:
        if self.i + n > len(self.data):
            raise ValueError("msgpack data truncated")
        out = self.data[self.i:self.i + n]
        self.i += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def items(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if type(key) not in (str, bytes):
                raise ValueError(f"{type(key).__name__} is not allowed for map key")
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack extension type {code}")
        shape, name, buf = _Reader(data).value()
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")
        return arr if code == _EXT_NDARRAY else arr[()]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b < 0x90:
            return self.mapping(b & 0x0F)
        if b < 0xA0:
            return self.items(b & 0x0F)
        if b < 0xC0:
            return str(self.take(b & 0x1F), "utf-8")
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            v = self.unpack(ints[b])
            return float(v) if b in (0xCA, 0xCB) else v
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lens:
            n = self.unpack(lens[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if b <= 0xDB and b >= 0xD9:
                return str(self.take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return self.items(n)
            if b in (0xDE, 0xDF):
                return self.mapping(n)
            return self.ext(n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")


def _unchunk(v: Any) -> Any:
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(v, dict):
        if _CHUNKED in v:
            shape = tuple(v["shape"][str(i)] for i in range(len(v["shape"])))
            chunks = [v["chunks"][str(i)] for i in range(len(v["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        for k, item in v.items():
            if isinstance(item, dict):
                v[k] = _unchunk(item)
    return v


def msgpack_restore(data: bytes) -> Any:
    """The tree of ``flax.serialization.msgpack_restore(data)``: arrays
    are read-only views into ``data``'s copy, as there."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.i != len(reader.data):
        raise ValueError("extra data after the msgpack object")
    return _unchunk(tree)


def save_shard_state(path: str, state: dict) -> str:
    """Atomically write one PServer shard snapshot (msgpack dict).

    The center, the per-shard version counter, the ``(src, epoch)`` dedup
    window and the membership view are written together, so a restore
    never sees a center that disagrees with its dedup window. tmp +
    rename: a server killed mid-write leaves the previous snapshot."""
    payload = msgpack_serialize(state)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)  # atomic: never torn at `path`
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_shard_state(path: str) -> dict:
    """Read a shard snapshot written by :func:`save_shard_state` (or by
    the reference's)."""
    with open(path, "rb") as f:
        payload = f.read()
    state = msgpack_restore(payload)
    if not isinstance(state, dict):
        raise ValueError(
            f"shard snapshot {path} is not a state dict "
            f"(got {type(state).__name__})"
        )
    return state
