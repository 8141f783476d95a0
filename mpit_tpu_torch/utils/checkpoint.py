"""Checkpoints of whole trainer states and shard snapshots of the parameter
server, in flax's msgpack format.

Counterpart of ``mpit_tpu/utils/checkpoint.py``. A checkpoint is the
bytes of ``flax.serialization.to_bytes`` of the reference's state for the
same values, so either package resumes from the other's files:

- :func:`state_to_state_dict` writes a state as flax's ``to_state_dict``
  writes the reference's: ``TrainState``, ``EASGDState`` and
  ``DownpourState`` (and the optimizer states of ``optim``) as the dicts of
  their fields, tuples as ``{"0": ..., "1": ...}``, the step, round and
  optimizer counts as int32 arrays (a stacked worker optimizer's counts as
  a ``(W,)`` array, as the reference's ``_stack`` leaves them), tensors in
  the flax layout (``convert.leaf_to_flax``: conv kernels HWIO, stacked
  ones W,HWIO);
- ``ckpt_%08d.msgpack`` files, beside ``.json`` metadata, written
  atomically (tmp + rename) and pruned to the last ``keep``.

In a world of several processes every process gathers the stacked worker
fields (a collective), process 0 writes, and all wait at a barrier before
the save returns; every process restores, keeping its own workers' rows.
A state cut across the processes says how: ``process_sharded`` names whole
fields cut on dim 0 (ZeRO's optimizer state), and ``process_cut(path)``
gives, for a leaf's path (its field, keys and indices), the dim along
which the processes hold equal shares of it, or None (the expert leaves of
an MoE state and their optimizer moments, cut on the expert dim). Such a
leaf is gathered whole for the file and cut back to this process's share
on restore: across the world's processes in process order, or, where the
state names a ``process_line`` (a ``ProcessLine``: the pipeline's pp line,
``parallel/pipeline.py`` ``PipelineState``, a dict), across that line's
processes in its order, each line holding the whole leaf.

The reference writes with ``flax.serialization``; the machine with the
card has neither flax nor ``msgpack``, so this module carries the small
part of both that a state needs: dict, list, int, float, str, bytes, bool
and None, ndarrays as flax's extension type 1 (``(shape, dtype name,
C-order bytes)``, itself msgpack-packed) and numpy scalars as type 3. Maps
are written with their keys sorted, as flax's tree copy leaves them, and
arrays above 1 GiB in flax's chunked form. Array payloads are written
from the arrays' own memory and read back as views of the file's bytes, so
a large state is not copied again on either side. The shard snapshots
(``save_shard_state``/``load_shard_state``) use the same codec
(``tests/test_torch_ps.py``, ``tests/test_torch_driver.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
import tempfile
from typing import Any, Optional

import numpy as np
import torch

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


def _ext_header(out: bytearray, code: int, n: int) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fixed is not None:
        out.append(fixed)
    else:
        _len_prefix(out, n, 0, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)


def _check_array(arr: np.ndarray) -> None:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(
            "Object and structured dtypes not supported "
            "for serialization of ndarrays."
        )


def _pack_ndarray(out: "_Out", arr: np.ndarray) -> None:
    """flax's ndarray extension: ``packb((shape, dtype.name, bytes))``,
    the bytes taken from the array's memory."""
    _check_array(arr)
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")  # (ascontiguousarray would make 0-d 1-d)
    head = bytearray([0x93])
    _pack(head, list(arr.shape))
    _pack(head, arr.dtype.name)
    _len_prefix(head, arr.nbytes, 0, 0, (0xC4, 0xC5, 0xC6))
    _ext_header(out, _EXT_NDARRAY, len(head) + arr.nbytes)
    out += head
    data = memoryview(arr.reshape(-1).view(np.uint8))
    if isinstance(out, _Out):
        out.raw(data)
    else:
        out += data


class _Out(bytearray):
    """The packed bytes as parts: small items gather here, large array
    payloads stay views of the arrays' memory."""

    def __init__(self):
        super().__init__()
        self.parts: list = []

    def raw(self, data: memoryview) -> None:
        if len(data) < 1 << 16:
            self += data
        else:
            self.parts += [bytes(self), data]
            del self[:]

    def chunks(self) -> list:
        return [*self.parts, bytes(self)]


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
        _pack_ndarray(out, v)
    elif isinstance(v, np.generic):
        # flax's ``_ndarray_to_bytes`` of the 0-d array, as extension type 3
        arr = np.asarray(v)
        _check_array(arr)
        data = bytearray()
        _pack(data, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        _ext_header(out, _EXT_NPSCALAR, len(data))
        out += data
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


def _canonical(v: Any, top: bool = True, sort: bool = True) -> Any:
    """The tree flax packs: oversized arrays chunked where flax chunks them
    (dict values and the top level), and, with ``sort``, dicts with their
    keys sorted, as the tree copy of flax's ``msgpack_serialize`` leaves
    them (``to_bytes`` packs its state dict as built, without the copy)."""
    if isinstance(v, dict):
        keys = sorted(v) if sort else v
        return {k: _canonical(v[k], True, sort) for k in keys}
    if isinstance(v, list):
        return [_canonical(item, False, sort) for item in v]
    if (
        top
        and isinstance(v, np.ndarray)
        and v.size * v.dtype.itemsize > _MAX_CHUNK_SIZE
    ):
        return _chunk(v)
    return v


def _serialize_chunks(tree: Any, sort: bool = True) -> list:
    out = _Out()
    _pack(out, _canonical(tree, sort=sort))
    return out.chunks()


def msgpack_serialize(tree: Any) -> bytes:
    """The bytes of ``flax.serialization.msgpack_serialize(tree)``."""
    return b"".join(_serialize_chunks(tree))


class _Reader:
    """``views``: bin values come back as views of ``data`` (inside an
    array extension, whose bytes become the array's memory)."""

    def __init__(self, data, views: bool = False):
        self.data = memoryview(data)
        self.i = 0
        self.views = views

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
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack extension type {code}")
        shape, name, buf = _Reader(data, views=True).value()
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
                return self.take(n) if self.views else bytes(self.take(n))
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


# ------------------------------------------------------ trainer checkpoints

_CKPT_RE = re.compile(r"^ckpt_(\d{8,})\.msgpack$")
# a state's per-worker fields: stacked on dim 0, gathered across processes
_WORKER_FIELDS = ("worker_params", "worker_opt")


# the ``rows`` of a field cut across processes on dim 0 (``process_sharded``):
# each tensor keeps this process's share, its own length's worth
_PROCESS_SHARE = object()


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:08d}.msgpack")


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _worker_fields(obj, fields: dict) -> tuple:
    """The per-worker fields of a trainer state, and the stacked W of this
    process (from its worker params)."""
    if "worker_params" not in fields:
        return (), 0
    leaves = [t for t in _tensor_leaves(fields["worker_params"])]
    return _WORKER_FIELDS, (leaves[0].shape[0] if leaves else 0)


def _tensor_leaves(tree) -> list:
    from mpit_tpu_torch.utils.params import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _gathered(t: torch.Tensor, dim: int = 0, line=None) -> torch.Tensor:
    """The world's processes' shares of ``t`` (or those of ``line``, a
    ``ProcessLine``) joined along ``dim`` in process (line) order."""
    from mpit_tpu_torch.comm.collectives import _gather, line_gather

    def gather(a):
        return _gather(a) if line is None else line_gather(a, line)

    if dim == 0:
        return gather(t)
    return gather(t.movedim(dim, 0).contiguous()).movedim(0, dim)


def _leaf_cut(obj, cut, line, procs: int) -> tuple:
    """The per-leaf cut in force below the state ``obj`` (a dataclass or a
    dict), and the processes it is cut across (None: the world): its own
    ``process_cut`` and ``process_line`` in a world of several processes,
    else the ones it inherits."""
    if procs == 1:
        return None, None
    return getattr(obj, "process_cut", cut), getattr(obj, "process_line", line)


def state_to_state_dict(obj: Any, lead: tuple = (), gather: bool = False,
                        cut=None, path: tuple = (), line=None) -> Any:
    """The reference's ``flax.serialization.to_state_dict`` of the state
    ``obj`` stands for, as host numpy (tensors in the flax layout), in the
    reference's order: a dataclass's fields as declared, dict keys sorted,
    tuple entries in order.
    ``lead`` is the shape of a count (``(W,)`` inside a stacked worker
    optimizer); ``gather`` gathers stacked tensors across processes, as it
    does the fields a state names in ``process_sharded`` (ZeRO's optimizer
    state, cut on dim 0 across processes); ``cut(path)`` is the dim along
    which the processes (of ``line``, the state's ``process_line``, or the
    world's) share the leaf at ``path`` (None: whole in each), the state's
    ``process_cut``."""
    from mpit_tpu_torch.comm.topology import current_process
    from mpit_tpu_torch.convert import leaf_to_flax

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = _fields(obj)
        stacked, w = _worker_fields(obj, fields)
        sharded = stacked + getattr(obj, "process_sharded", ())
        procs = current_process()[1]
        cut, line = _leaf_cut(obj, cut, line, procs)
        return {
            k: state_to_state_dict(
                v, (w * procs,) if k in stacked else lead,
                gather or (k in sharded and procs > 1), cut, path + (k,), line,
            )
            for k, v in fields.items()
        }
    if isinstance(obj, (tuple, list)):
        return {str(i): state_to_state_dict(v, lead, gather, cut, path + (i,), line)
                for i, v in enumerate(obj)}
    if isinstance(obj, dict):
        cut, line = _leaf_cut(obj, cut, line, current_process()[1])
        # sorted, as jax's tree functions leave the reference's dicts
        return {k: state_to_state_dict(obj[k], lead, gather, cut, path + (k,), line)
                for k in sorted(obj)}
    if isinstance(obj, torch.Tensor):
        if gather:
            return leaf_to_flax(_gathered(obj))
        dim = cut(path) if cut is not None else None
        return leaf_to_flax(obj if dim is None else _gathered(obj, dim, line))
    if isinstance(obj, int) and not isinstance(obj, bool):
        return np.full(lead, obj, np.int32)
    return obj


def state_to_host(state: Any) -> Any:
    """The state as the reference's checkpoint holds it (its state dict,
    host numpy, flax layout). Collective in a world of several processes:
    call it from every process."""
    return state_to_state_dict(state)


def state_from_state_dict(template: Any, sd: Any, rows: Optional[slice] = None,
                          cut=None, path: tuple = (), line=None) -> Any:
    """A state shaped like ``template`` with the values of the state dict
    ``sd`` (the inverse of :func:`state_to_state_dict`); tensors land on
    the template's devices with its dtypes. ``rows`` keeps this process's
    workers of a stacked field, ``cut(path)`` (the state's ``process_cut``)
    this process's share of a leaf cut across the processes (of ``line``,
    or the world's); a dict template's type is kept (``with_items``). Raises
    ``ValueError`` where the structures differ, as flax's
    ``from_state_dict`` does."""
    from mpit_tpu_torch.comm.topology import current_process
    from mpit_tpu_torch.convert import leaf_from_flax

    def keys_match(want, have, where):
        if not isinstance(have, dict) or set(want) != set(have):
            raise ValueError(
                f"the checkpoint's structure differs at {where}: it holds "
                f"{sorted(have) if isinstance(have, dict) else type(have).__name__},"
                f" the state has {sorted(want)}"
            )

    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        fields = _fields(template)
        keys_match(fields, sd, type(template).__name__)
        stacked, w = _worker_fields(template, fields)
        index, procs = current_process()
        cut, line = _leaf_cut(template, cut, line, procs)

        def mine(k, v):
            """This process's rows of a field cut across processes."""
            if procs == 1:
                return rows
            if k in stacked:
                return slice(index * w, (index + 1) * w)
            if k in getattr(template, "process_sharded", ()):
                return _PROCESS_SHARE
            return rows

        return dataclasses.replace(template, **{
            k: state_from_state_dict(v, sd[k], mine(k, v), cut, path + (k,), line)
            for k, v in fields.items()
        })
    if isinstance(template, (tuple, list)):
        keys_match([str(i) for i in range(len(template))], sd,
                   type(template).__name__)
        return type(template)(state_from_state_dict(v, sd[str(i)], rows, cut, path + (i,), line)
                              for i, v in enumerate(template))
    if isinstance(template, dict):
        keys_match(template, sd, "a dict")
        cut, line = _leaf_cut(template, cut, line, current_process()[1])
        items = {k: state_from_state_dict(v, sd[k], rows, cut, path + (k,), line)
                 for k, v in template.items()}
        rebuild = getattr(template, "with_items", None)
        return items if rebuild is None else rebuild(items)
    if isinstance(template, torch.Tensor):
        a = leaf_from_flax(sd)
        dim = cut(path) if cut is not None else None
        if rows is _PROCESS_SHARE:
            n = template.shape[0]
            a = a[current_process()[0] * n:][:n]
        elif rows is not None:
            a = a[rows]
        elif dim is not None:
            index, procs = current_process()
            if line is not None:
                index, procs = line.line.index(index), len(line.line)
            n = template.shape[dim]
            if a.ndim <= dim or a.shape[dim] != n * procs:
                raise ValueError(
                    f"the checkpoint holds an array of shape {tuple(a.shape)} where "
                    f"{procs} processes' shares {tuple(template.shape)} along dim "
                    f"{dim} make {n * procs}"
                )
            a = a.take(range(index * n, (index + 1) * n), axis=dim)
        if tuple(a.shape) != tuple(template.shape):
            raise ValueError(
                f"the checkpoint holds an array of shape {tuple(a.shape)} "
                f"where the state has {tuple(template.shape)}"
            )
        return torch.tensor(a, dtype=template.dtype, device=template.device)
    if isinstance(template, int) and not isinstance(template, bool):
        a = np.asarray(sd)
        if a.size and (a != a.flat[0]).any():
            raise ValueError(f"the workers' counts differ: {a.tolist()}")
        return int(a.flat[0]) if a.size else int(template)
    return sd


def list_checkpoints(directory: str) -> list[int]:
    """Steps of all checkpoints in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        m = _CKPT_RE.match(name)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_checkpoint(directory: str) -> Optional[int]:
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


def _write_atomic(directory: str, path: str, chunks) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            for chunk in chunks:
                f.write(chunk)
        os.replace(tmp, path)  # atomic: never torn at `path`
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_checkpoint(
    directory: str,
    state: Any,
    step: int,
    keep: int = 3,
    metadata: Optional[dict] = None,
) -> Optional[str]:
    """Write ``state`` (a trainer state, an optimizer state or a params
    tree) at ``step``; prune to ``keep``. Returns the written path, or
    None on processes other than 0, which do not write."""
    from mpit_tpu_torch.comm.collectives import barrier
    from mpit_tpu_torch.comm.topology import current_process
    from mpit_tpu_torch.parallel.common import check_live

    check_live(state, "checkpoint")
    # collective (the stacked fields gather across processes): before the
    # process-0 gate, or the others would wait in the gather for ever
    host_state = state_to_host(state)
    path = None
    try:
        if current_process()[0] == 0:
            os.makedirs(directory, exist_ok=True)
            path = _ckpt_path(directory, step)
            # to_bytes packs the state dict in its own order
            _write_atomic(directory, path, _serialize_chunks(host_state, sort=False))
            if metadata is not None:
                meta_path = os.path.join(directory, f"ckpt_{step:08d}.json")
                with open(meta_path, "w") as f:
                    json.dump({"step": step, **metadata}, f)
            for old in list_checkpoints(directory)[:-keep]:
                os.unlink(_ckpt_path(directory, old))
                meta = os.path.join(directory, f"ckpt_{old:08d}.json")
                if os.path.exists(meta):
                    os.unlink(meta)
    finally:
        # the save is done for no process until it is done for all: a
        # process restoring at once must find the file; in a finally, so a
        # failed write still releases the others
        barrier(f"mpit_ckpt_save_{step}")
    return path


def restore_checkpoint(
    directory: str, template: Any, step: Optional[int] = None
) -> tuple[Any, Optional[int]]:
    """Restore the latest (or ``step``'s) checkpoint into the structure of
    ``template`` (a fresh state whose values are replaced), on the
    template's devices. Returns ``(state, step)``, or ``(template, None)``
    when there is no checkpoint."""
    if step is None:
        step = latest_checkpoint(directory)
        if step is None:
            return template, None
    with open(_ckpt_path(directory, step), "rb") as f:
        payload = f.read()
    return state_from_state_dict(template, msgpack_restore(payload)), step
