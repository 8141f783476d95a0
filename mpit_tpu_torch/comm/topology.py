"""Topology bootstrap: the port's ``mpiT.Init / Comm_rank / Comm_size``.

Counterpart of ``mpit_tpu/comm/topology.py``. The JAX package gives every
worker its own device on a mesh axis. On one card the port keeps the same
*stacked* layout the reference's trainers already use for their state
(``mpit_tpu/parallel/easgd.py``): every per-worker tensor carries a leading
dim of size W, and a collective over the workers is a reduction over that
dim. So W = 8 workers run on one H100 as they do on the 8-device CPU mesh.

A world of several processes (``python -m mpit_tpu_torch.launch -n N
--jax-distributed``, or the same environment set by hand: ``MPIT_DISTRIBUTED
=1``, ``MPIT_RANK``, ``MPIT_WORLD_SIZE`` and the coordinator address in
``JAX_COORDINATOR_ADDRESS``, the reference's contract) joins a
``torch.distributed`` group in :func:`init`: NCCL when the workers live on
the card (process ``r`` on card ``r``), gloo when they live on the CPU.
Each process stacks its own W workers; the world's worker count is W times
the process count, as the reference's mesh spans its processes, and each
collective reduces the local dim first, then makes one call across the
processes.

Two identities, as in the reference: ``process_rank()``/``process_count()``
name the host process, ``rank()``/``size()`` the workers.

A world has a mesh shape over named axes, as the reference's mesh has:
``("dp",)`` with ``(W,)`` by default, or ``("dp", "sp")`` with ``(dp, sp)``
for sequence parallelism (``init(axis_names=..., mesh_shape=...)``). The
stacked dim holds the workers in the mesh's row-major order, worker
``d·sp + r`` at batch group ``d`` and sequence block ``r``. Process ``p``
holds the world's workers ``[p·W, (p+1)·W)``, so the inner axes (sp, tp)
span processes where a process holds a share of one inner group: its W
stacked workers cover either whole inner groups or an equal share of one.
:meth:`Topology.axis_span` gives a process its place on an axis and the
processes it shares the axis's lines with.

Devices: an entry point runs on the card unless the caller passes
``device="cpu"``. Without CUDA, asking for the default device raises; the
port never drops silently to the CPU.

The consistent-hash shard ring of the sharded parameter servers
(:class:`HashRing`, :class:`ShardMap`, :func:`reshard_schedule`) is a copy
of ``mpit_tpu/comm/topology.py:242-417``: placement is a wire-visible
constant, equal in both packages (``tests/test_torch_ps.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Union

import torch

from mpit_tpu_torch.analysis.runtime import make_lock

# the stacked tensors' worker dim: what psum/pmean reduce over
WORKER_DIM = 0
# the first mesh axis, the workers' (the reference's default mesh axis)
WORKER_AXIS = "dp"
# workers per card when the caller names none: the reference's 8-device
# test mesh, so the default run has the reference's W and α = 0.9/W
DEFAULT_WORKERS = 8

_lock = make_lock("topology._lock")
_topology: Optional["Topology"] = None
_distributed_initialized = False
# lines of processes -> this process's torch.distributed group among them
_line_groups: dict = {}


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: the card unless ``device`` names
    the CPU. Raises when a CUDA device is wanted and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; have cuda, cpu")
    return dev


@dataclasses.dataclass(frozen=True)
class Topology:
    """World description produced by :func:`init`: ``num_workers`` workers
    in the world, stacked on dim :data:`WORKER_DIM` of every per-worker
    tensor, :attr:`local_workers` of them in each of ``process_count``
    processes, this one ``process_index``."""

    num_workers: int
    device: torch.device
    process_index: int = 0
    process_count: int = 1
    axis_names: tuple = (WORKER_AXIS,)
    # the world's mesh over ``axis_names`` (default ``(num_workers, 1, ...)``)
    mesh_shape: Optional[tuple] = None

    def __post_init__(self):
        if self.num_workers % self.process_count:
            raise ValueError(
                f"{self.num_workers} workers do not split evenly over "
                f"{self.process_count} processes"
            )
        names = tuple(self.axis_names)
        shape = (tuple(int(n) for n in self.mesh_shape)
                 if self.mesh_shape is not None
                 else (self.num_workers,) + (1,) * (len(names) - 1))
        if len(shape) != len(names):
            raise ValueError(f"mesh_shape {shape} does not match axes {names}")
        if math.prod(shape) != self.num_workers:
            raise ValueError(
                f"mesh_shape {shape} does not cover {self.num_workers} workers"
            )
        inner, local = math.prod(shape[1:]), self.local_workers
        if local % inner and inner % local:
            raise ValueError(
                f"mesh_shape {shape}: the {names[1:]} extent {inner} and each "
                f"process's {local} stacked workers must divide one or the "
                "other: a process holds whole groups of the inner axes or an "
                "equal share of one, and cannot hold this mesh's"
            )
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "mesh_shape", shape)

    @property
    def platform(self) -> str:
        return self.device.type

    @property
    def worker_axis(self) -> int:
        return WORKER_DIM

    @property
    def local_workers(self) -> int:
        """The stacked W of this process."""
        return self.num_workers // self.process_count

    @property
    def num_devices(self) -> int:
        return self.process_count

    def local_slice(self, n: int) -> slice:
        """This process's share of ``n`` items split evenly over the world's
        workers in order (a global batch, a stacked leaf)."""
        per = n // self.process_count
        return slice(self.process_index * per, (self.process_index + 1) * per)

    def _box(self, process: int) -> tuple:
        """``(start, count)`` on each mesh axis of ``process``'s workers,
        which form a box of the mesh (raises where they do not)."""
        shape, w0 = self.mesh_shape, process * self.local_workers
        coords = [[] for _ in shape]
        for w in range(w0, w0 + self.local_workers):
            for i in reversed(range(len(shape))):
                w, c = divmod(w, shape[i])
                coords[i].append(c)
        box = tuple((min(c), len(set(c))) for c in coords)
        if math.prod(n for _, n in box) != self.local_workers or any(
                max(c) - lo + 1 != n for c, (lo, n) in zip(coords, box)):
            raise ValueError(
                f"mesh_shape {shape}: process {process}'s {self.local_workers} "
                "workers do not form a block of the mesh"
            )
        return box

    def _lines(self, axis: str, along: bool) -> tuple:
        """``(dim, boxes, line, lines)`` of the mesh axis ``axis``: every
        process's box, and the processes grouped, in process order (which
        is the axis's order within a group), by their boxes on the other
        axes (``along``: a group lies along the axis) or on the axis."""
        if axis not in self.axis_names:
            raise ValueError(f"unknown mesh axis {axis!r}; have {self.axis_names}")
        dim = self.axis_names.index(axis)
        boxes = [self._box(p) for p in range(self.process_count)]
        groups: dict = {}
        for p, box in enumerate(boxes):
            key = box[:dim] + box[dim + 1:] if along else box[dim]
            groups.setdefault(key, []).append(p)
        lines = tuple(tuple(g) for g in groups.values())
        line = next(ln for ln in lines if self.process_index in ln)
        return dim, boxes, line, lines

    def axis_span(self, axis: str) -> "AxisSpan":
        """This process's place on the mesh axis ``axis`` (see
        :class:`AxisSpan`)."""
        dim, boxes, line, lines = self._lines(axis, along=True)
        start, count = boxes[self.process_index][dim]
        return AxisSpan(line, lines, axis, self.mesh_shape[dim], start, count)

    def peers(self, axis: str) -> "ProcessLine":
        """The processes that hold this process's indices on the mesh axis
        ``axis`` (all of them where each holds the whole axis): the group
        a mean over the other axes runs in."""
        _, _, line, lines = self._lines(axis, along=False)
        return ProcessLine(line, lines)


@dataclasses.dataclass(frozen=True)
class ProcessLine:
    """A group of processes (``line``, this process's) and the partition of
    the world into such groups (``lines``, alike in every process)."""

    line: tuple
    lines: tuple


@dataclasses.dataclass(frozen=True)
class AxisSpan(ProcessLine):
    """A process's place on one mesh axis: it holds indices ``[start,
    start + count)`` of the axis's ``size``; its ``line`` are the processes
    that share its indices on every other axis, in the axis's order (one
    for each ``count`` indices; just this process when it holds the whole
    axis), and ``lines`` every process's line (the groups a collective over
    the axis runs in)."""

    name: str
    size: int
    start: int
    count: int

    @property
    def local(self) -> bool:
        """Whether this process holds the whole axis (no collective over it
        crosses a process)."""
        return self.count == self.size


def _should_init_distributed() -> bool:
    """A process world is opt-in through the launcher's environment, as in
    the reference (``MPIT_DISTRIBUTED`` or a coordinator address)."""
    if os.environ.get("MPIT_DISTRIBUTED", "").lower() in ("1", "true"):
        return True
    return bool(os.environ.get("JAX_COORDINATOR_ADDRESS"))


def _init_distributed(device: torch.device) -> torch.device:
    """Join the ``torch.distributed`` group the environment describes;
    returns the device of this process's workers."""
    import torch.distributed as dist

    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("MPIT_WORLD_SIZE")
    pid = os.environ.get("MPIT_RANK")
    if not (coord and nproc is not None and pid is not None):
        raise RuntimeError(
            "a process world needs MPIT_RANK, MPIT_WORLD_SIZE and "
            "JAX_COORDINATOR_ADDRESS (host:port); `python -m "
            "mpit_tpu_torch.launch -n N --jax-distributed` sets them"
        )
    nproc, pid = int(nproc), int(pid)
    if device.type == "cuda":
        cards = torch.cuda.device_count()
        if nproc > cards:
            raise RuntimeError(
                f"{nproc} processes but {cards} visible card(s): NCCL runs "
                "one process per card and cannot share one; run fewer "
                "ranks, or put the workers on the CPU (device='cpu', gloo)"
            )
        device = torch.device("cuda", pid)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=nproc, rank=pid
    )
    return device


def init(
    num_workers: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
    axis_names: Sequence[str] = (WORKER_AXIS,),
    mesh_shape: Optional[Sequence[int]] = None,
) -> Topology:
    """Initialize the world. ``num_workers`` is the stacked W of this
    process (default 8, or the mesh's share of it when ``mesh_shape`` is
    given); in a process world the topology counts every process's.
    ``axis_names`` and ``mesh_shape`` are the reference's: the world's
    mesh, e.g. ``axis_names=("dp", "sp"), mesh_shape=(2, 4)``.
    Idempotent: a repeated call returns the existing topology unless
    :func:`finalize` ran in between; explicit arguments on an existing
    world raise, as in the reference."""
    global _topology, _distributed_initialized
    with _lock:
        if _topology is not None:
            explicit = (num_workers is not None or device is not None
                        or tuple(axis_names) != (WORKER_AXIS,)
                        or mesh_shape is not None)
            if explicit:
                raise RuntimeError(
                    "mpit_tpu_torch.init() called with explicit arguments "
                    "but a topology already exists; call finalize() first"
                )
            return _topology
        dev = resolve_device(device)
        index, count = 0, 1
        if _should_init_distributed():
            import torch.distributed as dist

            if not _distributed_initialized:
                dev = _init_distributed(dev)
                _distributed_initialized = True
            index, count = dist.get_rank(), dist.get_world_size()
        if num_workers is not None:
            w = int(num_workers)
        elif mesh_shape is not None:
            w = math.prod(mesh_shape) // count
        else:
            w = DEFAULT_WORKERS
        if w < 1:
            raise ValueError(f"num_workers={num_workers} must be >= 1")
        _topology = Topology(num_workers=w * count, device=dev,
                             process_index=index, process_count=count,
                             axis_names=tuple(axis_names),
                             mesh_shape=mesh_shape)
        return _topology


def finalize() -> None:
    """``mpiT.Finalize()``: drop the world, and leave the process group
    :func:`init` joined. Safe when uninitialized."""
    global _topology, _distributed_initialized
    with _lock:
        _topology = None
        _line_groups.clear()
        if _distributed_initialized:
            import torch.distributed as dist

            dist.destroy_process_group()
            _distributed_initialized = False


def is_initialized() -> bool:
    return _topology is not None


def topology() -> Topology:
    """The current topology, auto-initializing with defaults if needed."""
    if _topology is None:
        return init()
    return _topology


def size() -> int:
    """Number of workers in the world — ``mpiT.Comm_size``."""
    return topology().num_workers


def rank() -> torch.Tensor:
    """The world's indices of this process's stacked workers, one per
    entry of the worker dim (the stacked counterpart of the reference's
    ``lax.axis_index``)."""
    topo = topology()
    base = topo.process_index * topo.local_workers
    return torch.arange(base, base + topo.local_workers, device=topo.device)


def process_rank() -> int:
    """Host-process index (the MPI rank of the process)."""
    return topology().process_index


def process_count() -> int:
    return topology().process_count


def current_process() -> tuple[int, int]:
    """``(process_index, process_count)`` of the current world, ``(0, 1)``
    when none is initialized (never initializes one)."""
    topo = _topology
    return (0, 1) if topo is None else (topo.process_index, topo.process_count)


def in_process_group() -> bool:
    """Whether :func:`init` joined a ``torch.distributed`` group, whose
    calls the collectives then make (in a world of one process too)."""
    return _distributed_initialized


def line_group(span):
    """The ``torch.distributed`` group of this process's line along
    ``span``'s axis (a :class:`ProcessLine`, an :class:`AxisSpan` too): None
    (the default group) when the line is the whole world. The first call
    for a set of lines creates every line's group, so every process makes
    it at the same point of its program."""
    import torch.distributed as dist

    if len(span.line) == dist.get_world_size():
        return None
    with _lock:
        if span.lines not in _line_groups:
            mine, _ = dist.new_subgroups_by_enumeration([list(ln) for ln in span.lines])
            _line_groups[span.lines] = mine
        return _line_groups[span.lines]

# ---------------------------------------------------------------------------
# Consistent-hash shard ring (sharded parameter servers).
#
# Ownership of parameter shards is decided by a consistent-hash ring over the
# live server ranks (docs/ROBUSTNESS.md "Shard ownership & resharding"). The
# ring is deterministic across processes — keys are hashed with blake2b, never
# Python's randomized ``hash()`` — so every client and server derives the same
# assignment from the same member set without coordination. Removing one of N
# members moves only the shards the leaver owned (~1/N of keys); everything
# else stays put, which is what bounds reshard traffic under churn.


def _ring_hash(key: str) -> int:
    import hashlib

    return int.from_bytes(
        hashlib.blake2b(key.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring over server ranks with a monotonic version.

    ``version`` increments on every membership change (``without`` /
    ``with_member``) and rides the TAG_SHARD_MAP wire envelope so receivers
    can discard stale views. Instances are immutable; membership edits return
    a new ring.
    """

    __slots__ = ("members", "vnodes", "version", "_points")

    def __init__(self, members, vnodes: int = 64, version: int = 0):
        self.members = tuple(sorted(set(int(m) for m in members)))
        if not self.members:
            raise ValueError("HashRing needs at least one member")
        self.vnodes = int(vnodes)
        self.version = int(version)
        pts = []
        for m in self.members:
            for v in range(self.vnodes):
                pts.append((_ring_hash(f"m{m}:v{v}"), m))
        pts.sort()
        self._points = pts

    def owner(self, key) -> int:
        """The member owning ``key`` (first point clockwise of its hash)."""
        import bisect

        h = _ring_hash(f"k{key}")
        i = bisect.bisect_right(self._points, (h, 1 << 62))
        if i == len(self._points):
            i = 0
        return self._points[i][1]

    def without(self, rank: int) -> "HashRing":
        rest = [m for m in self.members if m != rank]
        return HashRing(rest, vnodes=self.vnodes, version=self.version + 1)

    def with_member(self, rank: int) -> "HashRing":
        return HashRing(
            self.members + (int(rank),), vnodes=self.vnodes, version=self.version + 1
        )

    def __eq__(self, other):
        return (
            isinstance(other, HashRing)
            and self.members == other.members
            and self.vnodes == other.vnodes
        )

    def __hash__(self):
        return hash((self.members, self.vnodes))

    def __repr__(self):
        return f"HashRing(members={self.members}, vnodes={self.vnodes}, version={self.version})"


def shard_layout(param_size: int, num_shards: int):
    """Static, contiguous, near-equal split of the flat parameter vector.

    The layout never changes across membership churn — only *ownership* of
    each shard moves. Mirrors ``pserver.partition_bounds`` (kept separate to
    avoid a comm→parallel import cycle).
    """
    if num_shards <= 0:
        raise ValueError("num_shards must be positive")
    base, extra = divmod(param_size, num_shards)
    bounds = []
    start = 0
    for i in range(num_shards):
        size = base + (1 if i < extra else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


class ShardMap:
    """Ring + static layout glue: who owns which slice of the flat params.

    ``assignment[sid]`` is the owning rank of shard ``sid``; the slice bounds
    come from :func:`shard_layout` and are immutable — a reshard moves
    ownership, never the cut points.
    """

    __slots__ = ("ring", "param_size", "num_shards", "layout", "assignment")

    def __init__(self, ring: HashRing, param_size: int, num_shards: int):
        self.ring = ring
        self.param_size = int(param_size)
        self.num_shards = int(num_shards)
        self.layout = shard_layout(self.param_size, self.num_shards)
        self.assignment = tuple(ring.owner(sid) for sid in range(self.num_shards))

    def with_ring(self, ring: HashRing) -> "ShardMap":
        return ShardMap(ring, self.param_size, self.num_shards)

    def ranges_for(self, rank: int):
        """Ascending ``(sid, start, end)`` triples owned by ``rank``."""
        return [
            (sid, s, e)
            for sid, (s, e) in enumerate(self.layout)
            if self.assignment[sid] == rank
        ]

    def owned_size(self, rank: int) -> int:
        return sum(e - s for _, s, e in self.ranges_for(rank))

    def server_ranks(self):
        """Members that own at least one shard, ascending."""
        return sorted(set(self.assignment))

    def shard_size(self, sid: int) -> int:
        s, e = self.layout[sid]
        return e - s


def reshard_schedule(old_map: ShardMap, new_map: ShardMap):
    """The slice exchanges needed to go from ``old_map`` to ``new_map``.

    Returns ascending-shard-id moves ``{"shard", "src", "dst", "size"}``.
    Executed in order, each destination holds at most its old slices plus the
    one incoming slice at any instant (see :func:`schedule_peak_elems`) — the
    no-full-duplicate property from the portable-redistribution literature.
    """
    if old_map.param_size != new_map.param_size or old_map.num_shards != new_map.num_shards:
        raise ValueError("reshard requires identical layout on both sides")
    moves = []
    for sid in range(old_map.num_shards):
        src = old_map.assignment[sid]
        dst = new_map.assignment[sid]
        if src != dst:
            moves.append(
                {"shard": sid, "src": src, "dst": dst, "size": old_map.shard_size(sid)}
            )
    return moves


def schedule_peak_elems(moves, old_map: ShardMap):
    """Per-rank peak resident element count while executing ``moves`` in order.

    A destination materializes the incoming slice while the source still holds
    it (the transfer), then the source frees its copy. The peak for every rank
    must stay ≤ old resident + incoming — never the full model.
    """
    ranks = set(old_map.ring.members)
    for mv in moves:
        ranks.add(mv["src"])
        ranks.add(mv["dst"])
    resident = {r: old_map.owned_size(r) for r in ranks}
    peak = dict(resident)
    for mv in moves:
        src, dst, size = mv["src"], mv["dst"], mv["size"]
        resident[dst] += size
        peak[dst] = max(peak[dst], resident[dst])
        resident[src] -= size
    return peak
