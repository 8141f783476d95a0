"""Topology bootstrap: the port's ``mpiT.Init / Comm_size``.

Counterpart of ``mpit_tpu/comm/topology.py``. The JAX package gives every
worker its own device on a mesh axis. On one card the port keeps the same
*stacked* layout the reference's trainers already use for their state
(``mpit_tpu/parallel/easgd.py``): every per-worker tensor carries a leading
dim of size W, and a collective over the workers is a reduction over that
dim. So W = 8 workers run on one H100 as they do on the 8-device CPU mesh.

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
import threading
from typing import Optional, Union

import torch

# the stacked tensors' worker dim: what psum/pmean reduce over
WORKER_DIM = 0
# workers per card when the caller names none: the reference's 8-device
# test mesh, so the default run has the reference's W and α = 0.9/W
DEFAULT_WORKERS = 8

_lock = threading.Lock()
_topology: Optional["Topology"] = None


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
    """World description produced by :func:`init`: W workers stacked on
    dim :data:`WORKER_DIM` of every per-worker tensor, on one device."""

    num_workers: int
    device: torch.device

    @property
    def platform(self) -> str:
        return self.device.type

    @property
    def worker_axis(self) -> int:
        return WORKER_DIM


def init(
    num_workers: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
) -> Topology:
    """Initialize the world. Idempotent: a repeated call returns the
    existing topology unless :func:`finalize` ran in between; explicit
    arguments on an existing world raise, as in the reference."""
    global _topology
    with _lock:
        if _topology is not None:
            if num_workers is not None or device is not None:
                raise RuntimeError(
                    "mpit_tpu_torch.init() called with explicit arguments "
                    "but a topology already exists; call finalize() first"
                )
            return _topology
        w = DEFAULT_WORKERS if num_workers is None else int(num_workers)
        if w < 1:
            raise ValueError(f"num_workers={num_workers} must be >= 1")
        _topology = Topology(num_workers=w, device=resolve_device(device))
        return _topology


def finalize() -> None:
    """``mpiT.Finalize()``: drop the world. Safe when uninitialized."""
    global _topology
    with _lock:
        _topology = None


def is_initialized() -> bool:
    return _topology is not None


def topology() -> Topology:
    """The current topology, auto-initializing with defaults if needed."""
    if _topology is None:
        return init()
    return _topology


def size() -> int:
    """Number of workers — ``mpiT.Comm_size``."""
    return topology().num_workers

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
