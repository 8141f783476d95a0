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
