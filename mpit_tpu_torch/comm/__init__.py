"""Topology and collectives over the stacked worker dim."""

from mpit_tpu_torch.comm.collectives import AVG, SUM, allreduce, pmean, psum  # noqa: F401
from mpit_tpu_torch.comm.topology import (  # noqa: F401
    Topology,
    finalize,
    init,
    is_initialized,
    resolve_device,
    size,
    topology,
)
