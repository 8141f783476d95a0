"""Topology and collectives over the stacked worker dim (and across the
processes of a ``torch.distributed`` world)."""

from mpit_tpu_torch.comm.collectives import (  # noqa: F401
    AVG,
    MAX,
    MIN,
    PROD,
    SUM,
    allgather,
    allreduce,
    barrier,
    bcast,
    device_barrier,
    pmax,
    pmean,
    pmin,
    ppermute_ring,
    psum,
    quantized_allreduce,
    quantized_psum_scatter,
    reduce_scatter,
)
from mpit_tpu_torch.comm.topology import (  # noqa: F401
    Topology,
    finalize,
    init,
    is_initialized,
    process_count,
    process_rank,
    rank,
    resolve_device,
    size,
    topology,
)
