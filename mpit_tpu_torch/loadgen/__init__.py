"""Open-loop load generation and SLO accounting for the port's serving
stack; counterpart of ``mpit_tpu/loadgen``.

:mod:`workload` draws a seeded request schedule (Poisson arrivals, mixed
length buckets, cancellations), :mod:`harness` replays it against a live
``Server``/``RNNServer`` (optionally under :mod:`chaos` faults), the
server's obs journal records every request's lifecycle, and :mod:`slo`
reduces journals to TTFT/TPOT/e2e percentiles and goodput, read by
``python -m mpit_tpu_torch.obs slo <dir>``. The schedules and faults are
pure Python ``random`` and equal the reference's for the same spec.
"""

from mpit_tpu_torch.loadgen.chaos import ServeChaos
from mpit_tpu_torch.loadgen.harness import LoadHarness, LoadReport
from mpit_tpu_torch.loadgen.slo import (
    SLOAggregator,
    aggregate_paths,
    evaluate_gate,
    format_report,
    load_gate,
    pooled_latencies,
    validate_gate,
)
from mpit_tpu_torch.loadgen.workload import LoadSpec, Request, make_workload

__all__ = [
    "LoadSpec",
    "Request",
    "make_workload",
    "ServeChaos",
    "LoadHarness",
    "LoadReport",
    "SLOAggregator",
    "aggregate_paths",
    "evaluate_gate",
    "format_report",
    "load_gate",
    "pooled_latencies",
    "validate_gate",
]
