"""SLO accounting of the port: :mod:`~mpit_tpu_torch.loadgen.slo`, a copy of
``mpit_tpu/loadgen/slo.py``, for ``python -m mpit_tpu_torch.obs slo``.

The workload, the harness and the serving chaos of the reference's
``mpit_tpu/loadgen`` drive the serving stack, which the port does not have
yet (ROADMAP.md item A10); this package imports nothing of serving.
"""

from mpit_tpu_torch.loadgen.slo import (
    SLOAggregator,
    aggregate_paths,
    evaluate_gate,
    format_report,
    load_gate,
    pooled_latencies,
    validate_gate,
)

__all__ = [
    "SLOAggregator",
    "aggregate_paths",
    "evaluate_gate",
    "format_report",
    "load_gate",
    "pooled_latencies",
    "validate_gate",
]
