"""Stand-in for ``mpit_tpu/obs/live.py`` until ROADMAP.md item A12.

The reference publishes training metrics (steps, exchange seconds,
staleness, elastic distance...) to a per-rank registry when a transport
carries one (``MPIT_OBS_LIVE``), and to a shared no-op registry
otherwise. The port arms no registry yet, so :func:`live_registry`
always returns the no-op. The ``M_*`` names are the reference's, for the
training plane the PS roles publish to.
"""

from __future__ import annotations

from typing import Any

M_STEPS = "train.steps"
M_SAMPLES = "train.samples"
M_COMPUTE_S = "train.compute_s"
M_EXCHANGE_S = "train.exchange_s"
M_EXCHANGE_LAT = "train.exchange_lat"
M_ROUNDS = "train.rounds"
M_PUSHES = "train.pushes"
M_SKIPPED_ROUNDS = "train.skipped_rounds"
M_EXCHANGE_FAILURES = "train.exchange_failures"
M_STALE_PARAMS = "train.stale_params_dropped"
M_REPAIRED_CHUNKS = "train.repaired_chunks"
M_STALENESS = "train.staleness"
M_ELASTIC_DIST = "train.elastic_dist"
M_PUSH_NORM = "train.push_norm"
M_PARAM_NORM = "train.param_norm"
M_NORM_RATIO = "train.norm_ratio"


class _NullRegistry:
    """Drops every publish: the reference's ``NULL_REGISTRY``."""

    __slots__ = ()

    def inc(self, name: str, value: float = 1.0) -> None:
        pass

    def set_gauge(self, name: str, value: float) -> None:
        pass

    def observe(self, name: str, seconds: float) -> None:
        pass


NULL_REGISTRY = _NullRegistry()


def live_registry(obj: Any) -> _NullRegistry:
    """The registry to publish to for ``obj`` (a transport): the no-op."""
    return NULL_REGISTRY
