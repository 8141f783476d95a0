"""mpit_tpu_torch.obs — distributed tracing + wire telemetry for the PS protocol.

The port's copy of ``mpit_tpu/obs/__init__.py``, with the same public names;
nothing here imports JAX or the JAX package, so a run is read where it ran.

The third subsystem next to ``analysis`` (static/runtime correctness) and
``transport.chaos`` (fault injection): cross-rank trace/span context
propagated through the transport (docs/OBSERVABILITY.md), per-(peer, tag)
wire telemetry, per-rank JSONL event journals, and a merger CLI
(``python -m mpit_tpu_torch.obs``) that joins them — optionally overlaying a
chaos FaultLog — into one Perfetto timeline.

Activation: ``AsyncPSTrainer(obs=ObsConfig(...))`` in code, or any
``MPIT_OBS_*`` env knob for launcher-driven runs (no code changes).

The live plane (``MPIT_OBS_LIVE=1`` / ``ObsConfig(live=True)``) adds
in-run snapshots: a per-rank :class:`~mpit_tpu_torch.obs.live.MetricsRegistry`
exported atomically to ``<dir>/live/rank_<r>.json``, aggregated by
``python -m mpit_tpu_torch.obs live <dir>`` into a dashboard with online
health alerts (:mod:`mpit_tpu_torch.obs.alerts`).

The dynamics plane (:mod:`mpit_tpu_torch.obs.dynamics`) reduces the same
journals to update-quality evidence — per-source push staleness,
per-client elastic-distance trajectories with a divergence verdict,
update/param norm ratios — via ``python -m mpit_tpu_torch.obs dynamics
<dir> [--gate dynamics.json]``.

The black box (:mod:`mpit_tpu_torch.obs.blackbox`, on by default whenever a
journal dir is armed) keeps a bounded ring of each rank's last records
and dumps it to ``<dir>/blackbox/rank_<r>.jsonl`` on SIGTERM/atexit/
alert/supervisor request; ``python -m mpit_tpu_torch.obs postmortem <dir>``
(:mod:`mpit_tpu_torch.obs.postmortem`) assembles the dumps into a cross-rank
incident report — first-mover, final exchange rounds acked/dropped,
staleness/elastic/wire-phase overlays.
"""

from mpit_tpu_torch.obs.alerts import (  # noqa: F401
    AlertConfig,
    AlertEngine,
    read_alerts,
)
from mpit_tpu_torch.obs.blackbox import (  # noqa: F401
    BlackBox,
    arm_process_triggers,
    box_for,
    request_dump,
)
from mpit_tpu_torch.obs.core import (  # noqa: F401
    Journal,
    LogicalClock,
    NULL_SPAN,
    ObsConfig,
    SpanContext,
    Tracer,
    arm_faulthandler,
    config_from_env,
    disarm_faulthandler,
    span,
    write_fault_log,
)
from mpit_tpu_torch.obs.dynamics import (  # noqa: F401
    aggregate_dynamics,
    check_dynamics_gate,
    diverging,
    load_gate,
)
from mpit_tpu_torch.obs.live import (  # noqa: F401
    LiveExporter,
    MetricsRegistry,
    NULL_REGISTRY,
    aggregate,
    live_registry,
    read_snapshots,
    validate_snapshot,
)
from mpit_tpu_torch.obs.merge import (  # noqa: F401
    diff_summaries,
    merge_to_chrome_trace,
    read_journal,
    roofline,
    summarize,
    trace_ids_by_rank,
)
from mpit_tpu_torch.obs.postmortem import (  # noqa: F401
    analyze as analyze_postmortem,
    format_report as format_postmortem,
    load_dumps,
)
from mpit_tpu_torch.obs.telemetry import (  # noqa: F401
    TelemetryTransport,
    maybe_wrap,
    wrap_from_env,
    wrap_obs_transports,
)
