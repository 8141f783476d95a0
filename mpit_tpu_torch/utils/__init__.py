"""Utilities: flat-parameter handling, config, logging, metrics, checkpoint
and the completion barrier (the reference's ``mpit_tpu.utils`` names)."""

from mpit_tpu_torch.utils.params import (  # noqa: F401
    FlatParamSpec,
    flatten_params,
    tree_zeros_like,
    unflatten_params,
)
from mpit_tpu_torch.utils.checkpoint import (  # noqa: F401
    latest_checkpoint,
    list_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from mpit_tpu_torch.utils.config import PRESETS, TrainConfig  # noqa: F401
from mpit_tpu_torch.utils.metrics import MetricsLogger, Throughput  # noqa: F401
from mpit_tpu_torch.utils.profiling import (  # noqa: F401
    StepTimer,
    annotate,
    force_completion,
    trace,
)
