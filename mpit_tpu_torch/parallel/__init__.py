"""Trainers of the port: EASGD / EAMSGD over stacked workers, and sync DP."""

from mpit_tpu_torch.parallel.easgd import EASGDState, EASGDTrainer  # noqa: F401
from mpit_tpu_torch.parallel.sync import DataParallelTrainer  # noqa: F401
