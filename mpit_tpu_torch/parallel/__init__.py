"""Trainers of the port: EASGD / EAMSGD over stacked workers."""

from mpit_tpu_torch.parallel.easgd import EASGDState, EASGDTrainer  # noqa: F401
