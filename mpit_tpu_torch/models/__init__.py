"""Models of the port: LeNet and the MLP."""

from mpit_tpu_torch.models.lenet import LeNet  # noqa: F401
from mpit_tpu_torch.models.mlp import MLP  # noqa: F401
