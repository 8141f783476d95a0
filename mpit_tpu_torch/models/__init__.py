"""Models of the port: LeNet, the MLP and the transformer LM."""

from mpit_tpu_torch.models.lenet import LeNet  # noqa: F401
from mpit_tpu_torch.models.mlp import MLP  # noqa: F401
from mpit_tpu_torch.models.transformer import TransformerLM  # noqa: F401
