"""Models of the port, one per BASELINE workload config, with flax-keyed
parameter trees: LeNet and the MLP (MNIST), VGGSmall (CIFAR-10), AlexNet
and ResNet-50 (ImageNet), the LSTM LM and the transformer LM (PTB), and
the serving tier: the decoding recipes (``generate``, ``generate_fast``,
``generate_batch``, ``beam_search``, ``generate_rnn``, the speculative
pair) and the continuous-batching ``Server`` and ``RNNServer``.
Counterpart of ``mpit_tpu/models/__init__.py``, with ``generate_tp`` under
a tensor-parallel split."""

from mpit_tpu_torch.models.lenet import LeNet  # noqa: F401
from mpit_tpu_torch.models.mlp import MLP  # noqa: F401
from mpit_tpu_torch.models.sampling import (  # noqa: F401
    beam_search,
    generate,
    generate_batch,
    generate_fast,
    generate_tp,
)
from mpit_tpu_torch.models.rnn_sampling import generate_rnn  # noqa: F401
from mpit_tpu_torch.models.serving import RNNServer, Server  # noqa: F401
from mpit_tpu_torch.models.speculative import (  # noqa: F401
    generate_speculative,
    generate_speculative_batch,
)
from mpit_tpu_torch.models.transformer import TransformerLM  # noqa: F401

_REGISTRY = {"lenet": LeNet, "mlp": MLP, "transformer": TransformerLM}

# registry names (and aliases) whose model takes a stem= choice
# (conv | space_to_depth — mpit_tpu_torch/ops/stem.py)
STEM_MODELS = ("resnet50", "resnet", "alexnet")

# registry names whose model takes a remat= flag
REMAT_MODELS = ("resnet50", "resnet", "transformer")


def get_model(name: str, **kwargs):
    """Construct a model by registry name or alias (the reference's)."""
    name = name.lower()
    if name not in _REGISTRY:
        if name in ("vgg", "vgg_small", "vggsmall"):
            from mpit_tpu_torch.models.vgg import VGGSmall as cls
        elif name == "alexnet":
            from mpit_tpu_torch.models.alexnet import AlexNet as cls
        elif name in ("resnet50", "resnet"):
            from mpit_tpu_torch.models.resnet import ResNet50 as cls
        elif name in ("lstm", "lstm_lm", "ptb_lstm"):
            from mpit_tpu_torch.models.lstm import LSTMLM as cls
        else:
            raise ValueError(f"unknown model: {name!r}")
        _REGISTRY[name] = cls
    return _REGISTRY[name](**kwargs)
