"""Trainers of the port: EASGD / EAMSGD and Downpour over stacked workers,
sync DP (fused, or the bucketed and quantized exchange), ZeRO-1 sync DP,
sequence-parallel sync over a (dp, sp) world, tensor, pipeline,
expert-parallel and composed (dp, tp, sp) training, and the host-async
parameter server (servers and clients as threads)."""

from mpit_tpu_torch.parallel.composed import ComposedParallelTrainer  # noqa: F401
from mpit_tpu_torch.parallel.downpour import DownpourState, DownpourTrainer  # noqa: F401
from mpit_tpu_torch.parallel.easgd import EASGDState, EASGDTrainer  # noqa: F401
from mpit_tpu_torch.parallel.moe import MoEParallelTrainer  # noqa: F401
from mpit_tpu_torch.parallel.pclient import PClient  # noqa: F401
from mpit_tpu_torch.parallel.pserver import PServer  # noqa: F401
from mpit_tpu_torch.parallel.ps_trainer import AsyncPSTrainer  # noqa: F401
from mpit_tpu_torch.parallel.seq import SeqParallelTrainer  # noqa: F401
from mpit_tpu_torch.parallel.sync import DataParallelTrainer  # noqa: F401
from mpit_tpu_torch.parallel.tensor import TensorParallelTrainer  # noqa: F401
from mpit_tpu_torch.parallel.zero import ZeroDataParallelTrainer  # noqa: F401
