"""mpit_tpu_torch — the PyTorch/CUDA port of ``mpit_tpu`` for one NVIDIA H100.

The JAX package ``mpit_tpu`` is the reference; this package imports only
``torch`` and numpy, never JAX and nothing of ``mpit_tpu``. It keeps the
reference's module names, so each module's counterpart is found by name:

- ``comm``      — topology (W workers stacked on one device, in one or
  several processes, on a 1-D or a (dp, sp) mesh) and the collectives over
  the worker dim, ``ppermute_ring`` and the quantized allreduce and
  reduce-scatter among them.
- ``quant``     — the int8/bf16 quantization kernels: a numpy face (the PS
  wire) and a torch face (the collectives), bit for bit alike.
- ``goptim``    — EASGD / EAMSGD / Downpour math.
- ``optim``     — SGD, Adam and AdamW, global-norm clipping and the
  learning-rate schedules as ``optax`` computes them, in optax's state
  layout.
- ``ops``       — hand-written CUDA kernels (the fused elastic update; flash
  attention forward, dQ and dK/dV), each beside its plain PyTorch version;
  ring and Ulysses attention over a stacked sequence ring.
- ``models``    — LeNet, the MLP, VGG-small, ResNet-50, AlexNet, the LSTM
  and transformer LMs (``get_model``), with flax-keyed parameter trees;
  ``convert`` carries weights between the two packages. The serving tier:
  the LMs' decode modes, ``generate``, ``generate_fast``,
  ``generate_batch``, ``beam_search``, ``generate_rnn``, speculative
  decoding and the continuous-batching ``Server``/``RNNServer``, sampling
  from ``random``, the reference's threefry key stream.
- ``parallel``  — the EASGD, Downpour, sync data-parallel (fused, or the
  bucketed and quantized exchange), ZeRO-1 (zero-sync) and
  sequence-parallel (seq-sync) trainers, and the host-async parameter
  server.
- ``data``      — MNIST, CIFAR-10, ImageNet-like images and PTB or their
  synthetic stand-ins, batches, prefetch.
- ``utils``     — parameter trees, config, metrics, checkpoints in the
  reference's file format, profiler traces, completion barrier.
- ``obs``       — journals, live snapshots, the black box and the wire
  telemetry of the PS and sync trainers (the ``MPIT_OBS_*`` knobs), read
  by ``python -m mpit_tpu_torch.obs``; ``analysis.runtime`` holds the
  runtime sanitizers (``MPIT_RT_RACE``, ``MPIT_RT_NUMERICS``), and
  ``loadgen`` the seeded open-loop load harness (``python -m
  mpit_tpu_torch.loadgen``) and the SLO reader.
- ``run``       — ``python -m mpit_tpu_torch.run --preset mnist-easgd``
  (or any BASELINE preset), ``--preset ptb-transformer-large`` (seq-sync;
  ``--sp 4``, ``--seq-impl ulysses``, ``--remat``), or ``--preset
  ptb-transformer-large --algo sync|zero-sync --attn-impl flash``; sync
  DP's exchange takes ``MPIT_DP_QUANT``/``MPIT_DP_BUCKET_BYTES``.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from mpit_tpu_torch.comm import (  # noqa: F401
    AVG,
    MAX,
    MIN,
    PROD,
    SUM,
    Topology,
    allgather,
    allreduce,
    barrier,
    bcast,
    device_barrier,
    finalize,
    init,
    is_initialized,
    pmax,
    pmean,
    pmin,
    process_count,
    process_rank,
    psum,
    rank,
    reduce_scatter,
    size,
    topology,
)
from mpit_tpu_torch.utils.params import (  # noqa: F401
    FlatParamSpec,
    flatten_params,
    unflatten_params,
)
