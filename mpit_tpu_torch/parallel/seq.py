"""Sequence-parallel training over a (dp, sp) world; counterpart of
``mpit_tpu/parallel/seq.py`` (``SeqParallelTrainer``, algo ``seq-sync``).

The reference shards tokens ``(B, T)`` batch→dp and sequence→sp on a 2-D
mesh, runs the model with ``seq_axis="sp"`` (ring or Ulysses attention over
the sp axis, everything else position-local) and ``pmean``\\ s the loss and
the gradients over both axes. On one card the port stacks the sp ring as
it stacks the workers (``comm/topology.py``): a global batch becomes ``sp``
contiguous sequence blocks ``(sp, B, T/sp)``, block ``r`` holding global
positions ``[r·T/sp, (r+1)·T/sp)``, and dp is only the batch. The shards
are equal, so the mean token loss over all blocks is the reference's pmean
over both axes, and its gradient the pmean'd gradient: the step is one
forward and backward over the blocks, then the optimizer update. The math
is the same for every factorization of the world, (8, 1), (2, 4) or (1, 8),
as the reference's (``tests/test_torch_seq.py``).

In a world of several processes the sp ring lies inside each process
(``Topology`` refuses a mesh where it would not), each process takes its
dp groups' rows of the global batch, and the gradient and the loss are
averaged across the processes, as ``DataParallelTrainer`` does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.ops.ring_attention import to_blocks
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.parallel.sync import DataParallelTrainer


class SeqParallelTrainer(DataParallelTrainer):
    """Sync trainer over a 2-D (batch axis, sequence axis) world for an LM
    built with that sequence axis (``TransformerLM(seq_axis="sp")``).

    Usage::

        topo = mpit_tpu_torch.init(axis_names=("dp", "sp"), mesh_shape=(2, 4))
        model = TransformerLM(vocab_size=V, seq_axis="sp")
        trainer = SeqParallelTrainer(model, optim.Adam(3e-4), topo)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        state, metrics = trainer.step(state, x_global, y_global)

    ``x_global`` is ``(B, T)`` with ``B`` divisible by dp and ``T`` by sp.
    Initialization, the step, ``fit`` and the process-world averaging are
    :class:`DataParallelTrainer`'s, on the blocked batch.
    """

    def __init__(self, model, optimizer, topo: Optional[Topology] = None,
                 loss_fn: Optional[Callable] = None):
        self.model = model
        self.optimizer = optimizer
        self.topo = topo if topo is not None else _current_topology()
        names = self.topo.axis_names
        if len(names) < 2:
            raise ValueError(
                "SeqParallelTrainer needs a 2-D mesh, e.g. "
                "mpit_tpu_torch.init(axis_names=('dp','sp'), mesh_shape=(B, S)); "
                f"got axes {names}"
            )
        self.batch_axis, self.seq_axis = names[:2]
        model_axis = getattr(model, "seq_axis", None)
        if model_axis != self.seq_axis:
            raise ValueError(
                f"model.seq_axis={model_axis!r} must name the mesh's "
                f"sequence axis {self.seq_axis!r} (construct the model "
                f"with seq_axis={self.seq_axis!r})"
            )
        self.accum_steps = 1
        self.bucketed = False  # the reference's seq trainer has no exchange knobs
        self.obs, self._tracer = None, None  # ...and no obs journal
        # the mean cross-entropy over every token of every block
        self.loss_fn = (loss_fn if loss_fn is not None
                        else common.default_loss_fn(model.apply))
        self._vg = common.accumulated_value_and_grad(
            self.loss_fn, 1, remat=getattr(model, "remat", False))
        self._eval = common.build_count_loss_eval(
            model, self.topo.device, split=self._blocks)

    @property
    def dp_size(self) -> int:
        return self.topo.mesh_shape[0]

    @property
    def sp_size(self) -> int:
        return self.topo.mesh_shape[1]

    def _blocks(self, a) -> torch.Tensor:
        """``(B, T)`` tokens as the stacked ring ``(sp, B, T/sp)``."""
        return to_blocks(torch.as_tensor(a), self.sp_size).contiguous()

    def _check(self, x) -> None:
        b, t = x.shape[:2]
        if b % self.dp_size or t % self.sp_size:
            raise ValueError(
                f"global batch {b}x{t} not divisible by mesh "
                f"(dp={self.dp_size}, sp={self.sp_size})"
            )

    def _shard(self, x, y):
        """This process's rows of a global batch, as sequence blocks."""
        mine = self.topo.local_slice(len(x))
        return self._blocks(x[mine]), self._blocks(y[mine])

    def evaluate(self, state, x, y, batch: int = 512):
        """Token-level accuracy and mean loss over an ``(N, T)`` eval set,
        in the reference's dp-divisible batches (only T must divide by sp:
        the set's length owes the mesh nothing)."""
        if x.shape[1] % self.sp_size:
            raise ValueError(
                f"sequence length {x.shape[1]} not divisible by "
                f"sp={self.sp_size}"
            )
        correct, loss_sum, n = common.batched_count_eval(
            self._eval, state.params, x, y, batch, self.dp_size
        )
        tokens = n * x.shape[1]
        return correct / tokens, loss_sum / tokens
