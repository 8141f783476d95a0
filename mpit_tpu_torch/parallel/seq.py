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

In a world of several processes each process takes its rows of the
global batch (its indices on dp) and its sequence blocks (its indices on
sp): all the blocks where it holds whole dp groups, a share of one ring
where the ring spans processes. Such a ring passes its K/V blocks to the
neighbour process (``ops/ring_attention.py``) or exchanges head groups by
``all_to_all_single`` (``ops/ulysses.py``), both differentiable, so each
process's gradient of its local mean loss carries its share of every
other process's. The shards are equal, so the mean of the processes'
losses and gradients, which ``DataParallelTrainer``'s step takes, is the
reference's ``pmean`` over both axes. The evaluation cuts each eval batch
the same way and sums the counts across the processes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mpit_tpu_torch.comm.collectives import line_sum
from mpit_tpu_torch.comm.topology import ProcessLine, Topology, in_process_group
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
    Initialization, the step, ``fit``, ``donate_state``, ``capture`` (the
    step as a CUDA graph) and the process-world averaging are
    :class:`DataParallelTrainer`'s, on the blocked batch.
    """

    _log_tag = "seq-sync"

    def __init__(self, model, optimizer, topo: Optional[Topology] = None,
                 loss_fn: Optional[Callable] = None, donate_state: bool = True,
                 capture: Optional[bool] = None):
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
        self._place()
        if not self._seq_span.local:
            self.model = model = model.clone(seq_span=self._seq_span)
        self.accum_steps = 1
        self.donate_state = bool(donate_state)
        self.bucketed = False  # the reference's seq trainer has no exchange knobs
        self.obs, self._tracer = None, None  # ...and no obs journal
        # the mean cross-entropy over every token of every block
        self.loss_fn = (loss_fn if loss_fn is not None
                        else common.default_loss_fn(model.apply))
        self._vg = common.accumulated_value_and_grad(
            self.loss_fn, 1, remat=getattr(model, "remat", False))
        self._eval = common.build_count_loss_eval(
            model, self.topo.device, split=self._blocks)
        self._init_capture(capture, optimizer)

    def _place(self) -> None:
        """This process's place on the batch and sequence axes, and the
        processes its evaluation counts are summed over (the world)."""
        self._row_span = self.topo.axis_span(self.batch_axis)
        self._seq_span = self.topo.axis_span(self.seq_axis)
        world = tuple(range(self.topo.process_count))
        self._peers = ProcessLine(world, (world,))

    @property
    def dp_size(self) -> int:
        return self.topo.mesh_shape[0]

    @property
    def sp_size(self) -> int:
        return self.topo.mesh_shape[1]

    def _blocks(self, a) -> torch.Tensor:
        """``(B, T)`` tokens as the stacked ring ``(sp, B, T/sp)``, this
        process's blocks of it where the ring spans processes."""
        blocks = to_blocks(torch.as_tensor(a), self.sp_size)
        span = self._seq_span
        if not span.local:
            blocks = blocks[span.start:span.start + span.count]
        return blocks.contiguous()

    def _rows(self, a):
        """This process's rows of a global batch: its dp groups'."""
        per = len(a) // self.dp_size
        span = self._row_span
        return a[span.start * per:(span.start + span.count) * per]

    def _check(self, x) -> None:
        b, t = x.shape[:2]
        if b % self.dp_size or t % self.sp_size:
            raise ValueError(
                f"global batch {b}x{t} not divisible by mesh "
                f"(dp={self.dp_size}, sp={self.sp_size})"
            )

    def _shard(self, x, y):
        """This process's rows of a global batch, as its sequence blocks."""
        return self._blocks(self._rows(x)), self._blocks(self._rows(y))

    def _eval_shard(self, params, x, y):
        """The eval counts of this process's rows and blocks of a batch,
        summed over the processes that hold the others."""
        correct, loss_sum = self._eval(params, self._rows(x), self._rows(y))
        if not in_process_group():
            return correct, loss_sum
        both = line_sum(torch.stack([correct.double(), loss_sum.double()]), self._peers)
        return both[0], both[1]

    def evaluate(self, state, x, y, batch: int = 512):
        """Token-level accuracy and mean loss over an ``(N, T)`` eval set,
        in the reference's dp-divisible batches (only T must divide by sp:
        the set's length owes the mesh nothing)."""
        common.check_live(state, "evaluate")
        if x.shape[1] % self.sp_size:
            raise ValueError(
                f"sequence length {x.shape[1]} not divisible by "
                f"sp={self.sp_size}"
            )
        correct, loss_sum, n = common.batched_count_eval(
            self._eval_shard, state.params, x, y, batch, self.dp_size
        )
        tokens = n * x.shape[1]
        return correct / tokens, loss_sum / tokens
