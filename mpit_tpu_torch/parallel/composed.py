"""Composed parallelism: one 3-D ``(dp, tp, sp)`` world, one step;
counterpart of ``mpit_tpu/parallel/composed.py``
(``ComposedParallelTrainer``).

The reference runs data parallelism (batch over ``dp``), the Megatron
tensor parallelism of ``parallel/tensor.py`` (over ``tp``) and exact ring
or Ulysses sequence parallelism (over ``sp``) in one jitted step on one
``TransformerLM(seq_axis="sp")``. The port stacks the world as it stacks
every mesh (``comm/topology.py``): worker ``d·tp·sp + t·sp + r`` is batch
group ``d``, tensor shard ``t`` and sequence block ``r``. On one card that
means: the global batch is cut into ``sp`` sequence blocks ``(sp, B,
T/sp)`` as ``parallel/seq.py`` cuts it, the model attends over the stacked
ring, and the row-parallel products sum their ``tp`` shards in order
(``parallel/tensor.py``); the params stay whole. The loss is the mean over
every token of every block, the reference's ``pmean`` over sp of the
GSPMD mean over dp, and the update sees the whole gradient (cross-leaf
transforms such as global-norm clipping are safe, as in the reference).

tp, sp or both may span processes, where each process's workers form a
block of the mesh (``Topology.axis_span``): the ring as in
``parallel/seq.py``, the shards as in ``parallel/tensor.py``; the sharded
gradients are summed over the tp processes, then everything is averaged
over the processes that hold the same shards, and the evaluation counts
are summed over those.
"""

from __future__ import annotations

from typing import Callable, Optional

from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.parallel.seq import SeqParallelTrainer
from mpit_tpu_torch.parallel.tensor import (
    check_tp_divisibility, tp_across_processes, tp_state_specs,
)


class ComposedParallelTrainer(SeqParallelTrainer):
    """dp × tp × sp training for :class:`TransformerLM`.

    Usage::

        topo = mpit_tpu_torch.init(axis_names=("dp", "tp", "sp"), mesh_shape=(2, 2, 2))
        model = TransformerLM(vocab_size=V, seq_axis="sp")
        trainer = ComposedParallelTrainer(model, optim.Adam(3e-4), topo)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        state, metrics = trainer.step(state, x_global, y_global)

    Requires mesh axes named exactly ``("dp", "tp", "sp")``, a model with
    ``seq_axis="sp"``, a global batch divisible by dp, a sequence length
    divisible by sp, and the tp divisibility rules of the 2-D trainer.
    ``donate_state`` and ``capture`` (the step as a CUDA graph) are
    :class:`DataParallelTrainer`'s.
    """

    def __init__(self, model, optimizer, topo: Optional[Topology] = None,
                 loss_fn: Optional[Callable] = None, donate_state: bool = True,
                 capture: Optional[bool] = None):
        self.optimizer = optimizer
        self.topo = topo if topo is not None else _current_topology()
        names = self.topo.axis_names
        if tuple(names) != ("dp", "tp", "sp"):
            raise ValueError(
                "ComposedParallelTrainer needs a mesh with axes "
                "('dp', 'tp', 'sp'), e.g. mpit_tpu_torch.init(axis_names="
                "('dp','tp','sp'), mesh_shape=(D, T, S)); got "
                f"{names}"
            )
        if getattr(model, "seq_axis", None) != "sp":
            raise ValueError(
                "the composed trainer shards the sequence: construct the "
                "model with seq_axis='sp' "
                f"(got {getattr(model, 'seq_axis', None)!r})"
            )
        if getattr(model, "moe_experts", 0):
            raise ValueError(
                "MoE models are not composed here; use MoEParallelTrainer"
            )
        check_tp_divisibility(model, self.tp_size)
        self.batch_axis, self.seq_axis = "dp", "sp"
        self._place()
        across = {k: span for k, span in (("seq_span", self._seq_span),
                                          ("tp_span", self._tp_span)) if not span.local}
        self.model = model.clone(tp=self.tp_size, **across)
        self.accum_steps = 1
        self.donate_state = bool(donate_state)
        self.bucketed = False
        self.obs, self._tracer = None, None
        self.loss_fn = (loss_fn if loss_fn is not None
                        else common.default_loss_fn(self.model.apply))
        self._vg = common.accumulated_value_and_grad(
            self.loss_fn, 1, remat=getattr(model, "remat", False))
        self._eval = common.build_count_loss_eval(
            self.model, self.topo.device, split=self._blocks)
        self._init_capture(capture, optimizer)

    def _place(self) -> None:
        super()._place()
        self._tp_span = self.topo.axis_span("tp")
        self._peers = self._tp_peers = self.topo.peers("tp")

    def _across_processes(self, grads, loss):
        if self._tp_span.local:
            return super()._across_processes(grads, loss)
        return tp_across_processes(self, grads, loss)

    @property
    def dp_size(self) -> int:
        return self.topo.mesh_shape[0]

    @property
    def tp_size(self) -> int:
        return self.topo.mesh_shape[1]

    @property
    def sp_size(self) -> int:
        return self.topo.mesh_shape[2]

    def state_sharding(self, state):
        """The Megatron spec tree (strict), replicated over dp and sp."""
        return tp_state_specs(state)
