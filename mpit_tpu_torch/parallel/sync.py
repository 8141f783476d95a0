"""Synchronous data parallelism on one device; counterpart of the fused
path of ``mpit_tpu/parallel/sync.py`` (``DataParallelTrainer``).

Each of the reference's W workers takes an equal shard of the global
batch, computes the mean-loss gradient on it, and the step ``pmean``\\ s the
gradients over the workers before one replicated optimizer update. On one
card the params are one copy and the shards are equal slices of the global
batch, so the mean of the W shard-mean gradients is the gradient of the
mean loss over the global batch: the step computes exactly that, as one
forward/backward pass (or ``accum_steps`` sequential slices of it), then
the optimizer update. The batch must still divide by W and the per-worker
shard by ``accum_steps``, as in the reference. In a world of several
processes each takes its own workers' rows of the global batch, and the
gradient and loss are averaged across the processes (one all-reduce of
the flat gradient) before the update. A model with ``remat`` takes its
gradient through ``torch.autograd.grad`` (``common.autograd_value_and_grad``).

The bucketed and quantized exchange (``quant``/``bucket_bytes``, the
``MPIT_DP_QUANT``/``MPIT_DP_BUCKET_BYTES`` knobs) is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from mpit_tpu_torch.comm.topology import Topology, in_process_group
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.utils.params import tree_map


def _check_exchange(quant, bucket_bytes) -> None:
    env_quant = os.environ.get("MPIT_DP_QUANT") or "off"
    env_bucket = os.environ.get("MPIT_DP_BUCKET_BYTES") or None
    if (quant or env_quant) != "off" or (bucket_bytes or env_bucket) is not None:
        raise NotImplementedError(
            "the bucketed/quantized sync-DP exchange (quant, bucket_bytes, "
            "MPIT_DP_QUANT, MPIT_DP_BUCKET_BYTES) is not ported to "
            "mpit_tpu_torch yet (ROADMAP.md, item A6)"
        )


def _mean_across_processes(tree: Any, processes: int) -> Any:
    """The mean of ``tree`` over the world's processes: one all-reduce of
    the flat leaves, which returns the same bits on every process."""
    import torch.distributed as dist

    from mpit_tpu_torch.utils.params import flatten_params, unflatten_params

    flat, spec = flatten_params(tree)
    dist.all_reduce(flat)
    return unflatten_params(spec, flat / processes)


class DataParallelTrainer:
    """Sync allreduce DP trainer for a port model (``init``/``apply``).

    Args:
      model: the model; its ``apply(params, x)`` gives the logits.
      optimizer: ``optim.SGD``/``Adam``/``AdamW`` (``init``/``update``).
      topo: the topology (default: the current one); W sets the batch check.
      accum_steps: gradient accumulation slices per step (exact math).
    """

    def __init__(
        self,
        model,
        optimizer,
        topo: Optional[Topology] = None,
        accum_steps: int = 1,
        quant: Optional[str] = None,
        bucket_bytes: Optional[int] = None,
    ):
        _check_exchange(quant, bucket_bytes)
        self.model = model
        self.optimizer = optimizer
        self.topo = topo if topo is not None else _current_topology()
        self.accum_steps = common.check_accum_steps(accum_steps)
        self._vg = common.accumulated_value_and_grad(
            common.default_loss_fn(model.apply), self.accum_steps,
            remat=getattr(model, "remat", False),
        )
        self._eval = common.build_count_loss_eval(model, self.topo.device)

    def init_state(
        self, generator: Optional[torch.Generator] = None, params: Any = None
    ) -> common.TrainState:
        """Replicated state from the given tree, or ``model.init(generator)``."""
        if params is None:
            params = self.model.init(generator)
        params = tree_map(lambda a: a.detach().to(self.topo.device), params)
        return common.TrainState.create(params, self.optimizer)

    def _check(self, x) -> None:
        common.check_accum_batch(len(x), self.topo.num_workers, self.accum_steps)

    def _shard(self, x, y):
        """This process's rows of a global batch (all of it in one
        process)."""
        mine = self.topo.local_slice(len(x))
        return x[mine], y[mine]

    def _step(self, state: common.TrainState, x: torch.Tensor, y: torch.Tensor):
        """One step on device tensors (this process's rows of the global
        batch); returns the new state and ``{"loss": mean over the global
        batch}`` as a device scalar. In a world of several processes the
        gradient and the loss are averaged across them before the update,
        as the reference's pmean crosses its processes."""
        grads, loss = self._vg(state.params, x, y)
        if in_process_group():
            grads, loss = _mean_across_processes((grads, loss),
                                                 self.topo.process_count)
        params, opt_state = self.optimizer.update(state.params, grads, state.opt_state)
        return common.TrainState(params, opt_state, state.step + 1), {"loss": loss}

    def step(self, state, x_global, y_global):
        """One sync-DP step on a global batch (leading dim divisible by W,
        per-worker shard divisible by accum_steps)."""
        self._check(x_global)
        x, y = self._shard(x_global, y_global)
        dev = self.topo.device
        return self._step(state, torch.as_tensor(x).to(dev),
                          torch.as_tensor(y).to(dev))

    def evaluate(self, state, x, y, batch: int = 1024):
        """Full-dataset eval over the reference's batches; returns
        (accuracy, mean_loss), both per example as the reference divides
        them (for an LM: correct tokens and summed token loss per window)."""
        correct, loss_sum, n = common.batched_count_eval(
            self._eval, state.params, x, y, batch, self.topo.num_workers
        )
        return correct / n, loss_sum / n

    def fit(self, batches, state, epochs: int = 1, start_epoch: int = 0,
            skip_steps: int = 0, on_step=None, prefetch: int = 2):
        """Epoch loop over a :class:`Batches` (``start_epoch``/``skip_steps``
        re-enter its schedule on resume); returns (state, last_metrics)."""
        return common.synced_fit_loop(
            self._step, batches, state, device=self.topo.device, check=self._check,
            shard=self._shard, epochs=epochs, start_epoch=start_epoch, skip_steps=skip_steps,
            on_step=on_step, prefetch=prefetch,
        )
