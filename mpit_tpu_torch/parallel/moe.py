"""Expert-parallel training: the MoE transformer over the worker axis;
counterpart of ``mpit_tpu/parallel/moe.py`` (``MoEParallelTrainer``, algo
``moe-sync``).

The reference runs ``TransformerLM(moe_experts=E, moe_axis="dp")`` inside
``shard_map``: experts shard over the same axis the batch shards over, and
tokens travel to their expert's device and back by ``lax.all_to_all``.
Each device differentiates its LOCAL mean loss; an expert leaf then holds
``W ·`` the gradient of the global mean (every device's contribution
arrives through the all-to-all's transpose) and is divided by W, while the
replicated leaves are ``pmean``-ed.

On one card the workers are stacked (``comm/topology.py``): the global
batch is cut into the W workers' shards ``(W, b, T)``, the model routes
each worker's tokens on its own (``ops/moe.py``), and one backward pass of
the mean loss over every token gives both at once: the expert gradients
and the averaged replicated ones, the gradient of the global-mean
objective. In a world of several processes each holds its own workers'
experts; the gradient of its own mean loss gives its experts ``P ·`` their
share and the replicated leaves their process-local term, so expert leaves
are divided by the process count P and replicated leaves averaged across
the processes, the reference's rule with P for W. The state is a
:class:`MoETrainState`, whose ``process_cut`` tells the checkpoint to
gather the expert leaves and their optimizer moments along the expert dim
on save (process 0 writes all E experts, as the reference's
``save_checkpoint`` gathers its non-addressable leaves) and to cut them
back to each process's experts on restore.

The balance and z terms enter as the reference's do: their statistics are
averaged over the workers inside the op (the reference's ``pmean``, whose
transpose under ``check_vma=False`` hands every worker the full
cotangent), so the step differentiates ``mean CE + w_bal · balance + w_z ·
zloss`` of the global statistics. ``tests/test_torch_moe.py`` holds a step
with both weights nonzero against the reference's trainer.

On the card, with the state donated in a one-process world, the step is
captured as a CUDA graph after a first eager step and replayed from then
on (``parallel/capture.py``), as the reference runs it as one compiled
program: the router's shapes are static (a fixed capacity), and the loss
and the ``moe_*`` statistics are the graph's outputs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from mpit_tpu_torch.comm.topology import Topology, current_process, in_process_group
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.models.transformer import aggregate_moe_losses
from mpit_tpu_torch.parallel import capture as _capture
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.utils.params import (
    tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten,
)


def _is_expert_leaf(path) -> bool:
    """Expert-sharded leaves carry the ``moe_`` name prefix, except the
    replicated router (``Block._moe``'s naming contract). ``path`` is the
    tuple of the leaf's keys."""
    keys = [k for k in path if isinstance(k, str)]
    last = keys[-1] if keys else ""
    return last.startswith("moe_") and last != "moe_router"


@dataclasses.dataclass
class MoETrainState(common.TrainState):
    """The reference's ``TrainState`` (params, opt_state, step); in a world
    of several processes each holds its own workers' experts."""

    @staticmethod
    def process_cut(path) -> Optional[int]:
        """The expert dim (0) of an expert leaf or its optimizer moment
        (Adam's ``mu`` and ``nu``, SGD's trace mirror the param tree); None
        for a replicated leaf."""
        return 0 if _is_expert_leaf(path) else None


class MoEParallelTrainer(_capture.Captured):
    """Expert-parallel sync trainer for an MoE :class:`TransformerLM`.

    Usage::

        topo = mpit_tpu_torch.init()   # 1-D worker mesh, W = 8
        model = TransformerLM(vocab_size=V, moe_experts=16, moe_axis="dp")
        trainer = MoEParallelTrainer(model, optim.Adam(3e-4), topo)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        state, metrics = trainer.step(state, x_global, y_global)

    The optimizer must be ELEMENTWISE (the reference's behavioral probe,
    :func:`common.assert_elementwise_optimizer`); for global-norm clipping
    pass ``clip_norm=c``: :func:`common.clip_by_global_norm_in_mesh` over
    the reduced gradients, expert shards summing their squares across
    processes, replicated leaves counted once. ``donate_state`` updates
    the params (the experts too) and the optimizer state in place, as
    :class:`~mpit_tpu_torch.parallel.sync.DataParallelTrainer` does, and
    ``capture`` runs each step as a replay of a CUDA graph as it does.
    """

    _log_tag = "moe-sync"

    def __init__(self, model, optimizer, topo: Optional[Topology] = None,
                 donate_state: bool = True, clip_norm: Optional[float] = None,
                 capture: Optional[bool] = None):
        self.model = model
        self.optimizer = optimizer
        self.donate_state = bool(donate_state)
        common.assert_elementwise_optimizer(optimizer, "MoEParallelTrainer")
        self.clip_norm = common.check_clip_norm(clip_norm)
        self.topo = topo if topo is not None else _current_topology()
        axis = self.topo.axis_names[0]
        if getattr(model, "moe_experts", 0) <= 0:
            raise ValueError(
                "MoEParallelTrainer needs a model with moe_experts > 0"
            )
        if getattr(model, "moe_axis", None) != axis:
            raise ValueError(
                f"model.moe_axis={getattr(model, 'moe_axis', None)!r} must "
                f"name the worker axis {axis!r}"
            )
        w = self.topo.num_workers
        if model.moe_experts % w:
            raise ValueError(
                f"moe_experts={model.moe_experts} not divisible by "
                f"{w} workers"
            )
        self.w_bal = float(getattr(model, "moe_balance_weight", 0.0))
        self.w_z = float(getattr(model, "moe_zloss_weight", 0.0))
        self._init_capture(capture, optimizer)

    # -- the objective ------------------------------------------------------

    def loss_fn(self, params, x, y):
        """``(loss, aux)`` on this process's stacked shards ``x``, ``y``
        ``(W_local, b, T)``: the mean CE over their tokens plus the weighted
        aux losses; ``aux`` the blocks' mean statistics."""
        logits, collection = self.model.apply(params, x, with_aux=True)
        aux = aggregate_moe_losses(collection)
        loss = common.cross_entropy_loss(logits, y)
        loss = loss + self.w_bal * aux["balance"] + self.w_z * aux["zloss"]
        return loss, aux

    def _stack(self, a) -> torch.Tensor:
        """A batch of this process's rows as its stacked worker shards."""
        a = torch.as_tensor(a)
        return a.reshape(self.topo.local_workers, -1, *a.shape[1:])

    def _step(self, state: common.TrainState, x, y):
        common.check_live(state)
        (params, opt_state), metrics = self._replayable_step(state, x, y)
        common.donated(state, self.donate_state)
        return MoETrainState(params, opt_state, state.step + 1), metrics

    def _unit(self, state: common.TrainState, x, y, scalars=None):
        """A step's device work: ``((params, opt_state), metrics)``, the
        metrics the loss and the ``moe_*`` statistics; the optimizer reads
        ``scalars`` (see ``optim.Chain.update``) when given."""
        leaves = [p.detach().requires_grad_() for p in tree_leaves(state.params)]
        loss, aux = self.loss_fn(tree_unflatten(state.params, leaves), x, y)
        grads = tree_unflatten(state.params, list(torch.autograd.grad(loss, leaves)))
        loss = loss.detach()
        if in_process_group():
            import torch.distributed as dist

            procs = current_process()[1]
            # expert shards: the all-to-all already brought every
            # process's contribution (P x); replicated: average
            pairs = tree_leaves_with_path(grads)
            repl = [g for p, g in pairs if not _is_expert_leaf(p)]
            flat = torch.cat([g.reshape(-1) for g in repl] + [loss.reshape(1)])
            dist.all_reduce(flat)
            flat = flat / procs
            parts = iter(torch.split(flat[:-1], [g.numel() for g in repl]))
            loss = flat[-1]
            grads = tree_unflatten(grads, [
                g / procs if _is_expert_leaf(p) else next(parts).reshape(g.shape)
                for p, g in pairs])
        if self.clip_norm is not None:
            grads, _ = common.clip_by_global_norm_in_mesh(
                grads, self.clip_norm, self.topo.axis_names[0],
                is_sharded=_is_expert_leaf)
        kw = {} if scalars is None else {"scalars": scalars}
        out = self.optimizer.update(state.params, grads, state.opt_state,
                                    inplace=self.donate_state, **kw)
        metrics = {"loss": loss}
        metrics.update((f"moe_{k}", v.detach()) for k, v in aux.items())
        return out, metrics

    # -- public interface ---------------------------------------------------

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params=None) -> common.TrainState:
        """State from the given tree, or ``model.init(generator)``, with all
        E experts (the reference inits on the dense clone); in a world of
        several processes each keeps its own workers' experts."""
        given = params is not None
        if params is None:
            params = self.model.init(generator)
        # a donated step writes over the state's tensors: never the caller's
        copy = given and self.donate_state
        params = tree_map(lambda a: a.detach().to(self.topo.device, copy=copy), params)
        index, procs = current_process()
        if procs > 1:
            pairs = tree_leaves_with_path(params)
            params = tree_unflatten(params, [
                a.chunk(procs)[index].clone() if _is_expert_leaf(p) else a
                for p, a in pairs])
        return MoETrainState.create(params, self.optimizer)

    def _check(self, x) -> None:
        common.check_global_batch(len(x), self.topo.num_workers)

    def _shard(self, x, y):
        mine = self.topo.local_slice(len(x))
        return self._stack(x[mine]), self._stack(y[mine])

    def step(self, state, x_global, y_global):
        """One expert-parallel step on a global batch."""
        self._check(x_global)
        x, y = self._shard(x_global, y_global)
        dev = self.topo.device
        return self._step(state, x.to(dev), y.to(dev))

    def fit(self, batches, state, epochs: int = 1, log_every: int = 0,
            start_epoch: int = 0, skip_steps: int = 0, on_step=None,
            prefetch: int = 2):
        """Epoch loop (``common.synced_fit_loop``); returns (state,
        last_metrics)."""
        return common.synced_fit_loop(
            self._step, batches, state, device=self.topo.device, check=self._check,
            shard=self._shard, log_tag=self._log_tag, epochs=epochs,
            log_every=log_every, start_epoch=start_epoch, skip_steps=skip_steps,
            on_step=on_step, prefetch=prefetch,
        )

    @torch.no_grad()
    def _eval_batch(self, params, x, y):
        dev = self.topo.device
        x, y = self._shard(torch.as_tensor(x), torch.as_tensor(y))
        x, y = x.to(dev), y.to(dev)
        # the whole batch through the body (its routing groups are the
        # reference's), the tied head EVAL_ROWS windows at a time
        hidden = self.model.clone(head=False).apply(params, x)
        hidden, y = hidden.reshape(-1, *hidden.shape[2:]), y.reshape(-1, y.shape[-1])
        hdt = self.model._head_operand_dtype
        table = params["Embed_0"]["embedding"].to(hdt).float().t()
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for hs, ys in zip(hidden.split(common.EVAL_ROWS), y.split(common.EVAL_ROWS)):
            logits = torch.matmul(hs.to(hdt).float(), table)
            correct += (logits.argmax(-1) == ys).sum()
            loss_sum += common.cross_entropy_sum(logits, ys)
        if in_process_group():
            import torch.distributed as dist

            both = torch.stack([correct.double(), loss_sum.double()])
            dist.all_reduce(both)
            return both[0], both[1]
        return correct, loss_sum

    def evaluate(self, state, x, y, batch: int = 512):
        """Token-level accuracy and mean loss, in the reference's batches
        (each worker routes its share of a batch together)."""
        common.check_live(state, "evaluate")
        correct, loss_sum, n = common.batched_count_eval(
            self._eval_batch, state.params, x, y, batch, self.topo.num_workers
        )
        tokens = n * x.shape[1]
        return correct / tokens, loss_sum / tokens
