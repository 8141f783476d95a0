"""ZeRO-1 data parallelism: the optimizer state cut 1/W per worker.

Counterpart of ``mpit_tpu/parallel/zero.py`` (``ZeroDataParallelTrainer``,
ZeRO stage 1, arXiv:1910.02054). The flat parameter vector, in the
reference's element order (``convert.flax_flat``), is padded to a multiple
of W and cut into W contiguous chunks; worker ``k`` owns chunk ``k``'s
optimizer state. A step:

- takes the mean gradient as sync DP does, and keeps each worker's chunk
  of it (the reduce-scatter). With ``quant`` off one process takes the
  global batch's gradient, which is the W workers' mean, and cuts it; with
  ``quant`` on each worker takes its own gradient and the chunks cross
  ``comm.quantized_psum_scatter`` (int8 or bf16 codes, f32 sum; stateless,
  as in the reference). Under accumulation the scatter runs once a slice
  and the chunks are averaged;
- clips by the global norm over the chunks (``clip_norm``,
  ``common.clip_by_global_norm_in_mesh``), updates each chunk with an
  elementwise optimizer (a cross-leaf one is refused,
  ``common.assert_elementwise_optimizer``), and all-gathers the chunks
  back into the params.

The optimizer state's leaves of parameter size are flat vectors: the whole
``(padded,)`` vector in one process, as the reference's sharded arrays are
globally, so a checkpoint is ``flax.serialization.to_bytes`` of the
reference's ZeRO state byte for byte. In a world of P processes each holds
its workers' ``padded / P`` elements, and a checkpoint gathers them. On
one card the W chunks add up to one copy of the state, as sync DP holds:
ZeRO saves memory only across processes.

On the card, with the state donated in a one-process world, the step
(the quantized scatter too) is captured as a CUDA graph after a first
eager step and replayed from then on (``parallel/capture.py``), as the
reference runs it as one compiled program. The flat copy, the gathered
vector and the other temporaries of a step come from the graph's memory;
the params and the optimizer state's chunks are its static state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Optional

import torch

from mpit_tpu_torch import quant as _quant
from mpit_tpu_torch.comm.collectives import allgather, quantized_psum_scatter
from mpit_tpu_torch.comm.topology import Topology, in_process_group
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.convert import flax_flat, from_flax_flat
from mpit_tpu_torch.parallel import capture as _capture
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.parallel.sync import _mean_across_processes, dp_quant_from_env
from mpit_tpu_torch.utils.params import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class ZeroTrainState(common.TrainState):
    """The reference's ``TrainState`` (params, opt_state, step) with the
    optimizer state over this process's share of the flat vector; the
    checkpoint gathers the ``opt_state`` tensors across processes."""

    process_sharded: ClassVar[tuple] = ("opt_state",)


class ZeroDataParallelTrainer(_capture.Captured):
    """Sync DP with ZeRO-1 sharded optimizer state (``init_state``,
    ``step``, ``fit``, ``evaluate`` as :class:`DataParallelTrainer`).

    Args:
      model: the model; its ``apply(params, x)`` gives the logits, or None
        with ``loss_fn`` and ``init_state(params=...)``.
      optimizer: an elementwise ``optim`` chain (SGD, Adam, AdamW).
      topo: the topology (default: the current one).
      loss_fn: ``(params, x, y) -> scalar``; default the cross-entropy of
        ``model.apply``.
      donate_state: update the state in place (the optimizer state's
        chunks and the params' tensors), consuming the given state, as
        :class:`~mpit_tpu_torch.parallel.sync.DataParallelTrainer` does.
      accum_steps: gradient accumulation slices per step.
      clip_norm: global-norm clipping over the chunks (the chained clip of
        the other trainers is refused here).
      quant: ``off``/``bf16``/``int8`` for the gradient scatter (default:
        the ``MPIT_DP_QUANT`` knob).
      capture: run each step as a replay of a CUDA graph
        (``parallel/capture.py``): None = wherever it can (a CUDA device,
        ``donate_state``, a one-process world, an ``optim.Chain``), False =
        eagerly, True = always (raising where it cannot).
    """

    _log_tag = "zero-dp"

    def __init__(self, model, optimizer, topo: Optional[Topology] = None,
                 loss_fn: Optional[Callable] = None, donate_state: bool = True,
                 accum_steps: int = 1, clip_norm: Optional[float] = None,
                 quant: Optional[str] = None, capture: Optional[bool] = None):
        common.assert_elementwise_optimizer(optimizer, "ZeroDataParallelTrainer")
        self.model = model
        self.optimizer = optimizer
        self.clip_norm = common.check_clip_norm(clip_norm)
        self.quant = dp_quant_from_env() if quant is None else quant
        if self.quant not in _quant.QUANT_MODES:
            raise ValueError(f"quant={self.quant!r}: expected one of {_quant.QUANT_MODES}")
        self.topo = topo if topo is not None else _current_topology()
        self.accum_steps = common.check_accum_steps(accum_steps)
        self.donate_state = bool(donate_state)
        self.loss_fn = loss_fn = (loss_fn if loss_fn is not None
                                  else common.default_loss_fn(model.apply))
        remat = getattr(model, "remat", False)
        self._vg = common.accumulated_value_and_grad(loss_fn, self.accum_steps,
                                                     remat=remat)
        # one slice's per-worker gradients, for the quantized scatter
        self._worker_vg = common.per_worker_value_and_grad(loss_fn, 1, remat=remat)
        self._eval = (common.build_count_loss_eval(model, self.topo.device)
                      if model is not None else None)
        self._layout = None
        self._init_capture(capture, optimizer)

    def _check(self, x) -> None:
        common.check_accum_batch(len(x), self.topo.num_workers, self.accum_steps)

    def _shard(self, x, y):
        mine = self.topo.local_slice(len(x))
        return x[mine], y[mine]

    # -- the flat vector ---------------------------------------------------

    def _flat_layout(self, params) -> tuple:
        """(n, chunk, this process's [lo, hi) of the padded vector)."""
        if self._layout is None:
            n = sum(t.numel() for t in tree_leaves(params))
            w, wl = self.topo.num_workers, self.topo.local_workers
            chunk = -(-n // w)
            lo = self.topo.process_index * wl * chunk
            self._layout = (n, chunk, lo, lo + wl * chunk)
        return self._layout

    def _flatten(self, tree, lead: int = 0) -> torch.Tensor:
        """The padded f32 flat vector of a params-shaped tree, behind
        ``lead`` stacked dims (after :meth:`_flat_layout` saw the params)."""
        n, chunk, _, _ = self._layout
        flat = torch.cat([flax_flat(t, lead).to(torch.float32) for t in tree_leaves(tree)],
                         lead)
        return torch.nn.functional.pad(flat, (0, chunk * self.topo.num_workers - n))

    def _unflatten(self, template, flat: torch.Tensor):
        leaves = tree_leaves(template)
        parts = torch.split(flat[: self._flat_layout(template)[0]],
                            [t.numel() for t in leaves])
        return tree_unflatten(template, [
            from_flax_flat(p, tuple(t.shape)).to(t.dtype) for p, t in zip(parts, leaves)])

    def init_state(self, generator: Optional[torch.Generator] = None,
                   params: Any = None) -> ZeroTrainState:
        """Replicated params (given, or ``model.init(generator)``) and the
        optimizer state over this process's chunks of the flat vector."""
        given = params is not None
        if params is None:
            params = self.model.init(generator)
        # a donated step writes over the state's tensors: never the caller's
        copy = given and self.donate_state
        params = tree_map(lambda a: a.detach().to(self.topo.device, copy=copy), params)
        _, _, lo, hi = self._flat_layout(params)
        zeros = torch.zeros(hi - lo, dtype=torch.float32, device=self.topo.device)
        return ZeroTrainState(params, self.optimizer.init(zeros), 0)

    # -- the step ------------------------------------------------------------

    def _scattered_grad(self, params, x, y):
        """(mean loss over the world, this process's chunks of the mean
        gradient, flat ``(W_local · chunk,)``)."""
        w, wl = self.topo.num_workers, self.topo.local_workers
        _, _, lo, hi = self._flat_layout(params)
        if self.quant == "off":
            grads, loss = self._vg(params, x, y)
            flat = self._flatten(grads)
            if in_process_group():
                flat, loss = _mean_across_processes((flat, loss), self.topo.process_count)
            return loss, flat[lo:hi]
        accum = self.accum_steps
        xs = x.reshape(wl, accum, -1, *x.shape[1:])
        ys = y.reshape(wl, accum, -1, *y.shape[1:])
        shard, losses = 0.0, 0.0
        for i in range(accum):
            grads, l = self._worker_vg(params, xs[:, i], ys[:, i])
            rows = self._flatten(grads, lead=1)
            shard = shard + quantized_psum_scatter(rows, self.quant) / w
            losses = losses + l
        loss = common.world_sum(losses / accum) / w
        return loss, (shard / accum).reshape(-1)

    def _step(self, state: ZeroTrainState, x: torch.Tensor, y: torch.Tensor):
        """One step on device tensors (this process's rows of the global
        batch); returns the new state and ``{"loss": world mean}``."""
        common.check_live(state)
        (params, opt_state), metrics = self._replayable_step(state, x, y)
        common.donated(state, self.donate_state)
        return ZeroTrainState(params, opt_state, state.step + 1), metrics

    def _unit(self, state: ZeroTrainState, x, y, scalars=None):
        """A step's device work: ``((params, opt_state), {"loss": ...})``;
        the optimizer reads ``scalars`` (see ``optim.Chain.update``) when
        given."""
        loss, g = self._scattered_grad(state.params, x, y)
        if self.clip_norm is not None:
            g, _ = common.clip_by_global_norm_in_mesh(
                g.reshape(self.topo.local_workers, -1), self.clip_norm)
            g = g.reshape(-1)
        _, _, lo, hi = self._flat_layout(state.params)
        donate = self.donate_state
        kw = {} if scalars is None else {"scalars": scalars}
        # the flat chunk is this step's own copy, so it is updated in place
        # either way; donating, the optimizer state's chunks are too
        new, opt_state = self.optimizer.update(
            self._flatten(state.params)[lo:hi], g, state.opt_state, inplace=donate, **kw)
        params = self._unflatten(state.params, allgather(new, tiled=True))
        if donate:
            with torch.no_grad():
                torch._foreach_copy_(tree_leaves(state.params), tree_leaves(params))
            params = state.params
        return (params, opt_state), {"loss": loss}

    def step(self, state, x_global, y_global):
        """One ZeRO-1 step on a global batch (divisible by W; per-worker
        shard divisible by accum_steps)."""
        self._check(x_global)
        x, y = self._shard(x_global, y_global)
        dev = self.topo.device
        return self._step(state, torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev))

    def evaluate(self, state, x, y, batch: int = 1024):
        """Full-dataset eval; returns (accuracy, mean_loss)."""
        common.check_live(state, "evaluate")
        if self._eval is None:
            raise ValueError("evaluate() requires a model; this trainer was "
                             "built with model=None (loss-only math mode)")
        correct, loss_sum, n = common.batched_count_eval(
            self._eval, state.params, x, y, batch, self.topo.num_workers)
        return correct / n, loss_sum / n

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
