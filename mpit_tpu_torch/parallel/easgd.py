"""EASGD / EAMSGD trainer on one device; counterpart of
``mpit_tpu/parallel/easgd.py``.

Every worker keeps its own params and optimizer state, stacked on dim 0
(the reference's own stacked layout, there sharded over the mesh); the
center is one unstacked tree. A round is τ local steps, each computing all
W workers' gradients at once (``torch.func.vmap`` over
``torch.func.grad_and_value``, the counterpart of the reference's
``shard_map``), then one ``goptim.easgd_round``: a sum of the client diffs
and the fused elastic kernel, one launch for all the parameter leaves. On
the card, with the state donated in a one-process world, the round is
captured as a CUDA graph after a first eager round and replayed from then
on (``parallel/capture.py``), as the reference runs it as one compiled
program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from mpit_tpu_torch import goptim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.parallel import capture as _capture
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.utils.params import tree_map


@dataclasses.dataclass
class EASGDState:
    """worker_params/worker_opt have a leading worker dim W; center has
    none. ``round`` counts completed exchange rounds."""

    worker_params: Any
    worker_opt: Any
    center: Any
    round: int = 0


def _stack(tree: Any, w: int) -> Any:
    return tree_map(lambda a: a.unsqueeze(0).repeat(w, *([1] * a.dim())), tree)


class EASGDTrainer(common.RoundTrainer, _capture.Captured):
    """Elastic-averaging SGD over W stacked workers.

    Args:
      model: a port model (``init``/``apply``), or None when a custom
        ``loss_fn`` over raw params is given with ``init_state(params=...)``.
      optimizer: the *local* optimizer (EAMSGD = momentum here), e.g.
        ``optim.SGD(lr, momentum)``, optionally chained behind
        ``optim.clip_by_global_norm`` (each worker clips its own
        gradient).
      topo: the topology (default: the current one).
      alpha: elastic coupling; default 0.9/W, the paper's β/W rule.
      tau: communication period (local steps per exchange round).
      donate_state: update each round's state in place (the worker stacks,
        their optimizer state and the center; the elastic kernel writes
        over its inputs), consuming the given state: stepping, evaluating
        or checkpointing it again raises. False leaves it as it was.
      use_kernel: the elastic update's kernel switch (``ops.elastic``):
        None = the CUDA kernel for CUDA tensors, plain PyTorch on the CPU.
      exchange_dtype: sum the client diffs in this dtype (e.g.
        ``torch.bfloat16``); None = exact float32.
      capture: run each round as a replay of a CUDA graph
        (``parallel/capture.py``): None = wherever it can (a CUDA device,
        ``donate_state``, a one-process world, an ``optim.Chain``), False
        = eagerly, True = always (raising where it cannot).
    """

    def __init__(
        self,
        model,
        optimizer,
        topo: Optional[Topology] = None,
        loss_fn: Optional[Callable] = None,
        alpha: Optional[float] = None,
        tau: int = 4,
        donate_state: bool = True,
        use_kernel: Optional[bool] = None,
        exchange_dtype: Optional[torch.dtype] = None,
        capture: Optional[bool] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.donate_state = bool(donate_state)
        self.use_kernel = use_kernel
        self.exchange_dtype = exchange_dtype
        self.topo = topo if topo is not None else _current_topology()
        self.tau = int(tau)
        w = self.topo.num_workers
        self.alpha = float(alpha) if alpha is not None else 0.9 / w
        self.loss_fn = (
            loss_fn if loss_fn is not None else common.default_loss_fn(model.apply)
        )
        # all W workers' (grads, loss) in one batched call
        self._grad = common.worker_value_and_grad(
            self.loss_fn, getattr(model, "remat", False))
        self._log_tag = "easgd"
        self._init_capture(capture, optimizer)

    def init_state(
        self, generator: Optional[torch.Generator] = None, params: Any = None
    ) -> EASGDState:
        """All workers and the center start from identical params: the
        given tree, or ``model.init(generator)``."""
        if params is None:
            params = self.model.init(generator)
        params = tree_map(lambda a: a.detach().to(self.topo.device), params)
        stacked = _stack(params, self.topo.local_workers)
        return EASGDState(
            worker_params=stacked,
            # the stacked init is every worker's init, stacked
            worker_opt=self.optimizer.init(stacked),
            center=tree_map(torch.clone, params),
        )

    def _round(self, state: EASGDState, x: torch.Tensor, y: torch.Tensor):
        """τ local steps on x, y of shape (W, τ, B, ...), then the exchange.
        Returns the new state and ``{"loss": mean over workers and steps}``
        as a device scalar (no host sync)."""
        common.check_live(state)
        (params, opt, center), metrics = self._replayable_round(
            state, x, y, ("worker_params", "worker_opt", "center"))
        common.donated(state, self.donate_state)
        return EASGDState(params, opt, center, state.round + 1), metrics

    def _unit(self, state: EASGDState, x, y, scalars=None):
        """A round's device work: ``((params, opt, center), {"loss": ...})``.
        ``scalars`` holds the optimizer's host values for the τ steps in
        turn, or is None (they are computed on the host)."""
        donate = self.donate_state
        params, opt = state.worker_params, state.worker_opt
        per = len(scalars) // self.tau if scalars is not None else 0
        losses = []
        for t in range(self.tau):
            grads, loss = self._grad(params, x[:, t], y[:, t])
            kw = {} if scalars is None else {"scalars": scalars[t * per:(t + 1) * per]}
            params, opt = self.optimizer.update(params, grads, opt, per_worker=True,
                                                inplace=donate, **kw)
            losses.append(loss)
        params, center = goptim.easgd_round(
            params, state.center, self.alpha,
            use_kernel=self.use_kernel, compress_dtype=self.exchange_dtype,
            inplace=donate,
        )
        loss = common.world_mean(torch.stack(losses).mean(), self.topo)
        return (params, opt, center), {"loss": loss}

    def center_params(self, state: EASGDState):
        return state.center
