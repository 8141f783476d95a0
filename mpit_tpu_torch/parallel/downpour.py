"""Downpour-SGD trainer on one device (push the accumulated updates, pull a
possibly stale center); counterpart of ``mpit_tpu/parallel/downpour.py``.

Every worker keeps its own params and optimizer state, stacked on dim 0 as
in the EASGD trainer. A round is τ local steps of all W workers at once
(``torch.func.vmap`` over ``torch.func.grad_and_value``), then the push:
with no ``server_optimizer`` the center moves by the workers' mean update
(``goptim.downpour_push``, model averaging: the BASELINE config), else the
server optimizer takes −mean(update) as its gradient. The new center is
appended to a ring of the last ``staleness + 1`` centers and every worker
pulls the oldest (``goptim.downpour_pull``), so the staleness the reference
emulates is exact and reproducible here too. On the card, with the state
donated in a one-process world, the round (the τ steps, the push, the
ring's shift and the pull) is captured as a CUDA graph after a first
eager round and replayed from then on (``parallel/capture.py``), as the
reference runs it as one compiled program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from mpit_tpu_torch import goptim
from mpit_tpu_torch.comm import pmean
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.parallel import capture as _capture
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.parallel.easgd import _stack
from mpit_tpu_torch.utils.params import tree_leaves, tree_map


@dataclasses.dataclass
class DownpourState:
    """worker_params/worker_opt have a leading worker dim W;
    center_history a leading dim ``staleness + 1`` ([0] = oldest); the
    center and the server optimizer state have none. ``round`` counts
    completed rounds."""

    worker_params: Any
    worker_opt: Any
    center: Any
    server_opt: Any
    center_history: Any
    round: int = 0


class DownpourTrainer(common.RoundTrainer, _capture.Captured):
    """Downpour: τ local steps, push the accumulated updates, pull the
    (stale) center.

    Args:
      model: a port model (``init``/``apply``), or None with a custom
        ``loss_fn`` and ``init_state(params=...)``.
      optimizer: the local worker optimizer.
      topo: the topology (default: the current one).
      server_optimizer: applied at the center to −mean(update); None is
        model averaging (the center moves by the mean update).
      tau: push/pull period.
      staleness: rounds of center age the workers see on pull (0 = fresh).
      donate_state: update each round's state in place (the worker stacks,
        their optimizer state, the center, its ring and the server
        optimizer state), consuming the given state, as
        :class:`~mpit_tpu_torch.parallel.easgd.EASGDTrainer` does.
      capture: run each round as a replay of a CUDA graph
        (``parallel/capture.py``): None = wherever it can (a CUDA device,
        ``donate_state``, a one-process world, ``optim.Chain`` optimizers),
        False = eagerly, True = always (raising where it cannot).
    """

    def __init__(
        self,
        model,
        optimizer,
        topo: Optional[Topology] = None,
        loss_fn: Optional[Callable] = None,
        server_optimizer=None,
        tau: int = 4,
        staleness: int = 0,
        donate_state: bool = True,
        capture: Optional[bool] = None,
    ):
        self.model = model
        self.donate_state = bool(donate_state)
        self.optimizer = optimizer
        self.topo = topo if topo is not None else _current_topology()
        self.tau = int(tau)
        self.staleness = int(staleness)
        if self.staleness < 0:
            raise ValueError("staleness must be >= 0")
        self.server_optimizer = server_optimizer
        self.loss_fn = (
            loss_fn if loss_fn is not None else common.default_loss_fn(model.apply)
        )
        self._grad = common.worker_value_and_grad(
            self.loss_fn, getattr(model, "remat", False))
        self._log_tag = "downpour"
        self._init_capture(capture, optimizer, server_optimizer=server_optimizer)

    def init_state(
        self, generator: Optional[torch.Generator] = None, params: Any = None
    ) -> DownpourState:
        """Workers, the center and every ring entry start from identical
        params: the given tree, or ``model.init(generator)``."""
        if params is None:
            params = self.model.init(generator)
        params = tree_map(lambda a: a.detach().to(self.topo.device), params)
        stacked = _stack(params, self.topo.local_workers)
        server_opt = (self.server_optimizer.init(params)
                      if self.server_optimizer is not None else ())
        return DownpourState(
            worker_params=stacked,
            worker_opt=self.optimizer.init(stacked),
            center=tree_map(torch.clone, params),
            server_opt=server_opt,
            center_history=_stack(params, self.staleness + 1),
        )

    def _round(self, state: DownpourState, x: torch.Tensor, y: torch.Tensor):
        """τ local steps on x, y of shape (W, τ, B, ...), the push and the
        pull. Returns the new state and ``{"loss": mean over workers and
        steps}`` as a device scalar."""
        common.check_live(state)
        parts, metrics = self._replayable_round(
            state, x, y, ("worker_params", "worker_opt", "center", "server_opt",
                          "center_history"))
        common.donated(state, self.donate_state)
        return DownpourState(*parts, round=state.round + 1), metrics

    def _unit(self, state: DownpourState, x, y, scalars=None):
        """A round's device work: ``((worker_params, worker_opt, center,
        server_opt, center_history), {"loss": ...})``. ``scalars`` holds the
        host values of the τ worker updates in turn, then the server
        optimizer's, or is None (they are computed on the host)."""
        donate = self.donate_state
        start = state.worker_params
        # the local steps write over the worker stacks: keep the round's start
        params = tree_map(torch.clone, start) if donate else start
        opt = state.worker_opt
        per = len(self.optimizer.host_scalars(opt)) if scalars is not None else 0
        losses = []
        for t in range(self.tau):
            grads, loss = self._grad(params, x[:, t], y[:, t])
            kw = {} if scalars is None else {"scalars": scalars[t * per:(t + 1) * per]}
            params, opt = self.optimizer.update(params, grads, opt,
                                                per_worker=True, inplace=donate, **kw)
            losses.append(loss)
        delta = tree_map(torch.sub, params, start)
        if self.server_optimizer is None:
            center = goptim.downpour_push(state.center, delta, average=True)
            server_opt = state.server_opt
        else:
            kw = {} if scalars is None else {"scalars": scalars[self.tau * per:]}
            pseudo_grad = tree_map(torch.neg, pmean(delta))
            center, server_opt = self.server_optimizer.update(
                state.center, pseudo_grad, state.server_opt, inplace=donate, **kw
            )
        if donate:
            with torch.no_grad():
                if self.server_optimizer is None:
                    torch._foreach_copy_(tree_leaves(state.center), tree_leaves(center))
                    center = state.center
                history = state.center_history
                for h, c in zip(tree_leaves(history), tree_leaves(center)):
                    for i in range(h.shape[0] - 1):  # the ring moves one on
                        h[i].copy_(h[i + 1])
                    h[-1].copy_(c)
                pulled = goptim.downpour_pull(center, tree_map(lambda h: h[0], history))
                for w, p in zip(tree_leaves(start), tree_leaves(pulled)):
                    w.copy_(p.expand_as(w))
            workers = start
        else:
            history = tree_map(lambda h, c: torch.cat([h[1:], c[None]]),
                               state.center_history, center)
            pulled = goptim.downpour_pull(center, tree_map(lambda h: h[0], history))
            workers = _stack(pulled, self.topo.local_workers)
        loss = common.world_mean(torch.stack(losses).mean(), self.topo)
        return (workers, opt, center, server_opt, history), {"loss": loss}

    def center_params(self, state: DownpourState):
        return state.center
