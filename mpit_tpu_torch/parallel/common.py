"""Shared trainer plumbing: the loss, the batch checks, the τ-round loop.

Counterpart of the parts of ``mpit_tpu/parallel/common.py`` that the
EASGD trainer uses. The reference runs a round as one jitted ``shard_map``
over the worker mesh; here a round runs eagerly on one device, with the
W workers stacked on dim 0 of every per-worker tensor. Gradient clipping,
accumulation and the synchronous trainers' fit loop are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mpit_tpu_torch.data.prefetch import prefetch_to_device


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels
    (``optax.softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return F.cross_entropy(logits.float(), labels.long())


def default_loss_fn(apply_fn: Callable) -> Callable:
    """(params, x, y) -> scalar loss, for classification models."""

    def loss_fn(params, x, y):
        return cross_entropy_loss(apply_fn(params, x), y)

    return loss_fn


def check_global_batch(global_batch: int, num_workers: int) -> int:
    if global_batch % num_workers != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {num_workers} "
            "workers (the stacked workers' shards must be equal)"
        )
    return global_batch // num_workers


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    return float((np.argmax(logits, -1) == labels).mean())


class RoundTrainer:
    """Shared machinery for τ-round trainers (EASGD).

    Subclasses set, in __init__: ``topo``, ``tau``, ``model`` (or None when
    model-less), and implement ``_round(state, x, y)`` on device tensors of
    shape (W, τ, B, ...) and ``center_params(state)``.
    """

    topo: Any
    tau: int
    model: Any

    _log_tag = "round"

    def center_params(self, state):
        raise NotImplementedError

    def _round(self, state, x, y):
        raise NotImplementedError

    def round_batches(self, x_round, y_round):
        """Reshape τ stacked global batches (τ, W·B, ...) → (W, τ, B, ...)
        as contiguous CPU tensors."""
        x_round, y_round = torch.as_tensor(x_round), torch.as_tensor(y_round)
        tau, w = self.tau, self.topo.num_workers
        if x_round.shape[0] != tau:
            raise ValueError(
                f"need {tau} stacked batches, got {x_round.shape[0]}"
            )
        b = check_global_batch(x_round.shape[1], w)

        def regroup(a):
            return a.reshape(tau, w, b, *a.shape[2:]).transpose(0, 1).contiguous()

        return regroup(x_round), regroup(y_round)

    def step(self, state, x_round, y_round):
        """One exchange round: τ local steps + the exchange. Inputs are τ
        stacked global batches, shape (τ, W·B, ...)."""
        xr, yr = self.round_batches(x_round, y_round)
        dev = self.topo.device
        return self._round(state, xr.to(dev), yr.to(dev))

    def rounds_per_epoch(self, batches) -> int:
        return batches.steps_per_epoch() // self.tau

    def fit(
        self,
        batches,
        state,
        epochs: int = 1,
        log_every: int = 0,
        start_epoch: int = 0,
        skip_rounds: int = 0,
        on_round: Optional[Callable] = None,
        prefetch: int = 2,
    ):
        """Epoch loop grouping minibatches into τ-rounds, as the
        reference's: per epoch, a trailing group smaller than τ is
        dropped; ``start_epoch``/``skip_rounds`` re-enter the deterministic
        data schedule; ``on_round(rounds_done, state, metrics)`` fires after
        every round; ``prefetch`` round-groups are staged on the device
        ahead of the running round. Returns (state, last_metrics)."""
        if self.rounds_per_epoch(batches) == 0:
            raise ValueError(
                f"epoch of {batches.steps_per_epoch()} step(s) < "
                f"tau={self.tau}: no full rounds"
            )
        metrics = None
        rounds = 0
        dropped = 0

        def round_groups(e, to_skip):
            nonlocal dropped
            buf_x, buf_y = [], []
            for x, y in batches.epoch(e):
                buf_x.append(torch.as_tensor(x))
                buf_y.append(torch.as_tensor(y))
                if len(buf_x) < self.tau:
                    continue
                if to_skip > 0:
                    to_skip -= 1
                else:
                    yield self.round_batches(
                        torch.stack(buf_x), torch.stack(buf_y)
                    )
                buf_x, buf_y = [], []
            dropped += len(buf_x)

        for e in range(start_epoch, epochs):
            to_skip = skip_rounds if e == start_epoch else 0
            for xr, yr in prefetch_to_device(
                round_groups(e, to_skip), self.topo.device, depth=prefetch
            ):
                state, metrics = self._round(state, xr, yr)
                rounds += 1
                if on_round is not None:
                    on_round(rounds, state, metrics)
                if log_every and rounds % log_every == 0:
                    print(
                        f"[{self._log_tag}] round={rounds} "
                        f"loss={float(metrics['loss']):.4f}"
                    )
        if dropped:
            print(
                f"[{self._log_tag}] dropped {dropped} trailing batch(es) "
                f"across epochs (< tau={self.tau})"
            )
        return state, metrics

    @torch.no_grad()
    def evaluate(self, state, x, y, batch: int = 1024) -> float:
        """Accuracy of the CENTER variable (the consensus model), over the
        same whole batches the reference counts."""
        if self.model is None:
            raise ValueError(
                "evaluate() requires a model; this trainer was built with "
                "model=None (loss-only math mode)"
            )
        w = self.topo.num_workers
        batch = (min(batch, len(x)) // w) * w or w
        n = (len(x) // batch) * batch
        if n == 0:
            raise ValueError(
                f"eval set of {len(x)} smaller than one per-worker sample "
                f"each across {w} workers"
            )
        center = self.center_params(state)
        dev = self.topo.device
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(0, n, batch):
            xb = torch.as_tensor(x[i : i + batch]).to(dev)
            yb = torch.as_tensor(y[i : i + batch]).to(dev)
            logits = self.model.apply(center, xb)
            correct += (logits.argmax(-1) == yb).sum()
        return int(correct) / n
