"""Shared trainer plumbing: the loss, the train state, gradient
accumulation, the batch checks, the per-step and τ-round loops, and the
evaluations.

Counterpart of the parts of ``mpit_tpu/parallel/common.py`` that the EASGD
and sync-DP trainers use. The reference runs a step or a round as one
jitted ``shard_map`` over the worker mesh; here it runs eagerly on one
device, with the W workers stacked on dim 0 of every per-worker tensor (or,
for the sync trainer, as one pass over the global batch).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mpit_tpu_torch.data.prefetch import prefetch_to_device
from mpit_tpu_torch.utils.params import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class TrainState:
    """Replicated training state: params, optimizer state, and the number of
    steps taken (a host int)."""

    params: Any
    opt_state: Any
    step: int = 0

    @classmethod
    def create(cls, params, optimizer) -> "TrainState":
        return cls(params=params, opt_state=optimizer.init(params), step=0)


def check_live(state, what: str = "step") -> None:
    """Refuse a state that was handed to a donating step: its tensors now
    hold the state that step returned, so reading it again would silently
    read new values (JAX raises on a donated buffer in the same place)."""
    if getattr(state, "_donated", False):
        raise RuntimeError(
            f"cannot {what} a state that was donated to a training step: the "
            "step updated its tensors in place, so they now hold the state it "
            "returned. Use that state, or build the trainer with "
            "donate_state=False to keep every state it is given readable."
        )


def donated(state, donate: bool) -> None:
    """Mark ``state`` consumed when its step donated it (the state the
    step returns is a new object, unmarked)."""
    if donate:
        object.__setattr__(state, "_donated", True)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over integer labels, the classes on the
    last dim, for logits of any rank (``optax.softmax_cross_entropy_with_
    integer_labels(...).mean()``): (B, C) for a classifier, (B, T, V) for
    an LM."""
    return F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), labels.long().reshape(-1)
    )


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The summed counterpart of :func:`cross_entropy_loss`."""
    return F.cross_entropy(
        logits.float().reshape(-1, logits.shape[-1]), labels.long().reshape(-1),
        reduction="sum",
    )


def default_loss_fn(apply_fn: Callable) -> Callable:
    """(params, x, y) -> scalar loss, for classification models."""

    def loss_fn(params, x, y):
        return cross_entropy_loss(apply_fn(params, x), y)

    return loss_fn


def check_accum_steps(accum) -> int:
    if int(accum) != accum or accum < 1:
        raise ValueError(f"accum_steps={accum} must be an integer >= 1")
    return int(accum)


def autograd_value_and_grad(loss_fn: Callable) -> Callable:
    """(params, x, y) -> (grads, loss) by ``torch.autograd.grad`` over
    fresh leaf tensors; the loss comes back detached. The route for models
    with remat: ``torch.func``'s transforms refuse the saved-tensor hooks
    of a non-reentrant checkpoint (and an ``autograd.Function`` without
    ``setup_context``, which the reentrant form is)."""

    def value_and_grad(params, x, y):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), x, y)
        grads = torch.autograd.grad(loss, leaves)
        return tree_unflatten(params, list(grads)), loss.detach()

    return value_and_grad


def worker_value_and_grad(loss_fn: Callable, remat: bool = False) -> Callable:
    """(stacked params, x, y) -> (stacked grads, per-worker losses) for the
    W workers on dim 0: ``vmap`` of ``grad_and_value``, or with ``remat``
    (which ``torch.func`` refuses) :func:`autograd_value_and_grad` worker by
    worker, stacked."""
    if not remat:
        return torch.func.vmap(torch.func.grad_and_value(loss_fn))
    vg = autograd_value_and_grad(loss_fn)

    def stacked(params, x, y):
        outs = [vg(tree_map(lambda a: a[i], params), x[i], y[i])
                for i in range(x.shape[0])]
        grads = tree_map(lambda *g: torch.stack(g), *(g for g, _ in outs))
        return grads, torch.stack([loss for _, loss in outs])

    return stacked


def per_worker_value_and_grad(loss_fn: Callable, accum: int = 1,
                              remat: bool = False) -> Callable:
    """(params, x, y) -> (stacked grads, per-worker losses) for params
    shared by the W workers and their batches stacked on dim 0 of ``x``
    and ``y``: each worker's own (accumulated) mean-loss gradient, as the
    reference's ``shard_map`` computes it before any exchange. ``vmap``
    with the params unbatched, so they are not copied W times; with
    ``remat`` (which ``torch.func`` refuses) worker by worker through
    :func:`autograd_value_and_grad`, stacked."""
    vg = accumulated_value_and_grad(loss_fn, accum, remat=remat)
    if not remat:
        return torch.func.vmap(vg, in_dims=(None, 0, 0))

    def stacked(params, x, y):
        outs = [vg(params, x[i], y[i]) for i in range(x.shape[0])]
        grads = tree_map(lambda *g: torch.stack(g), *(g for g, _ in outs))
        return grads, torch.stack([loss for _, loss in outs])

    return stacked


def assert_elementwise_optimizer(optimizer, context: str) -> None:
    """Reject an optimizer whose update of one leaf depends on other
    leaves (``mpit_tpu/parallel/common.py:55``): ZeRO updates each chunk of
    the flat vector on its own, so a global-norm clip chained in would
    clip every chunk by its own norm, with no error. The probe is the
    reference's: gradient trees differing only in leaf ``b`` (scaled, then
    NaN) must leave leaf ``a``'s update bit for bit alike. An optimizer the
    probe cannot run passes."""
    probe = {"a": torch.full((2,), 1e8), "b": torch.full((2,), 1e8)}
    try:
        st = optimizer.init(probe)
        u1, _ = optimizer.update(probe, dict(probe), st)
        u2, _ = optimizer.update(probe, {"a": probe["a"], "b": probe["b"] * 3.0}, st)
        u3, _ = optimizer.update(probe, {"a": probe["a"],
                                         "b": torch.full((2,), float("nan"))}, st)
    except Exception:
        return
    if not (torch.equal(u1["a"], u2["a"]) and torch.equal(u1["a"], u3["a"])):
        raise ValueError(
            f"{context} requires an ELEMENTWISE optimizer: this one's "
            "update for a leaf depends on other leaves' gradients "
            "(global-norm clipping?), which silently differs when each "
            "chunk of the flat vector is updated on its own. Pass "
            "clip_norm= to the trainer instead."
        )


def check_clip_norm(clip_norm):
    """The clip_norm guard of the ZeRO trainer."""
    if clip_norm is not None and clip_norm <= 0:
        raise ValueError(f"clip_norm={clip_norm} must be > 0")
    return clip_norm


def clip_by_global_norm_in_mesh(grads, max_norm: float, axis: Optional[str] = None,
                                is_sharded: Optional[Callable] = None, line=None):
    """Global-norm clipping whose norm is the whole model's
    (``mpit_tpu/parallel/common.py:119``). Returns ``(clipped, norm)``.

    Tree form (``grads`` a tree): leaves for which ``is_sharded(path)``
    holds (``path`` the tuple of the leaf's keys) are this process's share
    of a leaf sharded over ``axis`` (expert shards, pipeline stages): their
    sums of squares are summed across the processes of ``line`` (a
    ``ProcessLine``: the pipeline's pp line) or, with ``line`` None, the
    world's (moe-sync's experts), as the reference's ``psum`` over
    ``axis`` sums them; every other leaf is replicated and counts once.
    ``is_sharded=None`` treats every leaf as sharded. The scale is
    ``max_norm / norm`` above ``max_norm``, multiplied in.

    Chunk form (``grads`` a tensor, ZeRO's flat gradient held as stacked
    chunks ``(W_local, chunk)``): each worker's chunk sum of squares,
    summed over the workers and across processes, is the norm of the whole
    vector."""
    if not isinstance(grads, torch.Tensor):
        return _clip_tree_in_mesh(grads, max_norm, is_sharded, line)
    chunks = grads
    sq = world_sum(chunks.to(torch.float32).square().sum(1))
    norm = sq.sqrt()
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    return (chunks * scale).to(chunks.dtype), norm


def _clip_tree_in_mesh(grads, max_norm: float, is_sharded, line):
    from mpit_tpu_torch.utils.params import tree_leaves_with_path

    leaves = tree_leaves_with_path(grads)
    if not leaves:
        return grads, torch.zeros(())
    dev = leaves[0][1].device
    shard_sq = torch.zeros((), dtype=torch.float32, device=dev)
    repl_sq = torch.zeros((), dtype=torch.float32, device=dev)
    for path, g in leaves:
        sq = g.to(torch.float32).square().sum()
        if is_sharded is None or is_sharded(path):
            shard_sq = shard_sq + sq
        else:
            repl_sq = repl_sq + sq
    if line is None:
        shard_sq = world_sum(shard_sq[None])
    else:
        from mpit_tpu_torch.comm.collectives import line_sum

        shard_sq = line_sum(shard_sq, line)
    norm = torch.sqrt(shard_sq + repl_sq)
    scale = torch.where(norm > max_norm, max_norm / norm, torch.ones_like(norm))
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def accumulated_value_and_grad(loss_fn: Callable, accum: int,
                               remat: bool = False) -> Callable:
    """(params, x, y) -> (grads, loss), processing the batch as ``accum``
    sequential equal slices whose losses and gradients average: the
    full-batch mean for equal slices (no model here carries batch
    statistics), at 1/accum of the peak activation memory. The slices cut
    the batch as given; for the global batch of W equal worker shards the
    mean is the same as the reference's per-worker slicing. ``accum=1`` is
    one ``grad_and_value``, or with ``remat`` one
    :func:`autograd_value_and_grad`."""
    accum = check_accum_steps(accum)
    vg = (autograd_value_and_grad(loss_fn) if remat
          else torch.func.grad_and_value(loss_fn))
    if accum == 1:
        return vg

    def value_and_grad(params, x, y):
        grads, loss = None, 0.0
        for xs, ys in zip(x.chunk(accum), y.chunk(accum)):
            g, l = vg(params, xs, ys)
            grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = loss + l
        return tree_map(lambda g: g / accum, grads), loss / accum

    return value_and_grad


def check_accum_batch(global_batch: int, num_workers: int, accum: int) -> None:
    """Sync-trainer batch check: divisible by W, per-worker shard
    divisible by the accumulation factor."""
    check_global_batch(global_batch, num_workers)
    if (global_batch // num_workers) % accum:
        raise ValueError(
            f"per-worker batch {global_batch // num_workers} not divisible "
            f"by accum_steps={accum}"
        )


def check_global_batch(global_batch: int, num_workers: int) -> int:
    if global_batch % num_workers != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {num_workers} "
            "workers (the stacked workers' shards must be equal)"
        )
    return global_batch // num_workers


def accuracy(logits: np.ndarray, labels: np.ndarray) -> float:
    return float((np.argmax(logits, -1) == labels).mean())


def world_sum(per_worker: torch.Tensor) -> torch.Tensor:
    """The sum of this process's per-worker values (on dim 0), in worker
    order, then across the world's processes: what every worker of the
    reference's ``psum`` gets."""
    from mpit_tpu_torch.comm.collectives import _fold_sum
    from mpit_tpu_torch.comm.topology import in_process_group

    total = _fold_sum(per_worker, 0)
    if not in_process_group():
        return total
    import torch.distributed as dist

    total = total.clone()
    dist.all_reduce(total)
    return total


def world_mean(loss: torch.Tensor, topo) -> torch.Tensor:
    """A mean over this process's workers, made the mean over the world's
    (equal worker counts per process): the metric every process reports
    alike, as the reference's pmean'd metrics are."""
    from mpit_tpu_torch.comm.topology import in_process_group

    if not in_process_group():
        return loss
    import torch.distributed as dist

    loss = loss.clone()
    dist.all_reduce(loss)
    return loss / topo.process_count


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
        as contiguous CPU tensors; in a world of several processes, the
        rows of this process's workers only."""
        x_round, y_round = torch.as_tensor(x_round), torch.as_tensor(y_round)
        tau, w = self.tau, self.topo.num_workers
        if x_round.shape[0] != tau:
            raise ValueError(
                f"need {tau} stacked batches, got {x_round.shape[0]}"
            )
        b = check_global_batch(x_round.shape[1], w)
        mine = self.topo.local_slice(w)

        def regroup(a):
            a = a.reshape(tau, w, b, *a.shape[2:])[:, mine]
            return a.transpose(0, 1).contiguous()

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
        check_live(state, "evaluate")
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


def synced_fit_loop(step_fn, batches, state, *, device, check, shard=None,
                    log_tag: str = "sync", epochs: int = 1, log_every: int = 0,
                    start_epoch: int = 0, skip_steps: int = 0,
                    on_step=None, prefetch: int = 2):
    """The per-step fit loop of the synchronous trainers:
    ``on_step(steps, state, metrics)`` after every step; batches checked by
    ``check``, cut to this process's rows by ``shard(x, y)`` (when given)
    and staged ``prefetch`` ahead on ``device``. A resume
    re-enters the deterministic data schedule at epoch ``start_epoch``
    (whose index seeds its permutation), drawing and dropping its first
    ``skip_steps`` batches. Every ``log_every`` steps (0: never) it prints
    the reference's ``[log_tag] step=N loss=L`` line, N counting from the
    state's step. Returns (state, last_metrics)."""
    metrics = None
    steps = 0
    # the step count is a host int (a dict for the pipeline's state), so
    # numbering the lines across a resume reads nothing from the device
    base_step = (state["step"] if isinstance(state, dict) else state.step) if log_every else 0

    def step_batches(e, to_skip):
        for x, y in batches.epoch(e):
            if to_skip > 0:
                to_skip -= 1
                continue
            check(x)
            yield shard(x, y) if shard is not None else (x, y)

    for e in range(start_epoch, epochs):
        to_skip = skip_steps if e == start_epoch else 0
        for x, y in prefetch_to_device(step_batches(e, to_skip), device,
                                       depth=prefetch):
            state, metrics = step_fn(state, x, y)
            steps += 1
            if on_step is not None:
                on_step(steps, state, metrics)
            # gated on the host counter: the loss is read only when due
            if log_every and steps % log_every == 0:
                print(
                    f"[{log_tag}] step={base_step + steps} "
                    f"loss={float(metrics['loss']):.4f}"
                )
    return state, metrics


def batched_count_eval(eval_fn, params, x, y, batch: int, group: int):
    """Run a (params, x, y) -> (correct_sum, loss_sum) eval over the set in
    ``group``-divisible batches (truncating the remainder). Returns
    (correct, loss_sum, n_examples_used)."""
    batch = (min(batch, len(x)) // group) * group or group
    n = (len(x) // batch) * batch
    if n == 0:
        raise ValueError("eval set smaller than one global batch")
    correct = 0
    loss_sum = 0.0
    for i in range(0, n, batch):
        c, l = eval_fn(params, x[i : i + batch], y[i : i + batch])
        correct += int(c)
        loss_sum += float(l)
    return correct, loss_sum, n


# Examples per forward pass of the count-and-loss eval: an LM's (64, T, V)
# f32 logits stay small (1.3 GB at T = 512, V = 10^4); the sums are the same.
EVAL_ROWS = 64


def build_count_loss_eval(model, device, split: Optional[Callable] = None) -> Callable:
    """(params, x, y) -> (correct-count sum, loss sum) over a batch, as the
    reference's sharded eval sums them over the workers: correct argmax
    predictions and summed cross-entropy over every label (every token for
    an LM). The batch runs :data:`EVAL_ROWS` examples at a time, each slice
    of inputs and labels laid out by ``split`` first when given (the
    sequence blocks of ``parallel/seq.py``)."""

    @torch.no_grad()
    def eval_fn(params, x, y):
        x, y = torch.as_tensor(x).to(device), torch.as_tensor(y).to(device)
        correct = torch.zeros((), dtype=torch.int64, device=device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for xs, ys in zip(x.split(EVAL_ROWS), y.split(EVAL_ROWS)):
            if split is not None:
                xs, ys = split(xs), split(ys)
            logits = model.apply(params, xs)
            correct += (logits.argmax(-1) == ys).sum()
            loss_sum += cross_entropy_sum(logits, ys)
        return correct, loss_sum

    return eval_fn
