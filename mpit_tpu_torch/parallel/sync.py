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
``MPIT_DP_QUANT``/``MPIT_DP_BUCKET_BYTES`` knobs; ``mpit_tpu/parallel/
sync.py:541``): when either engages it, each worker takes its own gradient
(``common.per_worker_value_and_grad``), the flat gradient (in the
reference's element order, ``convert.flax_flat``) is cut into buckets of
whole leaves in flatten order, and each bucket crosses two hops,
reduce-scatter by all-to-all then all-gather, at f32 width or as int8 or
bf16 codes (the phases ``comm.collectives.raw_rows_*`` and
``quantized_rows_*``) with two-level
error feedback: ``_residual`` on each worker's contribution, ``_residual2``
on its owned reduced chunk. They are trainer attributes, not part of the
checkpoint, as in the reference. The replicated update then runs on the
gathered mean. With both knobs off the step is the fused one above,
unchanged.

Observability (``obs``, or the ``MPIT_OBS_*`` knobs with ``MPIT_OBS_DIR``
set) journals the bucketed step as the reference does, into
``<dir>/obs_rank0.jsonl``: a ``compute`` span around each phase on the
device (the gradients, each bucket's encode and reduce, the update), a
``send`` record with each hop's wall time and bytes, and one ``dynamics``
record a step (``elastic`` the error-feedback residual norm, ``push_norm``
the update's norm). An armed span ends only after the card has finished
its work (a stream synchronize), so it measures device time, not dispatch;
unarmed, the step adds no synchronization at all. The fused step, armed,
is one ``compute`` span in :meth:`DataParallelTrainer.step`.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, List, Optional

import torch

from mpit_tpu_torch import quant as _quant
from mpit_tpu_torch.analysis import runtime as _runtime
from mpit_tpu_torch.comm.collectives import (
    quantized_rows_decode,
    quantized_rows_encode,
    quantized_rows_hop1,
    quantized_rows_hop2,
    quantized_rows_reduce,
    raw_rows_hop1,
    raw_rows_hop2,
    raw_rows_reduce,
)
from mpit_tpu_torch.comm.topology import Topology, in_process_group
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.convert import flax_flat, from_flax_flat
from mpit_tpu_torch.obs import core as obs_core
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.utils.params import tree_leaves, tree_map, tree_unflatten

# bucket size when bucketing is engaged without an explicit size: big
# enough that a hop's dispatch amortizes, small enough that a ResNet-scale
# gradient still splits into several buckets
DEFAULT_DP_BUCKET_BYTES = 4 << 20


def dp_quant_from_env(env=None) -> str:
    """``MPIT_DP_QUANT`` (off|bf16|int8; default off): the sync-DP
    gradient exchange's quantization mode."""
    env = os.environ if env is None else env
    mode = env.get("MPIT_DP_QUANT") or "off"
    if mode not in _quant.QUANT_MODES:
        raise ValueError(f"MPIT_DP_QUANT={mode!r}: expected one of {_quant.QUANT_MODES}")
    return mode


def dp_bucket_bytes_from_env(env=None) -> Optional[int]:
    """``MPIT_DP_BUCKET_BYTES`` (positive int, f32 bytes per bucket): set,
    it engages the bucketed exchange even unquantized. None when unset."""
    env = os.environ if env is None else env
    raw = env.get("MPIT_DP_BUCKET_BYTES")
    if raw is None or raw == "":
        return None
    b = int(raw)
    if b < 1:
        raise ValueError(f"MPIT_DP_BUCKET_BYTES={b} must be >= 1")
    return b


class _Bucket:
    """One gradient bucket: leaves ``[lo, hi)`` as one flat f32 vector of
    ``n`` elements, padded to ``n_pad`` (divisible by W; each worker owns
    a ``chunk``-element row of the reduce-scatter)."""

    __slots__ = ("lo", "hi", "n", "n_pad", "chunk", "hop_bytes")

    def __init__(self, lo: int, hi: int, n: int, w: int, mode: str):
        self.lo, self.hi, self.n = lo, hi, n
        self.n_pad = n + (-n % w)
        self.chunk = self.n_pad // w
        # per-worker bytes of ONE hop: the padded bucket at wire width,
        # plus W block scales for int8
        self.hop_bytes = self.n_pad * _quant.MODE_ITEMSIZE[mode] + (
            4 * w if mode == "int8" else 0)


class _BucketPlan:
    """Leaf layout and bucket partition of one parameter tree: buckets are
    runs of flatten-order leaves closed once their f32 bytes reach the
    target; a leaf is never split (one larger than the target is a bucket
    of its own)."""

    def __init__(self, params, w: int, bucket_bytes: int, mode: str):
        leaves = tree_leaves(params)
        self.template = params
        self.shapes = [tuple(leaf.shape) for leaf in leaves]
        self.dtypes = [leaf.dtype for leaf in leaves]
        self.sizes = [math.prod(sh) for sh in self.shapes]
        self.buckets: List[_Bucket] = []
        lo, acc = 0, 0
        for i, sz in enumerate(self.sizes):
            acc += sz * 4
            if acc >= bucket_bytes:
                self.buckets.append(_Bucket(lo, i + 1, sum(self.sizes[lo:i + 1]), w, mode))
                lo, acc = i + 1, 0
        if lo < len(self.sizes):
            self.buckets.append(_Bucket(lo, len(self.sizes), sum(self.sizes[lo:]), w, mode))

    def wire_bytes_per_step(self) -> int:
        """Per-worker bytes the exchange puts on the wire each step (two
        hops per bucket)."""
        return sum(2 * b.hop_bytes for b in self.buckets)


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
      quant, bucket_bytes: the bucketed exchange (default: the
        ``MPIT_DP_QUANT``/``MPIT_DP_BUCKET_BYTES`` knobs); see the module
        docstring. With both off the step is the fused one.
      obs: an :class:`~mpit_tpu_torch.obs.core.ObsConfig` (default: the
        ``MPIT_OBS_*`` knobs); with a ``dir`` it arms the step's journal.
        Call :meth:`close_obs` to close the journal.
    """

    def __init__(
        self,
        model,
        optimizer,
        topo: Optional[Topology] = None,
        accum_steps: int = 1,
        quant: Optional[str] = None,
        bucket_bytes: Optional[int] = None,
        obs: Optional[obs_core.ObsConfig] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.topo = topo if topo is not None else _current_topology()
        self.accum_steps = common.check_accum_steps(accum_steps)
        self.quant = dp_quant_from_env() if quant is None else quant
        if self.quant not in _quant.QUANT_MODES:
            raise ValueError(f"quant={self.quant!r}: expected one of {_quant.QUANT_MODES}")
        bb = bucket_bytes if bucket_bytes is not None else dp_bucket_bytes_from_env()
        self.bucketed = self.quant != "off" or bb is not None
        self.bucket_bytes = int(bb) if bb is not None else DEFAULT_DP_BUCKET_BYTES
        if self.bucket_bytes < 1:
            raise ValueError(f"bucket_bytes={self.bucket_bytes} must be >= 1")
        self.obs = obs if obs is not None else obs_core.config_from_env()
        self._tracer: Optional[obs_core.Tracer] = None
        self._round = 0
        loss_fn = common.default_loss_fn(model.apply)
        remat = getattr(model, "remat", False)
        self._vg = common.accumulated_value_and_grad(loss_fn, self.accum_steps,
                                                     remat=remat)
        # the bucketed path's: each worker's own gradient
        self._worker_vg = common.per_worker_value_and_grad(loss_fn, self.accum_steps,
                                                           remat=remat)
        self._plan: Optional[_BucketPlan] = None
        self._residual: Optional[list] = None
        self._residual2: Optional[list] = None
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

    # -- observability --------------------------------------------------------

    def _armed_tracer(self) -> Optional[obs_core.Tracer]:
        """Build the journal/tracer lazily so ``trainer.obs`` can be set
        after warmup (the bench A/B pattern)."""
        if self._tracer is None and self.obs is not None and self.obs.dir:
            os.makedirs(self.obs.dir, exist_ok=True)
            journal = obs_core.Journal(
                os.path.join(self.obs.dir, "obs_rank0.jsonl"),
                rank=0,
                max_records=self.obs.max_records,
            )
            self._tracer = obs_core.Tracer(0, journal=journal)
        return self._tracer

    def close_obs(self) -> None:
        """Flush and close the trainer's obs journal (idempotent)."""
        if self._tracer is not None:
            self._tracer.close()
            self._tracer = None

    def _settle(self) -> None:
        """Wait for the card to finish what this thread queued: an armed
        span or hop ends here, so it times device work, not dispatch."""
        dev = self.topo.device
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()

    def _timed_hop(self, hop, args, nbytes: int, tracer):
        """Run one wire hop. Armed: wait for it and journal the wall wait
        as a ``send`` (dur + bytes, the roofline's wire figure). Unarmed:
        dispatch only, which is where the overlap comes from."""
        if tracer is None:
            return hop(*args)
        t0 = time.perf_counter()
        out = hop(*args)
        self._settle()
        tracer.journal.event(
            "send", tracer.clock.tick(), dur=time.perf_counter() - t0, bytes=nbytes)
        return out

    # -- the bucketed exchange ---------------------------------------------

    def wire_bytes_per_step(self) -> Optional[int]:
        """Per-worker exchange bytes a step (None until the first bucketed
        step has built the plan, and on the fused path)."""
        return self._plan.wire_bytes_per_step() if self._plan is not None else None

    def _ensure_buckets(self, params) -> None:
        if self._plan is not None:
            return
        w, wl = self.topo.num_workers, self.topo.local_workers
        self._plan = plan = _BucketPlan(params, w, self.bucket_bytes, self.quant)
        if self.quant != "off":
            dev = self.topo.device
            self._residual = [torch.zeros(wl, b.n_pad, device=dev) for b in plan.buckets]
            self._residual2 = [torch.zeros(wl, b.chunk, device=dev) for b in plan.buckets]

    def _bucketed_step(self, state: common.TrainState, x: torch.Tensor, y: torch.Tensor):
        """One step of the bucketed exchange on device tensors (this
        process's rows); returns the new state and ``{"loss", "param_norm",
        "update_norm"}`` as device scalars. Armed, each phase is journaled
        as the reference's step journals it (see the module docstring)."""
        self._ensure_buckets(state.params)
        plan, wl, mode = self._plan, self.topo.local_workers, self.quant
        tracer = self._armed_tracer()
        armed = tracer is not None

        def _span():
            return tracer.span("compute") if armed else obs_core.NULL_SPAN

        def _settle():
            if armed:
                self._settle()

        with _span():
            grads, losses = self._worker_vg(
                state.params, x.reshape(wl, -1, *x.shape[1:]),
                y.reshape(wl, -1, *y.shape[1:]))
            loss = common.world_sum(losses) / self.topo.num_workers
            leaves = tree_leaves(grads)
            rows = []
            for b in plan.buckets:
                row = torch.cat([flax_flat(leaves[i], 1).to(torch.float32)
                                 for i in range(b.lo, b.hi)], 1)
                rows.append(torch.nn.functional.pad(row, (0, b.n_pad - b.n)))
            _settle()

        gathered, res_sq = [], []
        for k, b in enumerate(plan.buckets):
            if mode == "off":
                xch = self._timed_hop(raw_rows_hop1, (rows[k],), b.hop_bytes, tracer)
                with _span():
                    red = raw_rows_reduce(xch)
                    _settle()
                gathered.append(self._timed_hop(raw_rows_hop2, (red,), b.hop_bytes, tracer))
                continue
            with _span():
                c = rows[k] + self._residual[k]
                codes, scales, sent = quantized_rows_encode(c, mode)
                self._residual[k] = c - sent
                res_sq.append(self._residual[k].square().sum())
                _settle()
            cx, sx = self._timed_hop(quantized_rows_hop1, (codes, scales, mode),
                                     b.hop_bytes, tracer)
            with _span():
                rcodes, rscale, self._residual2[k] = quantized_rows_reduce(
                    cx, sx, mode, mean=True, r2=self._residual2[k])
                _settle()
            gathered.append(self._timed_hop(quantized_rows_hop2, (rcodes, rscale, mode),
                                            b.hop_bytes, tracer))

        with _span():
            flats = [(g if mode == "off" else quantized_rows_decode(*g, mode))[:b.n]
                     for g, b in zip(gathered, plan.buckets)]
            flat_all = torch.cat(flats)
            mean = [from_flax_flat(part, shape).to(dtype) for part, shape, dtype in zip(
                torch.split(flat_all, plan.sizes), plan.shapes, plan.dtypes)]
            # the optimizer's updates themselves, as the reference's
            # update_norm measures them (not new - old params)
            p = tree_leaves(state.params)
            updates, opt_state = self.optimizer.transform(mean, state.opt_state, p, False)
            params = tree_unflatten(state.params, torch._foreach_add(p, updates))
            pn = torch.stack([q.to(torch.float32).square().sum()
                              for q in tree_leaves(params)]).sum().sqrt()
            un = torch.stack([u.to(torch.float32).square().sum()
                              for u in updates]).sum().sqrt()
            _settle()

        checker = _runtime.active_checker()
        if armed or (checker is not None and getattr(checker, "numerics", False)):
            elastic = (math.sqrt(sum(torch.stack(res_sq).double().tolist()))
                       if res_sq else 0.0)
            # RT104 sees the SAME value the dynamics plane journals as
            # `elastic`: the sanitizer and the journal cannot disagree
            _runtime.note_residual_norm("sync-dp.elastic", elastic)
        if armed:
            self._round += 1
            pn_f, un_f = float(pn), float(un)
            tracer.journal.event(
                "dynamics", tracer.clock.tick(), round=self._round, algo="sync-dp",
                elastic=elastic, push_norm=un_f, param_norm=pn_f, fetch_delta=0.0,
                ratio=un_f / pn_f if pn_f > 0 else 0.0)
        return (common.TrainState(params, opt_state, state.step + 1),
                {"loss": loss, "param_norm": pn, "update_norm": un})

    def step(self, state, x_global, y_global):
        """One sync-DP step on a global batch (leading dim divisible by W,
        per-worker shard divisible by accum_steps)."""
        self._check(x_global)
        x, y = self._shard(x_global, y_global)
        dev = self.topo.device
        x, y = torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev)
        if self.bucketed:
            return self._bucketed_step(state, x, y)
        tracer = self._armed_tracer()
        if tracer is None:
            return self._step(state, x, y)
        with tracer.span("compute"):
            out = self._step(state, x, y)
            self._settle()
        return out

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
            self._bucketed_step if self.bucketed else self._step, batches, state,
            device=self.topo.device, check=self._check,
            shard=self._shard, epochs=epochs, start_epoch=start_epoch, skip_steps=skip_steps,
            on_step=on_step, prefetch=prefetch,
        )
