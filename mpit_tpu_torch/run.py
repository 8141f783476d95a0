"""Training entry point: one function from :class:`TrainConfig` to results.

Counterpart of ``mpit_tpu/run.py`` for the algos and models the port has:

- models: every registry model (``models.get_model``: ``lenet``, ``mlp``,
  ``vgg``, ``alexnet``, ``resnet50``, ``lstm``, ``transformer`` and the
  reference's aliases) on any dataset whose shapes fit (``mnist``,
  ``cifar10``, ``imagenet``, ``ptb``, each with its synthetic stand-in);
- ``easgd``/``eamsgd`` and ``downpour`` (τ-round trainers over W stacked
  workers) and ``sync`` (data-parallel), with SGD at a constant learning
  rate, and under ``sync`` also Adam or AdamW with a constant, cosine or
  warmup-cosine schedule;
- ``ps-easgd``/``ps-eamsgd``/``ps-downpour``: the host-async parameter
  server, servers and clients as threads over the message plane
  ``transport`` names (``auto``: the C++ broker where it builds;
  ``native``, ``inproc`` or ``socket``), each client's local steps on the
  card, with chaos fault injection when ``MPIT_CHAOS_*`` knobs are set.
  Process mode (one OS process per rank) is ``python -m
  mpit_tpu_torch.launch -n 3 mpit_tpu_torch/examples/ptest_proc.py``.

Everything else raises ``NotImplementedError`` naming the ROADMAP item that
will bring it. Flags that do not apply to the chosen algo or model warn,
with the reference's wording, as the reference does.

    python -m mpit_tpu_torch.run --preset mnist-easgd
    python -m mpit_tpu_torch.run --preset cifar-vgg-sync
    python -m mpit_tpu_torch.run --preset resnet50-sync
    python -m mpit_tpu_torch.run --preset ptb-lstm-easgd
    python -m mpit_tpu_torch.run --preset alexnet-downpour
    python -m mpit_tpu_torch.run --preset ptb-transformer-large --algo sync --attn-impl flash
    python -m mpit_tpu_torch.run --preset mnist-ps

run on the card, with W = 8 workers stacked on it (easgd, downpour) or
sharing its global batch (sync) unless the topology was initialized
otherwise, or with ``clients`` client threads and ``servers`` server
threads (ps-*), and print the results dict as one JSON line.
"""

from __future__ import annotations

import json
import time
import warnings

import numpy as np
import torch

from mpit_tpu_torch.models import REMAT_MODELS
from mpit_tpu_torch.utils.config import TrainConfig

_ALGOS = ("easgd", "downpour", "sync", "ps-easgd", "ps-downpour")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to mpit_tpu_torch yet (ROADMAP.md, {item})"
    )


def _check_supported(cfg: TrainConfig) -> None:
    algo = cfg.resolved_algo()
    if algo not in _ALGOS:
        raise _not_ported(f"algo={cfg.algo!r}", "items A6-A11")
    if (algo in ("easgd", "downpour") or cfg.optimizer == "sgd") and (
        cfg.optimizer != "sgd" or cfg.lr_schedule != "constant"
    ):
        raise _not_ported(
            f"optimizer={cfg.optimizer!r} with lr_schedule="
            f"{cfg.lr_schedule!r} under algo={cfg.algo!r}", "item A5b",
        )
    if cfg.optimizer not in ("sgd", "adam", "adamw"):
        raise ValueError(
            f"unknown optimizer {cfg.optimizer!r}; have: sgd, adam, adamw"
        )
    if cfg.clip_norm is not None:
        raise _not_ported("clip_norm", "item A5b")
    if cfg.ckpt_dir or cfg.resume:
        raise _not_ported("checkpointing (ckpt_dir, resume)", "item A5b")
    if cfg.profile_dir:
        raise _not_ported("profile_dir", "item A5b")
    if cfg.remat and cfg.model.lower() in REMAT_MODELS:
        raise _not_ported("remat", "item A9")
    if cfg.exchange_dtype not in ("none", "bf16"):
        raise ValueError(
            f"unknown exchange_dtype {cfg.exchange_dtype!r}; have: none, bf16"
        )


def _ptb_windows(cfg: TrainConfig):
    """Token stream → (N, T) next-token windows: x=tokens[i:i+T],
    y=tokens[i+1:i+T+1] (the LM objective over fixed-length unrolls).
    Returns (x_train, y_train, x_valid, y_valid, {"vocab_size": V})."""
    from mpit_tpu_torch.data import load_ptb

    t_len = cfg.seq_len
    need = (cfg.train_size + 1) * t_len + 1
    train_toks, valid_toks, vocab = load_ptb(
        synthetic_tokens=max(need + need // 8, 20_000)
    )

    def windows(toks: np.ndarray):
        n = (len(toks) - 1) // t_len
        x = toks[: n * t_len].reshape(n, t_len)
        y = toks[1 : n * t_len + 1].reshape(n, t_len)
        return x.astype(np.int32), y.astype(np.int32)

    x_tr, y_tr = windows(train_toks)
    x_va, y_va = windows(valid_toks)
    return (
        x_tr[: cfg.train_size],
        y_tr[: cfg.train_size],
        x_va,
        y_va,
        {"vocab_size": vocab},
    )


def _load_dataset(cfg: TrainConfig):
    """(x_train, y_train, x_test, y_test, meta) for the config's dataset;
    ``meta`` carries dataset facts the model needs (e.g. vocab_size)."""
    from mpit_tpu_torch.data import load_cifar10, load_imagenet_like, load_mnist

    if cfg.dataset == "mnist":
        return (*load_mnist(synthetic_train=cfg.train_size), {})
    if cfg.dataset == "cifar10":
        return (*load_cifar10(synthetic_train=cfg.train_size), {})
    if cfg.dataset == "imagenet":
        return (
            *load_imagenet_like(
                synthetic_train=cfg.train_size,
                synthetic_test=max(cfg.train_size // 4, 64),
                image_size=cfg.image_size,
            ),
            {},
        )
    if cfg.dataset == "ptb":
        return _ptb_windows(cfg)
    raise ValueError(f"unknown dataset {cfg.dataset!r}")


def _image_shape(cfg: TrainConfig):
    """(H, W, C) of the dataset's images (None for text): the port's image
    models fix their input size at construction, where flax infers it."""
    return {"mnist": (28, 28, 1), "cifar10": (32, 32, 3),
            "imagenet": (cfg.image_size, cfg.image_size, 3)}.get(cfg.dataset)


def build_model(cfg: TrainConfig, device, meta: dict | None = None):
    from mpit_tpu_torch.models import STEM_MODELS, get_model

    meta = meta or {}
    name = cfg.model.lower()  # the registry lowercases; match it
    algo = cfg.resolved_algo()
    if cfg.remat and name not in REMAT_MODELS:
        warnings.warn(
            f"remat is implemented for {REMAT_MODELS} only; model "
            f"{cfg.model!r} runs without it",
            stacklevel=2,
        )
    if cfg.moe_experts and not (name == "transformer" and algo == "moe-sync"):
        warnings.warn(
            f"moe_experts={cfg.moe_experts} only applies with "
            f"model='transformer' and algo='moe-sync'; model={cfg.model!r} "
            f"algo={cfg.algo!r} runs without experts",
            stacklevel=2,
        )
    if cfg.seq_impl != "ring" and algo != "seq-sync":
        warnings.warn(
            f"seq_impl={cfg.seq_impl!r} only applies with algo='seq-sync' "
            f"(no sequence axis exists under algo={cfg.algo!r}); running "
            "plain dense attention",
            stacklevel=2,
        )
    if name == "transformer":
        return get_model(
            cfg.model,
            vocab_size=meta.get("vocab_size", 10_000),
            num_layers=cfg.layers,
            d_model=cfg.d_model,
            num_heads=cfg.heads,
            d_ff=cfg.d_ff,
            max_len=max(cfg.seq_len, 32),
            attn_impl=cfg.attn_impl,
            device=device,
        )
    if name in ("lstm", "lstm_lm", "ptb_lstm"):
        return get_model(cfg.model, vocab_size=meta.get("vocab_size", 10_000),
                         device=device)
    # capability kwargs derive from the registry lists, as the reference's
    kwargs = {}
    if name in STEM_MODELS:
        kwargs["stem"] = cfg.stem
    if name in REMAT_MODELS:
        kwargs["remat"] = cfg.remat
    if _image_shape(cfg) is not None:
        kwargs["in_shape"] = _image_shape(cfg)
    return get_model(cfg.model, device=device, **kwargs)


def build_optimizer(cfg: TrainConfig, total_updates: int = 2):
    """The config's optimizer and schedule, as ``optax`` computes them
    (``mpit_tpu/run.py:164-213``); the cosine decays over
    ``total_updates``."""
    from mpit_tpu_torch import optim

    _check_supported(cfg)
    if cfg.optimizer == "sgd":
        return optim.SGD(cfg.lr, cfg.momentum)
    total = max(int(total_updates), 2)  # optax needs decay_steps > 0
    if cfg.lr_schedule == "constant":
        lr = cfg.lr
    elif cfg.lr_schedule == "cosine":
        lr = optim.cosine_decay_schedule(cfg.lr, total)
    elif cfg.lr_schedule == "warmup-cosine":
        warm = min(cfg.warmup_steps, total - 1)  # strictly < total
        lr = optim.warmup_cosine_decay_schedule(0.0, cfg.lr, warm, total)
    else:
        raise ValueError(
            f"unknown lr_schedule {cfg.lr_schedule!r}; have: constant, "
            "cosine, warmup-cosine"
        )
    if cfg.optimizer == "adam":
        return optim.Adam(lr)
    return optim.AdamW(lr, weight_decay=cfg.weight_decay)


def build_trainer(cfg: TrainConfig, model, opt, topo):
    """The trainer for ``cfg.algo`` (the kernels on by default for CUDA
    tensors)."""
    from mpit_tpu_torch.parallel import (
        DataParallelTrainer, DownpourTrainer, EASGDTrainer,
    )

    _check_supported(cfg)
    algo = cfg.resolved_algo()
    if cfg.grad_accum > 1 and algo not in ("sync", "zero-sync"):
        warnings.warn(
            f"grad_accum={cfg.grad_accum} applies to algo='sync' and "
            f"'zero-sync' only; algo={cfg.algo!r} runs without "
            "accumulation",
            stacklevel=2,
        )
    if cfg.exchange_dtype != "none" and algo != "easgd":
        warnings.warn(
            f"exchange_dtype={cfg.exchange_dtype!r} only applies to the "
            f"easgd/eamsgd exchange collective; algo={cfg.algo!r} runs "
            "full-precision (flag ignored)",
            stacklevel=2,
        )
    if algo == "sync":
        return DataParallelTrainer(model, opt, topo, accum_steps=cfg.grad_accum)
    if algo == "downpour":
        return DownpourTrainer(model, opt, topo, tau=cfg.tau,
                               staleness=cfg.staleness)
    xdtype = torch.bfloat16 if cfg.exchange_dtype == "bf16" else None
    return EASGDTrainer(
        model, opt, topo, alpha=cfg.alpha, tau=cfg.tau, exchange_dtype=xdtype
    )


def run(cfg: TrainConfig, device=None) -> dict:
    """Train per ``cfg``; returns a results dict (acc, loss, throughput...).

    Runs on the current topology (initialized on the card if there is
    none), or, when ``device`` is given, on that device with the current
    topology's worker count (default 8)."""
    from mpit_tpu_torch.comm.topology import (
        DEFAULT_WORKERS, Topology, is_initialized, resolve_device, size, topology,
    )
    from mpit_tpu_torch.data import Batches, cast_input_dtype
    from mpit_tpu_torch.utils.metrics import MetricsLogger
    from mpit_tpu_torch.utils.profiling import force_completion

    _check_supported(cfg)
    if device is None:
        topo = topology()
    else:
        w = size() if is_initialized() else DEFAULT_WORKERS
        topo = Topology(num_workers=w, device=resolve_device(device))
    x_tr, y_tr, x_te, y_te, meta = _load_dataset(cfg)
    x_tr = cast_input_dtype(x_tr, cfg.input_dtype)
    is_sync = cfg.resolved_algo() == "sync"
    tau = 1 if is_sync else cfg.tau

    model = build_model(cfg, topo.device, meta)
    # cosine horizon: PS clients count LOCAL steps; everyone else counts
    # fit-loop units
    if cfg.algo.startswith("ps-"):
        total_updates = cfg.steps
    else:
        total_updates = cfg.epochs * max(len(x_tr) // max(cfg.global_batch, 1), 1)
    opt = build_optimizer(cfg, total_updates)
    log = MetricsLogger(path=cfg.metrics_path, tag=cfg.algo, echo=False)
    results: dict = {"config": cfg.to_json(), "workers": topo.num_workers,
                     "platform": topo.platform}
    if cfg.algo.startswith("ps-"):
        return _run_async_ps(cfg, model, opt, x_tr, y_tr, x_te, y_te, log,
                             results, topo.device)

    trainer = build_trainer(cfg, model, opt, topo)
    gb = max(cfg.global_batch // topo.num_workers, 1) * topo.num_workers
    gen = torch.Generator().manual_seed(cfg.seed)
    state = trainer.init_state(gen)

    batches = Batches(x_tr, y_tr, global_batch=gb, seed=cfg.seed)
    if batches.steps_per_epoch() // tau == 0:
        raise ValueError(
            f"epoch of {batches.steps_per_epoch()} step(s) cannot fill one "
            f"{'step' if is_sync else f'round of tau={tau}'}"
        )
    units = 0
    losses = []

    def on_unit(done, st, m):
        nonlocal units
        units = done
        losses.append(m["loss"])
        if cfg.log_every and done % cfg.log_every == 0:
            log.log(done, loss=m["loss"])

    t_start = time.perf_counter()
    if is_sync:
        state, metrics = trainer.fit(batches, state, epochs=cfg.epochs,
                                     on_step=on_unit, prefetch=cfg.prefetch)
    else:
        state, metrics = trainer.fit(batches, state, epochs=cfg.epochs,
                                     on_round=on_unit, prefetch=cfg.prefetch)
    if metrics is not None:
        force_completion(trainer.center_params(state) if not is_sync
                         else state.params, metrics)
    wall = time.perf_counter() - t_start
    samples = units * tau * gb

    if is_sync:
        acc, eval_loss = trainer.evaluate(state, x_te, y_te)
        results["eval_loss"] = eval_loss
    else:
        acc = trainer.evaluate(state, x_te, y_te)
    if cfg.dataset == "ptb":
        acc = acc / cfg.seq_len  # eval counts correct *tokens* per window
    results.update(
        accuracy=acc,
        final_loss=float(metrics["loss"]) if metrics is not None else None,
        round_losses=[float(v) for v in losses],
        trained_units=units,
        samples=samples,
        wall_s=wall,
        samples_per_sec=samples / wall,
        samples_per_sec_per_chip=samples / wall,  # one device
        step_time={"steps": units,
                   "mean_s": wall / units if units else None},
    )
    log.close()
    return results


def _run_async_ps(cfg, model, opt, x_tr, y_tr, x_te, y_te, log, results, device):
    """The reference's literal pclient/pserver shape (BASELINE.json:7),
    ``mpit_tpu/run.py:621-710``. ``log_every`` logs the per-step client
    losses post-hoc (there is no global step during the run: clients are
    asynchronous by design). ``grad_accum`` and ``exchange_dtype`` have no
    meaning here and warn. The training set is staged on the device
    before the clock; the clients index their shards there.

    Beside the reference's keys, ``results`` carries, per client,
    ``client_losses`` (every local step's loss) and
    ``exchange_ms_per_round`` (the host milliseconds of one successful
    exchange — fetch, push, elastic move — averaged over its rounds), and
    ``transport_used``, the message plane ``transport`` resolved to
    (``native``, ``inproc`` or ``socket``)."""
    from mpit_tpu_torch.parallel import AsyncPSTrainer

    if cfg.grad_accum > 1:
        warnings.warn(
            f"'grad_accum' is not supported with algo={cfg.algo!r} "
            "(async PS clients run their own local steps); ignoring",
            stacklevel=3,
        )
    if cfg.exchange_dtype != "none":
        warnings.warn(
            "exchange_dtype compresses the collective easgd exchange; the "
            "host-async PS protocol serializes parameters on its own path "
            "and ignores it",
            stacklevel=3,
        )
    ps_algo = cfg.resolved_algo().removeprefix("ps-")
    alpha = cfg.alpha if cfg.alpha is not None else 0.9 / cfg.clients
    trainer = AsyncPSTrainer(
        model, opt,
        num_clients=cfg.clients, num_servers=cfg.servers,
        algo=ps_algo,
        alpha=alpha, tau=cfg.tau,
        transport=cfg.transport,
        client_timeout=cfg.client_timeout,
        device=device,
    )
    per_client = max(cfg.global_batch // cfg.clients, 1)
    x_dev = torch.as_tensor(x_tr).to(device)
    y_dev = torch.as_tensor(y_tr).to(device)
    t0 = time.perf_counter()
    center, stats = trainer.train(
        x_dev, y_dev, steps=cfg.steps, batch_size=per_client, seed=cfg.seed
    )
    wall = time.perf_counter() - t0
    acc = trainer.evaluate(center, x_te, y_te)
    samples = cfg.steps * per_client * cfg.clients
    if cfg.log_every:
        # stop before the final step — the summary line below logs it
        for s in range(cfg.log_every - 1, cfg.steps - 1, cfg.log_every):
            step_losses = [l[s] for l in stats["losses"] if len(l) > s]
            if step_losses:
                log.log(s + 1, loss=float(np.mean(step_losses)))
    log.log(cfg.steps, loss=stats["mean_final_loss"], accuracy=acc)
    results.update(
        accuracy=acc,
        final_loss=stats["mean_final_loss"],
        server_counts=stats["server_counts"],
        dead_clients=stats["dead_clients"],
        center_restored=stats["center_restored"],
        samples=samples,
        wall_s=wall,
        samples_per_sec=samples / wall,
        clients=cfg.clients,
        servers=cfg.servers,
        client_losses=stats["losses"],
        exchange_ms_per_round=[
            1e3 * s["exchange_s"] / s["rounds"] if s.get("rounds") else None
            for s in trainer.exchange_stats
        ],
        transport_used=trainer.transport_used,
    )
    log.close()
    return results


def main(argv=None) -> None:
    """CLI over the presets the port runs; prints the results dict as one
    JSON line."""
    cfg = TrainConfig.from_args(
        argv,
        description="mpit_tpu_torch training on one CUDA card (e.g. "
        "--preset mnist-easgd --epochs 1, --preset cifar-vgg-sync, --preset "
        "resnet50-sync, --preset ptb-lstm-easgd, --preset alexnet-downpour, "
        "--preset ptb-transformer-large --algo sync --attn-impl flash, or "
        "--preset mnist-ps)",
    )
    print(json.dumps(run(cfg), default=repr))


if __name__ == "__main__":
    main()
