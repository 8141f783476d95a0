"""Training entry point: one function from :class:`TrainConfig` to results.

Counterpart of ``mpit_tpu/run.py`` for the algos and models the port has:
``easgd``/``eamsgd`` with ``lenet``/``mlp`` on MNIST (or its synthetic
stand-in), SGD with momentum at a constant learning rate. Everything else
raises ``NotImplementedError`` naming the ROADMAP item that will bring it.

    python -m mpit_tpu_torch.run --preset mnist-easgd

runs on the card, with W = 8 workers stacked on it unless the topology was
initialized otherwise, and prints the results dict as one JSON line.
"""

from __future__ import annotations

import json
import time
import torch

from mpit_tpu_torch.utils.config import TrainConfig

_MODELS = ("lenet", "mlp")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to mpit_tpu_torch yet (ROADMAP.md, {item})"
    )


def _check_supported(cfg: TrainConfig) -> None:
    algo = cfg.resolved_algo()
    if algo != "easgd":
        raise _not_ported(f"algo={cfg.algo!r}", "items A6-A11")
    if cfg.model.lower() not in _MODELS:
        raise _not_ported(f"model={cfg.model!r}", "items A8-A9")
    if cfg.dataset != "mnist":
        raise _not_ported(f"dataset={cfg.dataset!r}", "item A5b")
    if cfg.optimizer != "sgd" or cfg.lr_schedule != "constant":
        raise _not_ported(
            f"optimizer={cfg.optimizer!r} with lr_schedule="
            f"{cfg.lr_schedule!r}", "item A5b",
        )
    if cfg.clip_norm is not None:
        raise _not_ported("clip_norm", "item A5b")
    if cfg.ckpt_dir or cfg.resume:
        raise _not_ported("checkpointing (ckpt_dir, resume)", "item A5b")
    if cfg.profile_dir:
        raise _not_ported("profile_dir", "item A5b")
    if cfg.exchange_dtype not in ("none", "bf16"):
        raise ValueError(
            f"unknown exchange_dtype {cfg.exchange_dtype!r}; have: none, bf16"
        )


def build_model(cfg: TrainConfig, device):
    from mpit_tpu_torch.models import MLP, LeNet

    name = cfg.model.lower()
    return (LeNet if name == "lenet" else MLP)(device=device)


def build_optimizer(cfg: TrainConfig):
    """The config's local optimizer: ``optax.sgd(lr, momentum)``'s math."""
    from mpit_tpu_torch.optim import SGD

    _check_supported(cfg)
    return SGD(cfg.lr, cfg.momentum)


def build_trainer(cfg: TrainConfig, model, opt, topo):
    """The EASGD trainer for ``cfg`` (the elastic kernel on by default for
    CUDA tensors)."""
    from mpit_tpu_torch.parallel import EASGDTrainer

    _check_supported(cfg)
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
    from mpit_tpu_torch.data import Batches, cast_input_dtype, load_mnist
    from mpit_tpu_torch.utils.metrics import MetricsLogger
    from mpit_tpu_torch.utils.profiling import force_completion

    _check_supported(cfg)
    if device is None:
        topo = topology()
    else:
        w = size() if is_initialized() else DEFAULT_WORKERS
        topo = Topology(num_workers=w, device=resolve_device(device))
    x_tr, y_tr, x_te, y_te = load_mnist(synthetic_train=cfg.train_size)
    x_tr = cast_input_dtype(x_tr, cfg.input_dtype)

    model = build_model(cfg, topo.device)
    opt = build_optimizer(cfg)
    log = MetricsLogger(path=cfg.metrics_path, tag=cfg.algo, echo=False)
    results: dict = {"config": cfg.to_json(), "workers": topo.num_workers,
                     "platform": topo.platform}

    trainer = build_trainer(cfg, model, opt, topo)
    gb = max(cfg.global_batch // topo.num_workers, 1) * topo.num_workers
    gen = torch.Generator().manual_seed(cfg.seed)
    state = trainer.init_state(gen)

    batches = Batches(x_tr, y_tr, global_batch=gb, seed=cfg.seed)
    if batches.steps_per_epoch() // cfg.tau == 0:
        raise ValueError(
            f"epoch of {batches.steps_per_epoch()} step(s) cannot fill one "
            f"round of tau={cfg.tau}"
        )
    rounds = 0
    losses = []

    def on_round(done, st, m):
        nonlocal rounds
        rounds = done
        losses.append(m["loss"])
        if cfg.log_every and done % cfg.log_every == 0:
            log.log(done, loss=m["loss"])

    t_start = time.perf_counter()
    state, metrics = trainer.fit(
        batches, state, epochs=cfg.epochs, on_round=on_round,
        prefetch=cfg.prefetch,
    )
    if metrics is not None:
        force_completion(state.center, metrics)
    wall = time.perf_counter() - t_start
    samples = rounds * cfg.tau * gb

    acc = trainer.evaluate(state, x_te, y_te)
    results.update(
        accuracy=acc,
        final_loss=float(metrics["loss"]) if metrics is not None else None,
        round_losses=[float(v) for v in losses],
        trained_units=rounds,
        samples=samples,
        wall_s=wall,
        samples_per_sec=samples / wall,
        samples_per_sec_per_chip=samples / wall,  # one device
        step_time={"steps": rounds,
                   "mean_s": wall / rounds if rounds else None},
    )
    log.close()
    return results


def main(argv=None) -> None:
    """CLI over the presets the port runs; prints the results dict as one
    JSON line."""
    cfg = TrainConfig.from_args(
        argv,
        description="mpit_tpu_torch training on one CUDA card "
        "(e.g. --preset mnist-easgd --epochs 1)",
    )
    print(json.dumps(run(cfg), default=repr))


if __name__ == "__main__":
    main()
