"""Training entry point: one function from :class:`TrainConfig` to results.

Counterpart of ``mpit_tpu/run.py`` for the algos and models the port has:

- models: every registry model (``models.get_model``: ``lenet``, ``mlp``,
  ``vgg``, ``alexnet``, ``resnet50``, ``lstm``, ``transformer`` and the
  reference's aliases) on any dataset whose shapes fit (``mnist``,
  ``cifar10``, ``imagenet``, ``ptb``, each with its synthetic stand-in);
- ``easgd``/``eamsgd`` and ``downpour`` (τ-round trainers over W stacked
  workers), ``sync`` (data-parallel; the bucketed and quantized exchange
  under ``MPIT_DP_QUANT``/``MPIT_DP_BUCKET_BYTES``), ``zero-sync`` (sync
  with ZeRO-1 sharded optimizer state) and ``seq-sync`` (sequence-parallel
  sync over a ``(W/sp, sp)`` world, ring or Ulysses attention by
  ``seq_impl``), each with SGD, Adam or AdamW under a constant, cosine or
  warmup-cosine schedule, and ``clip_norm``; ``remat`` on the transformer
  and ResNet-50;
- ``moe-sync`` (the MoE transformer, experts sharded over the worker axis,
  ``--moe-experts``) and ``pp-sync`` (the transformer's layers over a
  ``(W/pp, pp)`` world, ``--pp-schedule gpipe | 1f1b | interleaved``);
- ``ps-easgd``/``ps-eamsgd``/``ps-downpour``: the host-async parameter
  server, servers and clients as threads over the message plane
  ``transport`` names (``auto``: the C++ broker where it builds;
  ``native``, ``inproc`` or ``socket``), each client's local steps on the
  card, with chaos fault injection when ``MPIT_CHAOS_*`` knobs are set.
  Process mode (one OS process per rank) is ``python -m
  mpit_tpu_torch.launch -n 3 mpit_tpu_torch/examples/ptest_proc.py``;
- ``ckpt_dir``/``ckpt_every``/``resume``: checkpoints in the reference's
  file format (``utils/checkpoint.py``), so a run resumes from either
  package's files, and a resumed run re-enters the same data order;
  ``profile_dir``: a ``torch.profiler`` trace of the loop.

Flags that do not apply to the chosen algo or model warn, with the
reference's wording, as the reference does.

    python -m mpit_tpu_torch.run --preset mnist-easgd
    python -m mpit_tpu_torch.run --preset cifar-vgg-sync
    python -m mpit_tpu_torch.run --preset resnet50-sync
    python -m mpit_tpu_torch.run --preset ptb-lstm-easgd
    python -m mpit_tpu_torch.run --preset alexnet-downpour
    python -m mpit_tpu_torch.run --preset ptb-transformer-large
    python -m mpit_tpu_torch.run --preset ptb-transformer-large --sp 4 --seq-impl ulysses
    python -m mpit_tpu_torch.run --preset ptb-transformer-large --algo sync --attn-impl flash --remat
    python -m mpit_tpu_torch.run --preset ptb-transformer-large --algo zero-sync --attn-impl flash
    python -m mpit_tpu_torch.run --preset ptb-transformer-large --algo moe-sync --moe-experts 8 --attn-impl flash
    python -m mpit_tpu_torch.run --preset ptb-transformer-pp --pp-schedule 1f1b
    MPIT_DP_QUANT=int8 python -m mpit_tpu_torch.run --preset resnet50-sync
    python -m mpit_tpu_torch.run --preset mnist-ps
    python -m mpit_tpu_torch.run --preset mnist-easgd --ckpt-dir ck --epochs 1
    python -m mpit_tpu_torch.run --preset mnist-easgd --ckpt-dir ck --epochs 2 --resume

run on the card, with W = 8 workers stacked on it (easgd, downpour) or
sharing its global batch (sync, moe-sync; seq-sync as ``(W/sp, sp)``,
pp-sync as ``(W/pp, pp)``) unless the
topology was initialized otherwise, or with ``clients`` client threads and
``servers`` server threads (ps-*), and print the results dict as one JSON
line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from mpit_tpu_torch.models import REMAT_MODELS
from mpit_tpu_torch.utils.config import TrainConfig

_ALGOS = ("easgd", "downpour", "sync", "zero-sync", "seq-sync", "moe-sync",
          "pp-sync", "ps-easgd", "ps-downpour")
# the per-step (no τ-round) algos
SYNC_ALGOS = ("sync", "zero-sync", "seq-sync", "moe-sync", "pp-sync")
# the algos whose trainer takes clip_norm itself (its update runs on
# device-varying gradients in the reference, where the chain is refused)
TRAINER_CLIPS = ("moe-sync", "zero-sync", "pp-sync")


def second_axis_for(cfg: TrainConfig) -> dict:
    """algo -> (second mesh-axis name, configured extent) for the 2-D
    mesh algos (``mpit_tpu/run.py:158``); the one copy ``_world_for``
    reads."""
    return {"seq-sync": ("sp", cfg.sp), "pp-sync": ("pp", cfg.pp)}


def _check_supported(cfg: TrainConfig) -> None:
    algo = cfg.resolved_algo()
    if algo not in _ALGOS:
        raise ValueError(f"unknown algo {cfg.algo!r}")
    if cfg.optimizer not in ("sgd", "adam", "adamw"):
        raise ValueError(
            f"unknown optimizer {cfg.optimizer!r}; have: sgd, adam, adamw"
        )
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
            # seq-sync runs the model over the stacked blocks of the "sp"
            # axis (ring or Ulysses attention)
            seq_axis="sp" if algo == "seq-sync" else None,
            seq_impl=cfg.seq_impl,
            remat=cfg.remat,
            attn_impl=cfg.attn_impl,
            device=device,
            # moe-sync shards the experts over the worker axis
            **(
                {
                    "moe_experts": cfg.moe_experts,
                    "moe_axis": "dp",
                    "moe_capacity_factor": cfg.moe_capacity_factor,
                    "moe_top_k": cfg.moe_top_k,
                    "moe_balance_weight": cfg.moe_balance_weight,
                    "moe_zloss_weight": cfg.moe_zloss_weight,
                }
                if algo == "moe-sync"
                else {}
            ),
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
    (``mpit_tpu/run.py:164-213``), for every algo the port has; the cosine
    decays over ``total_updates``. With ``clip_norm`` the clip is chained in
    front: under easgd, downpour and ps-* each worker clips its own local
    gradient (the reference's "async semantics"), under sync the reduced
    one. zero-sync, moe-sync and pp-sync take ``clip_norm`` in their
    trainers instead (:data:`TRAINER_CLIPS`: the reference's update runs on
    chunks, expert shards or stages there, where the chain is refused)."""
    from mpit_tpu_torch import optim

    _check_supported(cfg)
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
    if cfg.optimizer == "sgd":
        opt = optim.SGD(lr, momentum=cfg.momentum)
    elif cfg.optimizer == "adam":
        opt = optim.Adam(lr)
    else:
        opt = optim.AdamW(lr, weight_decay=cfg.weight_decay)
    if cfg.clip_norm is not None and cfg.resolved_algo() not in TRAINER_CLIPS:
        opt = optim.chain(optim.clip_by_global_norm(cfg.clip_norm), opt)
    return opt


def build_trainer(cfg: TrainConfig, model, opt, topo, capture: Optional[bool] = None):
    """The trainer for ``cfg.algo`` (the kernels on by default for CUDA
    tensors); ``capture`` goes to every trainer but pp-sync's, which runs
    eagerly (None: a CUDA graph wherever the trainer can run one)."""
    from mpit_tpu_torch.parallel import (
        DataParallelTrainer, DownpourTrainer, EASGDTrainer, MoEParallelTrainer,
        SeqParallelTrainer, ZeroDataParallelTrainer,
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
        return DataParallelTrainer(model, opt, topo, accum_steps=cfg.grad_accum,
                                   capture=capture)
    if algo == "zero-sync":
        return ZeroDataParallelTrainer(model, opt, topo, accum_steps=cfg.grad_accum,
                                       clip_norm=cfg.clip_norm, capture=capture)
    if algo == "seq-sync":
        return SeqParallelTrainer(model, opt, topo, capture=capture)
    if algo == "moe-sync":
        if not cfg.moe_experts:
            raise ValueError(
                "algo='moe-sync' needs --moe-experts > 0 (and model="
                "transformer)"
            )
        return MoEParallelTrainer(model, opt, topo, clip_norm=cfg.clip_norm,
                                  capture=capture)
    if algo == "pp-sync":
        return _pipeline_trainer(cfg, model, opt, topo)
    if algo == "downpour":
        return DownpourTrainer(model, opt, topo, tau=cfg.tau,
                               staleness=cfg.staleness, capture=capture)
    xdtype = torch.bfloat16 if cfg.exchange_dtype == "bf16" else None
    return EASGDTrainer(
        model, opt, topo, alpha=cfg.alpha, tau=cfg.tau, exchange_dtype=xdtype,
        capture=capture,
    )


def _pipeline_trainer(cfg: TrainConfig, model, opt, topo):
    """pp-sync's trainer (``mpit_tpu/run.py:279-320``): the pipeline builds
    its own f32 dense-attention stacked-layer params, its shapes read off
    the transformer ``build_model`` made; it takes the optimizer every algo
    gets (elementwise, probed) and ``clip_norm``."""
    from mpit_tpu_torch.parallel.pipeline import PipelineParallelTrainer

    if cfg.model.lower() != "transformer":
        raise ValueError(
            "algo='pp-sync' is transformer-only (the pipeline stages "
            f"a transformer layer stack); got model={cfg.model!r}"
        )
    ignored = [f for f, on in (("attn_impl", cfg.attn_impl != "xla"),
                               ("remat", cfg.remat)) if on]
    if ignored:
        warnings.warn(
            f"pp-sync builds its own f32 dense-attention pipeline model; "
            f"{ignored} do not apply and are ignored",
            stacklevel=3,
        )
    return PipelineParallelTrainer(
        vocab_size=model.vocab_size, num_layers=model.num_layers,
        d_model=model.d_model, num_heads=model.num_heads, seq_len=model.max_len,
        d_ff=model.d_ff, topo=topo, n_micro=cfg.n_micro, optimizer=opt,
        clip_norm=cfg.clip_norm, schedule=cfg.pp_schedule, virtual=cfg.pp_virtual,
    )


def _world_for(cfg: TrainConfig, topo):
    """The world ``cfg`` needs over ``topo``'s stacked workers
    (``mpit_tpu/run.py:324-360``): seq-sync a 2-D ``(W/sp, sp)`` mesh over
    ``("dp", "sp")``, pp-sync ``(W/pp, pp)`` over ``("dp", "pp")``,
    everything else the 1-D worker mesh."""
    n = topo.num_workers
    second = second_axis_for(cfg)
    algo = cfg.resolved_algo()
    if algo not in second:
        return dataclasses.replace(topo, axis_names=("dp",), mesh_shape=(n,))
    ax, extent = second[algo]
    if n % extent:
        raise ValueError(f"{ax}={extent} does not divide the {n} available workers")
    return dataclasses.replace(topo, axis_names=("dp", ax),
                               mesh_shape=(n // extent, extent))


def _check_resume_layout(cfg: TrainConfig) -> None:
    """Refuse a resume whose checkpoint was written with another
    optimizer-state structure (``mpit_tpu/run.py:365-470``): the optimizer
    (Adam's moments or SGD's trace), a schedule or not (a count leaf or
    none) and clip_norm or not (the chain's tuple grows) change the
    layout; restoring across them would fail deep in the restore with an
    opaque structure error, so say it here. Value-only changes (lr, the
    clip threshold, cosine against warmup-cosine, momentum: a trace is kept
    for any float, 0.0 included) keep the layout and resume.

    pp-sync's params carry a LAYOUT as well: the pre-optax ``{params,
    momentum, step}`` state is refused, and so are another ``layers``,
    another schedule (unless both are gpipe/1f1b, which store alike) and,
    under interleaving, another ``pp`` or ``pp_virtual`` (the chunk storage
    permutation): shapes match, so a restore would load layers in the
    wrong order with no error."""
    from mpit_tpu_torch.utils.checkpoint import latest_checkpoint

    step = latest_checkpoint(cfg.ckpt_dir)
    if step is None:
        return
    meta_path = os.path.join(cfg.ckpt_dir, f"ckpt_{step:08d}.json")
    if not os.path.exists(meta_path):
        return
    with open(meta_path) as f:
        saved = json.loads(json.load(f).get("config", "{}"))
    if saved.get("algo") != cfg.algo:
        return  # a restore across algos fails on the structure already

    clip_chained = cfg.resolved_algo() not in TRAINER_CLIPS  # they clip

    def structure_of(opt, sched, clip):
        return {"optimizer": opt, "lr_is_schedule": sched != "constant",
                **({"clip_chained": clip is not None} if clip_chained else {})}

    cur = structure_of(cfg.optimizer, cfg.lr_schedule, cfg.clip_norm)
    # metadata without a field: compare only what the checkpoint recorded
    sav = structure_of(
        saved.get("optimizer", cfg.optimizer),
        saved.get("lr_schedule", cfg.lr_schedule),
        saved.get("clip_norm", cfg.clip_norm),
    )
    if sav != cur:
        diff = {k: (sav[k], cur[k]) for k in cur if sav[k] != cur[k]}
        raise ValueError(
            f"resume layout mismatch: checkpoint in {cfg.ckpt_dir!r} was "
            f"written with a different optimizer-state structure "
            f"{diff} (saved, requested) — restore with the original "
            "optimizer/lr_schedule/clip_norm configuration or start fresh"
        )
    if cfg.algo != "pp-sync":
        return
    _check_pipeline_layout(cfg, saved, step)


def _check_pipeline_layout(cfg: TrainConfig, saved: dict, step: int) -> None:
    """pp-sync's layout checks of :func:`_check_resume_layout`."""
    from mpit_tpu_torch.utils.checkpoint import _ckpt_path, msgpack_restore

    try:
        with open(_ckpt_path(cfg.ckpt_dir, step), "rb") as f:
            keys = set(msgpack_restore(f.read()))
    except Exception:
        keys = None
    if keys is not None and "momentum" in keys and "opt_state" not in keys:
        raise ValueError(
            f"checkpoint step {step} in {cfg.ckpt_dir} stores the "
            "pre-optax pipeline state layout {params, momentum, step}; "
            "the current pp-sync trainer keeps {params, opt_state, "
            "step}. Restart training (or restore with an old build) — "
            "resuming across this layout change is not supported."
        )
    # only interleaving permutes storage: under gpipe/1f1b the stacked
    # layers are in global order, and a gpipe<->1f1b flip stores alike
    fields = ["layers", "pp_schedule"]
    if "interleaved" in (saved.get("pp_schedule"), cfg.pp_schedule):
        fields += ["pp", "pp_virtual"]
    mismatched = {
        f: (saved.get(f), getattr(cfg, f))
        for f in fields
        if f in saved and saved.get(f) != getattr(cfg, f)
    }
    if set(mismatched) == {"pp_schedule"} and "interleaved" not in (
        saved.get("pp_schedule"), cfg.pp_schedule
    ):
        return
    if mismatched:
        raise ValueError(
            f"resume layout mismatch: checkpoint in {cfg.ckpt_dir!r} was "
            f"written with {mismatched} (saved, requested) — the pipeline "
            "param/opt-state layout depends on these; restore with the "
            "original config or start fresh"
        )


def _params_of(state):
    """A sync trainer state's params (pp-sync's state is a dict)."""
    return state["params"] if isinstance(state, dict) else state.params


def deterministic_convolutions() -> None:
    """cuDNN's deterministic algorithms and no autotuning, for every run
    (ROADMAP C7): cuDNN's default convolution backward sums in an order
    that changes run to run, and a chaotic trajectory (LeNet at lr 0.05,
    momentum 0.9) then ends elsewhere each time; XLA's programs, the
    reference's, give the same bits every run."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def run(cfg: TrainConfig, device=None) -> dict:
    """Train per ``cfg``; returns a results dict (acc, loss, throughput...).

    Runs on the current topology (initialized on the card if there is
    none), or, when ``device`` is given, on that device with the current
    topology's worker count (default 8). With ``resume`` it restores the
    latest checkpoint of ``ckpt_dir`` and trains on to ``epochs`` in all
    (the total, not the number to add), re-entering the data order where
    the checkpoint left it. cuDNN runs its deterministic algorithms
    (:func:`deterministic_convolutions`), so a run repeats bit for bit."""
    from mpit_tpu_torch.comm.topology import (
        DEFAULT_WORKERS, Topology, is_initialized, resolve_device, topology,
    )
    from mpit_tpu_torch.data import Batches, cast_input_dtype
    from mpit_tpu_torch.utils.checkpoint import (
        latest_checkpoint, restore_checkpoint, save_checkpoint,
    )
    from mpit_tpu_torch.utils.metrics import MetricsLogger
    from mpit_tpu_torch.utils.profiling import force_completion, trace

    _check_supported(cfg)
    deterministic_convolutions()
    if device is None:
        topo = topology()
    else:
        w = topology().local_workers if is_initialized() else DEFAULT_WORKERS
        topo = Topology(num_workers=w, device=resolve_device(device))
    topo = _world_for(cfg, topo)
    x_tr, y_tr, x_te, y_te, meta = _load_dataset(cfg)
    x_tr = cast_input_dtype(x_tr, cfg.input_dtype)
    is_sync = cfg.resolved_algo() in SYNC_ALGOS
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
    # the worker axis's extent, as the reference counts it (dp on seq-sync)
    workers = topo.mesh_shape[0]
    results: dict = {"config": cfg.to_json(), "workers": workers,
                     "platform": topo.platform}
    if cfg.algo.startswith("ps-"):
        return _run_async_ps(cfg, model, opt, x_tr, y_tr, x_te, y_te, log,
                             results, topo.device)

    trainer = build_trainer(cfg, model, opt, topo)
    gb = max(cfg.global_batch // workers, 1) * workers
    gen = torch.Generator().manual_seed(cfg.seed)
    state = trainer.init_state(gen)

    start_unit = 0
    if cfg.resume and cfg.ckpt_dir:
        _check_resume_layout(cfg)
        state, step = restore_checkpoint(cfg.ckpt_dir, state)
        if step is not None:
            start_unit = step
            results["resumed_from"] = step

    batches = Batches(x_tr, y_tr, global_batch=gb, seed=cfg.seed)
    units_per_epoch = batches.steps_per_epoch() // tau
    if units_per_epoch == 0:
        raise ValueError(
            f"epoch of {batches.steps_per_epoch()} step(s) cannot fill one "
            f"{'step' if is_sync else f'round of tau={tau}'}"
        )
    # resume re-enters the same data schedule: the unit count maps back to
    # (epoch, offset); cfg.epochs is the total
    start_epoch, skip_units = divmod(start_unit, units_per_epoch)
    unit = start_unit  # steps (sync) or rounds (easgd/downpour)
    losses = []
    metrics = None

    def on_unit(_done, st, m):
        nonlocal unit
        unit += 1
        losses.append(m["loss"])
        if cfg.log_every and unit % cfg.log_every == 0:
            log.log(unit, loss=m["loss"])
        if cfg.ckpt_dir and cfg.ckpt_every and unit % cfg.ckpt_every == 0:
            save_checkpoint(cfg.ckpt_dir, st, step=unit,
                            metadata={"config": cfg.to_json()})

    t_start = time.perf_counter()
    with trace(cfg.profile_dir, topo.device):
        if is_sync:
            state, metrics = trainer.fit(
                batches, state, epochs=cfg.epochs, start_epoch=start_epoch,
                skip_steps=skip_units, on_step=on_unit, prefetch=cfg.prefetch)
        else:
            state, metrics = trainer.fit(
                batches, state, epochs=cfg.epochs, start_epoch=start_epoch,
                skip_rounds=skip_units, on_round=on_unit, prefetch=cfg.prefetch)
        if metrics is not None:
            force_completion(trainer.center_params(state) if not is_sync
                             else _params_of(state), metrics)
    wall = time.perf_counter() - t_start
    trained = unit - start_unit
    samples = trained * tau * gb
    if cfg.ckpt_dir and trained:
        save_checkpoint(cfg.ckpt_dir, state, step=unit,
                        metadata={"config": cfg.to_json()})

    if is_sync:
        acc, eval_loss = trainer.evaluate(state, x_te, y_te)
        results["eval_loss"] = eval_loss
    else:
        acc = trainer.evaluate(state, x_te, y_te)
    if cfg.dataset == "ptb" and cfg.resolved_algo() not in (
            "seq-sync", "moe-sync", "pp-sync"):
        # eval counts correct *tokens* per window; the seq/moe/pp-sync
        # trainers count per token themselves
        acc = acc / cfg.seq_len
    results.update(
        accuracy=acc,
        final_loss=float(metrics["loss"]) if metrics is not None else None,
        round_losses=[float(v) for v in losses],
        trained_units=trained,
        samples=samples,
        wall_s=wall,
        samples_per_sec=samples / wall,
        samples_per_sec_per_chip=samples / wall / topo.num_devices,
        step_time={"steps": trained,
                   "mean_s": wall / trained if trained else None},
        last_checkpoint=(latest_checkpoint(cfg.ckpt_dir)
                         if cfg.ckpt_dir else None),
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
    (``native``, ``inproc`` or ``socket``).

    ``profile_dir`` traces the whole async run; ``ckpt_dir`` makes every
    server persist its center chunk (every ``ckpt_every`` updates and at
    teardown) and writes the final center checkpoint (``kind:
    "ps_center"``); ``resume`` restores the persisted chunks, so a
    restarted job continues from the last center."""
    from mpit_tpu_torch.parallel import AsyncPSTrainer
    from mpit_tpu_torch.utils.checkpoint import save_checkpoint
    from mpit_tpu_torch.utils.profiling import trace

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
        ckpt_dir=cfg.ckpt_dir or None,
        # ckpt_every=0 means no periodic writes: servers persist only at
        # teardown
        ckpt_every=cfg.ckpt_every or None,
        resume=cfg.resume,
        device=device,
    )
    per_client = max(cfg.global_batch // cfg.clients, 1)
    x_dev = torch.as_tensor(x_tr).to(device)
    y_dev = torch.as_tensor(y_tr).to(device)
    t0 = time.perf_counter()
    with trace(cfg.profile_dir, device):
        center, stats = trainer.train(
            x_dev, y_dev, steps=cfg.steps, batch_size=per_client, seed=cfg.seed
        )
    wall = time.perf_counter() - t0
    acc = trainer.evaluate(center, x_te, y_te)
    if cfg.dataset == "ptb":
        acc = acc / cfg.seq_len
    samples = cfg.steps * per_client * cfg.clients
    if cfg.log_every:
        # stop before the final step — the summary line below logs it
        for s in range(cfg.log_every - 1, cfg.steps - 1, cfg.log_every):
            step_losses = [l[s] for l in stats["losses"] if len(l) > s]
            if step_losses:
                log.log(s + 1, loss=float(np.mean(step_losses)))
    log.log(cfg.steps, loss=stats["mean_final_loss"], accuracy=acc)
    if cfg.ckpt_dir:
        save_checkpoint(
            cfg.ckpt_dir, center, step=cfg.steps,
            metadata={"config": cfg.to_json(), "kind": "ps_center"},
        )
        results["last_checkpoint"] = cfg.steps
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


def main(argv=None, device=None, description: Optional[str] = None) -> None:
    """CLI over the presets the port runs (installed as ``mpit-torch-train``;
    ``mpit_tpu_torch/examples/train.py`` is the same entry run from a
    checkout, passing its ``--device`` and its usage docstring as
    ``description``); runs on ``device`` (default: the card) and prints the
    results dict as one JSON line."""
    cfg = TrainConfig.from_args(
        argv,
        description=description or "mpit_tpu_torch training on one CUDA card (e.g. "
        "--preset mnist-easgd --epochs 1, --preset cifar-vgg-sync, --preset "
        "resnet50-sync, --preset ptb-lstm-easgd, --preset alexnet-downpour, "
        "--preset ptb-transformer-large (--sp 4, --seq-impl ulysses, "
        "--remat), --preset ptb-transformer-large --algo sync|zero-sync "
        "--attn-impl flash, --algo moe-sync --moe-experts 8, --preset "
        "ptb-transformer-pp --pp-schedule 1f1b, or --preset mnist-ps)",
    )
    print(json.dumps(run(cfg, device=device), default=repr))


if __name__ == "__main__":
    main()
