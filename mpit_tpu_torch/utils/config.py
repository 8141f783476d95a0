"""Run configuration: one dataclass + argparse, nothing heavier.

A copy of ``mpit_tpu/utils/config.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_data.py`` holds the two equal. The port's
``run`` drives every algo named below (the EASGD, Downpour, sync, ZeRO,
sequence, MoE and pipeline trainers and the parameter-server ``ps-*``
algos) and every preset; an unknown algo, optimizer or exchange dtype
raises ``ValueError`` (``_check_supported`` in ``mpit_tpu_torch/run.py``).

Reference parity (SURVEY.md §5): the reference's config system was a plain
Lua ``conf``/``opt`` table in ``ptest.lua`` (lr, τ, α, #servers, batch size).
Match that simplicity: a flat dataclass whose fields are the union of what
the five baseline configs need, an argparse bridge generated from the fields,
and JSON (de)serialization for reproducibility (the config is stamped into
checkpoints/metrics).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # what to run
    preset: Optional[str] = None  # one of PRESETS, or None for flag-driven
    model: str = "lenet"
    dataset: str = "mnist"
    # easgd | eamsgd | downpour | sync | zero-sync | seq-sync | moe-sync |
    # pp-sync | ps-easgd | ps-eamsgd | ps-downpour (zero-sync = sync DP
    # with ZeRO-1 sharded optimizer state; eamsgd = EASGD with momentum in
    # the local optimizer, the paper's momentum variant — the alias
    # asserts momentum > 0; seq-sync = sync DP over a 2-D dp x sp mesh
    # with sequence-parallel ring attention; moe-sync = sync DP with the
    # transformer's MoE experts sharded over the worker axis; pp-sync =
    # pipeline parallelism over a dp x pp mesh, --pp-schedule
    # gpipe|1f1b|interleaved — all three transformer only)
    algo: str = "easgd"
    # optimization (reference conf table: lr, τ, α — SURVEY.md §5).
    # optimizer: sgd (the reference's; momentum applies) | adam | adamw
    # (weight_decay applies). lr_schedule: constant | cosine |
    # warmup-cosine (peak cfg.lr after warmup_steps, cosine to 0 over the
    # run's optimizer-update count). All elementwise — every trainer
    # (incl. ZeRO/MoE with their cross-leaf guards) accepts them.
    optimizer: str = "sgd"
    lr: float = 0.05
    momentum: float = 0.9
    # global-norm gradient clipping (None = off). Algos whose update runs
    # on consistent gradients get optax.clip_by_global_norm chained in;
    # moe-sync/zero-sync/pp-sync (device-varying grads inside shard_map,
    # where the chain would silently desync replicas) get the trainer's
    # mesh-correct clip_norm instead — same math, proven equal in tests
    clip_norm: Optional[float] = None
    lr_schedule: str = "constant"
    warmup_steps: int = 100
    weight_decay: float = 1e-4
    tau: int = 4
    alpha: Optional[float] = None  # None -> 0.9/W (EASGD paper rule)
    staleness: int = 0
    # exchange-collective compression for easgd/eamsgd: "none" (exact) or
    # "bf16" (halves ICI/DCN bytes per round; goptim.summed_client_diffs)
    exchange_dtype: str = "none"
    # input staging dtype: "float32" or "bf16" (halves host->device bytes
    # and first-layer HBM reads; models compute in bf16 anyway, so this
    # just moves their entry cast to the host — data.cast_input_dtype)
    input_dtype: str = "float32"
    # scale
    global_batch: int = 256
    epochs: int = 3
    train_size: int = 8192
    clients: int = 2  # ps-* algos
    servers: int = 1
    steps: int = 200  # ps-* algos: local steps per client
    transport: str = "auto"  # ps-* message plane: auto | native | inproc | socket
    client_timeout: Optional[float] = None  # ps-* watchdog (None = hang,
    # matching the reference's dead-rank semantics)
    # stem for models with an MXU-hostile 3-channel first conv (resnet50,
    # alexnet): "conv" (textbook) or "space_to_depth" (same function,
    # MXU-friendlier input layout — mpit_tpu/ops/stem.py)
    stem: str = "conv"
    # rematerialize blocks on backward (resnet50, transformer): trades
    # ~1/3 extra FLOPs for O(1)-block activation memory — bigger batches
    # or longer sequences per chip (jax.checkpoint via flax nn.remat)
    remat: bool = False
    # sequence models
    seq_len: int = 32
    # seq-sync only: sequence-parallel extent (devices per ring; the mesh is
    # (num_devices // sp) x sp — batch axis "dp", sequence axis "sp") and
    # the scheme: "ring" (ppermute K/V rotation — extreme T) or "ulysses"
    # (all_to_all head<->sequence re-shard — moderate T, heads % sp == 0)
    sp: int = 1
    seq_impl: str = "ring"
    # pp-sync only: pipeline extent (stages; mesh (num_devices // pp) x pp),
    # microbatches per step, the schedule (gpipe | 1f1b | interleaved),
    # and virtual chunks per stage (interleaved only; layers must divide
    # by pp x pp-virtual)
    pp: int = 2
    n_micro: int = 4
    pp_schedule: str = "gpipe"
    pp_virtual: int = 2
    # transformer depth (pp-sync needs layers % pp == 0)
    layers: int = 2
    # transformer width: model dim, attention heads, FFN dim (0 -> 4x
    # d_model) — the knobs that set MXU fill; the tiny defaults match the
    # CPU-mesh tests, the ptb-transformer-large preset sets a
    # realistically-sized model (GPT-2-small shape)
    d_model: int = 128
    heads: int = 4
    d_ff: int = 0
    # sync/zero-sync: gradient accumulation — per-worker batch processed as
    # this many sequential slices, one optimizer update (exact math; no
    # model here has batch statistics). Memory knob for big batches.
    grad_accum: int = 1
    # transformer dense-attention implementation: "xla" (fused dense) or
    # "flash" (pallas tiled kernel on TPU; dense elsewhere) — the kernel
    # stays opt-in until its TPU measurement lands (ops/flash_attention)
    attn_impl: str = "xla"
    # moe-sync only: expert count (sharded over the worker axis; must be
    # divisible by it) and the GShard capacity factor
    moe_experts: int = 0
    moe_capacity_factor: float = 2.0
    # routing fidelity: top-k expert choice (1 = Switch, 2 = GShard),
    # auxiliary load-balance loss weight (GShard uses ~1e-2) and router
    # z-loss weight (ST-MoE uses ~1e-3); 0.0 = off
    moe_top_k: int = 1
    moe_balance_weight: float = 0.0
    moe_zloss_weight: float = 0.0
    # image models (ImageNet-shaped configs; smaller for CPU-mesh smoke runs)
    image_size: int = 224
    # plumbing
    seed: int = 0
    log_every: int = 0
    metrics_path: Optional[str] = None
    # input-pipeline depth: batches staged on device ahead of the running
    # step (async device_put overlaps transfer with compute); 0 = stage
    # synchronously — large-input configs (high tau x batch x resolution)
    # may need 0, since each staged group holds its full HBM footprint
    prefetch: int = 2
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0  # rounds/steps between checkpoints (0 = off)
    resume: bool = False
    profile_dir: Optional[str] = None

    def resolved_algo(self) -> str:
        """``algo`` with the eamsgd alias resolved to its protocol.

        EAMSGD is EASGD with momentum in the local optimizer (the paper's
        momentum variant; goptim.py module docstring) — same exchange
        protocol, so everything downstream dispatches on the resolved
        name. The alias's one job is asserting the momentum is actually
        on. The ONE place this rule lives; every algo consumer (run(),
        the PS path, the process examples) resolves through here.
        """
        if self.algo in ("eamsgd", "ps-eamsgd"):
            if self.momentum <= 0:
                raise ValueError(
                    f"algo={self.algo!r} requires momentum > 0 (EAMSGD is "
                    "EASGD with a momentum local optimizer); set "
                    "--momentum or use "
                    f"algo={self.algo.replace('eamsgd', 'easgd')!r}"
                )
            return self.algo.replace("eamsgd", "easgd")
        return self.algo

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "TrainConfig":
        return cls(**json.loads(s))

    @classmethod
    def parser(cls, description: str = "") -> argparse.ArgumentParser:
        """Argparse bridge: one ``--flag`` per field (underscores → dashes).

        Every flag defaults to ``argparse.SUPPRESS``, so the parsed namespace
        contains exactly the flags the user typed — "passed the default
        value" and "not passed" stay distinguishable for preset overlay."""
        p = argparse.ArgumentParser(description=description)
        for f in dataclasses.fields(cls):
            flag = "--" + f.name.replace("_", "-")
            if f.type == "bool" or isinstance(f.default, bool):
                p.add_argument(
                    flag, action="store_true", default=argparse.SUPPRESS
                )
            else:
                typ = {
                    "int": int, "float": float, "str": str,
                    "Optional[int]": int, "Optional[float]": float,
                    "Optional[str]": str,
                }.get(str(f.type), str)
                p.add_argument(flag, type=typ, default=argparse.SUPPRESS)
        return p

    @classmethod
    def from_args(cls, argv=None, description: str = "") -> "TrainConfig":
        """defaults < preset < explicitly-typed flags."""
        supplied = vars(cls.parser(description).parse_args(argv))
        cfg = cls()
        if "preset" in supplied:
            cfg = cfg.apply_preset(supplied["preset"])
        return dataclasses.replace(cfg, **supplied)

    def apply_preset(self, name: str):
        """Overlay a named baseline config on this config."""
        if name not in PRESETS:
            raise ValueError(
                f"unknown preset {name!r}; have {sorted(PRESETS)}"
            )
        return dataclasses.replace(self, preset=name, **PRESETS[name])


# The five baseline workload configs (BASELINE.md table; BASELINE.json
# lines 7-11). Scales are trimmed-down by default so every preset runs on the
# CPU-simulated mesh; pass bigger --train-size/--epochs on real hardware.
PRESETS: dict[str, dict] = {
    # 1: MNIST LeNet async-SGD — the reference's bundled ptest example
    "mnist-easgd": dict(
        model="lenet", dataset="mnist", algo="easgd",
        lr=0.05, momentum=0.9, tau=4, global_batch=256, epochs=3,
    ),
    # the literal 2-pclient + 1-pserver shape of the reference example
    "mnist-ps": dict(
        model="lenet", dataset="mnist", algo="ps-easgd",
        clients=2, servers=1, steps=200, tau=4, lr=0.05,
    ),
    # 2: CIFAR-10 VGG-small, sync allreduce DP, 8 workers
    "cifar-vgg-sync": dict(
        model="vgg", dataset="cifar10", algo="sync",
        lr=0.02, momentum=0.9, global_batch=256, epochs=3,
    ),
    # 3: ImageNet AlexNet, Downpour model-averaging
    "alexnet-downpour": dict(
        model="alexnet", dataset="imagenet", algo="downpour",
        lr=0.01, momentum=0.9, tau=4, staleness=1,
        global_batch=128, epochs=1, train_size=1024,
    ),
    # 4: ImageNet ResNet-50, sync allreduce (large-tensor collective stress)
    "resnet50-sync": dict(
        model="resnet50", dataset="imagenet", algo="sync",
        lr=0.1, momentum=0.9, global_batch=64, epochs=1, train_size=512,
    ),
    # 5: PTB LSTM EASGD (small frequent async updates, non-vision)
    "ptb-lstm-easgd": dict(
        model="lstm", dataset="ptb", algo="easgd",
        lr=1.0, momentum=0.0, tau=4, global_batch=128, epochs=1,
        seq_len=32,
    ),
    # beyond-parity: long-context transformer LM, sequence-parallel sync DP
    # over a dp x sp mesh (ring attention; --sp picks the ring width)
    "ptb-transformer-seq": dict(
        model="transformer", dataset="ptb", algo="seq-sync",
        lr=0.001, momentum=0.9, global_batch=32, epochs=1,
        seq_len=256, sp=1,
    ),
    # beyond-parity pipeline config: transformer over a dp x pp mesh
    # (pp=1 on one chip — staging/microbatching still exercised; the
    # multi-stage path is proven on the CPU mesh and in the dryrun)
    "ptb-transformer-pp": dict(
        model="transformer", dataset="ptb", algo="pp-sync",
        lr=0.001, momentum=0.9, global_batch=32, epochs=1,
        seq_len=256, pp=1, n_micro=4, layers=2,
    ),
    # beyond-parity MFU-ceiling config: a GPT-2-small-shaped LM whose
    # matmul dims (768/3072, T=512) actually fill the 128x128 MXU — the
    # tiny parity presets' low MFU is their 2015-era shapes, not the
    # framework; this preset is the evidence
    "ptb-transformer-large": dict(
        model="transformer", dataset="ptb", algo="seq-sync",
        optimizer="adamw", lr=3e-4, lr_schedule="warmup-cosine",
        global_batch=8, epochs=1, seq_len=512, sp=1,
        layers=6, d_model=768, heads=12,
    ),
}
