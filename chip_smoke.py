#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mpit_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order, one line each; nothing is caught, so any failure exits
non-zero before the result lines:

1. card    — name and power limit from ``nvidia-smi``.
2. build   — compile every CUDA kernel of the port from ``mpit_tpu_torch/ops/csrc``
             (one ``nvcc`` per source, all started together).
3. kernels — each kernel against its plain PyTorch version on the card, at
             the reference's test shapes and at the shapes the main path gives
             it, with TF32 off; timed with CUDA events beside its bound, the
             plain version and one PyTorch library call of the same function.
4. round   — one EASGD round of an f32 LeNet, W = 8, on the card (kernel)
             against the same round on the CPU (plain version).
5. main    — ``run()`` with the ``mnist-easgd`` preset for one epoch, W = 8
             workers stacked on the card, bf16 LeNet; the kernels' launch
             counts are set to 0 just before and read just after.
6. profile — ``torch.profiler`` over a few of the same rounds: the card's
             busy share and the kernels that take the most time.

Then a JSON line ``{"kernels": [...]}`` and, last, the device line
``{"ok": true, "device": {...}}``. Without CUDA it exits 2 and prints no
result. It needs the repository beside it: alone it fails at the import.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM, f32 outside the tensor cores
TOL = 1e-6                 # FMA contraction moves the last bit
WORKERS = 8


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    phase("card", out)
    return out


def build() -> None:
    from mpit_tpu_torch.ops import _build

    t0 = time.perf_counter()
    outputs = _build.build_all()
    for name, out in outputs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                phase("build", f"{name}: {line.strip()}")
    phase("build", f"{len(outputs)} source(s) compiled in "
          f"{time.perf_counter() - t0:.2f} s (set-up)")


def time_ms(fn, reps: int = 50, trials: int = 7) -> float:
    """Median over trials of the mean time of ``reps`` back-to-back calls,
    by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call: the card's kernel time under ``torch.profiler``
    summed over ``reps`` calls, divided by ``reps``. Unlike :func:`time_ms`
    it leaves out the host's launch overhead between small kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def elastic_bytes(w: int, n: int) -> int:
    return 4 * (2 * w * n + 3 * n)  # read x, c, d; write new_x, new_c


def elastic_bound_ms(w: int, n: int) -> float:
    by_bytes = elastic_bytes(w, n) / HBM_BYTES_PER_S
    by_ops = (3 * w * n + 2 * n) / F32_FLOPS_PER_S
    return 1e3 * max(by_bytes, by_ops)


def lenet_leaf_shapes() -> list[tuple[str, tuple]]:
    """(name, shape) of each LeNet parameter leaf, in leaf order: the
    shapes of the main path's elastic launches, one per leaf."""
    from mpit_tpu_torch.models import LeNet

    params = LeNet(device="cuda").init(torch.Generator().manual_seed(0))
    return [(f"{layer}.{k}", tuple(params[layer][k].shape))
            for layer in sorted(params) for k in sorted(params[layer])]


def kernels_vs_plain() -> dict:
    from mpit_tpu_torch.ops import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("kernels", "TF32 off for matmuls and convolutions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    alpha = 0.9 / WORKERS

    def inputs(w, shape):
        xs = (w, *shape) if w > 1 else shape
        return (torch.randn(xs, generator=gen, device="cuda"),
                torch.randn(shape, generator=gen, device="cuda"),
                torch.randn(shape, generator=gen, device="cuda"))

    max_err = 0.0
    cases = [(s, w) for s in [(7,), (65536,), (65549,), (3, 50, 11)] for w in (1, 8)]
    leaves = lenet_leaf_shapes()
    cases += [(s, WORKERS) for _, s in leaves]
    for shape, w in cases:
        x, c, d = inputs(w, shape)
        kx, kc = elastic.elastic_update(x, c, d, alpha, use_kernel=True)
        torch.cuda.synchronize()
        px, pc = elastic.elastic_update_plain(x, c, d, alpha)
        torch.testing.assert_close(kx, px, rtol=TOL, atol=TOL)
        torch.testing.assert_close(kc, pc, rtol=TOL, atol=TOL)
        max_err = max(max_err, (kx - px).abs().max().item(),
                      (kc - pc).abs().max().item())
    phase("kernels", f"elastic_update: {len(cases)} cases match the plain "
          f"version (rtol=atol={TOL}), max |err| {max_err:.3g}")

    # times at the main path's shapes: one launch per LeNet leaf, W = 8
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
    dev = {}  # the same sums of device time alone (profiler)
    per_round = []
    for name, shape in leaves:
        x, c, d = inputs(WORKERS, shape)
        n = c.numel()
        fns = dict(
            ms=lambda: elastic.elastic_update(x, c, d, alpha, use_kernel=True),
            plain_ms=lambda: elastic.elastic_update_plain(x, c, d, alpha),
            library_ms=lambda: (torch.lerp(x, c, alpha),
                                torch.add(c, d, alpha=alpha)),
        )
        row = dict(leaf=name, n=n, bound_ms=elastic_bound_ms(WORKERS, n))
        for k, fn in fns.items():
            row[k] = time_ms(fn)
            row["device_" + k] = device_ms(fn)
        for k in tot:
            tot[k] += row[k]
            dev[k] = dev.get(k, 0.0) + row.get("device_" + k, 0.0)
        phase("kernels", "elastic_update " + json.dumps(row))
        per_round.append((x, c, d))
    round_ms = time_ms(lambda: [elastic.elastic_update(x, c, d, alpha, use_kernel=True)
                                for x, c, d in per_round])
    phase("kernels", f"elastic_update per round (8 launches back to back): "
          f"{round_ms:.6f} ms; sums over the leaves: " + json.dumps(
              {"events_ms": tot, "device_ms": {k: v for k, v in dev.items()
                                               if k != "bound_ms"}}))
    return dict(
        name="elastic_update", route="cuda",
        source="mpit_tpu_torch/ops/csrc/elastic.cu",
        replaces="mpit_tpu/ops/elastic.py:70",
        max_abs_err=max_err, ms=round_ms, plain_ms=tot["plain_ms"],
        bound_ms=tot["bound_ms"], bound_by="bytes",
        library_ms=tot["library_ms"],
    )


def round_vs_cpu() -> None:
    """One EASGD round of an f32 LeNet on the card (through the kernel)
    against the same round on the CPU (plain version)."""
    import numpy as np

    from mpit_tpu_torch.comm.topology import Topology
    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import EASGDTrainer
    from mpit_tpu_torch.utils.params import tree_leaves, tree_map

    rng = np.random.default_rng(0)
    tau, b = 2, 4
    x = rng.uniform(0, 1, (tau, WORKERS * b, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, (tau, WORKERS * b)).astype(np.int32)
    params = LeNet(compute_dtype=torch.float32, device="cpu").init(
        torch.Generator().manual_seed(0))
    centers = {}
    for dev in ("cuda", "cpu"):
        trainer = EASGDTrainer(
            LeNet(compute_dtype=torch.float32, device=dev), SGD(0.05, 0.9),
            Topology(WORKERS, torch.device(dev)), tau=tau,
        )
        state = trainer.init_state(params=tree_map(torch.clone, params))
        state, m = trainer.step(state, x, y)
        centers[dev] = [t.cpu() for t in tree_leaves(state.center)]
    err = max((a - b).abs().max().item()
              for a, b in zip(centers["cuda"], centers["cpu"]))
    if not err <= 1e-4:
        raise AssertionError(f"card round differs from CPU round by {err}")
    phase("round", f"f32 LeNet EASGD round, card vs CPU: max |center err| {err:.3g}"
          " (tolerance 1e-4)")


def main_path(kernel_ms_per_round: float) -> dict:
    import mpit_tpu_torch
    from mpit_tpu_torch.ops import elastic
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    mpit_tpu_torch.finalize()
    topo = mpit_tpu_torch.init(num_workers=WORKERS)
    cfg = dataclasses.replace(TrainConfig().apply_preset("mnist-easgd"), epochs=1)
    phase("main", f"preset mnist-easgd, 1 epoch, W={topo.num_workers} on "
          f"{topo.device}: lr {cfg.lr}, momentum {cfg.momentum}, tau {cfg.tau}, "
          f"global batch {cfg.global_batch}, train_size {cfg.train_size}")
    warm = run(cfg)  # warm-up: first-call set-up of cuDNN, vmap, allocator
    phase("main", f"warm-up run: {warm['samples_per_sec']:.1f} samples/s")

    elastic.launches = 0
    res = run(cfg)
    launches = elastic.launches

    rounds = res["trained_units"]
    losses = res["round_losses"]
    if launches != rounds * 8:
        raise AssertionError(f"elastic launches {launches} != rounds {rounds} x 8")
    if not all(map(lambda v: v == v and abs(v) != float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    # chance is 0.1; one epoch is early in training, where the accuracy
    # of the center still swings with the init draw (0.55 to 0.94 seen)
    if not res["accuracy"] > 0.3:
        raise AssertionError(f"center accuracy {res['accuracy']} is near chance")
    round_ms = 1e3 * res["wall_s"] / rounds
    phase("main", json.dumps({k: res[k] for k in (
        "accuracy", "final_loss", "round_losses", "trained_units", "samples",
        "wall_s", "samples_per_sec")}))
    phase("main", f"elastic launches {launches} = {rounds} rounds x 8 leaves; "
          f"round {round_ms:.3f} ms, of which the elastic kernel "
          f"{kernel_ms_per_round:.4f} ms ({100 * kernel_ms_per_round / round_ms:.3f}%)")
    return dict(launches=launches)


def profile_rounds(rounds: int = 4) -> None:
    """Where a round's time goes: ``torch.profiler`` over a few EASGD rounds
    built as ``run()`` builds them, after two warm-up rounds. Prints the
    card's busy share of the wall time and the kernels that take most."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mpit_tpu_torch.comm.topology import topology
    from mpit_tpu_torch.data import Batches, load_mnist
    from mpit_tpu_torch.run import build_model, build_optimizer, build_trainer
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig().apply_preset("mnist-easgd")
    topo = topology()
    trainer = build_trainer(cfg, build_model(cfg, topo.device),
                            build_optimizer(cfg), topo)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    x, y, _, _ = load_mnist(synthetic_train=cfg.train_size)
    it = Batches(x, y, global_batch=cfg.global_batch).epoch(0)
    xs, ys = zip(*[next(it) for _ in range(cfg.tau)])
    xr, yr = trainer.round_batches(np.stack(xs), np.stack(ys))
    xr, yr = xr.to(topo.device), yr.to(topo.device)
    for _ in range(2):
        state, _ = trainer._round(state, xr, yr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, m = trainer._round(state, xr, yr)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # device-side events only: an operator's own entry repeats its kernels' time
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        phase("profile", "device busy time: not measured (no device events)")
        return
    phase("profile", f"{rounds} rounds under the profiler: wall {wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), "
          f"idle {100 * (1 - busy_ms / wall_ms):.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        phase("profile", f"  {e.self_device_time_total / 1e3 / rounds:9.4f} ms/round "
              f"{e.count // rounds:4d} calls/round  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import mpit_tpu_torch  # noqa: F401  (fails alone, without the repository)

    card()
    build()
    kernel = kernels_vs_plain()
    round_vs_cpu()
    kernel.update(main_path(kernel["ms"]))
    profile_rounds()
    order = ["name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: kernel[k] for k in order}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
