"""Device time a unit of the paths whose forward products take bf16
operands into a float32 result (``mpit_tpu_torch/ops/products.py``), on
one card: the ``lm`` phase's sync flash LM (the tied head), seq-sync at
(dp, sp) = (8, 1) and (2, 4) with ring attention and at (2, 4) with
Ulysses (the head and the QKᵀ products), and ``ptb-lstm-easgd``'s round
(the LSTM's head under ``vmap`` over W = 8 workers), each at the size
``chip_smoke.py`` runs it::

    python3 product_times.py [ROOT] [--label NAME] [--units N]

It imports the port and ``chip_smoke.py`` from ROOT (default: this file's
directory), so that two checkouts compare in one call: run it once from
each, alternating (parent, change, change, parent). For each
configuration, with TF32 off: the trainer built as ``run()`` builds it,
two warm-up units (the second captured where the trainer captures), then
``N`` units under ``torch.profiler``: device ms a unit (kernel time summed
over streams), the device busy share of the wall, and the ms a unit of the
GEMM kernels (names holding ``gemm``, ``nvjet`` or ``xmma``), split into
those with bf16 inputs and the rest. Prints one JSON line a configuration,
then the card's name and power limit. Needs the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def gemm_kind(name: str) -> str | None:
    """``"bf16"`` or ``"other"`` for a GEMM kernel's name, None for the
    rest: cuBLAS's Hopper kernels name their input type (``bf16``,
    ``tst``/``hsh`` for half types in ``nvjet`` names)."""
    low = name.lower()
    if not any(tag in low for tag in ("gemm", "nvjet", "xmma")):
        return None
    return "bf16" if any(tag in low for tag in ("bf16", "_tst", "_hsh", "_tss")) else "other"


def profile_unit(cs, unit, state, x, y, units: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        state, _ = unit(state, x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(units):
            state, _ = unit(state, x, y)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms, sum_ms = cs.busy_union_ms(prof)
    gemm = {"bf16": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = gemm_kind(e.key)
        if kind:
            gemm[kind] += e.self_device_time_total / 1e3 / units
            top.append((e.self_device_time_total / 1e3 / units, e.key[:80]))
    return dict(device_ms=sum_ms / units, busy_share=busy_ms / wall_ms,
                wall_ms=wall_ms / units, gemm_bf16_ms=gemm["bf16"],
                gemm_other_ms=gemm["other"],
                top_gemms=[[round(ms, 6), k] for ms, k in sorted(top, reverse=True)[:6]])


def lstm_unit(cs, cfg):
    """(round, state, x, y): ``cfg``'s EASGD trainer as ``run()`` builds it
    and random tokens of its round's shape (``chip_smoke.profile_units``'s
    inputs)."""
    import torch

    from mpit_tpu_torch.comm.topology import topology
    from mpit_tpu_torch.run import build_model, build_optimizer, build_trainer

    topo = topology()
    trainer = build_trainer(cfg, build_model(cfg, topo.device), build_optimizer(cfg), topo)
    state = trainer.init_state(torch.Generator().manual_seed(cfg.seed))
    gen = torch.Generator(device="cuda").manual_seed(0)
    lead = (cs.WORKERS, cfg.tau, cfg.global_batch // cs.WORKERS)
    x, y = (torch.randint(0, 10_000, (*lead, cfg.seq_len), generator=gen, device="cuda")
            for _ in range(2))
    return trainer._round, state, x, y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--label", default="")
    ap.add_argument("--units", type=int, default=4)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("product_times: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    import mpit_tpu_torch
    from mpit_tpu_torch.utils.config import TrainConfig

    for mod in (cs, mpit_tpu_torch):
        if not os.path.abspath(mod.__file__).startswith(root + os.sep):
            raise SystemExit(f"product_times: {mod.__file__} is not under {root}")
    card_line = cs.card()
    cs.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq = dataclasses.replace(TrainConfig().apply_preset("ptb-transformer-large"),
                              epochs=1, train_size=cs.LM_TRAIN_WINDOWS)
    configs = [("lm sync flash", cs.lm_config())]
    configs += [(f"seq-sync {name}", dataclasses.replace(seq, **over))
                for name, over in cs.SEQ_RUNS]
    for name, cfg in configs:
        trainer, state, x, y = cs.built_step(cfg)
        row = profile_unit(cs, cs.sync_step(trainer), state, x, y, args.units)
        print(json.dumps({"tree": args.label, "config": name, **row}), flush=True)
        del trainer, state, x, y
    lstm = TrainConfig().apply_preset("ptb-lstm-easgd")
    row = profile_unit(cs, *lstm_unit(cs, lstm), args.units)
    print(json.dumps({"tree": args.label, "config": "ptb-lstm-easgd round", **row}),
          flush=True)
    print(card_line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
