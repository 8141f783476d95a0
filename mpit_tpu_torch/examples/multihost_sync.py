"""Multi-process training over a ``torch.distributed`` world — the port's
counterpart of ``examples/multihost_sync.py``.

    python -m mpit_tpu_torch.launch -n 2 --jax-distributed \
        mpit_tpu_torch/examples/multihost_sync.py --local-devices 2 --device cpu

Each rank joins the process group the launcher wires (gloo between CPU
processes, NCCL between cards: one card per rank), stacks its
``--local-devices`` workers, and the trainers' collectives (the sync
step's gradient mean or its bucketed exchange under ``MPIT_DP_QUANT``,
ZeRO's reduce-scatter and all-gather, EASGD's diff sum, Downpour's update
mean) reduce the local workers first, then cross the processes. ``--algo
zero`` runs ZeRO-1 with Adam: each rank holds its workers' share of the
optimizer state. The world has
``--local-devices`` × N workers, as the reference's mesh spans its
processes. ``--algo moe`` trains a small MoE LM (8 experts, top-2, the
balance and z losses on) by expert parallelism: each rank holds its
workers' experts, and the tokens cross the processes by
``all_to_all_single`` both ways (the backward's too); ``--out`` then also
carries every step's loss. Every rank feeds the same global batch stream and takes its
own workers' rows. With ``--ckpt-dir`` the run ends with a checkpoint that
every rank gathers, rank 0 writes and every rank restores (under ``--algo
moe`` the file holds all the experts and their momentum traces, and each
rank restores its own); ``--out``
writes ``<out>.rank<i>.json`` with the reference's keys; the round
trip is bit-exact when every leaf of the restored state (params and
optimizer state, gathered) equals the trained one's.
"""

import argparse
import json
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--algo", choices=("sync", "zero", "easgd", "downpour", "moe"),
                    default="sync")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--local-devices", type=int, default=1,
                    help="workers stacked in each rank (the stacked W)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default; NCCL, one card per rank)")
    ap.add_argument("--out", default="",
                    help="write final metrics JSON to <out>.rank<i>.json")
    ap.add_argument("--ckpt-dir", default="",
                    help="save + restore a checkpoint at the end (rank 0 "
                         "writes what every rank gathers; every rank restores)")
    ns = ap.parse_args()

    import numpy as np
    import torch

    import mpit_tpu_torch
    from mpit_tpu_torch.data import load_mnist
    from mpit_tpu_torch.models import MLP, TransformerLM
    from mpit_tpu_torch.optim import SGD, Adam
    from mpit_tpu_torch.parallel import (
        DataParallelTrainer, DownpourTrainer, EASGDTrainer, MoEParallelTrainer,
        ZeroDataParallelTrainer,
    )

    topo = mpit_tpu_torch.init(num_workers=ns.local_devices, device=ns.device)
    w = topo.num_workers
    print(
        f"[rank {topo.process_index}/{topo.process_count}] "
        f"local={topo.local_workers} global_workers={w} device={topo.device}",
        flush=True,
    )

    # every process feeds the SAME global batch stream (deterministic
    # seeds) and takes its own workers' rows of it
    x, y, *_ = load_mnist(synthetic_train=2048)
    model = MLP(hidden=(64,), compute_dtype=torch.float32, device=topo.device)
    if ns.algo == "sync":
        trainer = DataParallelTrainer(model, SGD(0.2), topo)
    elif ns.algo == "zero":
        trainer = ZeroDataParallelTrainer(model, Adam(1e-3), topo)
    elif ns.algo == "moe":
        # a small MoE LM on random tokens: vocab 31, T = 16
        x = np.random.default_rng(0).integers(0, 31, (2048, 16)).astype(np.int32)
        y = np.roll(x, -1, axis=1).astype(np.int32)
        model = TransformerLM(31, num_layers=2, d_model=32, num_heads=4, max_len=16,
                              compute_dtype=torch.float32, moe_experts=8, moe_axis="dp",
                              moe_top_k=2, moe_capacity_factor=1.5,
                              moe_balance_weight=0.1, moe_zloss_weight=0.01,
                              device=topo.device)
        trainer = MoEParallelTrainer(model, SGD(0.2, momentum=0.9), topo)
    elif ns.algo == "easgd":
        trainer = EASGDTrainer(model, SGD(0.2, momentum=0.9), topo, tau=4)
    else:
        trainer = DownpourTrainer(model, SGD(0.2), topo, tau=4)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    gb = (2 if ns.algo == "moe" else 16) * w
    tau = getattr(trainer, "tau", 1)
    first = last = None
    losses = []
    for step in range(ns.steps):
        idx = np.random.default_rng(step).integers(0, len(x), tau * gb)
        if ns.algo in ("sync", "zero", "moe"):
            state, m = trainer.step(state, x[idx], y[idx])
        else:  # one whole τ-round per step
            state, m = trainer.step(
                state,
                x[idx].reshape(tau, gb, *x.shape[1:]),
                y[idx].reshape(tau, gb),
            )
        loss = float(m["loss"])
        losses.append(loss)
        if first is None:
            first = loss
        last = loss
    print(f"[rank {topo.process_index}] loss {first:.4f} -> {last:.4f}", flush=True)
    ckpt_roundtrip = None
    if ns.ckpt_dir:
        from mpit_tpu_torch.utils.checkpoint import (
            restore_checkpoint, save_checkpoint, state_to_host,
        )
        from mpit_tpu_torch.utils.params import tree_leaves

        # the gather of the stacked workers (and of ZeRO's optimizer
        # shares) runs on EVERY process; only process 0 writes
        save_checkpoint(ns.ckpt_dir, state, step=ns.steps)
        restored, step = restore_checkpoint(ns.ckpt_dir, state)
        assert step == ns.steps
        # the whole state as the checkpoint holds it (collective: gathers)
        want, got = (tree_leaves(state_to_host(s)) for s in (state, restored))
        ckpt_roundtrip = all(np.array_equal(a, b) for a, b in zip(want, got, strict=True))
        print(f"[rank {topo.process_index}] checkpoint roundtrip "
              f"bit-exact={ckpt_roundtrip}", flush=True)
    if ns.out:
        with open(f"{ns.out}.rank{topo.process_index}.json", "w") as f:
            json.dump(
                {
                    "rank": topo.process_index,
                    "process_count": topo.process_count,
                    "num_workers": w,
                    "first_loss": first,
                    "last_loss": last,
                    "ckpt_roundtrip": ckpt_roundtrip,
                    "losses": losses,
                },
                f,
            )
    mpit_tpu_torch.finalize()


if __name__ == "__main__":
    main()
