"""The transformer's inner mesh axes across the processes of a
``torch.distributed`` world: the sequence ring (ring and Ulysses), tensor
parallelism, composed ``(dp, tp, sp)`` training and the pipeline, and
``run()`` of seq-sync, moe-sync and pp-sync, each as one leg of one launch.

    python -m mpit_tpu_torch.launch -n 2 --jax-distributed \\
        mpit_tpu_torch/examples/multihost_lm.py --device cpu \\
        --leg seq-ring:1,2 --leg seq-ulysses:2,2 --leg tp:1,2 --leg composed:1,2,2 \\
        --leg pp-gpipe:1,2 --leg pp-1f1b:1,2 --leg pp-interleaved:1,2 \\
        --leg run-seq-ring:2 --leg run-moe:4 --leg run-pp:2 \\
        --out /tmp/lm --ckpt-dir /tmp/lm-ck

A trainer leg ``seq-ring|seq-ulysses|tp|composed:<mesh>`` builds the
trainer over that mesh (``(dp, sp)``, ``(dp, tp)`` or ``(dp, tp, sp)``;
its worker count split evenly over the processes, so an inner axis spans
processes where a process holds less than one inner group) on an f32
``TransformerLM`` initialized from ``--seed``, and trains ``--steps`` SGD
steps (lr 0.1, momentum 0.9) on one seeded ``(--batch, --seq-len)`` batch
of tokens (``--remat``: each block recomputed on the backward, its hops
with it). A pipeline leg ``pp-gpipe|pp-1f1b|pp-interleaved:<dp>,<pp>``
builds ``PipelineParallelTrainer`` (f32, dense attention; 2 microbatches,
interleaved with 2 virtual chunks a stage and its depth rounded up to a
multiple of ``2·pp``) over the ``(dp, pp)`` mesh and trains the same SGD
steps, saving a checkpoint after each; ``pp-clip`` is ``pp-1f1b`` with
``clip_norm`` :data:`PP_CLIP`, low enough to bind. A ``run-*`` leg calls
``run()`` of ``ptb-transformer-large`` (AdamW) narrowed by the same flags:
``run-seq-ring:<sp>`` and ``run-seq-ulysses:<sp>`` under ``--algo
seq-sync`` (bf16), ``run-moe:<experts>`` under ``--algo moe-sync`` (bf16),
``run-pp:<pp>`` under ``--algo pp-sync`` (f32, 1f1b, 2 microbatches,
``clip_norm`` 1), over the world's workers (``--local-devices`` in each
process).

Every process writes ``<out>.rank<i>.json``: for each leg its losses, its
evaluation on the batch before and after training, whether the checkpoint
round trip was bit-exact (every process gathers, process 0 writes under
``<ckpt-dir>/<leg>``, every process restores and compares the state it
gets, gathered, with the file) and its wall seconds, under the leg's key
(``seq-ring:1,2`` is ``seq-ring@1x2``); a trainer leg also writes this
process's logits of its share of the batch at the initial params to
``<out>.<key>.rank<i>.npy`` and a step-0 checkpoint beside the last (a
pipeline leg: the leading dims of its ``blocks`` leaves, of the params
and the momentum, as ``block_rows``, and no logits). Run
the same legs in one process (``--local-devices`` = the world's workers,
no ``--jax-distributed``) for the same world on one process; with
``--resave-from <the world's ckpt-dir>`` that process also restores each
leg's last checkpoint of the world into its own state and saves it again,
and reports whether the file it writes is the world's, byte for byte
(``resaved_bytes_equal``).
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)

AXES = {"seq": ("dp", "sp"), "tp": ("dp", "tp"), "composed": ("dp", "tp", "sp"),
        "pp": ("dp", "pp")}
# the pp-clip leg's clip_norm: below the gradient norm of the first steps
PP_CLIP = 0.05


def _parse_leg(text: str):
    name, _, arg = text.partition(":")
    return name, tuple(int(a) for a in arg.split(",")) if arg else ()


def leg_key(text: str) -> str:
    """A leg's name in files and in the results: ``seq-ring:1,2`` ->
    ``seq-ring@1x2``."""
    return text.replace(":", "@").replace(",", "x")


def _roundtrip(directory: str, state, template) -> bool:
    """Save ``state`` (collective), restore it into ``template`` and hold
    the restored state, gathered, against the file, leaf for leaf."""
    import numpy as np

    from mpit_tpu_torch.utils.checkpoint import (
        _ckpt_path, latest_checkpoint, msgpack_restore, restore_checkpoint,
        save_checkpoint, state_to_host,
    )
    from mpit_tpu_torch.utils.params import tree_leaves

    if state is not None:
        step = state["step"] if isinstance(state, dict) else state.step
        save_checkpoint(directory, state, step=step)
    step = latest_checkpoint(directory)
    restored, _ = restore_checkpoint(directory, template)
    with open(_ckpt_path(directory, step), "rb") as f:
        want = tree_leaves(msgpack_restore(f.read()))
    got = tree_leaves(state_to_host(restored))
    return len(want) == len(got) and all(
        np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(want, got))


def _resaved(source: str, template, directory: str) -> bool:
    """Restore ``source``'s last checkpoint into ``template`` and save it
    under ``directory``: whether the two files hold the same bytes."""
    from mpit_tpu_torch.utils.checkpoint import (
        _ckpt_path, restore_checkpoint, save_checkpoint,
    )

    state, step = restore_checkpoint(source, template)
    with open(save_checkpoint(directory, state, step=step), "rb") as a, \
            open(_ckpt_path(source, step), "rb") as b:
        return a.read() == b.read()


def _check_ckpt(ns, key: str, ck: str, state, template, res: dict) -> None:
    """The leg's checkpoint checks (see the module docstring) into ``res``."""
    res["ckpt_roundtrip"] = _roundtrip(ck, state, template)
    if ns.resave_from:
        res["resaved_bytes_equal"] = _resaved(os.path.join(ns.resave_from, key),
                                              template, ck + "-resaved")


def trainer_leg(ns, name: str, mesh: tuple, topo, key: str) -> dict:
    """One trainer leg over ``mesh`` (see the module docstring)."""
    import numpy as np
    import torch

    from mpit_tpu_torch import optim
    from mpit_tpu_torch.models import TransformerLM
    from mpit_tpu_torch.parallel import (
        ComposedParallelTrainer, SeqParallelTrainer, TensorParallelTrainer,
    )
    from mpit_tpu_torch.utils.checkpoint import save_checkpoint

    kind, _, impl = name.partition("-")
    world = dataclasses.replace(topo, num_workers=int(np.prod(mesh)),
                                axis_names=AXES[kind], mesh_shape=mesh)
    model = TransformerLM(ns.vocab, num_layers=ns.layers, d_model=ns.d_model,
                          num_heads=ns.heads, max_len=ns.seq_len,
                          compute_dtype=torch.float32, device=topo.device,
                          seq_axis=None if kind == "tp" else "sp",
                          seq_impl=impl or "ring", remat=ns.remat)
    cls = {"seq": SeqParallelTrainer, "tp": TensorParallelTrainer,
           "composed": ComposedParallelTrainer}[kind]
    trainer = cls(model, optim.SGD(0.1, momentum=0.9), world)
    state = trainer.init_state(torch.Generator().manual_seed(ns.seed))
    rng = np.random.default_rng(ns.seed)
    x = rng.integers(0, ns.vocab, (ns.batch, ns.seq_len)).astype(np.int64)
    y = np.roll(x, -1, axis=1)
    xs, _ = trainer._shard(x, y)
    with torch.no_grad():
        logits = trainer.model.apply(state.params, torch.as_tensor(xs).to(topo.device))
    np.save(f"{ns.out}.{key}.rank{topo.process_index}.npy", logits.float().cpu().numpy())
    ck = os.path.join(ns.ckpt_dir, key) if ns.ckpt_dir else ""
    if ck:
        save_checkpoint(ck, state, step=0, keep=2)
    eval0 = trainer.evaluate(state, x, y)
    losses = []
    for _ in range(ns.steps):
        state, m = trainer.step(state, x, y)
        losses.append(float(m["loss"]))
    res = {"losses": losses, "eval0": list(eval0),
           "eval": list(trainer.evaluate(state, x, y)), "mesh": list(mesh)}
    if ck:
        template = trainer.init_state(torch.Generator().manual_seed(ns.seed + 1))
        _check_ckpt(ns, key, ck, state, template, res)
    return res


def pipeline_leg(ns, name: str, mesh: tuple, topo, key: str) -> dict:
    """One pipeline leg over the ``(dp, pp)`` mesh (see the module
    docstring)."""
    import numpy as np
    import torch

    from mpit_tpu_torch.parallel.pipeline import PipelineParallelTrainer
    from mpit_tpu_torch.utils.checkpoint import save_checkpoint
    from mpit_tpu_torch.utils.params import tree_leaves

    schedule = name.removeprefix("pp-").replace("clip", "1f1b")
    world = dataclasses.replace(topo, num_workers=int(np.prod(mesh)),
                                axis_names=AXES["pp"], mesh_shape=mesh)
    chunks = mesh[1] * (2 if schedule == "interleaved" else 1)
    layers = -(-ns.layers // chunks) * chunks
    trainer = PipelineParallelTrainer(
        ns.vocab, layers, ns.d_model, ns.heads, ns.seq_len, topo=world, n_micro=2,
        lr=0.1, momentum=0.9, schedule=schedule, virtual=2,
        clip_norm=PP_CLIP if name == "pp-clip" else None)
    state = trainer.init_state(torch.Generator().manual_seed(ns.seed))
    rng = np.random.default_rng(ns.seed)
    x = rng.integers(0, ns.vocab, (ns.batch, ns.seq_len)).astype(np.int64)
    y = np.roll(x, -1, axis=1)
    ck = os.path.join(ns.ckpt_dir, key) if ns.ckpt_dir else ""
    if ck:
        save_checkpoint(ck, state, step=0)
    eval0 = trainer.evaluate(state, x, y)
    losses = []
    for _ in range(ns.steps):
        state, m = trainer.step(state, x, y)
        losses.append(float(m["loss"]))
        if ck and state["step"] < ns.steps:
            save_checkpoint(ck, state, step=state["step"])
    res = {"losses": losses, "eval0": list(eval0),
           "eval": list(trainer.evaluate(state, x, y)), "mesh": list(mesh),
           "layers": layers,
           "block_rows": sorted({int(a.shape[0]) for part in ("params", "momentum")
                                 for a in tree_leaves(state[part]["blocks"])})}
    if ck:
        template = trainer.init_state(torch.Generator().manual_seed(ns.seed + 1))
        _check_ckpt(ns, key, ck, state, template, res)
    return res


def run_leg(ns, name: str, arg: tuple, key: str) -> dict:
    """One ``run()`` leg (see the module docstring)."""
    import torch

    from mpit_tpu_torch.comm.topology import topology
    from mpit_tpu_torch.run import (
        _load_dataset, _world_for, build_model, build_optimizer, build_trainer, run,
    )
    from mpit_tpu_torch.utils.config import TrainConfig

    kind = name.removeprefix("run-")
    over = (dict(algo="moe-sync", moe_experts=arg[0]) if kind == "moe" else
            dict(algo="pp-sync", pp=arg[0], n_micro=2, pp_schedule="1f1b", clip_norm=1.0)
            if kind == "pp" else
            dict(algo="seq-sync", sp=arg[0], seq_impl=kind.removeprefix("seq-")))
    ck = os.path.join(ns.ckpt_dir, key) if ns.ckpt_dir else ""
    cfg = dataclasses.replace(
        TrainConfig().apply_preset("ptb-transformer-large"), layers=ns.layers,
        d_model=ns.d_model, heads=ns.heads, seq_len=ns.seq_len, global_batch=ns.batch,
        train_size=ns.batch * ns.steps, epochs=1, seed=ns.seed, ckpt_dir=ck,
        remat=ns.remat, **over)
    r = run(cfg)
    res = {k: r[k] for k in ("workers", "round_losses", "final_loss", "eval_loss",
                             "accuracy", "trained_units")}
    if ck:
        topo = _world_for(cfg, topology())
        *_, meta = _load_dataset(cfg)
        model = build_model(cfg, topo.device, meta)
        trainer = build_trainer(cfg, model, build_optimizer(cfg), topo)
        template = trainer.init_state(torch.Generator().manual_seed(ns.seed + 1))
        _check_ckpt(ns, key, ck, None, template, res)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--leg", action="append", default=[],
                    help="seq-ring|seq-ulysses|tp|composed:<mesh>, "
                         "pp-gpipe|pp-1f1b|pp-interleaved|pp-clip:<dp>,<pp>, "
                         "run-seq-ring|run-seq-ulysses:<sp>, run-moe:<experts>, "
                         "run-pp:<pp>")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="workers stacked in each process for the run-* legs")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=32)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=31)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block on the backward (its hops too)")
    ap.add_argument("--out", required=True, help="<out>.rank<i>.json per process")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--resave-from", default="",
                    help="another run's --ckpt-dir: restore and save again each "
                         "leg's last checkpoint (one process)")
    ns = ap.parse_args(argv)

    import mpit_tpu_torch

    topo = mpit_tpu_torch.init(num_workers=ns.local_devices, device=ns.device)
    print(f"[rank {topo.process_index}/{topo.process_count}] device={topo.device}",
          flush=True)
    results = {}
    for text in ns.leg:
        (name, arg), key = _parse_leg(text), leg_key(text)
        t0 = time.perf_counter()
        if name.startswith("run-"):
            res = run_leg(ns, name, arg, key)
        elif name.startswith("pp-"):
            res = pipeline_leg(ns, name, arg, topo, key)
        else:
            res = trainer_leg(ns, name, arg, topo, key)
        res["wall_s"] = time.perf_counter() - t0
        results[key] = res
        print(f"[rank {topo.process_index}] {key}: {res}", flush=True)
    with open(f"{ns.out}.rank{topo.process_index}.json", "w") as f:
        json.dump(results, f)
    mpit_tpu_torch.finalize()


if __name__ == "__main__":
    main()
