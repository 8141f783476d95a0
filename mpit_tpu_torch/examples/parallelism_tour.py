"""parallelism_tour — every parallelism axis of the port, one step each.

The port's counterpart of ``examples/parallelism_tour.py``: the same tiny
transformer LM trained one step under

  dp   sync data parallelism                  (DataParallelTrainer)
  sp   ring-attention sequence parallelism    (SeqParallelTrainer)
  tp   Megatron tensor parallelism            (TensorParallelTrainer)
  pp   pipeline parallelism, 3 schedules      (PipelineParallelTrainer)
  ep   expert-parallel mixture-of-experts     (MoEParallelTrainer)
  3-D  composed dp x tp x sp in one step      (ComposedParallelTrainer)

with the 8 workers stacked on one device (``mpit_tpu_torch/comm/
topology.py``):

  python mpit_tpu_torch/examples/parallelism_tour.py                # the card
  python mpit_tpu_torch/examples/parallelism_tour.py --device cpu

Each section prints its mesh and the first-step loss; the tests under
``tests/test_torch_*.py`` hold every trainer against the reference's.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpit_tpu_torch import optim  # noqa: E402
from mpit_tpu_torch.comm.topology import Topology, resolve_device  # noqa: E402
from mpit_tpu_torch.models import TransformerLM  # noqa: E402
from mpit_tpu_torch.parallel import (  # noqa: E402
    ComposedParallelTrainer,
    DataParallelTrainer,
    MoEParallelTrainer,
    SeqParallelTrainer,
    TensorParallelTrainer,
    ZeroDataParallelTrainer,
)
from mpit_tpu_torch.parallel.pipeline import PipelineParallelTrainer  # noqa: E402

V, B, T = 31, 8, 32


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, V, (B, T)).astype(np.int32)
    y = np.roll(x, -1, axis=1).astype(np.int32)
    losses = {}

    def lm(**kw):
        kw = {"num_heads": 4, **kw}
        return TransformerLM(V, num_layers=2, d_model=32, max_len=T,
                             compute_dtype=torch.float32, device=dev, **kw)

    def world(names=("dp",), shape=(8,)):
        return Topology(8, dev, axis_names=names, mesh_shape=shape)

    def show(tag, topo, loss):
        loss = float(loss)
        losses[tag] = loss
        mesh = dict(zip(topo.axis_names, topo.mesh_shape))
        print(f"{tag:<28} mesh={mesh}  loss={loss:.4f}")

    def first(tr, xs=x, ys=y):
        st = tr.init_state(torch.Generator().manual_seed(0))
        return tr.step(st, xs, ys)[1]["loss"]

    topo = world()
    show("dp (sync allreduce)", topo,
         first(DataParallelTrainer(lm(), optim.Adam(1e-3), topo)))
    show("dp + grad accumulation x4", topo,
         first(DataParallelTrainer(lm(), optim.Adam(1e-3), topo, accum_steps=4),
               np.tile(x, (4, 1)), np.tile(y, (4, 1))))
    show("dp + ZeRO-1 optimizer shards", topo,
         first(ZeroDataParallelTrainer(lm(), optim.Adam(1e-3), topo)))

    topo = world(("dp", "sp"), (2, 4))
    show("sp (ring attention)", topo,
         first(SeqParallelTrainer(lm(seq_axis="sp"), optim.Adam(1e-3), topo)))

    topo = world(("dp", "tp"), (2, 4))
    show("tp (Megatron)", topo,
         first(TensorParallelTrainer(lm(), optim.Adam(1e-3), topo)))

    topo = world(("dp", "pp"), (2, 4))
    for sched, layers in (("gpipe", 4), ("1f1b", 4), ("interleaved", 8)):
        tr = PipelineParallelTrainer(
            vocab_size=V, num_layers=layers, d_model=32, num_heads=4,
            seq_len=T, topo=topo, n_micro=2, lr=0.1, schedule=sched,
        )
        show(f"pp ({sched}, {tr.ticks} ticks)", topo, first(tr))

    topo = world()
    tr = MoEParallelTrainer(
        lm(moe_experts=8, moe_axis="dp", moe_top_k=2, moe_balance_weight=0.01,
           moe_capacity_factor=4.0),
        optim.Adam(1e-3), topo,
    )
    st = tr.init_state(torch.Generator().manual_seed(0))
    _, m = tr.step(st, x, y)
    show(f"ep (top-2 MoE, balance={float(m['moe_balance']):.3f})", topo, m["loss"])

    topo = world(("dp", "tp", "sp"), (2, 2, 2))
    show("dp x tp x sp (composed)", topo,
         first(ComposedParallelTrainer(lm(seq_axis="sp", num_heads=8),
                                       optim.Adam(1e-3), topo)))
    print(f"tour complete on {dev} — every axis trained a real step")
    return losses


if __name__ == "__main__":
    main()
