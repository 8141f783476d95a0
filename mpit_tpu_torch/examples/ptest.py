"""ptest — the bundled end-to-end MNIST example, on the port.

Counterpart of ``examples/ptest.py``: the reference's ``asyncsgd/ptest.lua``
was launched as ``mpirun -n 3 th ptest.lua`` and split ranks into 2
pclients + 1 pserver training LeNet on MNIST. Here the workers are stacked
on one card and the algorithm is chosen by flag. All flags come from
:class:`mpit_tpu_torch.utils.config.TrainConfig` (see
``mpit_tpu_torch/examples/train.py`` for the preset-driven superset CLI),
plus ``--device``: ``cuda`` (the default; raises where there is no card)
or ``cpu``.

  python mpit_tpu_torch/examples/ptest.py --algo easgd --epochs 3
  python mpit_tpu_torch/examples/ptest.py --algo ps-easgd   # the literal shape
  python mpit_tpu_torch/examples/ptest.py --device cpu --algo easgd \\
      --epochs 1 --train-size 512 --global-batch 64
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)


def main(argv=None):
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    known, rest = pre.parse_known_args(argv)

    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = TrainConfig.from_args(rest, description=__doc__)
    if cfg.preset is None and cfg.dataset != "mnist":
        raise SystemExit(
            "ptest is the MNIST example; use mpit_tpu_torch/examples/train.py "
            "for other datasets"
        )

    from mpit_tpu_torch.run import run

    r = run(cfg, device=known.device)
    # the reference's per-chip rate is per worker (a device each); the
    # port stacks the workers on one card, so the line divides by them
    if cfg.algo.startswith("ps-"):
        print(
            f"[ptest] {cfg.algo} ({r['clients']} pclients + {r['servers']} "
            f"pservers): test acc={r['accuracy']:.4f} "
            f"loss={r['final_loss']:.4f} wall={r['wall_s']:.1f}s "
            f"({r['samples_per_sec']:.0f} samples/sec) "
            f"server_counts={r['server_counts']}"
        )
    else:
        print(
            f"[ptest] {cfg.algo}: test acc={r['accuracy']:.4f} "
            f"loss={r['final_loss']:.4f} wall={r['wall_s']:.1f}s "
            f"({r['samples_per_sec']:.0f} samples/sec, "
            f"{r['samples_per_sec'] / r['workers']:.0f} per worker)"
        )


if __name__ == "__main__":
    main()
