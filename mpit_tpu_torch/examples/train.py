"""train — unified CLI over every BASELINE workload config, on the port.

Counterpart of ``examples/train.py``: one CLI and its presets cover every
workload (BASELINE.md table):

  python mpit_tpu_torch/examples/train.py --preset mnist-easgd        # config 1 (collective)
  python mpit_tpu_torch/examples/train.py --preset mnist-ps           # config 1 (literal
                                                                      #   2 pclient+1 pserver)
  python mpit_tpu_torch/examples/train.py --preset cifar-vgg-sync     # config 2
  python mpit_tpu_torch/examples/train.py --preset alexnet-downpour   # config 3
  python mpit_tpu_torch/examples/train.py --preset resnet50-sync      # config 4
  python mpit_tpu_torch/examples/train.py --preset ptb-lstm-easgd     # config 5

Any flag overrides its preset value (e.g. ``--epochs 10 --lr 0.1``).
``--device`` is ``cuda`` (the default; raises where there is no card) or
``cpu``. Prints ``run()``'s results dict as one JSON line.
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
)


def main(argv=None):
    # the CLI lives in the package (installed as `mpit-torch-train`); this
    # file is the same entry run from a checkout
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    known, rest = pre.parse_known_args(argv)

    from mpit_tpu_torch.run import main as run_main

    run_main(rest, device=known.device, description=__doc__)


if __name__ == "__main__":
    main()
