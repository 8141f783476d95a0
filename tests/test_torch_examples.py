"""The reference's two top-level examples on the port:
``mpit_tpu_torch/examples/ptest.py`` and ``train.py`` against
``examples/ptest.py`` and ``examples/train.py``.

Each script runs a tiny ``mnist-easgd`` (one epoch of 256 samples, global
batch 64) or ``ps-easgd`` (8 local steps) on the CPU in a subprocess and
prints its line; the port's ``TrainConfig.from_args`` (and the scripts,
``--device`` stripped) parse the reference's flag lines to the reference's
configs; ``ptest.py`` refuses a dataset other than MNIST as the
reference's does; without ``--device`` the scripts want the card."""

import dataclasses
import importlib.util
import json
import math
import os
import re
import subprocess
import sys

import pytest

from mpit_tpu.utils.config import TrainConfig as RefConfig
from mpit_tpu_torch.utils.config import TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "mpit_tpu_torch", "examples")
TIMEOUT_S = 240
TINY = ["--epochs", "1", "--train-size", "256", "--global-batch", "64"]
# the reference's documented command lines (examples/ptest.py,
# examples/train.py, mpit_tpu/run.py) and a few overrides
REFERENCE_FLAGS = [
    "--algo easgd --epochs 3",
    "--algo ps-easgd",
    "--preset mnist-easgd",
    "--preset mnist-ps",
    "--preset cifar-vgg-sync",
    "--preset alexnet-downpour",
    "--preset resnet50-sync",
    "--preset ptb-lstm-easgd",
    "--preset mnist-easgd --epochs 10 --lr 0.1",
    "--preset ptb-transformer-large --sp 4 --seq-impl ulysses --remat",
    "--preset ptb-transformer-pp --pp 2 --pp-schedule interleaved --pp-virtual 2",
    "--preset ptb-transformer-seq --algo moe-sync --moe-experts 8",
    "--optimizer adamw --lr-schedule warmup-cosine --clip-norm 1.0 --seed 3",
]


def _script(name: str, *args, env=None):
    return subprocess.run([sys.executable, os.path.join(EXAMPLES, name), *args], cwd=REPO,
                          capture_output=True, text=True, timeout=TIMEOUT_S,
                          env={**os.environ, **(env or {})})


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("flags, form", [
    (["--preset", "mnist-easgd", *TINY], r"\[ptest\] easgd: test acc=([\d.]+) "
                                          r"loss=([\d.naif]+) wall=[\d.]+s \(\d+ samples/sec, "
                                          r"\d+ per worker\)"),
    (["--algo", "ps-easgd", "--steps", "8", "--train-size", "256"],
     r"\[ptest\] ps-easgd \(2 pclients \+ 1 pservers\): test acc=([\d.]+) "
     r"loss=([\d.naif]+) wall=[\d.]+s \(\d+ samples/sec\) server_counts=\[\{.*\}\]"),
])
def test_ptest_runs_on_the_cpu_and_prints_the_reference_line(flags, form):
    """The collective form (samples/s per worker) and the PS form
    (pclients, pservers, ``server_counts``), each with a finite loss."""
    r = _script("ptest.py", "--device", "cpu", *flags)
    assert r.returncode == 0, r.stdout + r.stderr
    line = r.stdout.strip().splitlines()[-1]
    m = re.fullmatch(form, line)
    assert m, line
    assert 0 <= float(m.group(1)) <= 1 and math.isfinite(float(m.group(2)))


def test_train_runs_on_the_cpu_and_prints_run_results_as_json():
    r = _script("train.py", "--device", "cpu", "--preset", "mnist-easgd", *TINY)
    assert r.returncode == 0, r.stdout + r.stderr
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["platform"] == "cpu" and res["workers"] == 8 and res["trained_units"] == 1
    assert math.isfinite(res["final_loss"])
    assert json.loads(res["config"])["preset"] == "mnist-easgd"


@pytest.mark.parametrize("name", ["ptest.py", "train.py"])
def test_without_device_the_examples_want_the_card(name):
    """``--device`` defaults to ``cuda``: with no card visible the run
    raises instead of falling back to the CPU."""
    r = _script(name, "--preset", "mnist-easgd", *TINY, env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr


@pytest.mark.parametrize("flags", REFERENCE_FLAGS)
def test_from_args_parses_the_reference_flags_to_the_reference_config(flags):
    ref = RefConfig.from_args(flags.split())
    port = TrainConfig.from_args(flags.split())
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.to_json() == ref.to_json()


@pytest.mark.parametrize("name", ["ptest.py", "train.py"])
@pytest.mark.parametrize("flags", ["--preset mnist-easgd --epochs 2", "--algo ps-easgd"])
def test_the_examples_strip_device_and_run_the_reference_config(name, flags, monkeypatch,
                                                               capsys):
    """``--device cpu`` anywhere on the line goes to ``run()``; the rest is
    the reference's config."""
    import mpit_tpu_torch.run as port_run

    seen = []

    def fake_run(cfg, device=None):
        seen.append((cfg, device))
        return dict(clients=2, servers=1, accuracy=0.5, final_loss=1.0, wall_s=1.0,
                    samples_per_sec=8.0, server_counts=[], workers=8)

    monkeypatch.setattr(port_run, "run", fake_run)
    argv = flags.split()
    _load(os.path.join(EXAMPLES, name), f"port_{name[:-3]}").main(
        argv[:1] + ["--device", "cpu"] + argv[1:])
    (cfg, device), = seen
    assert device == "cpu"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(RefConfig.from_args(argv))
    assert capsys.readouterr().out.startswith("[ptest]" if name == "ptest.py" else "{")


def test_ptest_refuses_a_dataset_other_than_mnist_as_the_reference_does(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["ptest.py", "--dataset", "cifar10"])
    with pytest.raises(SystemExit) as ref:
        _load(os.path.join(REPO, "examples", "ptest.py"), "ref_ptest").main()
    with pytest.raises(SystemExit) as port:
        _load(os.path.join(EXAMPLES, "ptest.py"), "port_ptest").main(
            ["--device", "cpu", "--dataset", "cifar10"])
    for exc in (ref, port):
        assert str(exc.value).startswith("ptest is the MNIST example; use ")
        assert str(exc.value).endswith("train.py for other datasets")
