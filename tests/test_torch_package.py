"""Rules of the port as a package: what it imports, where it runs, and its
collectives against the JAX package's."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpit_tpu_torch
from mpit_tpu.comm import collectives as jax_collectives
from mpit_tpu_torch.ops import _build
from mpit_tpu_torch.ops import elastic as port_elastic
from mpit_tpu_torch.utils.profiling import force_completion

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ml_dtypes", "mpit_tpu")


def _port_files():
    return sorted((ROOT / "mpit_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 20 and files[-1].exists()
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_roots(p) if m in FORBIDDEN]
    assert bad == []


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, mpit_tpu_torch, mpit_tpu_torch.run, mpit_tpu_torch.ops, "
        "mpit_tpu_torch.parallel, mpit_tpu_torch.convert, mpit_tpu_torch.quant, "
        "mpit_tpu_torch.transport, mpit_tpu_torch.parallel.ps_trainer, "
        "mpit_tpu_torch.obs.core, mpit_tpu_torch.obs.live, "
        "mpit_tpu_torch.obs, mpit_tpu_torch.obs.telemetry, mpit_tpu_torch.obs.blackbox, "
        "mpit_tpu_torch.obs.__main__, mpit_tpu_torch.loadgen, "
        "mpit_tpu_torch.analysis.runtime\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    _no_cuda()
    from mpit_tpu_torch.convert import from_flax
    from mpit_tpu_torch.models import MLP, LeNet, TransformerLM
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import DataParallelTrainer, EASGDTrainer
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    mpit_tpu_torch.finalize()
    try:
        for call in (
            mpit_tpu_torch.init,
            lambda: mpit_tpu_torch.init(device="cuda"),
            LeNet,
            MLP,
            lambda: from_flax({"a": np.zeros(2)}),
            lambda: TransformerLM(31),
            lambda: EASGDTrainer(None, SGD(0.1), loss_fn=lambda p, x, y: 0),
            lambda: DataParallelTrainer(TransformerLM(31, device="cpu"), SGD(0.1)),
            lambda: run(TrainConfig().apply_preset("mnist-easgd")),
            lambda: run(dataclasses.replace(
                TrainConfig().apply_preset("ptb-transformer-large"), algo="sync")),
        ):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
        assert not mpit_tpu_torch.is_initialized()
        topo = mpit_tpu_torch.init(num_workers=4, device="cpu")
        assert (topo.num_workers, topo.platform, topo.worker_axis) == (4, "cpu", 0)
        assert mpit_tpu_torch.init() is topo and mpit_tpu_torch.size() == 4
        with pytest.raises(RuntimeError, match="finalize"):
            mpit_tpu_torch.init(num_workers=2)
    finally:
        mpit_tpu_torch.finalize()


@pytest.mark.parametrize("bad", ["cpu-tensor", "float64"])
def test_kernel_refuses_what_it_cannot_take(bad):
    x = torch.zeros(8, 3)
    c = torch.zeros(3, dtype=torch.float64 if bad == "float64" else torch.float32)
    before = port_elastic.launches
    with pytest.raises(ValueError, match="elastic kernel"):
        port_elastic.elastic_update(x, c, c, 0.1, use_kernel=True)
    assert port_elastic.launches == before


def test_kernel_module_imports_and_names_its_build_without_nvcc(monkeypatch):
    """The module imports anywhere; the build is deferred to first use and
    says plainly when there is no compiler."""
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    if pathlib.Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("checks the behaviour on a machine without nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    src = _build.CSRC / "elastic.cu"
    assert src.exists() and "mpit_elastic_update" in src.read_text()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "mpit_tpu_torch")
    assert _build._target("elastic").name.startswith("elastic-")


@pytest.mark.parametrize("op", ["sum", "avg"])
def test_allreduce_matches_jax(topo8, op):
    rng = np.random.default_rng(0)
    tree = {"a": rng.normal(size=(8, 5)).astype(np.float32),
            "b": (rng.normal(size=(8, 2, 3)).astype(np.float32),)}
    fn = jax.jit(jax.shard_map(
        lambda t: jax_collectives.allreduce(
            jax.tree.map(lambda a: a[0], t), op=op),
        mesh=topo8.mesh, in_specs=(P(topo8.worker_axis),), out_specs=P(),
        check_vma=False,
    ))
    ref = fn(tree)
    got = mpit_tpu_torch.allreduce(jax.tree.map(torch.from_numpy, tree), op=op)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), got))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-6)
    # MAX, MIN and PROD are ported since item A5b (tests/test_torch_dist.py);
    # an op neither package has still raises
    with pytest.raises(ValueError, match="unknown reduction op"):
        mpit_tpu_torch.allreduce(got, op="xor")


def test_flash_source_builds_under_its_own_name():
    src = _build.CSRC / "flash_attention.cu"
    text = src.read_text()
    for entry in ("mpit_flash_forward", "mpit_flash_dq", "mpit_flash_dkv"):
        assert f'extern "C" int {entry}(' in text
    assert _build._target("flash_attention").name.startswith("flash_attention-")


@pytest.mark.parametrize("env,card", [({}, "0"), ({"CUDA_VISIBLE_DEVICES": "2,3"}, "2"),
                                      ({"CUDA_VISIBLE_DEVICES": "1"}, "1")])
def test_chip_smoke_uses_one_card_and_reports_it(env, card):
    """chip_smoke.py hides every card but one before CUDA starts, so the
    device line's count is the number of cards the run used: 1."""
    import chip_smoke

    assert chip_smoke.one_card(env) == card
    line = chip_smoke.device_line("NVIDIA H100 80GB HBM3", 1)
    assert line == {"ok": True, "device": {"platform": "gpu",
                                           "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert 'os.environ["CUDA_VISIBLE_DEVICES"] = one_card(os.environ)' in (
        ROOT / "chip_smoke.py").read_text()


def test_force_completion_fetches_one_scalar_per_argument():
    state = {"w": torch.ones(100), "b": torch.full((2,), 3.0)}
    metrics = {"loss": torch.tensor(0.5), "step": torch.tensor(4)}
    assert force_completion(state, metrics) == 6.5
    assert force_completion({"n": 3}) == 0.0
