"""The pipeline (``parallel/pipeline.py``, ``--algo pp-sync``) with its
``pp`` axis spanning gloo processes, each holding only its stages, against
the same world in one process and against the JAX package's
``PipelineParallelTrainer`` on the 8-device CPU mesh.

The 2-process legs run in one launch of
``mpit_tpu_torch/examples/multihost_lm.py`` (``JAX_PLATFORMS=cpu``, one
intra-op thread, a timeout), and once more in one process of the same
world's workers; the (2, 2) legs in a launch of 4 processes and one
process of 4. Widths are tiny: 4 layers, d_model 32, 4 heads, T = 16, a
batch of 4 in 2 microbatches, 2 SGD steps with momentum (f32), a
checkpoint after each; ``run-pp@2`` is ``run()`` of pp-sync (1f1b, AdamW,
``clip_norm``) with ``--pp 2`` over 2 processes of 1 worker."""

import glob
import json
import os
import subprocess
import sys

import flax.serialization
import jax
import numpy as np
import pytest

import mpit_tpu
from mpit_tpu.parallel import pipeline as ref_pp
from mpit_tpu_torch.utils import checkpoint as ckpt
from mpit_tpu_torch.utils.params import tree_leaves, tree_leaves_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "mpit_tpu_torch", "examples", "multihost_lm.py")
TIMEOUT_S = 300
PP_LEGS = ["pp-gpipe@1x2", "pp-1f1b@1x2", "pp-interleaved@1x2", "pp-clip@1x2"]
RUN_LEGS = ["run-pp@2"]
FOUR_LEGS = ["pp-1f1b@2x2", "pp-clip@2x2"]
# tests/test_torch_dist_axes.py's limits (the processes sum the rest
# gradient and the loss in another order than one process; GPipe's
# transpose is written out across processes, autograd's in one)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-5, atol=5e-5)
# tests/test_torch_pipeline.py's limits against the reference's trainer
REF_LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
REF_PARAM_TOL = dict(rtol=2e-4, atol=2e-4)
V, B, T, L, D, H = 31, 4, 16, 4, 32, 4
WIDTH = ["--device", "cpu", "--layers", str(L), "--d-model", str(D), "--heads", str(H),
         "--seq-len", str(T), "--vocab", str(V), "--batch", str(B), "--steps", "2"]


def _launch(n, args, distributed=True):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MPIT_", "JAX_COORDINATOR"))}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "mpit_tpu_torch.launch", "-n", str(n)]
    if distributed:
        cmd.append("--jax-distributed")
    return subprocess.run([*cmd, *args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)


def _worlds(tmp, keys, n):
    """``keys`` over ``n`` processes of 1 worker and over 1 process of
    ``n`` (which also restores and saves again each leg's last file of the
    ``n`` processes): ``{"many": [rank 0, ...], "one": rank 0, "dir": tmp}``."""
    args = [SCRIPT, *(f"--leg={k.replace('@', ':').replace('x', ',')}" for k in keys), *WIDTH]
    r = _launch(n, [*args, "--out", str(tmp / "many"), "--ckpt-dir", str(tmp / "ckn")])
    assert r.returncode == 0, r.stdout + r.stderr
    r = _launch(1, [*args, "--local-devices", str(n), "--out", str(tmp / "one"),
                    "--ckpt-dir", str(tmp / "ck1"), "--resave-from", str(tmp / "ckn")],
                distributed=False)
    assert r.returncode == 0, r.stdout + r.stderr
    return {"many": [json.load(open(tmp / f"many.rank{i}.json")) for i in range(n)],
            "one": json.load(open(tmp / "one.rank0.json")), "dir": tmp}


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    return _worlds(tmp_path_factory.mktemp("pp2"), PP_LEGS + RUN_LEGS, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _worlds(tmp_path_factory.mktemp("pp4"), FOUR_LEGS, 4)


def _files(run, world: str, key: str) -> list:
    return sorted(glob.glob(str(run["dir"] / f"ck{world}" / key / "ckpt_*.msgpack")))


def _leaves(path) -> list:
    return tree_leaves(ckpt.msgpack_restore(open(path, "rb").read()))


def _same_on_every_rank(run, key):
    first = dict(run["many"][0][key], wall_s=None)
    assert all(dict(r[key], wall_s=None) == first for r in run["many"])


def _matches_one_process(run, key, losses="losses"):
    """Every rank alike; losses and every checkpoint's leaves within the
    limits of one process's; the checkpoint round trip bit-exact on every
    rank and the last file, restored and saved by one process, the same
    bytes."""
    _same_on_every_rank(run, key)
    many, one = run["many"][0][key], run["one"][key]
    np.testing.assert_allclose(many[losses], one[losses], **LOSS_TOL)
    files = [_files(run, w, key) for w in ("1", "n")]
    assert len(files[0]) == len(files[1]) >= 1
    for a, b in zip(*files):
        for x, y in zip(_leaves(a), _leaves(b), strict=True):
            np.testing.assert_allclose(np.asarray(y), np.asarray(x), **PARAM_TOL)
    assert all(r[key]["ckpt_roundtrip"] is True for r in run["many"])
    assert one["ckpt_roundtrip"] is True and one["resaved_bytes_equal"] is True


@pytest.mark.parametrize("key", PP_LEGS)
def test_the_initial_eval_across_two_processes_is_one_process_eval_bit_for_bit(key, legs):
    """The pipelined forward moves activations between the processes as
    bytes and runs each stage's ops as one process runs them; only the last
    stage counts, so the evaluation of the initial params is equal bit for
    bit (interleaved: the stack gathered along the pp line)."""
    for rank in legs["many"]:
        assert rank[key]["eval0"] == legs["one"][key]["eval0"]


@pytest.mark.parametrize("key", PP_LEGS)
def test_two_steps_across_two_processes_match_one_process(key, legs):
    """gpipe, 1f1b, interleaved (2 virtual chunks) and 1f1b with clipping:
    both ranks report the same losses and evaluations, which equal one
    process's within the limits; so do the params after each step; the
    step-0 files are the same bytes."""
    _matches_one_process(legs, key)
    assert legs["many"][0][key]["losses"][-1] < legs["many"][0][key]["losses"][0]
    a, b = (_files(legs, w, key)[0] for w in ("1", "n"))
    assert open(a, "rb").read() == open(b, "rb").read()
    many, one = legs["many"][0][key], legs["one"][key]
    assert many["eval"][0] == pytest.approx(one["eval"][0], abs=1e-6)
    assert many["eval"][1] == pytest.approx(one["eval"][1], rel=1e-5)


@pytest.mark.parametrize("key", PP_LEGS)
def test_each_process_holds_only_its_stages(key, legs):
    """Every ``blocks`` leaf of the params and the momentum holds L/2 rows
    in each of the 2 processes, L in one process, and the file holds L."""
    assert all(r[key]["block_rows"] == [L // 2] for r in legs["many"])
    assert legs["one"][key]["block_rows"] == [L]
    tree = ckpt.msgpack_restore(open(_files(legs, "n", key)[-1], "rb").read())
    for part in ("params", "momentum"):
        assert {np.asarray(a).shape[0] for a in tree_leaves(tree[part]["blocks"])} == {L}


def test_clipping_binds_and_sums_the_stages_squares_over_the_pp_line(legs):
    """``pp-clip`` is ``pp-1f1b`` with a ``clip_norm`` below the gradient's
    norm: its params move less than the unclipped run's, and across the
    processes they equal one process's (above), whose norm counts each
    stage once."""
    def params(path):
        return tree_leaves(ckpt.msgpack_restore(open(path, "rb").read())["params"])

    clipped, free = (params(_files(legs, "n", k)[-1]) for k in ("pp-clip@1x2", "pp-1f1b@1x2"))
    init = params(_files(legs, "n", "pp-1f1b@1x2")[0])
    moved = [np.abs(np.asarray(a) - np.asarray(i)).max() for a, i in zip(clipped, init)]
    moved_free = [np.abs(np.asarray(a) - np.asarray(i)).max() for a, i in zip(free, init)]
    assert max(moved) > 0 and max(moved) < 0.5 * max(moved_free)


@pytest.mark.parametrize("key", PP_LEGS + RUN_LEGS)
def test_the_checkpoint_round_trip_is_bit_exact_and_one_process_writes_the_same_bytes(key, legs):
    """Every rank gathers its stages along the pp line, rank 0 writes,
    every rank restores its own stages; each rank's restored state,
    gathered, equals the file leaf for leaf; the last file, restored into
    the one-process state and saved again, is the same bytes."""
    for rank in legs["many"]:
        assert rank[key]["ckpt_roundtrip"] is True
    assert legs["one"][key]["ckpt_roundtrip"] is True
    assert legs["one"][key]["resaved_bytes_equal"] is True


def test_run_pp_across_two_processes_matches_one_process(legs):
    """``run()`` of pp-sync with ``--pp 2`` over 2 processes of 1 worker
    (1f1b, AdamW, ``clip_norm``): both ranks report the same results, which
    equal one process's within the limits; the file holds every layer and
    its AdamW moments."""
    key = "run-pp@2"
    _matches_one_process(legs, key, losses="round_losses")
    many, one = legs["many"][0][key], legs["one"][key]
    assert many["workers"] == one["workers"] == 1
    assert many["trained_units"] == one["trained_units"] == 2
    assert many["eval_loss"] == pytest.approx(one["eval_loss"], rel=1e-5)
    tree = ckpt.msgpack_restore(open(_files(legs, "n", key)[-1], "rb").read())
    adam = tree["opt_state"]["0"]
    for part in (tree["params"], adam["mu"], adam["nu"]):
        assert np.asarray(part["blocks"]["Dense_0"]["kernel"]).shape[0] == L


@pytest.mark.parametrize("key", FOUR_LEGS)
def test_a_2x2_world_over_four_processes_matches_one_process(key, four):
    """(dp, pp) = (2, 2) over 4 processes: processes {0, 1} and {2, 3} are
    the pp lines, {0, 2} and {1, 3} hold the same stages. The stages
    gather along the pp line, the gradient is averaged over the processes
    holding the same stages, and clipping sums the stages' squares over the
    pp line (over the world it would count each stage twice): every rank
    alike, L/2 rows each, losses and params within the limits of one
    process's, the file one process's bytes."""
    _matches_one_process(four, key)
    assert all(r[key]["block_rows"] == [L // 2] for r in four["many"])
    many, one = four["many"][0][key], four["one"][key]
    for name in ("eval0", "eval"):
        assert many[name][0] == pytest.approx(one[name][0], abs=1e-6)
        assert many[name][1] == pytest.approx(one[name][1], rel=1e-5)


# ------------------------------------------------------ against the reference

@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_two_processes_match_the_reference_trainer(schedule, legs):
    """The reference's ``PipelineParallelTrainer`` at (1, 2) on the CPU
    mesh, from the 2-process run's step-0 checkpoint (the reference's
    bytes) and the same batch: the first loss and the params after one step
    within ``tests/test_torch_pipeline.py``'s limits."""
    key = f"pp-{schedule}@1x2"
    mpit_tpu.finalize()
    topo = mpit_tpu.init(num_workers=2, axis_names=("dp", "pp"), mesh_shape=(1, 2))
    jt = ref_pp.PipelineParallelTrainer(
        vocab_size=V, num_layers=L, d_model=D, num_heads=H, seq_len=T, topo=topo,
        n_micro=2, lr=0.1, momentum=0.9, schedule=schedule, virtual=2, donate_state=False)
    template = jt.init_state(jax.random.key(1))
    files = _files(legs, "n", key)
    state = flax.serialization.from_bytes(jax.device_get(template), open(files[0], "rb").read())
    state = jax.device_put(state, jax.tree.map(lambda a: a.sharding, template))
    x = np.random.default_rng(0).integers(0, V, (B, T)).astype(np.int32)
    state, m = jt.step(state, x, np.roll(x, -1, axis=1))
    np.testing.assert_allclose(legs["many"][0][key]["losses"][0], float(m["loss"]),
                               **REF_LOSS_TOL)
    want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, jax.device_get(state)["params"])))
    got = dict(tree_leaves_with_path(ckpt.msgpack_restore(open(files[1], "rb").read())["params"]))
    assert set(want) == set(got)
    for path, a in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), a, **REF_PARAM_TOL, err_msg=str(path))
