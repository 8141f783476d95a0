"""The sequence ring (ring and Ulysses), tensor parallelism and composed
``(dp, tp, sp)`` training with their inner axes spanning 2 gloo processes,
and ``run()`` of seq-sync and moe-sync in a process world, against the
same world in one process and the ring against the JAX package's
``SeqParallelTrainer`` on the 8-device CPU mesh.

Every leg runs in one launch of ``mpit_tpu_torch/examples/multihost_lm.py``
(2 ranks, ``JAX_PLATFORMS=cpu``, one intra-op thread, a timeout), and once
more in one process of the same world's workers; each rank writes one
JSON, its share of the initial logits and, from rank 0, a step-0 and a
final checkpoint a leg. Widths are tiny: 2 layers, d_model 32, 4 heads,
T = 16, a batch of 4, 2 SGD steps (f32) or 2 ``run()`` steps (bf16)."""

import glob
import json
import os
import subprocess
import sys

import flax.serialization
import jax
import numpy as np
import optax
import pytest

import mpit_tpu
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu.parallel import SeqParallelTrainer as JaxSeq
from mpit_tpu_torch.utils import checkpoint as ckpt
from mpit_tpu_torch.utils.params import tree_leaves, tree_leaves_with_path

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "mpit_tpu_torch", "examples", "multihost_lm.py")
TIMEOUT_S = 300
TRAINER_LEGS = ["seq-ring@1x2", "seq-ulysses@1x2", "seq-ring@2x2", "seq-ulysses@2x2",
                "tp@1x2", "composed@1x2x2"]
RUN_LEGS = ["run-seq-ring@2", "run-seq-ulysses@2", "run-moe@4"]
# tests/test_torch_seq.py's limits (the reference's mesh invariance,
# tests/test_seq_parallel.py:62-79): the processes sum the gradient in
# another order than one process
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-5, atol=5e-5)
# run() of the bf16 preset: tests/test_torch_seq.py's BF16_TRAJ_TOL (AdamW's
# first steps turn a last-bit gradient difference into up to lr on a leaf)
BF16_TRAJ_TOL = dict(rtol=0, atol=5e-3)
V, B, T = 31, 4, 16


def _launch(n, args, distributed=True):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MPIT_", "JAX_COORDINATOR"))}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "mpit_tpu_torch.launch", "-n", str(n)]
    if distributed:
        cmd.append("--jax-distributed")
    return subprocess.run([*cmd, *args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)


@pytest.fixture(scope="module")
def legs(tmp_path_factory):
    """Every leg over 2 processes and over 1: ``{"two": [rank 0, rank 1],
    "one": rank 0, "dir": tmp}``."""
    tmp = tmp_path_factory.mktemp("axes")
    args = [f"--leg={k.replace('@', ':').replace('x', ',')}" for k in TRAINER_LEGS + RUN_LEGS]
    args += ["--device", "cpu", "--layers", "2", "--d-model", "32", "--heads", "4",
             "--seq-len", str(T), "--vocab", str(V), "--batch", str(B), "--steps", "2"]
    r = _launch(2, [SCRIPT, *args, "--out", str(tmp / "two"), "--ckpt-dir", str(tmp / "ck2")])
    assert r.returncode == 0, r.stdout + r.stderr
    r = _launch(1, [SCRIPT, *args, "--local-devices", "2", "--out", str(tmp / "one"),
                    "--ckpt-dir", str(tmp / "ck1"), "--resave-from", str(tmp / "ck2")],
                distributed=False)
    assert r.returncode == 0, r.stdout + r.stderr
    return {"two": [json.load(open(tmp / f"two.rank{i}.json")) for i in range(2)],
            "one": json.load(open(tmp / "one.rank0.json")), "dir": tmp}


def _file(legs, world: str, key: str, which: int = -1) -> dict:
    paths = sorted(glob.glob(str(legs["dir"] / f"ck{world}" / key / "ckpt_*.msgpack")))
    return ckpt.msgpack_restore(open(paths[which], "rb").read())


def _same_on_every_rank(legs, key):
    a, b = (dict(r[key], wall_s=None) for r in legs["two"])
    assert a == b


@pytest.mark.parametrize("key", TRAINER_LEGS)
def test_the_forward_across_two_processes_is_the_one_process_forward(key, legs):
    """The initial logits of each process's share of the batch (its rows
    and sequence blocks) equal the one-process run's at the same places,
    bit for bit: the ring's hops and Ulysses' all-to-alls only move values,
    the positions are global, and the row-parallel partials are summed in
    shard order."""
    one = np.load(legs["dir"] / f"one.{key}.rank0.npy")
    for rank in range(2):
        got = np.load(legs["dir"] / f"two.{key}.rank{rank}.npy")
        if key.startswith(("tp", "composed")):
            want = one  # dp = 1: every process holds every row and block
        elif key.endswith("1x2"):
            want = one[rank:rank + 1]  # block `rank` of the ring
        else:
            want = one[:, 2 * rank:2 * rank + 2]  # dp group `rank`'s rows
        assert got.shape == want.shape
        assert np.array_equal(got, want)


@pytest.mark.parametrize("key", TRAINER_LEGS)
def test_two_steps_across_two_processes_match_one_process(key, legs):
    """Both ranks report the same losses and evaluations; those and the
    final params equal the one-process run's within
    ``tests/test_torch_seq.py``'s mesh-invariance limits; the step-0
    checkpoints are equal bytes for bytes."""
    _same_on_every_rank(legs, key)
    two, one = legs["two"][0][key], legs["one"][key]
    np.testing.assert_allclose(two["losses"], one["losses"], **LOSS_TOL)
    assert two["losses"][-1] < two["losses"][0]
    for name in ("eval0", "eval"):
        assert two[name][0] == pytest.approx(one[name][0], abs=1e-6)
        assert two[name][1] == pytest.approx(one[name][1], rel=1e-5)
    for a, b in zip(tree_leaves(_file(legs, "1", key)), tree_leaves(_file(legs, "2", key)),
                    strict=True):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **PARAM_TOL)
    for a, b in zip(tree_leaves(_file(legs, "1", key, 0)),
                    tree_leaves(_file(legs, "2", key, 0)), strict=True):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("key", TRAINER_LEGS + RUN_LEGS)
def test_the_checkpoint_round_trip_across_two_processes_is_bit_exact(key, legs):
    """Every rank gathers, rank 0 writes, every rank restores; each rank's
    restored state, gathered, equals the file leaf for leaf."""
    for rank in legs["two"]:
        assert rank[key]["ckpt_roundtrip"] is True
    assert legs["one"][key]["ckpt_roundtrip"] is True


@pytest.mark.parametrize("key", TRAINER_LEGS + RUN_LEGS)
def test_the_two_process_file_is_what_one_process_writes_of_its_state(key, legs):
    """Each leg's last two-process checkpoint, restored into the same
    world's state in one process and saved again, gives the same bytes:
    the processes write what one process writes (moe-sync's experts
    gathered in order, with their AdamW moments)."""
    assert legs["one"][key]["resaved_bytes_equal"] is True


def test_tp_across_processes_carries_every_shards_layernorm_gradient(legs):
    """With tp over 2 processes each computes half of the column products;
    Megatron's "f" sums the LayerNorms' and the embeddings' gradients over
    both. Their updates equal the one-process run's (a missing "f" halves
    their share of the column products' gradient)."""
    key = "tp@1x2"
    init = dict(tree_leaves_with_path(_file(legs, "2", key, 0)["params"]))
    one = dict(tree_leaves_with_path(_file(legs, "1", key)["params"]))
    two = dict(tree_leaves_with_path(_file(legs, "2", key)["params"]))
    for path in [("Block_0", "LayerNorm_0", "scale"), ("Block_1", "LayerNorm_1", "bias"),
                 ("Embed_0", "embedding"), ("Block_0", "Dense_0", "kernel"),
                 ("Block_1", "Dense_3", "kernel")]:
        moved = np.asarray(one[path]) - np.asarray(init[path])
        assert np.abs(moved).max() > 1e-4, path
        np.testing.assert_allclose(np.asarray(two[path]) - np.asarray(init[path]), moved,
                                   **PARAM_TOL, err_msg=str(path))


@pytest.mark.parametrize("key", RUN_LEGS)
def test_run_across_two_processes_matches_one_process(key, legs):
    """``run()`` of ``ptb-transformer-large`` (narrowed, bf16, AdamW) with
    ``--sp 2`` over 2 processes of 1 worker (the ring wider than a
    process), and moe-sync with 4 experts over them: both ranks report the
    same results, which equal one process's within the limits above (the
    params within the bf16 trajectory tolerance); the moe-sync file holds
    all 4 experts and their AdamW moments."""
    _same_on_every_rank(legs, key)
    two, one = legs["two"][0][key], legs["one"][key]
    assert two["workers"] == one["workers"] == (2 if key == "run-moe@4" else 1)
    assert two["trained_units"] == one["trained_units"] == 2
    np.testing.assert_allclose(two["round_losses"], one["round_losses"], **LOSS_TOL)
    assert two["eval_loss"] == pytest.approx(one["eval_loss"], rel=1e-4)
    got = _file(legs, "2", key)
    for a, b in zip(tree_leaves(_file(legs, "1", key)), tree_leaves(got), strict=True):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **BF16_TRAJ_TOL)
    if key == "run-moe@4":
        adam = got["opt_state"]["0"]
        for tree in (got["params"], adam["mu"], adam["nu"]):
            assert np.asarray(tree["Block_0"]["moe_w_up"]).shape[0] == 4


# ------------------------------------------------------ against the reference

@pytest.mark.parametrize("key", ["seq-ring@1x2", "seq-ulysses@1x2", "seq-ring@2x2"])
def test_the_two_process_ring_matches_the_reference_trainer(key, legs):
    """The 2-process run against the reference's ``SeqParallelTrainer`` at
    the same ``(dp, sp)`` on the CPU mesh, from the port's step-0
    checkpoint (the reference's bytes) and the same batch: losses, final
    params and evaluation within ``tests/test_torch_seq.py``'s limits."""
    shape = tuple(int(a) for a in key.split("@")[1].split("x"))
    impl = key.split("@")[0].removeprefix("seq-")
    mpit_tpu.finalize()
    topo = mpit_tpu.init(num_workers=int(np.prod(shape)), axis_names=("dp", "sp"),
                         mesh_shape=shape)
    model = JaxLM(vocab_size=V, num_layers=2, d_model=32, num_heads=4, max_len=T,
                  compute_dtype=np.float32, seq_axis="sp", seq_impl=impl)
    trainer = JaxSeq(model, optax.sgd(0.1, momentum=0.9), topo, donate_state=False)
    rng = np.random.default_rng(0)
    x = rng.integers(0, V, (B, T)).astype(np.int32)
    y = np.roll(x, -1, axis=1)
    template = trainer.init_state(jax.random.key(0), x[: B // shape[0], : T // shape[1]])
    paths = sorted(glob.glob(str(legs["dir"] / "ck2" / key / "ckpt_*.msgpack")))
    state = flax.serialization.from_bytes(jax.device_get(template),
                                          open(paths[0], "rb").read())
    state = jax.device_put(state, jax.tree.map(lambda a: a.sharding, template))
    losses = []
    for _ in range(2):
        state, m = trainer.step(state, x, y)
        losses.append(float(m["loss"]))
    two = legs["two"][0][key]
    np.testing.assert_allclose(two["losses"], losses, **LOSS_TOL)
    want = jax.tree.leaves(jax.device_get(state.params))
    got = tree_leaves(_file(legs, "2", key)["params"])
    for a, b in zip(want, got, strict=True):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **PARAM_TOL)
    acc, loss = trainer.evaluate(state, x, y)
    assert two["eval"][0] == pytest.approx(acc, abs=1e-6)
    assert two["eval"][1] == pytest.approx(loss, rel=1e-4)


REMAT_LEGS = ["seq-ring@1x2", "composed@1x2x2"]


@pytest.fixture(scope="module")
def remat_legs(tmp_path_factory):
    """:data:`REMAT_LEGS` over 2 processes with ``--remat``."""
    tmp = tmp_path_factory.mktemp("remat")
    args = [SCRIPT, *(f"--leg={k.replace('@', ':').replace('x', ',')}" for k in REMAT_LEGS),
            "--remat", "--device", "cpu", "--seq-len", str(T), "--vocab", str(V),
            "--batch", str(B), "--out", str(tmp / "two"), "--ckpt-dir", str(tmp / "ck")]
    r = _launch(2, args)
    assert r.returncode == 0, r.stdout + r.stderr
    return tmp, [json.load(open(tmp / f"two.rank{i}.json")) for i in range(2)]


@pytest.mark.parametrize("key", REMAT_LEGS)
def test_remat_across_two_processes_recomputes_its_hops_in_step(key, legs, remat_legs):
    """With ``--remat`` every block's forward, its ring hops and tp gathers
    with it, runs again in the backward (``torch.autograd.grad``): the
    processes recompute in step and the run ends as the one-process run
    without remat does, within the limits above."""
    tmp, ranks = remat_legs
    ranks = [r[key] for r in ranks]
    assert dict(ranks[0], wall_s=None) == dict(ranks[1], wall_s=None)
    np.testing.assert_allclose(ranks[0]["losses"], legs["one"][key]["losses"], **LOSS_TOL)
    final = sorted(glob.glob(str(tmp / "ck" / key / "ckpt_*.msgpack")))[-1]
    got = tree_leaves(ckpt.msgpack_restore(open(final, "rb").read()))
    for a, b in zip(tree_leaves(_file(legs, "1", key)), got, strict=True):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **PARAM_TOL)
    assert ranks[0]["ckpt_roundtrip"] is True


FOUR_LEGS = ["seq-ring@2x2", "seq-ulysses@2x2", "tp@2x2", "composed@1x2x2"]


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """:data:`FOUR_LEGS` over 4 processes of 1 worker (2 lines of
    processes along each inner axis, each line its own subgroup) and over
    1 process of 4."""
    tmp = tmp_path_factory.mktemp("four")
    args = [SCRIPT, *(f"--leg={k.replace('@', ':').replace('x', ',')}" for k in FOUR_LEGS),
            "--device", "cpu", "--seq-len", str(T), "--vocab", str(V), "--batch", str(B)]
    r = _launch(4, [*args, "--out", str(tmp / "four"), "--ckpt-dir", str(tmp / "ck4")])
    assert r.returncode == 0, r.stdout + r.stderr
    r = _launch(1, [*args, "--local-devices", "4", "--out", str(tmp / "one"),
                    "--ckpt-dir", str(tmp / "ck1")], distributed=False)
    assert r.returncode == 0, r.stdout + r.stderr
    return tmp, ([json.load(open(tmp / f"four.rank{i}.json")) for i in range(4)],
                 json.load(open(tmp / "one.rank0.json")))


@pytest.mark.parametrize("key", FOUR_LEGS)
def test_four_processes_with_two_lines_on_each_axis_match_one_process(key, four):
    """dp and sp (or tp) both span the processes: process ``p`` holds
    group ``p // 2``'s rows and block (or shard) ``p % 2``; composed
    (1, 2, 2) puts tp over processes {0, 2}, {1, 3} and sp over {0, 1},
    {2, 3}. Every rank reports the same results, its initial logits equal
    the one-process run's at its place bit for bit, and the losses and
    params agree within the limits above."""
    tmp, (ranks, one) = four
    assert all(dict(r[key], wall_s=None) == dict(ranks[0][key], wall_s=None) for r in ranks)
    np.testing.assert_allclose(ranks[0][key]["losses"], one[key]["losses"], **LOSS_TOL)
    assert all(r[key]["ckpt_roundtrip"] for r in ranks)
    whole = np.load(tmp / f"one.{key}.rank0.npy")
    for p in range(4):
        got = np.load(tmp / f"four.{key}.rank{p}.npy")
        d, i = divmod(p, 2)
        want = (whole[2 * d:2 * d + 2] if key.startswith("tp") else
                whole[i:i + 1] if key.startswith("composed") else
                whole[i:i + 1, 2 * d:2 * d + 2])
        assert np.array_equal(got, want), p
    final = [sorted(glob.glob(str(tmp / f"ck{n}" / key / "ckpt_*.msgpack")))[-1]
             for n in (1, 4)]
    a, b = (tree_leaves(ckpt.msgpack_restore(open(f, "rb").read())) for f in final)
    for x, y in zip(a, b, strict=True):
        np.testing.assert_allclose(np.asarray(y), np.asarray(x), **PARAM_TOL)
