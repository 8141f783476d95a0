"""The port's inner mesh axes across processes, at the collective level:
``Topology``'s spans, the ring hop, the line all-to-all, gather and "f"
of ``comm/collectives.py`` over 2 gloo processes (against ``torch.roll``
and the one-process stack, forward and backward, bit for bit), and the
moe-sync checkpoint of a process world (ROADMAP C10): every expert and its
optimizer moment gathered on save, each process's own cut back on restore.

The processes are subprocesses started through the port's launcher with
``JAX_PLATFORMS=cpu``, one intra-op thread and a timeout, as
``tests/test_torch_dist.py`` starts them; every check of the collectives
runs in one launched script that writes one JSON per rank."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mpit_tpu_torch.comm.topology import AxisSpan, Topology
from mpit_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240
CPU = torch.device("cpu")


def _launch(n, args, distributed=True):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MPIT_", "JAX_COORDINATOR"))}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "mpit_tpu_torch.launch", "-n", str(n)]
    if distributed:
        cmd.append("--jax-distributed")
    return subprocess.run([*cmd, *args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=TIMEOUT_S)


# ------------------------------------------------------------------ spans

@pytest.mark.parametrize("shape,procs,axis,want", [
    ((1, 2), 2, "sp", [(0, 1, (0, 1)), (1, 1, (0, 1))]),
    ((2, 2), 2, "sp", [(0, 2, (0,)), (0, 2, (1,))]),
    ((2, 4), 4, "sp", [(0, 2, (0, 1)), (2, 2, (0, 1)), (0, 2, (2, 3)), (2, 2, (2, 3))]),
    ((2, 4), 4, "dp", [(0, 1, (0, 2)), (0, 1, (1, 3)), (1, 1, (0, 2)), (1, 1, (1, 3))]),
], ids=["1x2-sp", "2x2-sp", "2x4-sp", "2x4-dp"])
def test_each_process_knows_its_place_on_an_axis(shape, procs, axis, want):
    """``axis_span`` gives each process its first index and count on the
    axis and the processes along it; ``peers`` the processes sharing its
    indices."""
    n = int(np.prod(shape))
    got = []
    for p in range(procs):
        topo = Topology(n, CPU, process_index=p, process_count=procs,
                        axis_names=("dp", axis if axis != "dp" else "sp"), mesh_shape=shape)
        span = topo.axis_span(axis)
        got.append((span.start, span.count, span.line))
        assert span.size == shape[topo.axis_names.index(axis)]
        assert span.local == (span.count == span.size)
        assert p in topo.peers(axis).line
    assert got == want


def test_composed_spans_and_a_process_holding_no_block_is_refused():
    """(1, 2, 2) over 2 processes: tp spans them, sp lies inside each;
    (1, 3, 4) over 2 processes is admitted by the divisibility rule but a
    process's 6 workers are no block of the mesh, which ``axis_span``
    refuses."""
    topo = Topology(4, CPU, process_index=1, process_count=2,
                    axis_names=("dp", "tp", "sp"), mesh_shape=(1, 2, 2))
    tp, sp = topo.axis_span("tp"), topo.axis_span("sp")
    assert (tp.start, tp.count, tp.line, tp.local) == (1, 1, (0, 1), False)
    assert (sp.start, sp.count, sp.line, sp.local) == (0, 2, (1,), True)
    assert topo.peers("tp").line == (1,)
    assert topo.peers("sp").line == (0, 1)
    odd = Topology(12, CPU, process_count=2, axis_names=("dp", "tp", "sp"),
                   mesh_shape=(1, 3, 4))
    with pytest.raises(ValueError, match="do not form a block"):
        odd.axis_span("sp")


def test_a_local_span_is_the_stacked_path():
    """On a span the process holds whole, the hop is ``torch.roll`` and
    the ring and Ulysses give the stacked results bit for bit."""
    from mpit_tpu_torch.comm.collectives import ring_hop
    from mpit_tpu_torch.ops.ring_attention import ring_attention
    from mpit_tpu_torch.ops.ulysses import ulysses_attention

    span = AxisSpan((0,), ((0,),), "sp", 4, 0, 4)
    a = torch.randn(4, 2, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(ring_hop(a, 1, span), torch.roll(a, 1, 0))
    q, k, v = (torch.randn(4, 2, 8, 4, 8, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    for fn in (ring_attention, ulysses_attention):
        assert torch.equal(fn(q, k, v, causal=True, span=span), fn(q, k, v, causal=True))


# -------------------------------------------- the collectives, 2 processes

_SCRIPT = """
import json, sys
import torch
sys.path.insert(0, {repo!r})
import mpit_tpu_torch as m
from mpit_tpu_torch.comm import collectives as c
from mpit_tpu_torch.comm.topology import AxisSpan

topo = m.init(num_workers=1, device="cpu")
p = topo.process_index
out = {{}}
gen = torch.Generator().manual_seed(0)
for count in (1, 2):
    for dtype in (torch.float32, torch.bfloat16):
        full = torch.randn(2 * count, 3, 5, generator=gen).to(dtype)
        cot = torch.randn(2 * count, 3, 5, generator=gen).to(dtype)
        mine = slice(p * count, (p + 1) * count)
        span = AxisSpan((0, 1), ((0, 1),), "sp", 2 * count, p * count, count)
        for shift in sorted({{1, -1, count, -count}}):
            a = full[mine].clone().requires_grad_()
            got = c.ring_hop(a, shift, span)
            (grad,) = torch.autograd.grad(got, a, cot[mine])
            # under torch.func too, as the trainers take gradients
            fgrad = torch.func.vjp(lambda t: c.ring_hop(t, shift, span), full[mine])[1](
                cot[mine])[0]
            key = f"hop c{{count}} {{str(dtype)[6:]}} {{shift:+d}}"
            out[key] = [torch.equal(got, torch.roll(full, shift, 0)[mine]),
                        torch.equal(grad, torch.roll(cot, -shift, 0)[mine]),
                        torch.equal(fgrad, grad)]
# all-to-all: row j to process j, its own inverse in the backward
full = torch.randn(2, 2, 4, generator=gen)  # (source, destination, ...)
span = AxisSpan((0, 1), ((0, 1),), "sp", 2, p, 1)
a = full[p].clone().requires_grad_()
got = c.line_all_to_all(a, span)
(grad,) = torch.autograd.grad(got, a, got.detach() * 3)
out["all_to_all"] = [torch.equal(got, full[:, p]), torch.equal(grad, a.detach() * 3)]
# gather: every process's stack in line order; the backward keeps its rows
a = full[p].clone().requires_grad_()
got = c.line_gather(a, span)
cot = torch.randn(4, 4, generator=torch.Generator().manual_seed(5))
(grad,) = torch.autograd.grad(got, a, cot)
out["gather"] = [torch.equal(got, full.reshape(4, 4)), torch.equal(grad, cot[2 * p:2 * p + 2])]
# "f": the identity, its backward the sum over the line
a = full[0].clone().requires_grad_()
got = c.line_sum_grad(a, span)
(grad,) = torch.autograd.grad(got, a, full[1] * (p + 1))
out["f"] = [torch.equal(got, full[0]), torch.equal(grad, full[1] + full[1] * 2)]
json.dump(out, open(sys.argv[1] + f".rank{{p}}.json", "w"))
m.finalize()
"""


@pytest.fixture(scope="module")
def collectives_across(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("hop")
    script = tmp / "across.py"
    script.write_text(_SCRIPT.format(repo=REPO))
    r = _launch(2, [str(script), str(tmp / "out")])
    assert r.returncode == 0, r.stdout + r.stderr
    return [json.load(open(tmp / f"out.rank{i}.json")) for i in range(2)]


@pytest.mark.parametrize("count", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_ring_hop_across_two_processes_is_torch_roll(count, dtype, collectives_across):
    """A ring of ``2·count`` blocks, ``count`` in each of 2 gloo processes:
    for each shift (±1, ±count) the hop's output is ``torch.roll`` of the
    one-process stack at this process's blocks and its gradient the
    reverse roll of the cotangent, bit for bit, by ``autograd.grad`` and
    by ``torch.func.vjp`` alike."""
    for out in collectives_across:
        keys = [k for k in out if k.startswith(f"hop c{count} {dtype} ")]
        assert len(keys) == (2 if count == 1 else 4)
        for k in keys:
            assert out[k] == [True, True, True], k


@pytest.mark.parametrize("name", ["all_to_all", "gather", "f"])
def test_the_line_exchanges_across_two_processes(name, collectives_across):
    """``line_all_to_all`` (its own inverse), ``line_gather`` (the
    backward keeps this process's rows) and ``line_sum_grad`` (the
    identity whose backward sums over the line), bit for bit."""
    for out in collectives_across:
        assert all(out[name]), (name, out[name])


# ------------------------------------------------- C10: moe-sync checkpoint

def _moe_trainer(workers):
    from mpit_tpu_torch.models import TransformerLM
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import MoEParallelTrainer

    # multihost_sync.py --algo moe's model and optimizer
    model = TransformerLM(31, num_layers=2, d_model=32, num_heads=4, max_len=16,
                          compute_dtype=torch.float32, moe_experts=8, moe_axis="dp",
                          moe_top_k=2, moe_capacity_factor=1.5, moe_balance_weight=0.1,
                          moe_zloss_weight=0.01, device="cpu")
    return MoEParallelTrainer(model, SGD(0.2, momentum=0.9), Topology(workers, CPU))


@pytest.fixture(scope="module")
def moe_two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    script = os.path.join(REPO, "mpit_tpu_torch", "examples", "multihost_sync.py")
    r = _launch(2, [script, "--algo", "moe", "--steps", "3", "--device", "cpu",
                    "--local-devices", "4", "--ckpt-dir", str(tmp / "ck"),
                    "--out", str(tmp / "two")])
    assert r.returncode == 0, r.stdout + r.stderr
    return tmp, [json.load(open(tmp / f"two.rank{i}.json")) for i in range(2)]


def test_a_two_process_moe_checkpoint_round_trips_bit_for_bit(moe_two):
    """``multihost_sync.py --algo moe --ckpt-dir`` over 2 gloo ranks × 4
    workers (each rank holding 4 of the 8 experts) runs (the refusal is
    gone), both ranks report the same losses, and each rank's restored
    state, gathered, equals the trained one bit for bit: each rank gets its
    own experts back."""
    _, ranks = moe_two
    assert [m["num_workers"] for m in ranks] == [8, 8]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert all(m["ckpt_roundtrip"] is True for m in ranks)


def test_the_moe_checkpoint_holds_every_expert_as_one_process_writes_it(moe_two, tmp_path):
    """The file holds all 8 experts and their momentum traces; restored
    into a one-process world of the same 8 workers and saved again, its
    bytes come back unchanged (it is the one-process checkpoint of that
    state); a process of the two cut from it holds its own experts."""
    tmp, _ = moe_two
    path = os.path.join(tmp, "ck", "ckpt_00000003.msgpack")
    raw = open(path, "rb").read()
    sd = ckpt.msgpack_restore(raw)
    for tree in (sd["params"], sd["opt_state"]["0"]["trace"]):
        for leaf in ("moe_w_up", "moe_b_up", "moe_w_down", "moe_b_down"):
            assert np.asarray(tree["Block_1"][leaf]).shape[0] == 8
    trainer = _moe_trainer(8)
    state, step = ckpt.restore_checkpoint(str(tmp / "ck"),
                                          trainer.init_state(torch.Generator().manual_seed(1)))
    assert step == 3 and state.step == 3
    again = ckpt.save_checkpoint(str(tmp_path), state, step=3)
    assert open(again, "rb").read() == raw
    from mpit_tpu_torch.parallel.moe import MoETrainState

    assert MoETrainState.process_cut(("opt_state", 0, "trace", "Block_0", "moe_w_up")) == 0
    assert MoETrainState.process_cut(("params", "Block_0", "moe_router")) is None


def test_a_restore_cuts_each_process_its_own_experts(moe_two, monkeypatch):
    """Restored as process 1 of 2 (its template holding experts 4..7), the
    expert leaves and their traces are the file's experts 4..7 and every
    other leaf is whole; a file holding too few experts is refused."""
    # the submodule (the package re-exports a function of its name)
    topology_mod = sys.modules["mpit_tpu_torch.comm.topology"]
    tmp, _ = moe_two
    sd = ckpt.msgpack_restore(open(os.path.join(tmp, "ck", "ckpt_00000003.msgpack"),
                                   "rb").read())
    monkeypatch.setattr(topology_mod, "_topology",
                        Topology(8, CPU, process_index=1, process_count=2))
    trainer = _moe_trainer(8)
    template = trainer.init_state(torch.Generator().manual_seed(1))
    assert template.params["Block_0"]["moe_w_up"].shape[0] == 4
    state = ckpt.state_from_state_dict(template, sd)
    from mpit_tpu_torch.utils.params import tree_leaves, tree_leaves_with_path

    for want, got in ((sd["params"], state.params),
                      (sd["opt_state"]["0"]["trace"], state.opt_state[0].trace)):
        pairs = tree_leaves_with_path(got)
        assert len(pairs) == len(tree_leaves(want)) == 2 * 11 + 4
        for (path, g), w in zip(pairs, tree_leaves(want)):
            w = np.asarray(w)
            cut = path[-1].startswith("moe_") and path[-1] != "moe_router"
            np.testing.assert_array_equal(g.numpy(), w[4:] if cut else w)
    short = dict(sd, params=dict(sd["params"], Block_0=dict(
        sd["params"]["Block_0"], moe_w_up=np.asarray(sd["params"]["Block_0"]["moe_w_up"])[:4])))
    with pytest.raises(ValueError, match="shares"):
        ckpt.state_from_state_dict(template, short)
