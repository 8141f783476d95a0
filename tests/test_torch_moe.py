"""The port's mixture of experts (``ops/moe.py``, the MoE FFN of
``models/transformer.py``, ``parallel/moe.py``, ``--algo moe-sync``)
against the JAX package's, on the 8-device CPU mesh.

The reference's 15 cases of ``tests/test_moe.py`` run on the port's
objects (the sharded op over 8 stacked workers against per-token and
per-shard ground truth, the aux statistics, the balance loss, gradients,
W-invariance, the refusals, ``clip_norm``), then the parity cases: the op,
its routing tensors and the dense reference against the reference's on
the same numpy-seeded inputs; a tie; the MoE model against flax; a
trainer step against the reference's trainer with both aux weights
nonzero; and 2 gloo processes × 4 workers against 1 × 8 (``run()`` of
``--algo moe-sync`` is in ``tests/test_torch_driver.py``).

Tolerances: the reference's own (2e-4 on the op against per-token or
per-shard truth, 1e-5 on aux statistics, 1e-4 / 3e-4 on trainer losses /
params); against the reference's arrays the same limits, with routing
(dispatch and dropped) equal exactly and the gates of combine within a few
ulps (``GATE_TOL``).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conftest import moe_dense_per_shard, run_moe_sharded
from mpit_tpu.ops import init_moe_params as ref_init
from mpit_tpu.ops import moe as ref_moe
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import TransformerLM
from mpit_tpu_torch.models.transformer import aggregate_moe_losses
from mpit_tpu_torch.ops import moe
from mpit_tpu_torch.parallel import MoEParallelTrainer
from mpit_tpu_torch.utils.params import tree_leaves

EP, E, D, F = 8, 16, 16, 32
B, T = 8, 12  # one batch row per worker
CPU = torch.device("cpu")
OP_TOL = dict(rtol=2e-4, atol=2e-4)
AUX_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=3e-4, atol=3e-4)
# the gates in combine: the router's f32 product and softmax round in
# another order than XLA's, a few ulps (the slots, dispatch and the drop
# statistic are equal exactly)
GATE_TOL = dict(rtol=1e-6, atol=1e-7)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(seed=0):
    """The reference's params (numpy) and activations, and the port's."""
    params = jax.tree.map(np.asarray, ref_init(jax.random.key(seed), D, F, E))
    h = np.random.default_rng(seed).standard_normal((B, T, D)).astype(np.float32)
    return params, h, {k: torch.tensor(v) for k, v in params.items()}


def _sharded(tp, h, cf, top_k=1, with_aux=False):
    """The port's op over EP stacked workers, one batch row each."""
    out = moe.moe_ffn(tp, torch.from_numpy(h).reshape(EP, B // EP, T, D),
                      capacity_factor=cf, top_k=top_k, with_aux=with_aux)
    if with_aux:
        return out[0].reshape(B, T, D), out[1]
    return out.reshape(B, T, D)


def _per_shard(tp, h, cf, top_k=1):
    per = B // EP
    return torch.cat([moe.moe_ffn_dense_reference(
        tp, torch.from_numpy(h[i * per:(i + 1) * per]), capacity_factor=cf, top_k=top_k)
        for i in range(EP)])


def _expert(tp, e, x):
    return moe._expert_ffn(tp["w_up"][e], tp["b_up"][e], tp["w_down"][e],
                           tp["b_down"][e], x[None])[0]


# ----------------------------------------------- the reference's op cases

class TestMoE:
    def test_matches_per_token_expert_choice_ample_capacity(self):
        """No drops: every token gets exactly gate × its expert's FFN."""
        _, h, tp = _setup()
        got = _sharded(tp, h, float(E))
        h2 = torch.from_numpy(h).reshape(-1, D)
        probs = torch.softmax(h2 @ tp["router"], -1)
        expert = probs.argmax(-1)
        want = torch.stack([probs[i, expert[i]] * _expert(tp, expert[i], h2[i])
                            for i in range(len(h2))]).reshape(B, T, D)
        torch.testing.assert_close(got, want, **OP_TOL)

    def test_matches_dense_reference_with_drops(self):
        """Tight capacity: per-shard overflow equals the dense reference
        run shard by shard with the same local token count, and drops
        happened."""
        _, h, tp = _setup(seed=1)
        got = _sharded(tp, h, 0.5)
        torch.testing.assert_close(got, _per_shard(tp, h, 0.5), **OP_TOL)
        assert not torch.allclose(got, _sharded(tp, h, float(E)))

    def test_top2_matches_per_token_ample_capacity(self):
        """Top-2: each token mixes its two experts by the renormalized
        gates (the GShard rule)."""
        _, h, tp = _setup(seed=3)
        got = _sharded(tp, h, float(E), top_k=2)
        h2 = torch.from_numpy(h).reshape(-1, D)
        probs = torch.softmax(h2 @ tp["router"], -1)
        want = torch.zeros_like(h2)
        for i in range(len(h2)):
            idx = torch.argsort(-probs[i])[:2]
            g = probs[i][idx] / probs[i][idx].sum()
            for gw, ex in zip(g, idx):
                want[i] += gw * _expert(tp, ex, h2[i])
        torch.testing.assert_close(got, want.reshape(B, T, D), **OP_TOL)

    def test_top2_matches_dense_reference_with_drops(self):
        """Tight capacity, top-2: per shard, first choices claim slots
        before any second choice."""
        _, h, tp = _setup(seed=4)
        got = _sharded(tp, h, 0.75, top_k=2)
        torch.testing.assert_close(got, _per_shard(tp, h, 0.75, top_k=2), **OP_TOL)
        assert not torch.allclose(got, _sharded(tp, h, float(E), top_k=2))

    def test_aux_sharded_matches_dense_global(self):
        """The worker-averaged aux of the sharded op equals the dense aux
        of the whole batch (ample capacity)."""
        _, h, tp = _setup(seed=5)
        _, got = _sharded(tp, h, float(E), top_k=2, with_aux=True)
        _, want = moe.moe_ffn_dense_reference(tp, torch.from_numpy(h), float(E), 2,
                                              with_aux=True)
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(want[k]), **AUX_TOL, err_msg=k)

    def test_balance_loss_detects_and_fixes_skew(self):
        """A router collapsed onto expert 0 scores a high balance loss and
        drops tokens; descending the balance loss alone re-spreads it."""
        _, h, tp = _setup(seed=6)
        tp = dict(tp)
        tp["router"] = tp["router"].clone()
        tp["router"][:, 0] = 5.0
        hh = torch.from_numpy(h)

        def aux_of(r):
            return moe.moe_ffn_dense_reference({**tp, "router": r}, hh, 1.5, 1,
                                               with_aux=True)[1]

        before = aux_of(tp["router"])
        assert float(before["balance"]) > 2.0
        assert float(before["dropped_frac"]) > 0.3
        r = tp["router"]
        for _ in range(250):
            r = r.detach().requires_grad_()
            (g,) = torch.autograd.grad(aux_of(r)["balance"], r)
            r = r - 2.0 * g
        after = aux_of(r.detach())
        assert float(after["balance"]) < float(before["balance"]) * 0.6
        assert float(after["dropped_frac"]) < float(before["dropped_frac"])

    def test_gradients_flow_to_local_experts(self):
        """The gradient through the all-to-all pair lands on the expert
        weights and the router (on the port's own ``init_moe_params``,
        whose leaves have the reference's names and shapes)."""
        params, h, _ = _setup(seed=2)
        tp = moe.init_moe_params(torch.Generator().manual_seed(2), D, F, E)
        assert {k: tuple(v.shape) for k, v in tp.items()} == {
            k: v.shape for k, v in params.items()}
        leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
        out = _sharded(leaves, h, float(E))
        g = torch.autograd.grad(out.square().mean(), [leaves["w_up"], leaves["router"]])
        assert float(g[0].abs().sum()) > 0 and float(g[1].abs().sum()) > 0


# ------------------------------------------ the reference's trainer cases

def _lm(axis="dp", experts=16, cf=16.0, **kw):
    return TransformerLM(31, num_layers=2, d_model=32, num_heads=4, max_len=16,
                         compute_dtype=torch.float32, moe_experts=experts, moe_axis=axis,
                         moe_capacity_factor=cf, device="cpu", **kw)


def _tokens(n=8, t=16, seed=0):
    x = np.random.default_rng(seed).integers(0, 31, (n, t)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _steps(w, steps=3, seed=0, params=None, clip_norm=None, opt=None, **kw):
    opt = opt if opt is not None else optim.SGD(0.1, momentum=0.9)
    tr = MoEParallelTrainer(_lm(**kw), opt, Topology(w, CPU), clip_norm=clip_norm)
    st = tr.init_state(torch.Generator().manual_seed(0), params=params)
    x, y = _tokens(seed=seed)
    out = []
    for _ in range(steps):
        st, m = tr.step(st, x, y)
        out.append((float(m["loss"]), float(m["moe_balance"])))
    return out, st, tr


class TestMoETrainer:
    def test_w_invariance_with_ample_capacity(self):
        """No drops: the W = 8 expert-sharded trajectory equals W = 1."""
        l8, s8, _ = _steps(8)
        l1, s1, _ = _steps(1)
        np.testing.assert_allclose(l8, l1, **LOSS_TOL)
        for a, b in zip(tree_leaves(s8.params), tree_leaves(s1.params), strict=True):
            torch.testing.assert_close(a, b, **PARAM_TOL)

    def test_w_invariance_top2_with_aux_losses(self):
        """Top-2 with the balance and z losses in the objective: the aux
        stats are averaged inside the op, so W = 8 and W = 1 optimize the
        same loss."""
        kw = dict(moe_top_k=2, moe_balance_weight=0.02, moe_zloss_weight=1e-3)
        l8, s8, _ = _steps(8, seed=3, **kw)
        l1, s1, _ = _steps(1, seed=3, **kw)
        np.testing.assert_allclose(l8, l1, **LOSS_TOL)
        for a, b in zip(tree_leaves(s8.params), tree_leaves(s1.params), strict=True):
            torch.testing.assert_close(a, b, **PARAM_TOL)

    def test_aux_metrics_reported(self):
        tr = MoEParallelTrainer(_lm(), optim.SGD(0.1), Topology(8, CPU))
        x, y = _tokens()
        _, m = tr.step(tr.init_state(torch.Generator().manual_seed(0)), x, y)
        assert {"moe_balance", "moe_zloss", "moe_dropped_frac"} <= set(m)
        assert float(m["moe_balance"]) >= 1.0 - 1e-3
        assert 0.0 <= float(m["moe_dropped_frac"]) <= 1.0

    def test_converges(self):
        tr = MoEParallelTrainer(_lm(cf=4.0), optim.SGD(0.1, momentum=0.9), Topology(8, CPU))
        x = (np.arange(8 * 16 * 2, dtype=np.int32) % 31).reshape(-1, 16)[:8]
        y = np.roll(x, -1, axis=1).astype(np.int32)
        st = tr.init_state(torch.Generator().manual_seed(1))
        losses = []
        for _ in range(40):
            st, m = tr.step(st, x, y)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] * 0.5, losses
        acc, _ = tr.evaluate(st, x, y)
        assert acc > 0.5
        # all 16 experts held whole on the card, 2 a worker
        assert st.params["Block_0"]["moe_w_up"].shape[0] == 16

    def test_cross_leaf_optimizer_rejected(self):
        """A global-norm clip chained into the optimizer couples leaves
        (the reference's probe, its message); Adam and SGD pass."""
        topo = Topology(8, CPU)
        for big in (1.0, 5e4):
            with pytest.raises(ValueError, match="ELEMENTWISE"):
                MoEParallelTrainer(
                    _lm(), optim.chain(optim.clip_by_global_norm(big), optim.SGD(0.1)), topo)
        MoEParallelTrainer(_lm(), optim.Adam(1e-3), topo)
        MoEParallelTrainer(_lm(), optim.SGD(0.1, momentum=0.9), topo)

    def test_validation(self):
        """The reference's refusals, word for word
        (``mpit_tpu/parallel/moe.py:102-118``)."""
        topo = Topology(8, CPU)
        dense = TransformerLM(31, max_len=16, device="cpu")
        with pytest.raises(ValueError, match="moe_experts > 0"):
            MoEParallelTrainer(dense, optim.SGD(0.1), topo)
        with pytest.raises(ValueError, match="worker axis"):
            MoEParallelTrainer(_lm(axis="ep"), optim.SGD(0.1), topo)
        with pytest.raises(ValueError, match="not divisible"):
            MoEParallelTrainer(_lm(experts=12), optim.SGD(0.1), topo)


class TestClipNorm:
    def test_clip_matches_optax_dense_and_w_invariant(self):
        """``clip_norm`` equals the chained global-norm clip on the dense
        model (``moe_axis=None``), at W = 1 and W = 8."""
        x, y = _tokens(seed=5)
        c = 0.5
        dense = _lm(axis=None)
        params = dense.init(torch.Generator().manual_seed(0))
        opt = optim.chain(optim.clip_by_global_norm(c), optim.SGD(0.1))
        st = opt.init(params)
        ref_losses, p = [], params
        from mpit_tpu_torch.parallel import common

        for _ in range(3):
            g, loss = common.autograd_value_and_grad(
                lambda q, a, b: common.cross_entropy_loss(dense.apply(q, a), b))(
                p, torch.from_numpy(x), torch.from_numpy(y))
            p, st = opt.update(p, g, st)
            ref_losses.append(float(loss))
        for w in (1, 8):
            got, s, _ = _steps(w, seed=5, params=params, clip_norm=c, opt=optim.SGD(0.1))
            np.testing.assert_allclose([g[0] for g in got], ref_losses, **LOSS_TOL)
            for a, b in zip(tree_leaves(s.params), tree_leaves(p), strict=True):
                torch.testing.assert_close(a, b, **PARAM_TOL)

    def test_clip_validation(self):
        with pytest.raises(ValueError, match="clip_norm"):
            MoEParallelTrainer(_lm(), optim.SGD(0.1), Topology(8, CPU), clip_norm=-1.0)


# ------------------------------------------------------- against the JAX package

@pytest.mark.parametrize("cf,top_k", [(0.5, 1), (float(E), 1), (0.75, 2), (float(E), 2)],
                         ids=["top1-drops", "top1-ample", "top2-drops", "top2-ample"])
def test_op_and_routing_match_the_reference(cf, top_k, topo8):
    """``moe_ffn`` over 8 stacked workers against the reference's under
    ``shard_map``; the dense reference per shard against the reference's;
    and each shard's dispatch, combine and dropped stat equal to the
    reference's ``_routing`` exactly."""
    params, h, tp = _setup(seed=7 + top_k)
    got = _sharded(tp, h, cf, top_k).numpy()
    np.testing.assert_allclose(got, run_moe_sharded(topo8, params, h, cf, top_k=top_k),
                               **OP_TOL)
    np.testing.assert_allclose(_per_shard(tp, h, cf, top_k).numpy(),
                               moe_dense_per_shard(params, h, cf, EP, top_k=top_k), **OP_TOL)
    tokens = T  # one row a worker
    cap = int(np.ceil(tokens * cf / E))
    for i in range(EP):
        want = ref_moe._routing(jnp.asarray(h[i]), jnp.asarray(params["router"]), E, cap,
                                top_k=top_k)
        port = moe._routing(torch.from_numpy(h[i]), tp["router"], E, cap, top_k=top_k)
        assert np.array_equal(port[0].numpy(), np.asarray(want[0]))
        np.testing.assert_allclose(port[1].numpy(), np.asarray(want[1]), **GATE_TOL)
        assert float(port[2]["dropped"]) == float(want[2]["dropped"])
    # the batched routing of all workers at once is each worker's own
    batched = moe._routing(torch.from_numpy(h), tp["router"], E, cap, top_k=top_k)
    alone = moe._routing(torch.from_numpy(h[3]), tp["router"], E, cap, top_k=top_k)
    assert torch.equal(batched[0][3], alone[0]) and torch.equal(batched[1][3], alone[1])


def test_a_tie_picks_the_lower_index_as_lax_top_k():
    """Two experts with equal scores: the lower index is the first choice,
    as ``lax.top_k`` orders a tie; routing against the reference's."""
    h = np.ones((4, D), np.float32)
    router = np.zeros((D, E), np.float32)
    router[:, 5] = router[:, 9] = 0.5  # experts 5 and 9 tie for every token
    want = ref_moe._routing(jnp.asarray(h), jnp.asarray(router), E, 8, top_k=2)
    got = moe._routing(torch.from_numpy(h), torch.from_numpy(router), E, 8, top_k=2)
    expert = moe._route(torch.from_numpy(h), torch.from_numpy(router), E, 8, 2)[0]
    assert expert.tolist() == [5] * 4 + [9] * 4  # first choices, then second
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **GATE_TOL)
    assert float(got[2]["f"][5]) == 1.0 and float(want[2]["f"][5]) == 1.0


def test_moe_model_matches_flax():
    """The MoE LM (dense reference path, ``moe_axis=None``) against flax:
    logits and every block's aux statistics (``sow("moe_losses")`` →
    ``with_aux=True``), the leaves carried by ``convert``."""
    from mpit_tpu.models.transformer import TransformerLM as JaxLM
    from mpit_tpu.models.transformer import aggregate_moe_losses as ref_agg

    kw = dict(num_layers=2, d_model=32, num_heads=4, max_len=16, moe_experts=8,
              moe_capacity_factor=1.0, moe_top_k=2)
    jm = JaxLM(vocab_size=31, compute_dtype=jnp.float32, **kw)
    x, _ = _tokens(n=4)
    params = jm.init(jax.random.key(0), jnp.asarray(x))["params"]
    want, mut = jm.apply({"params": params}, jnp.asarray(x), mutable=["moe_losses"])
    pm = TransformerLM(31, compute_dtype=torch.float32, device="cpu", **kw)
    host = jax.tree.map(np.asarray, params)
    tp = from_flax(host, device="cpu")
    assert sorted(tp["Block_0"]) == sorted(params["Block_0"])
    got, aux = pm.apply(tp, torch.from_numpy(x), with_aux=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **OP_TOL)
    ref_aux = ref_agg(mut["moe_losses"])
    for k, v in aggregate_moe_losses(aux).items():
        np.testing.assert_allclose(float(v), float(ref_aux[k]), **AUX_TOL, err_msg=k)
    # and back: the tree round-trips to the reference's arrays
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(to_flax(tp)), strict=True):
        assert np.array_equal(a, b)


def test_trainer_steps_match_the_reference_trainer(topo8):
    """Three steps of the expert-parallel trainer, top-2 with the balance
    and z weights both nonzero (large, so a wrong factor on their gradient
    shows), against the reference's on the 8-device mesh from the same
    init: losses, aux metrics, params and the evaluation."""
    from mpit_tpu.models.transformer import TransformerLM as JaxLM
    from mpit_tpu.parallel import MoEParallelTrainer as JaxMoE

    kw = dict(num_layers=2, d_model=32, num_heads=4, max_len=16, moe_experts=16,
              moe_capacity_factor=2.0, moe_top_k=2, moe_balance_weight=0.5,
              moe_zloss_weight=0.1)
    jt = JaxMoE(JaxLM(vocab_size=31, compute_dtype=jnp.float32, moe_axis="dp", **kw),
                optax.sgd(0.1, momentum=0.9), topo8, donate_state=False)
    x, y = _tokens(seed=3)
    js = jt.init_state(jax.random.key(0), x[:1])
    init = jax.tree.map(np.asarray, jax.device_get(js.params))
    pt = MoEParallelTrainer(TransformerLM(31, compute_dtype=torch.float32, moe_axis="dp",
                                          device="cpu", **kw),
                            optim.SGD(0.1, momentum=0.9), Topology(8, CPU))
    ps = pt.init_state(params=from_flax(init, device="cpu"))
    for _ in range(3):
        js, jm_ = jt.step(js, x, y)
        ps, pm_ = pt.step(ps, x, y)
        for k in ("loss", "moe_balance", "moe_zloss", "moe_dropped_frac"):
            np.testing.assert_allclose(float(pm_[k]), float(jm_[k]), **LOSS_TOL, err_msg=k)
    want = jax.tree.map(np.asarray, jax.device_get(js.params))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(to_flax(ps.params)), strict=True):
        np.testing.assert_allclose(b, a, **PARAM_TOL)
    acc, loss = pt.evaluate(ps, x, y)
    want_acc, want_loss = jt.evaluate(js, x, y)
    assert acc == pytest.approx(want_acc, abs=1e-6)
    assert loss == pytest.approx(want_loss, rel=1e-4)


def _launch(n, args, distributed=True):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MPIT_", "JAX_COORDINATOR"))}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "mpit_tpu_torch.launch", "-n", str(n)]
    if distributed:
        cmd.append("--jax-distributed")
    return subprocess.run([*cmd, *args], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=240)


def test_two_gloo_processes_of_four_workers_train_as_one_of_eight(tmp_path):
    """``multihost_sync.py --algo moe`` as 2 gloo ranks × 4 workers (each
    rank holding 4 of the 8 experts; the tokens and, in the backward,
    their cotangents cross the processes by ``all_to_all_single``) against
    1 process × 8: every step's loss equal on both ranks and within the
    f32 trajectory tolerance of ``tests/test_torch_dist.py`` of the
    single process's."""
    script = os.path.join(REPO, "mpit_tpu_torch", "examples", "multihost_sync.py")
    common = [script, "--algo", "moe", "--steps", "6", "--device", "cpu"]
    r = _launch(2, [*common, "--local-devices", "4", "--out", str(tmp_path / "two")])
    assert r.returncode == 0, r.stdout + r.stderr
    r1 = _launch(1, [*common, "--local-devices", "8", "--out", str(tmp_path / "one")],
                 distributed=False)
    assert r1.returncode == 0, r1.stdout + r1.stderr
    ranks = [json.load(open(tmp_path / f"two.rank{i}.json")) for i in range(2)]
    solo = json.load(open(tmp_path / "one.rank0.json"))
    assert [m["num_workers"] for m in ranks] == [8, 8]
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], solo["losses"], rtol=1e-4, atol=1e-4)
    assert solo["losses"][-1] < solo["losses"][0]
