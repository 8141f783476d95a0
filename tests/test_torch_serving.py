"""The port's continuous-batching servers against the JAX package's, on the CPU.

The same requests (prompts, budgets, keys, per-request rules) go to the
reference's ``Server``/``RNNServer`` and the port's; every result must be
equal to the reference's and to the port's own solo call
(``generate_fast``/``generate_rnn``), under fixed schedules and under
schedules drawn from numpy seeds in the shape of the reference's
``test_random_scheduling_preserves_parity`` (submit, step and cancel ops
over 1-3 slots and 1-4 tick segments). The obs journal's lifecycle
records come in the reference's order.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models import RNNServer as JaxRNNServer
from mpit_tpu.models import Server as JaxServer
from mpit_tpu.models.lstm import LSTMLM as JaxLSTM
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu.obs.core import ObsConfig as JaxObsConfig
from mpit_tpu_torch import random as jrandom
from mpit_tpu_torch.convert import from_flax
from mpit_tpu_torch.models import (
    RNNServer,
    Server,
    generate_fast,
    generate_rnn,
    serving,
)
from mpit_tpu_torch.models.layers import matmul_rows
from mpit_tpu_torch.models.lstm import LSTMLM
from mpit_tpu_torch.models.transformer import TransformerLM
from mpit_tpu_torch.obs.core import ObsConfig
from mpit_tpu_torch.utils.params import tree_map

V, T = 17, 64
CPU = dict(device="cpu")
REQS = [  # (prompt, max_new): unequal lengths and budgets, the reference's
    ([3, 1, 4, 1, 5], 9),
    ([2], 14),
    ([7, 7, 7], 5),
    ([9, 8, 7, 6, 5, 4], 11),
    ([1, 2], 3),
]
SAMPLED = dict(temperature=0.8, top_k=7, top_p=0.9)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and small CPU ops oversubscribed across all of
    them run many times slower. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(layers, d, heads, seed):
    jm = JaxLM(vocab_size=V, num_layers=layers, d_model=d, num_heads=heads, max_len=T,
               compute_dtype=jnp.float32)
    pm = TransformerLM(V, num_layers=layers, d_model=d, num_heads=heads, max_len=T,
                       compute_dtype=torch.float32, device="cpu")
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, pm, params, from_flax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def lm():
    return _pair(2, 32, 4, 0)


@pytest.fixture(scope="module")
def draft():
    return _pair(1, 16, 2, 11)


@pytest.fixture(scope="module")
def lstm():
    jm = JaxLSTM(vocab_size=V, embed_dim=12, hidden=16, num_layers=2,
                 compute_dtype=jnp.float32)
    pm = LSTMLM(vocab_size=V, embed_dim=12, hidden=16, num_layers=2,
                compute_dtype=torch.float32, device="cpu")
    params = jax.jit(jm.init)(jax.random.key(3), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, pm, params, from_flax(jax.tree.map(np.asarray, params), device="cpu")


def _both(jsrv, tsrv, reqs, key0=100, step_after=None):
    """Submit ``reqs`` to both servers with keys ``key0 + i`` (one
    scheduling step after the ``step_after``-th), drain both."""
    for i, (prompt, mn, *rule) in enumerate(reqs):
        over = rule[0] if rule else {}
        jsrv.submit(prompt, mn, rng=jax.random.key(key0 + i), **over)
        tsrv.submit(prompt, mn, rng=jrandom.key(key0 + i), **over)
        if i == step_after:
            jsrv.step()
            tsrv.step()
    return jsrv.drain(), tsrv.drain()


@pytest.mark.parametrize("rule", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_server_equals_jax_server_and_solo_calls(lm, rule):
    jm, pm, p, tp = lm
    want, got = _both(JaxServer(jm, p, max_batch=2, segment=3, **rule),
                      Server(pm, tp, max_batch=2, segment=3, **rule, **CPU),
                      REQS, step_after=1)
    assert got == want
    for i, (prompt, mn) in enumerate(REQS):
        assert got[i] == generate_fast(pm, tp, prompt, mn, rng=jrandom.key(100 + i),
                                       **rule, **CPU), i


def test_per_request_rules_and_prefix_equal_jax(lm):
    jm, pm, p, tp = lm
    rules = [dict(temperature=0.5, top_p=0.95), dict(temperature=1.3), dict(top_p=0.6),
             {}, {}]
    reqs = [(q, mn, r) for (q, mn), r in zip(REQS, rules)]
    kw = dict(temperature=0.9, top_p=0.8)
    want, got = _both(JaxServer(jm, p, max_batch=2, segment=3, **kw),
                      Server(pm, tp, max_batch=2, segment=3, **kw, **CPU), reqs, 200)
    assert got == want
    for i, (q, mn, r) in enumerate(reqs):
        assert got[i] == generate_fast(pm, tp, q, mn, rng=jrandom.key(200 + i),
                                       **{**kw, **r}, **CPU)
    prefix = [5, 4, 3, 2, 1, 2, 3, 4, 5, 6, 7, 8]
    kw = dict(temperature=0.8, top_k=5)
    want, got = _both(JaxServer(jm, p, max_batch=2, segment=4, prefix=prefix, **kw),
                      Server(pm, tp, max_batch=2, segment=4, prefix=prefix, **kw, **CPU),
                      REQS[:4], 300)
    assert got == want
    for i, (q, mn) in enumerate(REQS[:4]):
        assert got[i] == generate_fast(pm, tp, prefix + q, mn, rng=jrandom.key(300 + i),
                                       **kw, **CPU)


def test_spec_server_equals_jax_and_solo_greedy(lm, draft):
    jm, pm, p, tp = lm
    jd, pd, dp, tdp = draft
    want, got = _both(
        JaxServer(jm, p, max_batch=2, draft_model=jd, draft_params=dp, spec_k=3,
                  spec_rounds=2),
        Server(pm, tp, max_batch=2, draft_model=pd, draft_params=tdp, spec_k=3,
               spec_rounds=2, **CPU),
        REQS[:4], step_after=2)
    assert got == want
    for i, (q, mn) in enumerate(REQS[:4]):
        assert got[i] == generate_fast(pm, tp, q, mn, **CPU)
    # a request ending right at the max_len - spec_k frontier
    srv = Server(pm, tp, max_batch=2, draft_model=pd, draft_params=tdp, spec_k=4,
                 spec_rounds=4, **CPU)
    prompt = [(i * 3 + 1) % V for i in range(40)]
    rid = srv.submit(prompt, T - 44)
    assert srv.drain()[rid] == generate_fast(pm, tp, prompt, T - 44, **CPU)


def test_rnn_server_equals_jax_and_solo(lstm):
    jm, pm, p, tp = lstm
    kw = dict(temperature=0.9, top_k=5)
    want, got = _both(JaxRNNServer(jm, p, max_batch=2, segment=3, **kw),
                      RNNServer(pm, tp, max_batch=2, segment=3, **kw, **CPU),
                      REQS[:4], 400, step_after=2)
    assert got == want
    for i, (q, mn) in enumerate(REQS[:4]):
        assert got[i] == generate_rnn(pm, tp, q, mn, rng=jrandom.key(400 + i), **kw, **CPU)
    prefix = [3, 1, 4, 1, 5, 9, 2, 6]
    srv = RNNServer(pm, tp, max_batch=2, segment=8, prefix=prefix, **CPU)
    a = srv.submit([7, 7], 150)  # far past any transformer-style horizon
    assert srv.drain()[a] == generate_rnn(pm, tp, prefix + [7, 7], 150, **CPU)
    with pytest.raises(ValueError, match="carry-decode"):
        RNNServer(TransformerLM(V, num_layers=1, d_model=16, num_heads=2, max_len=T,
                                device="cpu"), None, **CPU)


@pytest.mark.parametrize("n", [1, 3, 8, 11])
def test_padded_product_equals_each_row_alone(n):
    """ROADMAP C8: ``matmul_rows`` runs a product at a multiple of
    ``ROW_BLOCK`` rows. Each row of it equals that row's product computed
    alone bit for bit, and the product is the unpadded one within f32
    rounding; the same holds for the batched form the cached attention
    uses."""
    rng = np.random.default_rng(n)
    a = torch.from_numpy(rng.normal(size=(n, 48)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(48, 40)).astype(np.float32))
    got = matmul_rows(a, b)
    assert got.shape == (n, 40)
    for r in range(n):
        assert torch.equal(got[r], matmul_rows(a[r:r + 1], b)[0]), r
    torch.testing.assert_close(got, a @ b, rtol=2e-6, atol=2e-5)
    q = torch.from_numpy(rng.normal(size=(2, 3, n, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 3, 16, 24)).astype(np.float32))
    got = matmul_rows(q, k)
    assert got.shape == (2, 3, n, 24)
    for r in range(n):
        assert torch.equal(got[:, :, r], matmul_rows(q[:, :, r:r + 1], k)[:, :, 0]), r
    torch.testing.assert_close(got, q @ k, rtol=2e-6, atol=2e-5)


@pytest.mark.parametrize("rule", [{}, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("max_batch", [3, 11])
def test_server_blocks_equal_solo_calls(lm, rule, max_batch):
    """ROADMAP C8: a server below one ``ROW_BLOCK`` of slots (3, whose
    ticks run padded) and above one (11: 16 slots, two blocks) serves
    every request equal to its solo call."""
    _, pm, _, tp = lm
    reqs = REQS + [([(7 * i + 3) % V for i in range(1 + n % 6)], 4 + n % 5)
                   for n in range(7)]
    srv = Server(pm, tp, max_batch=max_batch, segment=3, **rule, **CPU)
    rids = [srv.submit(q, mn, rng=jrandom.key(500 + i)) for i, (q, mn) in enumerate(reqs)]
    got = srv.drain()
    for i, ((q, mn), rid) in enumerate(zip(reqs, rids)):
        assert got[rid] == generate_fast(pm, tp, q, mn, rng=jrandom.key(500 + i),
                                         **rule, **CPU), i


def test_servers_in_threads_keep_their_own_weights(lm):
    """Servers built on one model object, each with weights of its own and
    each in a thread of its own (a fleet's replicas), serve every request
    as the solo call with those weights: ``Model.apply`` swaps parameters
    on the module objects while it runs, so each server runs module
    objects of its own."""
    import sys
    import threading

    _, pm, _, tp = lm
    bumped = tree_map(lambda a: a + 1e-2, tp)
    weights = [tp, bumped] * 3
    reqs = REQS[:3]
    got = [None] * len(weights)

    def serve(i):
        srv = Server(pm, weights[i], max_batch=2, segment=2, **CPU)
        rids = [srv.submit(q, mn) for q, mn in reqs]
        out = srv.drain()
        got[i] = [out[r] for r in rids]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=serve, args=(i,)) for i in range(len(weights))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for w, rows in zip(weights, got):
        assert rows == [generate_fast(pm, w, q, mn, **CPU) for q, mn in reqs]


def _schedule(seed):
    """Ops in the shape of the reference's hypothesis strategy: 3-10 of
    submit (prompt length 1-7, budget 1-8, temperature None/0.5/1.2),
    step, cancel (id 0-9); 1-3 slots, 1-4 tick segments."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(rng.integers(3, 11)):
        kind = rng.integers(3)
        if kind == 0:
            ops.append(("submit", int(rng.integers(1, 8)), int(rng.integers(1, 9)),
                        [None, 0.5, 1.2][rng.integers(3)]))
        elif kind == 1:
            ops.append(("step",))
        else:
            ops.append(("cancel", int(rng.integers(0, 10))))
    return ops, int(rng.integers(1, 4)), int(rng.integers(1, 5))


def _replay(srv, ops, make_key):
    live, cancelled = {}, set()
    for op in ops:
        if op[0] == "submit":
            _, plen, mn, temp = op
            prompt = [(plen * 13 + i * 7) % V for i in range(plen)]
            over = {} if temp is None else {"temperature": temp}
            rid = srv.submit(prompt, mn, rng=make_key(plen * 100 + mn), **over)
            live[rid] = (prompt, mn, temp)
        elif op[0] == "step":
            srv.step()
        elif srv.cancel(op[1]):
            cancelled.add(op[1])
    return live, cancelled, srv.drain()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_scheduling_preserves_parity(lm, seed):
    jm, pm, p, tp = lm
    ops, max_batch, segment = _schedule(seed)
    _, _, want = _replay(JaxServer(jm, p, max_batch=max_batch, segment=segment,
                                   **SAMPLED), ops, jax.random.key)
    live, cancelled, got = _replay(
        Server(pm, tp, max_batch=max_batch, segment=segment, **SAMPLED, **CPU), ops,
        jrandom.key)
    assert got == want
    for rid, (prompt, mn, temp) in live.items():
        if rid in cancelled:
            assert rid not in got
            continue
        rule = {**SAMPLED, **({} if temp is None else {"temperature": temp})}
        assert got[rid] == generate_fast(pm, tp, prompt, mn,
                                         rng=jrandom.key(len(prompt) * 100 + mn),
                                         **rule, **CPU), (rid, ops)


def _lifecycle(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [(r["ev"], r.get("rid"), r.get("slot"), r.get("reason"), r.get("gen"),
             r.get("occupied"), r.get("seg"), r.get("k"), r.get("bucket"))
            for r in recs if "ev" in r]


def test_obs_journal_records_the_reference_lifecycle(lm, tmp_path):
    jm, pm, p, tp = lm
    jsrv = JaxServer(jm, p, max_batch=2, segment=3,
                     obs=JaxObsConfig(dir=str(tmp_path / "jax")))
    tsrv = Server(pm, tp, max_batch=2, segment=3,
                  obs=ObsConfig(dir=str(tmp_path / "port")), **CPU)
    for srv in (jsrv, tsrv):
        for prompt, mn in REQS:
            srv.submit(prompt, mn, slo_ms=5000.0)
        srv.step()
        srv.cancel(4)
        srv.drain()
        srv.close()
    want = _lifecycle(tmp_path / "jax" / "obs_rank0.jsonl")
    got = _lifecycle(tmp_path / "port" / "obs_rank0.jsonl")
    assert got == want
    kinds = [r[0] for r in got]
    assert kinds[:5] == ["req_enqueue"] * 5 and "req_cancel" in kinds
    assert {"prefill", "req_admit", "req_first_token", "segment", "req_finish"} <= set(kinds)
    assert os.path.isdir(tmp_path / "port")


def test_poisoning_cancel_eos_and_segment_caps(lm, monkeypatch):
    jm, pm, p, tp = lm
    srv = Server(pm, tp, max_batch=1, segment=4, **CPU)
    a = srv.submit(*REQS[4])
    b = srv.submit(*REQS[0])
    while a not in srv._results:
        srv.step()

    def boom(*args, **kw):
        raise RuntimeError("simulated mid-segment failure")

    monkeypatch.setattr(serving, "_serve_segment", boom)
    with pytest.raises(RuntimeError, match="simulated"):
        srv.step()
    monkeypatch.undo()
    for call in (srv.step, srv.drain, lambda: srv.submit(*REQS[1])):
        with pytest.raises(RuntimeError, match="poisoned"):
            call()
    done = srv.results()
    assert done[a] == generate_fast(pm, tp, *REQS[4], **CPU) and b not in done

    srv = Server(pm, tp, max_batch=1, segment=4, **CPU)
    x, y, z = (srv.submit(*r) for r in REQS[:3])
    assert srv.cancel(y)
    srv.step()
    assert srv.cancel(x)
    got = srv.drain()
    assert set(got) == {z} and got[z] == generate_fast(pm, tp, *REQS[2], **CPU)
    assert not srv.cancel(z) and not srv.cancel(999) and srv.pending == 0

    probe = generate_fast(pm, tp, REQS[0][0], 8, **CPU)
    eos = probe[len(REQS[0][0]) + 1]
    srv = Server(pm, tp, max_batch=1, segment=4, eos_id=eos, **CPU)
    rid = srv.submit(REQS[0][0], 8)
    assert srv.drain()[rid] == generate_fast(pm, tp, REQS[0][0], 8, eos_id=eos, **CPU)

    segs, prefills = [], []
    real_seg, real_pre = serving._serve_segment, serving._prefill_rows
    monkeypatch.setattr(serving, "_serve_segment",
                        lambda m, seg, *a, **k: segs.append(seg) or real_seg(m, seg, *a, **k))
    monkeypatch.setattr(serving, "_prefill_rows",
                        lambda *a, **k: prefills.append(1) or real_pre(*a, **k))
    srv = Server(pm, tp, max_batch=4, segment=32, **CPU)
    for prompt in ([3, 1, 4], [2, 7], [5, 5], [1]):
        srv.submit(prompt, 4)
    srv.drain()
    assert segs and max(segs) <= 4  # capped at the largest remaining budget
    assert len(prefills) == 3  # one per prompt bucket (4, 2 for two prompts, 1)
    assert srv.install_weights(tp) == 1 and srv.weights_version == 1
    with pytest.raises(ValueError, match="advance"):
        srv.install_weights(tp, version=1)


def test_validation_and_reuse(lm, draft):
    jm, pm, p, tp = lm
    jd, pd, dp, tdp = draft
    for bad, match in ((dict(max_batch=0), "max_batch"), (dict(segment=0), "segment"),
                       (dict(temperature=0.5, draft_model=pd, draft_params=tdp), "greedy"),
                       (dict(prefix=[1, 2], draft_model=pd, draft_params=tdp), "prefix"),
                       (dict(prefix=[999]), "vocab_size")):
        with pytest.raises(ValueError, match=match):
            Server(pm, tp, **bad, **CPU)
    with pytest.raises(ValueError, match="server-level mode"):
        Server(pm, tp, **CPU).submit([1], 2, temperature=0.7)
    with pytest.raises(ValueError, match="nucleus"):
        Server(pm, tp, temperature=0.8, **CPU).submit([1], 2, top_p=0.5)
    with pytest.raises(ValueError, match="headroom"):
        Server(pm, tp, draft_model=pd, draft_params=tdp, **CPU).submit(
            list(range(10)), T - 13)
    with pytest.raises(ValueError, match="prefix"):
        Server(pm, tp, prefix=[1, 2, 3], **CPU).submit(list(range(10)), T - 10)
    srv = Server(pm, tp, max_batch=2, segment=4, **CPU)
    assert srv.drain() == {}
    a = srv.submit([1, 2], 3)
    first = srv.drain()
    b = srv.submit([1, 2], 3)
    assert srv.drain()[b] == first[a]
