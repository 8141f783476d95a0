"""A server's decode segments as CUDA graphs (``models/serving.py`` through
``parallel/capture.py`` ``GraphSet``), the counterpart of the reference's
``_serve_segment`` and ``_serve_spec_segment``, compiled once per static
shape over the donated resident cache.

On the CPU no graph is captured, so ``HostGraphs``, a test double of
``GraphSet``, runs each segment's (or speculative round's) body where a
graph would warm up, capture or replay it, and the server is told that
nothing stands in its way. What is held:

- the segment body over the static buffers and the resident tree (the
  clocks and an LSTM's carries copied back) gives the tokens and the
  resident cache bytes of ``capture=False``: greedy, sampled (per-request
  temperature and top-p), ``prefix=``, ``RNNServer`` and speculative; the
  resident tensors keep their storage, so each graph warms up once;
- a server on the CPU does not capture, says why, and ``capture=True``
  raises;
- a capturing server serves from weights of its own: a push is copied
  into them (their storage kept, the caller's tensors untouched) and
  gives the tokens of an eager server given the same push; a push of
  another shape or dtype raises;
- ``capture_graph`` runs one capture at a time across threads, the
  collector off during each, in ``thread_local`` error mode.

The file imports nothing of JAX (the parity of every server with the
reference is ``test_torch_serving.py``'s, ``test_torch_speculative.py``'s
and ``test_torch_fleet.py``'s). Tiny f32 models.
"""

import threading
import time

import pytest
import torch

from mpit_tpu_torch import random as jrandom
from mpit_tpu_torch.models import RNNServer, Server
from mpit_tpu_torch.models.lstm import LSTMLM
from mpit_tpu_torch.models.transformer import TransformerLM
from mpit_tpu_torch.parallel import capture as cap
from mpit_tpu_torch.utils.params import tree_leaves, tree_map

CPU = dict(device="cpu")
V, T = 17, 48
REQS = [([3, 1, 4, 1, 5], 9), ([2, 7], 5), ([9, 2, 6, 5, 3, 5, 8], 12), ([1], 3),
        ([4, 4, 4], 7)]


class HostGraphs:
    """A test double of ``capture.GraphSet``: it runs ``body()`` at every
    call, where the real one warms up (a name's first call), captures and
    replays (its second) or replays. It counts the calls it answers as
    replays, and the warm-ups, which the real one repeats for a name whose
    tensors moved to other storage."""

    def __init__(self, device):
        self.replays = 0
        self.warm_ups = 0
        self.costs = {}
        self._keys = {}

    def run(self, name, state, body):
        key = [(t.data_ptr(), tuple(t.shape), t.dtype) for t in state]
        body()
        if self._keys.get(name) == key:
            self.replays += 1
        else:
            self._keys[name] = key
            self.warm_ups += 1


@pytest.fixture
def captured(monkeypatch):
    """Servers built inside the test capture (through ``HostGraphs``)."""
    monkeypatch.setattr(cap, "device_reasons", lambda device: [])
    monkeypatch.setattr(cap, "GraphSet", HostGraphs)


def _lm(layers=2, d=16):
    m = TransformerLM(V, num_layers=layers, d_model=d, num_heads=4, max_len=T,
                      compute_dtype=torch.float32, **CPU)
    return m, m.init(torch.Generator().manual_seed(layers))


def _bits(t):
    return t.detach().reshape(-1).view(torch.uint8)


def _same_tree(a, b) -> bool:
    a, b = tree_leaves(a), tree_leaves(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(a, b))


def _drain(make, reqs, per_request=None):
    """The requests through the server ``make()`` builds, submitted in
    two waves (the second after one step) so admissions meet rows in
    flight; returns the server and its results by request."""
    srv = make()
    rids = []
    for i, (p, mn) in enumerate(reqs):
        if i == 3:
            srv.step()
        rids.append(srv.submit(p, mn, rng=jrandom.key(100 + i), **(per_request or {}).get(i, {})))
    got = srv.drain()
    return srv, [got[r] for r in rids]


def _kinds():
    lm, p = _lm()
    draft, dp = _lm(1, 8)
    lstm = LSTMLM(V, embed_dim=8, hidden=16, num_layers=2, compute_dtype=torch.float32, **CPU)
    lp = lstm.init(torch.Generator().manual_seed(5))
    sampled = dict(temperature=0.9, top_p=0.8)
    return {
        "greedy": (lambda **kw: Server(lm, p, max_batch=4, segment=4, **CPU, **kw), None),
        "sampled": (lambda **kw: Server(lm, p, max_batch=4, segment=4, top_k=12, **sampled,
                                        **CPU, **kw),
                    {1: dict(temperature=0.5), 2: dict(top_p=0.6)}),
        "prefix": (lambda **kw: Server(lm, p, max_batch=4, segment=8, prefix=[6, 2, 8],
                                       **CPU, **kw), None),
        "rnn": (lambda **kw: RNNServer(lstm, lp, max_batch=4, segment=4, **sampled, **CPU,
                                       **kw), None),
        "spec": (lambda **kw: Server(lm, p, max_batch=4, draft_model=draft, draft_params=dp,
                                     spec_k=3, spec_rounds=2, **CPU, **kw), None),
    }


@pytest.mark.parametrize("kind", ["greedy", "sampled", "prefix", "rnn", "spec"])
def test_the_segment_through_its_static_buffers_is_the_eager_one(kind, captured):
    make, per_request = _kinds()[kind]
    eager, want = _drain(lambda: make(capture=False), REQS, per_request)
    assert eager.capture is False and eager.replays == 0 and eager._graphs is None
    srv, got = _drain(make, REQS, per_request)
    assert srv.capture is True and isinstance(srv._graphs, HostGraphs)
    assert got == want
    assert _same_tree(srv._cache, eager._cache) and torch.equal(srv._prev, eager._prev)
    if kind == "spec":
        assert _same_tree(srv._d_cache, eager._d_cache)
    # each name warmed up once: the resident tensors kept their storage
    names = {"spec-round"} if kind == "spec" else {("segment", s) for s in srv._keys}
    assert srv._graphs.warm_ups == len(names) and srv.replays > 0
    assert srv.segments_run == eager.segments_run


def test_a_cpu_server_stays_eager_and_capture_true_raises():
    lm, p = _lm()
    lstm = LSTMLM(V, embed_dim=8, hidden=16, num_layers=1, compute_dtype=torch.float32, **CPU)
    lp = lstm.init(torch.Generator().manual_seed(0))
    for srv in (Server(lm, p, **CPU), RNNServer(lstm, lp, **CPU)):
        assert srv.capture is False and srv._graphs is None and srv.replays == 0
        assert srv.owned_weight_bytes == 0
        assert len(srv.eager_reasons) == 1 and "a CUDA graph needs a CUDA device" in (
            srv.eager_reasons[0])
    for make in (lambda: Server(lm, p, capture=True, **CPU),
                 lambda: RNNServer(lstm, lp, capture=True, **CPU)):
        with pytest.raises(ValueError, match="capture=True.*CUDA device"):
            make()


def _pushed(params, seed):
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t + 0.05 * torch.randn(t.shape, generator=g), params)


def test_a_push_is_copied_into_the_servers_own_weights(captured):
    lm, p = _lm()
    before = tree_map(torch.clone, p)
    srv = Server(lm, p, max_batch=4, segment=4, **CPU)
    eager = Server(lm, p, max_batch=4, segment=4, capture=False, **CPU)
    # the caller's tensors are on the server's device: a copy of its own
    assert srv.owned_weight_bytes == sum(t.numel() * 4 for t in tree_leaves(p))
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(tree_leaves(srv.params),
                                                             tree_leaves(p)))
    ptrs = [t.data_ptr() for t in tree_leaves(srv.params)]
    push = _pushed(p, 1)
    sent = tree_map(torch.clone, push)
    rids = {}
    for s in (srv, eager):
        rids[s] = [s.submit(q, mn, rng=jrandom.key(7 + i)) for i, (q, mn) in enumerate(REQS)]
        s.step()
        assert s.install_weights(push) == 1
    got = {s: s.drain() for s in (srv, eager)}
    assert [got[srv][r] for r in rids[srv]] == [got[eager][r] for r in rids[eager]]
    assert [t.data_ptr() for t in tree_leaves(srv.params)] == ptrs
    assert _same_tree(srv.params, push) and srv.replays > 0
    assert _same_tree(p, before) and _same_tree(push, sent)
    # a bf16 server casts into new tensors: nothing more to own
    assert Server(lm, p, weights_dtype="bf16", **CPU).owned_weight_bytes == 0


@pytest.mark.parametrize("bad", ["shape", "dtype", "leaf"])
def test_a_push_of_other_shapes_raises(bad, captured):
    lm, p = _lm()
    srv = Server(lm, p, max_batch=2, segment=4, **CPU)
    push = _pushed(p, 2)
    if bad == "shape":
        push["Embed_0"]["embedding"] = push["Embed_0"]["embedding"][:-1]
    elif bad == "dtype":
        push["LayerNorm_0"]["scale"] = push["LayerNorm_0"]["scale"].double()
    else:
        del push["LayerNorm_0"]["bias"]
    kept = tree_map(torch.clone, srv.params)
    with pytest.raises(ValueError, match="does not match the served weights"):
        srv.install_weights(push)
    assert srv.weights_version == 0 and _same_tree(srv.params, kept)


def test_captures_from_threads_take_turns_with_the_collector_off(monkeypatch):
    """``capture_graph`` from four threads at once, over a stand-in for
    ``torch.cuda.graph``: no two captures overlap, the collector is off
    during each and on after all, and each asks for ``thread_local``."""
    inside, seen = [], []

    class FakeGraph:
        def __init__(self, graph, pool=None, stream=None, capture_error_mode="global"):
            seen.append(capture_error_mode)

        def __enter__(self):
            inside.append(1)
            assert len(inside) == 1 and not __import__("gc").isenabled()

        def __exit__(self, *exc):
            inside.pop()

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", FakeGraph)
    errors = []

    def capture(i):
        try:
            _, out, launches = cap.capture_graph(None, lambda: time.sleep(0.01) or i)
            assert out == i and launches == {}
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=capture, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and seen == ["thread_local"] * 4
    assert __import__("gc").isenabled()
