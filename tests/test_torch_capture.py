"""Every device trainer's unit as a CUDA graph
(``mpit_tpu_torch/parallel/capture.py``), the counterpart of the
reference's ``jit`` with ``donate_argnums``: the EASGD and Downpour
rounds, the sync-DP step and those of its seq, tp and composed
subclasses, the ZeRO-1 step and the MoE step.

On the CPU:

- the optimizer fed its host values as 0-dim tensors (what a graph reads)
  is bit-equal over 6 updates to the float path (SGD with momentum,
  constant and cosine behind a clip, AdamW warmup-cosine behind a clip;
  in place and not; per worker too), and ``advance`` moves the counts as
  the updates do;
- the trainers' replay branch, driven by a test double that runs the
  unit's body with those 0-dim tensors where a graph would replay, leaves
  the eager trainer's bits, metrics and host bookkeeping (round or step,
  counts);
- a CPU trainer never captures, and ``capture=True`` says why it cannot;
  the pipeline and the server say why they stay eager.

On a CUDA card (skipped without one): replayed units are bit-equal to
eager ones and keep the state's storage, a restored checkpoint is warmed
up and captured anew, and the launch counters count every replay. A
server's captured segments (greedy, sampled, ``prefix=``, ``RNNServer``,
speculative) give the tokens and resident cache bytes of ``capture=False``;
a weight push between segments gives an eager server's tokens without a
new capture; two servers in two threads capture at once, and a trainer
captures while a server thread replays.

The file imports nothing of JAX, so it also runs on a machine without it
(``pytest --noconftest``). Small shapes (W = 4, or 8 for the composed
mesh; MLPs of width 16, 1-layer LMs of width 16), f32 on the CPU.
"""

import time

import numpy as np
import pytest
import torch

from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.models import MLP, TransformerLM
from mpit_tpu_torch.parallel import (
    ComposedParallelTrainer,
    DataParallelTrainer,
    DownpourTrainer,
    EASGDTrainer,
    MoEParallelTrainer,
    SeqParallelTrainer,
    TensorParallelTrainer,
    ZeroDataParallelTrainer,
)
from mpit_tpu_torch.parallel import capture as cap
from mpit_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

CPU = torch.device("cpu")
W, TAU, V, T = 4, 3, 17, 8
STEPS = 6


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().reshape(-1).view(torch.uint8)


def _same(a, b) -> bool:
    a, b = cap.tensors_of(a), cap.tensors_of(b)
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(_bits(x), _bits(y))
        for x, y in zip(a, b))


def _counts(state) -> list:
    if isinstance(state, tuple):
        return [c for s in state for c in _counts(s)]
    return [state.count] if hasattr(state, "count") else []


# name -> optimizer; the schedules span the 6 updates
OPTIMIZERS = {
    "sgd-momentum": lambda: optim.SGD(0.05, 0.9),
    "sgd-cosine-clip": lambda: optim.chain(
        optim.clip_by_global_norm(1.0), optim.SGD(optim.cosine_decay_schedule(0.1, STEPS), 0.9)),
    "adamw-warmup-cosine-clip": lambda: optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.AdamW(optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, STEPS), 1e-2)),
    # elementwise, for ZeRO and MoE (which take clip_norm= instead)
    "adamw-warmup-cosine": lambda: optim.AdamW(
        optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, STEPS), 1e-2),
}


def _tree(lead=()):
    rng = np.random.default_rng(0)
    return {"Dense_0": {"kernel": torch.from_numpy(rng.normal(size=(*lead, 5, 7)).astype(np.float32)),
                        "bias": torch.from_numpy(rng.normal(size=(*lead, 7)).astype(np.float32))},
            "Dense_1": {"kernel": torch.from_numpy(rng.normal(size=(*lead, 7, 3)).astype(np.float32))}}


@pytest.mark.parametrize("inplace", [False, True], ids=["out-of-place", "in-place"])
@pytest.mark.parametrize("per_worker", [False, True], ids=["replicated", "per-worker"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_device_scalars_are_bit_equal_to_the_float_path(name, per_worker, inplace):
    opt = OPTIMIZERS[name]()
    lead = (W,) if per_worker else ()
    rng = np.random.default_rng(1)
    grads = [{k: {n: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32) * 3)
                  for n, v in layer.items()} for k, layer in _tree(lead).items()}
             for _ in range(STEPS)]
    runs = {}
    for fed in (False, True):
        params = _tree(lead)
        state = first = opt.init(params)
        read = []
        for g in grads:
            g = {k: {n: v.clone() for n, v in layer.items()} for k, layer in g.items()}
            values = opt.host_scalars(state)
            read.append(values)
            kw = {"scalars": [torch.tensor(v) for v in values]} if fed else {}
            params, state = opt.update(params, g, state, per_worker=per_worker,
                                       inplace=inplace, **kw)
        runs[fed] = (params, state, read)
    (p0, s0, read), (p1, s1, _) = runs[False], runs[True]
    assert _same(p0, p1) and _same(s0, s1)
    assert _counts(s0) == _counts(s1) == _counts(opt.advance(first, STEPS))
    # the values of the update after t more, read off the first state
    assert [opt.host_scalars(first, t) for t in range(STEPS)] == read
    if name != "sgd-momentum":
        assert all(v.dtype == np.float32 for values in read for v in values) and read[0]


class ReplayOnTheHost:
    """A test double of ``capture.UnitGraph``: it runs the unit's body where
    a graph would replay it, reading the host values from 0-dim tensors as
    the graph reads them from its buffer, and answers as a replay does
    (no result, copies of the metrics): the trainer's replay branch then
    does its own bookkeeping."""

    def __init__(self):
        self.replays = 0

    def run(self, state, inputs, values, body):
        _, metrics = body(tuple(inputs), [torch.tensor(v) for v in values])
        self.replays += 1
        return None, {k: v.clone() for k, v in metrics.items()}


def _mlp(device=CPU):
    return MLP(num_classes=5, hidden=(16,), compute_dtype=torch.float32, in_shape=(3, 3, 1),
               device=device)


def _images(lead=(), seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(*lead, 8, 3, 3, 1)).astype(np.float32)
    return x, rng.integers(0, 5, (*lead, 8)).astype(np.int32)


def _lm(device=CPU, **kw):
    return TransformerLM(V, num_layers=1, d_model=16, num_heads=4, max_len=T,
                         compute_dtype=torch.float32, device=device, **kw)


def _tokens(seed, n=8):
    x = np.random.default_rng(seed).integers(0, V, (n, T)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _world(device, names=("dp",), shape=None, w=W):
    return Topology(w, device, axis_names=names, mesh_shape=shape or (w,))


MOE = dict(moe_experts=W, moe_axis="dp", moe_top_k=2, moe_capacity_factor=1.0,
           moe_balance_weight=0.5, moe_zloss_weight=0.1)


def _downpour(staleness, opt, server=None):
    return lambda dev=CPU, capture=None: DownpourTrainer(
        _mlp(dev), OPTIMIZERS[opt](), _world(dev), tau=TAU, staleness=staleness,
        server_optimizer=server() if server else None, capture=capture)


def _step_images(seed):
    return _images((), seed)


def _round_images(seed):
    return _images((TAU,), seed)


# name -> (trainer(device, capture), batch(seed)): every device trainer
TRAINERS = {
    "easgd-sgd": (lambda dev=CPU, capture=None: EASGDTrainer(
        _mlp(dev), OPTIMIZERS["sgd-cosine-clip"](), _world(dev), tau=TAU, capture=capture),
        _round_images),
    "easgd-adamw": (lambda dev=CPU, capture=None: EASGDTrainer(
        _mlp(dev), OPTIMIZERS["adamw-warmup-cosine-clip"](), _world(dev), tau=TAU,
        capture=capture), _round_images),
    "sync-adamw": (lambda dev=CPU, capture=None: DataParallelTrainer(
        _mlp(dev), OPTIMIZERS["adamw-warmup-cosine-clip"](), _world(dev), accum_steps=2,
        capture=capture), _step_images),
    "sync-sgd": (lambda dev=CPU, capture=None: DataParallelTrainer(
        _mlp(dev), OPTIMIZERS["sgd-momentum"](), _world(dev), capture=capture), _step_images),
    "zero-adamw-clip": (lambda dev=CPU, capture=None: ZeroDataParallelTrainer(
        _mlp(dev), OPTIMIZERS["adamw-warmup-cosine"](), _world(dev), accum_steps=2,
        clip_norm=1.0, capture=capture), _step_images),
    "zero-int8": (lambda dev=CPU, capture=None: ZeroDataParallelTrainer(
        _mlp(dev), optim.SGD(optim.cosine_decay_schedule(0.1, STEPS), 0.9), _world(dev),
        quant="int8", capture=capture), _step_images),
    "moe-adamw-clip": (lambda dev=CPU, capture=None: MoEParallelTrainer(
        _lm(dev, **MOE), OPTIMIZERS["adamw-warmup-cosine"](), _world(dev), clip_norm=1.0,
        capture=capture), _tokens),
    "seq-ring": (lambda dev=CPU, capture=None: SeqParallelTrainer(
        _lm(dev, seq_axis="sp"), OPTIMIZERS["adamw-warmup-cosine-clip"](),
        _world(dev, ("dp", "sp"), (2, 2)), capture=capture), _tokens),
    "seq-ulysses": (lambda dev=CPU, capture=None: SeqParallelTrainer(
        _lm(dev, seq_axis="sp", seq_impl="ulysses"), OPTIMIZERS["sgd-cosine-clip"](),
        _world(dev, ("dp", "sp"), (2, 2)), capture=capture), _tokens),
    "tp": (lambda dev=CPU, capture=None: TensorParallelTrainer(
        _lm(dev), OPTIMIZERS["adamw-warmup-cosine-clip"](), _world(dev, ("dp", "tp"), (2, 2)),
        capture=capture), _tokens),
    "composed": (lambda dev=CPU, capture=None: ComposedParallelTrainer(
        _lm(dev, seq_axis="sp"), OPTIMIZERS["adamw-warmup-cosine-clip"](),
        _world(dev, ("dp", "tp", "sp"), (2, 2, 2), w=8), capture=capture), _tokens),
    "downpour-staleness-0": (_downpour(0, "sgd-cosine-clip"), _round_images),
    "downpour-staleness-1": (_downpour(1, "adamw-warmup-cosine-clip"), _round_images),
    "downpour-server-adam": (_downpour(1, "sgd-momentum", lambda: optim.Adam(
        optim.cosine_decay_schedule(0.05, STEPS))), _round_images),
}


def _host(state):
    if hasattr(state, "params"):
        return state.step, _counts(state.opt_state)
    return state.round, _counts(state.worker_opt) + _counts(getattr(state, "server_opt", ()))


def _same_metrics(a: list, b: list) -> bool:
    return all(m.keys() == n.keys() and all(torch.equal(_bits(m[k]), _bits(n[k])) for k in m)
               for m, n in zip(a, b, strict=True))


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_the_replay_branch_leaves_the_eager_bits_and_bookkeeping(name):
    make, batch = TRAINERS[name]
    runs = {}
    for replayed in (False, True):
        tr = make()
        assert tr._graph is None
        if replayed:
            tr._graph = ReplayOnTheHost()
        state = tr.init_state(torch.Generator().manual_seed(0))
        ptrs = [t.data_ptr() for t in cap.tensors_of(state)]
        metrics, hosts = [], []
        for i in range(4):
            state, m = tr.step(state, *batch(i))
            metrics.append(m)
            hosts.append(_host(state))
        assert [t.data_ptr() for t in cap.tensors_of(state)] == ptrs
        runs[replayed] = (tr, state, metrics, hosts)
    (_, s0, m0, h0), (tr, s1, m1, h1) = runs[False], runs[True]
    assert tr._graph.replays == 4
    assert h0 == h1 and h1[-1][0] == 4
    assert _same(s0, s1) and _same_metrics(m0, m1)
    if name.startswith("moe"):
        assert {"loss", "moe_balance", "moe_zloss", "moe_dropped_frac"} <= m1[0].keys()


def test_a_cpu_trainer_never_captures_and_capture_true_says_why():
    topo = Topology(W, CPU)
    trainers = [EASGDTrainer(_mlp(), optim.SGD(0.05, 0.9), topo, tau=TAU),
                DataParallelTrainer(_mlp(), optim.SGD(0.05, 0.9), topo)]
    for tr in trainers:
        assert tr.capture is False and tr._graph is None and tr.replays == 0
    tr = trainers[1]
    state = tr.init_state(torch.Generator().manual_seed(0))
    cap.replays = 0
    for i in range(3):
        state, _ = tr.step(state, *_images((), i))
    assert tr.replays == 0 and cap.replays == 0
    with pytest.raises(ValueError, match="a CUDA graph needs a CUDA device"):
        DataParallelTrainer(_mlp(), optim.SGD(0.05), topo, capture=True)
    with pytest.raises(ValueError, match="donate_state=False"):
        EASGDTrainer(_mlp(), optim.SGD(0.05), topo, donate_state=False, capture=True)
    # every trainer of the table stays eager on the CPU, and says why
    for name, (make, _) in TRAINERS.items():
        tr = make()
        assert tr.capture is False and tr._graph is None and tr.replays == 0, name
        assert any("CUDA device" in w for w in tr.eager_reasons), name
    with pytest.raises(ValueError, match="CUDA device"):
        SeqParallelTrainer(_lm(seq_axis="sp"), optim.SGD(0.1),
                           _world(CPU, ("dp", "sp"), (2, 2)), capture=True)
    with pytest.raises(ValueError, match="CUDA device.*donate_state=False"):
        DownpourTrainer(_mlp(), optim.SGD(0.1), topo, donate_state=False, capture=True)
    # the bucketed exchange never captures
    assert DataParallelTrainer(_mlp(), optim.SGD(0.05), topo, quant="int8").capture is False


def test_eager_reasons_name_each_obstacle(monkeypatch):
    import importlib

    from mpit_tpu_torch.models.serving import Server
    from mpit_tpu_torch.parallel.pipeline import PipelineParallelTrainer

    opt = optim.SGD(0.05)
    assert cap.eager_reasons("cuda", True, opt) == []
    assert cap.eager_reasons("cuda", True, opt, server_optimizer=optim.Adam(1e-3)) == []
    why = cap.eager_reasons("cpu", False, object(), bucketed=True)
    assert len(why) == 4
    assert any("CUDA device" in w for w in why) and any("donate_state" in w for w in why)
    assert any("bucketed" in w for w in why) and any("host_scalars" in w for w in why)
    assert cap.resolve(None, []) is True and cap.resolve(None, why) is False
    assert cap.resolve(False, []) is False and cap.resolve(True, []) is True
    # Downpour's server optimizer needs its host values too
    why = cap.eager_reasons("cuda", True, opt, server_optimizer=object())
    assert len(why) == 1 and "server_optimizer has no host_scalars" in why[0]
    # a world of several processes
    topology = importlib.import_module("mpit_tpu_torch.comm.topology")
    monkeypatch.setattr(topology, "_distributed_initialized", True)
    why = cap.eager_reasons("cuda", True, opt)
    assert len(why) == 1 and "world of several" in why[0]
    with pytest.raises(ValueError, match="world of several"):
        cap.resolve(True, why)
    monkeypatch.setattr(topology, "_distributed_initialized", False)
    # the pipeline stays eager on any device, and says why; a server on
    # the CPU names the device
    pp = PipelineParallelTrainer(V, 2, 16, 4, T, topo=_world(CPU, ("dp", "pp"), (2, 2)),
                                 n_micro=2, optimizer=opt)
    assert pp.capture is False and any("timetable" in w for w in pp.eager_reasons)
    lm = TransformerLM(V, num_layers=1, d_model=16, num_heads=4, max_len=T,
                       compute_dtype=torch.float32, device="cpu")
    server = Server(lm, lm.init(torch.Generator().manual_seed(0)), max_batch=2, segment=2,
                    device="cpu")
    assert server.capture is False and any("CUDA device" in w for w in server.eager_reasons)


def test_the_key_holds_across_in_place_updates_and_not_across_storage():
    state = _tree()
    opt = optim.AdamW(1e-3)
    opt_state = opt.init(state)
    leaves = cap.tensors_of(state, opt_state)
    assert len(leaves) == 9
    key = cap._key(leaves, [torch.zeros(2, 3)], 1)
    g = {k: {n: torch.ones_like(v) for n, v in layer.items()} for k, layer in state.items()}
    state, opt_state = opt.update(state, g, opt_state, inplace=True)
    assert cap._key(cap.tensors_of(state, opt_state), [torch.ones(2, 3)], 1) == key
    assert cap._key(cap.tensors_of(state, opt_state), [torch.ones(2, 4)], 1) != key
    moved = [t.clone() for t in leaves]
    assert cap._key(moved, [torch.zeros(2, 3)], 1) != key


# ---------------------------------------------------------------- the card


def _card_easgd(capture, opt=None):
    mlp = MLP(num_classes=5, hidden=(16,), compute_dtype=torch.float32, in_shape=(3, 3, 1),
              device="cuda")
    return EASGDTrainer(mlp, opt or OPTIMIZERS["adamw-warmup-cosine-clip"](),
                        Topology(W, torch.device("cuda")), tau=TAU, capture=capture)


def _flash_lm(**kw):
    return TransformerLM(V, num_layers=1, d_model=64, num_heads=1, max_len=64,
                         compute_dtype=torch.bfloat16, attn_impl="flash", device="cuda", **kw)


def _card_lm(capture):
    return DataParallelTrainer(_flash_lm(), OPTIMIZERS["adamw-warmup-cosine-clip"](),
                               Topology(W, torch.device("cuda")), capture=capture)


def _card_zero(capture):
    return ZeroDataParallelTrainer(_flash_lm(), OPTIMIZERS["adamw-warmup-cosine"](),
                                   Topology(W, torch.device("cuda")), clip_norm=1.0,
                                   capture=capture)


def _card_moe(capture):
    return MoEParallelTrainer(_flash_lm(**MOE), OPTIMIZERS["adamw-warmup-cosine"](),
                              Topology(W, torch.device("cuda")), clip_norm=1.0,
                              capture=capture)


def _card_tokens(seed):
    x = np.random.default_rng(seed).integers(0, V, (8, 64)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


# the bf16 flash LMs through the sm90 kernels; every trainer of the CPU
# table at its f32 widths
CARD = {"easgd": (_card_easgd, _round_images), "sync-flash": (_card_lm, _card_tokens),
        "zero-flash": (_card_zero, _card_tokens), "moe-flash": (_card_moe, _card_tokens),
        **{name: ((lambda capture, make=make: make(torch.device("cuda"), capture)), batch)
           for name, (make, batch) in TRAINERS.items()}}


@pytest.mark.parametrize("name", sorted(CARD))
def test_replayed_units_are_bit_equal_to_eager_ones_and_keep_storage(name):
    _need_card()
    make, batch = CARD[name]
    runs = {}
    for capture in (False, True):
        tr = make(capture)
        assert tr.capture is capture and list(tr.eager_reasons) == []
        state = tr.init_state(torch.Generator().manual_seed(0))
        ptrs = [t.data_ptr() for t in cap.tensors_of(state)]
        metrics = []
        for i in range(STEPS):
            state, m = tr.step(state, *batch(i))
            metrics.append(m)
        assert [t.data_ptr() for t in cap.tensors_of(state)] == ptrs
        runs[capture] = (tr, state, metrics)
    (_, s0, m0), (tr, s1, m1) = runs[False], runs[True]
    assert runs[False][0].replays == 0 and tr.replays == STEPS - 1
    assert _host(s0) == _host(s1)
    assert _same(s0, s1) and _same_metrics(m0, m1)


def test_a_restored_checkpoint_is_warmed_up_and_captured_anew(tmp_path):
    _need_card()
    straight = _card_easgd(True)
    state = straight.init_state(torch.Generator().manual_seed(0))
    for i in range(STEPS):
        state, _ = straight.step(state, *_images((TAU,), i))
    tr = _card_easgd(True)
    half = tr.init_state(torch.Generator().manual_seed(0))
    for i in range(STEPS // 2):
        half, _ = tr.step(half, *_images((TAU,), i))
    save_checkpoint(str(tmp_path), half, step=STEPS // 2)
    first_graph = tr._graph._graph
    restored, step = restore_checkpoint(str(tmp_path), tr.init_state(
        torch.Generator().manual_seed(1)))
    assert step == STEPS // 2
    replays = tr.replays
    restored, _ = tr.step(restored, *_images((TAU,), STEPS // 2))
    assert tr.replays == replays and tr._graph._graph is None  # a warm-up
    for i in range(STEPS // 2 + 1, STEPS):
        restored, _ = tr.step(restored, *_images((TAU,), i))
    assert tr.replays == replays + STEPS // 2 - 1
    assert tr._graph._graph is not None and tr._graph._graph is not first_graph
    assert _host(restored) == _host(state) and _same(restored, state)


def test_a_graph_freed_by_the_collector_does_not_break_the_next_capture():
    """An old trainer's graph, in a reference cycle, freed by the garbage
    collector while a new graph is captured would end that capture; the
    capture holds the collector off."""
    _need_card()
    import gc

    tr = _card_lm(True)
    state = tr.init_state(torch.Generator().manual_seed(0))
    for i in range(3):
        state, _ = tr.step(state, *_card_tokens(i))
    assert tr.replays == 2
    tr.cycle = tr  # only the collector frees it, and its graph
    del tr, state
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        tr = _card_lm(True)
        state = tr.init_state(torch.Generator().manual_seed(0))
        for i in range(3):
            state, _ = tr.step(state, *_card_tokens(i))
    finally:
        gc.set_threshold(*thresholds)
    assert tr.replays == 2 and gc.isenabled()


def test_launch_counters_count_every_replay():
    _need_card()
    from mpit_tpu_torch.ops import elastic
    from mpit_tpu_torch.ops import flash_attention as fa

    tr = _card_easgd(True, optim.SGD(0.05, 0.9))
    state = tr.init_state(torch.Generator().manual_seed(0))
    elastic.launches = 0
    for i in range(STEPS):
        state, _ = tr.step(state, *_images((TAU,), i))
    assert tr.replays == STEPS - 1 and elastic.launches == STEPS

    for make in (_card_lm, _card_zero, _card_moe):
        tr = make(True)
        state = tr.init_state(torch.Generator().manual_seed(0))
        for k in fa.launches:
            fa.launches[k] = 0
        for i in range(STEPS):
            state, _ = tr.step(state, *_card_tokens(i))
        assert tr.replays == STEPS - 1
        assert fa.launches["flash_forward_sm90"] == fa.launches["flash_dq_sm90"] == STEPS
        assert fa.launches["flash_dkv_sm90"] == STEPS and fa.launches["flash_forward"] == 0


# ------------------------------------------------------- servers on the card


def _card_serve_lm(layers=2, d=64):
    from mpit_tpu_torch.models import TransformerLM as LM

    m = LM(V, num_layers=layers, d_model=d, num_heads=4, max_len=64,
           compute_dtype=torch.bfloat16, device="cuda")
    return m, m.init(torch.Generator().manual_seed(layers))


def _card_servers():
    from mpit_tpu_torch.models import RNNServer, Server
    from mpit_tpu_torch.models.lstm import LSTMLM

    lm, p = _card_serve_lm()
    draft, dp = _card_serve_lm(1, 32)
    lstm = LSTMLM(V, embed_dim=32, hidden=64, num_layers=2, device="cuda")
    lp = lstm.init(torch.Generator().manual_seed(5))
    sampled = dict(temperature=0.9, top_p=0.8)
    return {
        "greedy": lambda **kw: Server(lm, p, max_batch=4, segment=8, **kw),
        "sampled": lambda **kw: Server(lm, p, max_batch=4, segment=8, top_k=12, **sampled,
                                       **kw),
        "prefix": lambda **kw: Server(lm, p, max_batch=4, segment=8, prefix=[6, 2, 8], **kw),
        "rnn": lambda **kw: RNNServer(lstm, lp, max_batch=4, segment=8, **sampled, **kw),
        "spec": lambda **kw: Server(lm, p, max_batch=4, draft_model=draft, draft_params=dp,
                                    spec_k=3, spec_rounds=3, **kw),
    }


SERVE_REQS = [([3, 1, 4, 1, 5], 21), ([2, 7], 9), ([9, 2, 6, 5, 3, 5, 8], 30), ([1], 5),
              ([4, 4, 4], 17), ([8, 1, 8], 26)]


def _serve(srv, reqs=SERVE_REQS, wave=3):
    from mpit_tpu_torch import random as jrandom

    rids = []
    for i, (prompt, new) in enumerate(reqs):
        if i == wave:
            srv.step()
        rids.append(srv.submit(prompt, new, rng=jrandom.key(100 + i)))
    got = srv.drain()
    return [got[r] for r in rids]


def _same_cache(a, b) -> bool:
    from mpit_tpu_torch.utils.params import tree_leaves

    return all(torch.equal(_bits(x), _bits(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


@pytest.mark.parametrize("kind", ["greedy", "sampled", "prefix", "rnn", "spec"])
def test_captured_servers_are_bit_equal_to_eager_ones(kind):
    _need_card()
    make = _card_servers()[kind]
    eager, srv = make(capture=False), make()
    assert eager.capture is False and srv.capture is True and srv.eager_reasons == []
    want, got = _serve(eager), _serve(srv)
    assert got == want and srv.replays > 0 and eager.replays == 0
    assert _same_cache(srv._cache, eager._cache) and torch.equal(srv._prev, eager._prev)
    if kind == "spec":
        assert _same_cache(srv._d_cache, eager._d_cache)


def test_a_push_between_segments_needs_no_new_capture():
    _need_card()
    from mpit_tpu_torch import random as jrandom
    from mpit_tpu_torch.utils.params import tree_leaves, tree_map

    make = _card_servers()["sampled"]
    lm, p = _card_serve_lm()
    g = torch.Generator().manual_seed(3)
    push = tree_map(lambda t: (t.float().cpu() + 0.05 * torch.randn(t.shape, generator=g)).to(
        t.device, t.dtype), p)
    sent = tree_map(torch.clone, push)
    reqs = [(prompt, 40) for prompt, _ in SERVE_REQS[:4]]
    runs = {}
    for capture in (False, True):
        srv = make(capture=capture)
        rids = [srv.submit(q, n, rng=jrandom.key(7 + i)) for i, (q, n) in enumerate(reqs)]
        for _ in range(3):
            srv.step()
        graphs = dict(srv._graphs._graphs) if capture else {}
        ptrs = [t.data_ptr() for t in tree_leaves(srv.params)]
        srv.install_weights(push)
        got = srv.drain()
        runs[capture] = [got[r] for r in rids]
        if capture:
            name = ("segment", 8)
            assert graphs[name][1] is not None and srv._graphs._graphs[name][1] is graphs[name][1]
            assert [t.data_ptr() for t in tree_leaves(srv.params)] == ptrs
    assert runs[True] == runs[False]
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(tree_leaves(push),
                                                               tree_leaves(sent)))


def test_two_servers_in_two_threads_capture_at_once():
    _need_card()
    import threading

    servers = _card_servers()
    want = {k: _serve(servers[k](capture=False)) for k in ("greedy", "rnn")}
    got, errors = {}, []
    start = threading.Barrier(2)

    def serve(kind):
        try:
            srv = servers[kind]()
            start.wait()
            got[kind] = (_serve(srv), srv.replays)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=serve, args=(k,)) for k in want]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert all(got[k][0] == want[k] and got[k][1] > 0 for k in want)


def test_a_trainer_captures_while_a_server_thread_replays():
    _need_card()
    import threading

    make = _card_servers()["greedy"]
    reqs = [(prompt, 40) for prompt, _ in SERVE_REQS]
    want = _serve(make(capture=False), reqs, wave=0)
    srv = make()
    out, errors, stop = [], [], threading.Event()

    def serve():
        try:
            while not stop.is_set():
                out.append(_serve(srv, reqs, wave=0))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    thread = threading.Thread(target=serve)
    thread.start()
    while srv.replays == 0 and thread.is_alive():
        time.sleep(0.001)
    runs = {}
    for capture in (False, True):
        tr = _card_lm(capture)
        state = tr.init_state(torch.Generator().manual_seed(0))
        for i in range(4):
            state, _ = tr.step(state, *_card_tokens(i))
        runs[capture] = (tr, state)
    replaying = thread.is_alive()
    stop.set()
    thread.join()
    assert not errors, errors
    assert replaying and out and all(o == want for o in out)
    assert runs[True][0].replays == 3 and _same(runs[True][1], runs[False][1])
