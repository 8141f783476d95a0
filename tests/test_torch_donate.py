"""``donate_state``: the port's trainers update their state in place, as
the reference donates it (``donate_argnums``), with the same bits.

- every device trainer (and the sync trainer's bucketed exchange): two
  steps or rounds with ``donate_state=True`` are bit-equal to two with
  ``False``, every params and optimizer tensor keeps its storage
  (``data_ptr``), and stepping, evaluating or checkpointing the consumed
  state raises;
- the optimizer transforms (SGD, momentum, Adam, AdamW, each behind a
  schedule and ``clip_by_global_norm``) in place are bit-equal to out of
  place over three updates, per worker too;
- the elastic update's plain version in place is bit-equal to out of
  place and within the reference's 1e-6 of ``mpit_tpu.ops.elastic_update``
  (``tests/test_ops.py``).

Small shapes (W = 4, MLPs and 1–2 layer transformers of width 16), f32.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpit_tpu.ops import elastic_update as ref_elastic_update
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.models import MLP, TransformerLM
from mpit_tpu_torch.ops.elastic import elastic_update_leaves
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
from mpit_tpu_torch.parallel.pipeline import PipelineParallelTrainer
from mpit_tpu_torch.utils.checkpoint import save_checkpoint

CPU = torch.device("cpu")
W, V, T = 4, 17, 8


def _tensors(obj) -> list:
    """Every tensor of a state, in a fixed order (dataclass fields, dict
    keys, sequence items)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [t for f in dataclasses.fields(obj) for t in _tensors(getattr(obj, f.name))]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _tensors(obj[k])]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _tensors(v)]
    return []


def _mlp():
    return MLP(num_classes=5, hidden=(16,), compute_dtype=torch.float32, in_shape=(3, 3, 1),
               device="cpu")


def _lm(**kw):
    return TransformerLM(V, num_layers=1, d_model=16, num_heads=4, max_len=T,
                         compute_dtype=torch.float32, device="cpu", **kw)


def _images(lead=()):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(*lead, 8, 3, 3, 1)).astype(np.float32)
    return x, rng.integers(0, 5, (*lead, 8)).astype(np.int32)


def _tokens():
    x = np.random.default_rng(0).integers(0, V, (8, T)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _world(names, shape):
    return Topology(W, CPU, axis_names=names, mesh_shape=shape)


def _adamw():
    sched = optim.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 4)
    return optim.chain(optim.clip_by_global_norm(0.5), optim.AdamW(sched, 1e-2))


# name -> (trainer from donate_state, batch)
TRAINERS = {
    "easgd": (lambda d: EASGDTrainer(_mlp(), optim.SGD(0.05, 0.9), Topology(W, CPU), tau=2,
                                     donate_state=d), lambda: _images((2,))),
    "downpour": (lambda d: DownpourTrainer(_mlp(), optim.Adam(1e-2), Topology(W, CPU),
                                           server_optimizer=optim.SGD(0.5, 0.9), tau=2,
                                           staleness=1, donate_state=d), lambda: _images((2,))),
    "sync": (lambda d: DataParallelTrainer(_mlp(), _adamw(), Topology(W, CPU), donate_state=d,
                                           accum_steps=2), _images),
    "sync-int8": (lambda d: DataParallelTrainer(_mlp(), optim.SGD(0.05, 0.9), Topology(W, CPU),
                                                donate_state=d, quant="int8",
                                                bucket_bytes=256), _images),
    "zero": (lambda d: ZeroDataParallelTrainer(_mlp(), optim.Adam(1e-2), Topology(W, CPU),
                                               donate_state=d, clip_norm=0.5), _images),
    "moe": (lambda d: MoEParallelTrainer(_lm(moe_experts=4, moe_axis="dp"), optim.Adam(1e-2),
                                         Topology(W, CPU), donate_state=d, clip_norm=1.0),
            _tokens),
    "seq": (lambda d: SeqParallelTrainer(_lm(seq_axis="sp"), optim.SGD(0.1, 0.9),
                                         _world(("dp", "sp"), (2, 2)), donate_state=d),
            _tokens),
    "tensor": (lambda d: TensorParallelTrainer(_lm(), _adamw(), _world(("dp", "tp"), (2, 2)),
                                               donate_state=d), _tokens),
    "composed": (lambda d: ComposedParallelTrainer(
        _lm(seq_axis="sp"), optim.Adam(1e-2), _world(("dp", "tp", "sp"), (1, 2, 2)),
        donate_state=d), _tokens),
    "pipeline": (lambda d: PipelineParallelTrainer(
        vocab_size=V, num_layers=2, d_model=16, num_heads=4, seq_len=T,
        topo=_world(("dp", "pp"), (2, 2)), n_micro=2, donate_state=d), _tokens),
}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_donated_steps_are_in_place_bit_equal_and_consume_the_state(name, tmp_path):
    make, batch = TRAINERS[name]
    x, y = batch()
    runs = {}
    for donate in (False, True):
        tr = make(donate)
        state = first = tr.init_state(torch.Generator().manual_seed(0))
        before = [t.data_ptr() for t in _tensors(first)]
        losses = []
        for _ in range(2):
            state, m = tr.step(state, x, y)
            losses.append(m["loss"])
        runs[donate] = (tr, first, state, before, losses)
    _, _, kept, _, kept_losses = runs[False]
    tr, first, state, before, losses = runs[True]
    assert all(torch.equal(a, b) for a, b in zip(losses, kept_losses, strict=True))
    got, want = _tensors(state), _tensors(kept)
    assert len(got) == len(want) == len(before) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # the same storage: every params and optimizer tensor written in place
    assert [t.data_ptr() for t in got] == before
    # the consumed state refuses a second use; the returned one steps on
    for use in (lambda: tr.step(first, x, y), lambda: tr.evaluate(first, x, y),
                lambda: save_checkpoint(str(tmp_path), first, step=1)):
        with pytest.raises(RuntimeError, match="donate_state=False"):
            use()
    tr.step(state, x, y)
    # undonated, the first state is as it was made
    tr0, first0, _, _, _ = runs[False]
    fresh = _tensors(tr0.init_state(torch.Generator().manual_seed(0)))
    assert all(torch.equal(a, b) for a, b in zip(_tensors(first0), fresh, strict=True))


def _grads(rng, shapes, lead=()):
    return {k: torch.from_numpy(rng.normal(size=(*lead, *s)).astype(np.float32))
            for k, s in shapes.items()}


OPTIMIZERS = {
    "sgd": lambda s: optim.SGD(s),
    "momentum": lambda s: optim.SGD(s, momentum=0.9),
    "adam": lambda s: optim.Adam(s),
    "adamw": lambda s: optim.AdamW(s, weight_decay=1e-2),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_in_place_is_bit_equal_to_out_of_place(name):
    sched = optim.warmup_cosine_decay_schedule(1e-3, 5e-2, 1, 5)
    opt = optim.chain(optim.clip_by_global_norm(0.7), OPTIMIZERS[name](sched))
    shapes = {"a": (3, 3, 2, 4), "b": (4,), "c": (5, 4)}
    for lead, per_worker in (((), False), ((W,), True)):
        rng = np.random.default_rng(1)
        params = _grads(rng, shapes, lead)
        grads = [_grads(rng, shapes, lead) for _ in range(3)]
        out_p, out_s = params, opt.init(params)
        in_p = {k: v.clone() for k, v in params.items()}
        in_s = opt.init(in_p)
        ptrs = [t.data_ptr() for t in _tensors((in_p, in_s))]
        for g in grads:
            out_p, out_s = opt.update(out_p, g, out_s, per_worker=per_worker)
            in_p, in_s = opt.update(in_p, {k: v.clone() for k, v in g.items()}, in_s,
                                    per_worker=per_worker, inplace=True)
        assert all(torch.equal(a, b) for a, b in zip(_tensors((in_p, in_s)),
                                                     _tensors((out_p, out_s)), strict=True))
        assert [t.data_ptr() for t in _tensors((in_p, in_s))] == ptrs
        # out of place, the first params are as they were
        assert torch.equal(params["b"], _grads(np.random.default_rng(1), shapes, lead)["b"])


def test_plain_elastic_update_in_place_matches_out_of_place_and_the_reference():
    rng = np.random.default_rng(0)
    shapes = [(7,), (3, 50, 11), (1024 + 13,)]
    xs = [rng.normal(size=(W, *s)).astype(np.float32) for s in shapes]
    cs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    ds = [rng.normal(size=s).astype(np.float32) for s in shapes]
    alpha = 0.3
    tx, tc, td = ([torch.from_numpy(a.copy()) for a in arrs] for arrs in (xs, cs, ds))
    new_x, new_c = elastic_update_leaves(tx, tc, td, alpha, use_kernel=False)
    ptrs = [t.data_ptr() for t in tx + tc]
    in_x, in_c = elastic_update_leaves(tx, tc, td, alpha, use_kernel=False, inplace=True)
    assert [t.data_ptr() for t in in_x + in_c] == ptrs
    for a, b in zip(in_x + in_c, new_x + new_c, strict=True):
        assert torch.equal(a, b)
    for x, c, d, gx, gc in zip(xs, cs, ds, in_x, in_c):
        want_x, want_c = ref_elastic_update(x, c, d, alpha, use_pallas=False)
        np.testing.assert_allclose(gx.numpy(), np.asarray(want_x), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gc.numpy(), np.asarray(want_c), rtol=1e-6, atol=1e-6)
