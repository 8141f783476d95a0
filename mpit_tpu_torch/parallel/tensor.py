"""Tensor parallelism over a ``(dp, tp)`` world; counterpart of
``mpit_tpu/parallel/tensor.py`` (``TensorParallelTrainer``).

The reference annotates WHERE tensors live (the Megatron column/row
shardings of the transformer's projections over a ``tp`` mesh axis) and
lets XLA's SPMD partitioner insert the all-reduces. Its sharded arrays are
global arrays: what the partitioner changes is not the values but where
the sums are taken. The port holds the state whole on the card, keeps the
strict spec tree (:func:`tp_state_specs`, the reference's rule table and
both of its refusals word for word) and :func:`shard_views`, which cuts
shard ``i`` of each leaf as device ``i`` of the tp axis holds it. The one
numerical consequence of the split is the **row-parallel reduction**: the
attention output (``Dense_1``) and the MLP down projection (``Dense_3``)
are row-sharded, so each device multiplies its slice of the input by its
rows of the kernel and GSPMD ``psum``\\ s the partial products. The model
run with ``tp`` set (``TransformerLM.clone(tp=...)``,
``models/transformer.py`` ``row_parallel``) computes exactly that sum, in
shard order, with the bias added after it; the column-parallel products
(``Dense_0``, ``Dense_2``) stay one product, since their output columns
are independent.

Sharding rules (first match wins, default replicated):

- qkv projection (``Dense_0``): column-sharded ``P(None, "tp")``;
- attention output (``Dense_1``): row-sharded ``P("tp", None)``;
- MLP up (``Dense_2``): column-sharded, bias with it;
- MLP down (``Dense_3``): row-sharded, bias replicated;
- embeddings, positions, LayerNorms: replicated.

The batch shards over ``dp``; the step is :class:`DataParallelTrainer`'s
one pass over the global batch. dp and tp may span processes
(``comm/topology.py``). Where tp does, each process keeps the whole tree
but computes only its shards (``models/transformer.py``: the column
products of its heads and MLP columns, the row-parallel partials gathered
over the tp processes and summed in shard order, Megatron's "f" on the
column products' input), so a sharded leaf's gradient holds its shards'
part and zeros elsewhere: :func:`tp_across_processes` sums those over the
tp processes (exact: one nonzero term an element) and averages the
gradient and the loss over the processes that hold the same shards. Every
process then runs the same update on the same whole gradient, so the
copies of every leaf stay equal bit for bit, global-norm clipping sees the
whole gradient and the checkpoint holds whole leaves, as the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from mpit_tpu_torch.comm.collectives import line_sum
from mpit_tpu_torch.comm.topology import Topology, line_group
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.parallel.sync import DataParallelTrainer, _mean_across_processes
from mpit_tpu_torch.utils.params import (
    flatten_params, tree_leaves, tree_leaves_with_path, tree_unflatten, unflatten_params,
)


class P(tuple):
    """A ``PartitionSpec``: one entry per leaf dim (an axis name or None);
    dims past its length are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# (module name, leaf name) -> PartitionSpec; the reference's table
_TP_RULES = (
    ("Dense_0", "kernel", P(None, "tp")),
    ("Dense_1", "kernel", P("tp", None)),
    ("Dense_2", "kernel", P(None, "tp")),
    ("Dense_2", "bias", P("tp")),
    ("Dense_3", "kernel", P("tp", None)),
    ("Dense_3", "bias", P()),
)


def _path_keys(path) -> list:
    return [k for k in path if isinstance(k, str)]


def _spec_for_path(path) -> "tuple[P, Optional[int]]":
    """(spec, index of the matching rule) — (P(), None) when unmatched."""
    keys = _path_keys(path)
    for i, (module_name, leaf, spec) in enumerate(_TP_RULES):
        # exact segment equality: substring matching would let Dense_10
        # take Dense_1's row sharding
        if leaf in keys[-1:] and any(k == module_name for k in keys[:-1]):
            return spec, i
    return P(), None


def _is_block_dense_kernel(keys: list) -> bool:
    """A Dense kernel inside a transformer Block: one matching no rule
    means the model drifted from the rule table."""
    return (
        keys[-1:] == ["kernel"]
        and any(k.startswith("Block") for k in keys[:-1])
        and any("Dense" in k for k in keys[:-1])
    )


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a state tree: dataclasses by field name
    (a path key, as ``jax``'s attribute keys), dicts by key, tuples and
    lists by index; anything else is a leaf (tensors, counts)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_with_path(fn, getattr(tree, f.name), path + (f.name,))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tp_state_specs(state):
    """The PartitionSpec tree of a state (a ``TrainState``, a params tree,
    an optimizer state) under the Megatron rules. Strict: every Dense
    kernel inside a Block must match a rule, and every rule must match at
    least one leaf."""
    matched: set = set()
    unmatched: list = []

    def assign(path, _):
        spec, idx = _spec_for_path(path)
        if idx is not None:
            matched.add(idx)
        else:
            keys = _path_keys(path)
            if _is_block_dense_kernel(keys):
                unmatched.append("/".join(keys))
        return spec

    tree = _map_with_path(assign, state)
    if unmatched:
        raise ValueError(
            "tensor-parallel rules cover Dense_0..Dense_3 inside each "
            f"Block, but these Dense kernels matched no rule: "
            f"{sorted(set(unmatched))}. The model's block structure "
            "drifted from _TP_RULES — update the rule table rather "
            "than silently replicating these weights."
        )
    missing = set(range(len(_TP_RULES))) - matched
    if missing:
        raise ValueError(
            "tensor-parallel rules matched no parameter at all for: "
            f"{[_TP_RULES[i][:2] for i in sorted(missing)]} — the "
            "model's layer names drifted from _TP_RULES; fix the "
            "table or the model."
        )
    return tree


def _shard_of(leaf, spec: P, tp: int, i: int):
    """Shard ``i`` of ``leaf`` along the dims ``spec`` names ``"tp"``."""
    if not hasattr(leaf, "shape"):
        return leaf
    for dim, axis in enumerate(spec):
        if axis == "tp":
            n = leaf.shape[dim] // tp
            leaf = leaf.narrow(dim, i * n, n)
    return leaf


def shard_views(tree, specs, tp: int):
    """Yield, for ``i`` in ``range(tp)``, the tree of views that device
    ``i`` of the tp axis holds (each leaf's ``i``-th shard along the dims
    its spec names ``"tp"``; a replicated leaf whole)."""
    flat_specs = {}

    def note(path, spec):
        flat_specs[path] = spec
        return spec

    _map_with_path(note, specs)
    for i in range(tp):
        yield _map_with_path(lambda path, leaf: _shard_of(leaf, flat_specs[path], tp, i),
                             tree)


def check_tp_divisibility(model, tp: int) -> None:
    """d_model / num_heads / d_ff must all split across the tp axis."""
    d_model = getattr(model, "d_model", tp)
    for field, need in (
        ("d_model", d_model),
        ("num_heads", getattr(model, "num_heads", tp)),
        ("d_ff", getattr(model, "d_ff", 0) or 4 * d_model),
    ):
        if need % tp:
            raise ValueError(f"{field}={need} not divisible by tp={tp}")


def tp_across_processes(trainer, grads, loss):
    """The step's gradient and loss of a trainer whose ``_tp_span`` spans
    processes: the sharded leaves summed over the tp processes, then the
    whole gradient and the loss averaged over ``_tp_peers``, the processes
    that hold the same shards (the batch's other shares)."""
    pairs = tree_leaves_with_path(grads)
    sharded = ["tp" in _spec_for_path(path)[0] for path, _ in pairs]
    flat, spec = flatten_params([g for (_, g), s in zip(pairs, sharded) if s])
    summed = iter(tree_leaves(unflatten_params(spec, line_sum(flat, trainer._tp_span))))
    grads = tree_unflatten(grads, [next(summed) if s else g
                                   for (_, g), s in zip(pairs, sharded)])
    peers = trainer._tp_peers
    if len(peers.line) == 1:
        return grads, loss
    return _mean_across_processes((grads, loss), len(peers.line), line_group(peers))


class TensorParallelTrainer(DataParallelTrainer):
    """dp × tp training for :class:`TransformerLM` (dense attention).

    Usage::

        topo = mpit_tpu_torch.init(axis_names=("dp", "tp"), mesh_shape=(2, 4))
        model = TransformerLM(vocab_size=V)
        trainer = TensorParallelTrainer(model, optim.SGD(0.1), topo)
        state = trainer.init_state(torch.Generator().manual_seed(0))
        state, metrics = trainer.step(state, x_global, y_global)

    Requires ``d_model``, ``num_heads`` and ``d_ff`` divisible by tp. Any
    optimizer works (the update sees the whole gradient, as the
    reference's GSPMD update does). ``donate_state`` and ``capture`` (the
    step as a CUDA graph) are :class:`DataParallelTrainer`'s.
    """

    def __init__(self, model, optimizer, topo: Optional[Topology] = None,
                 loss_fn: Optional[Callable] = None, donate_state: bool = True,
                 capture: Optional[bool] = None):
        self.optimizer = optimizer
        self.topo = topo if topo is not None else _current_topology()
        names = self.topo.axis_names
        if len(names) < 2 or names[1] != "tp":
            raise ValueError(
                "TensorParallelTrainer needs a mesh whose second axis is "
                "'tp', e.g. mpit_tpu_torch.init(axis_names=('dp','tp'), "
                f"mesh_shape=(B, T)); got axes {names}"
            )
        if getattr(model, "seq_axis", None) is not None:
            raise ValueError(
                "tensor parallelism uses the dense-attention model "
                "(seq_axis=None); ring attention shards the sequence, "
                "not the weights"
            )
        if getattr(model, "moe_experts", 0):
            raise ValueError(
                "TensorParallelTrainer has no sharding rules for MoE "
                "expert weights (moe_* leaves would silently stay "
                "replicated, losing expert parallelism); use "
                "MoEParallelTrainer for moe_experts > 0"
            )
        check_tp_divisibility(model, self.tp_size)
        self.batch_axis = names[0]
        self._row_span = self.topo.axis_span(self.batch_axis)
        self._tp_span, self._tp_peers = self.topo.axis_span("tp"), self.topo.peers("tp")
        across = {} if self._tp_span.local else {"tp_span": self._tp_span}
        self.model = model.clone(tp=self.tp_size, **across)
        self.accum_steps = 1
        self.donate_state = bool(donate_state)
        self.bucketed = False  # the reference's tp trainer has no exchange knobs
        self.obs, self._tracer = None, None
        self.loss_fn = (loss_fn if loss_fn is not None
                        else common.default_loss_fn(self.model.apply))
        self._vg = common.accumulated_value_and_grad(
            self.loss_fn, 1, remat=getattr(model, "remat", False))
        self._eval = common.build_count_loss_eval(self.model, self.topo.device)
        self._init_capture(capture, optimizer)

    @property
    def tp_size(self) -> int:
        return self.topo.mesh_shape[1]

    @property
    def dp_size(self) -> int:
        return self.topo.mesh_shape[0]

    def state_sharding(self, state):
        """The spec tree of a state under the Megatron rules (strict — see
        :func:`tp_state_specs`)."""
        return tp_state_specs(state)

    def _check(self, x) -> None:
        if len(x) % self.dp_size:
            raise ValueError(
                f"global batch {len(x)} not divisible by dp={self.dp_size}"
            )

    def _shard(self, x, y):
        """This process's rows of a global batch: its dp groups'."""
        per, span = len(x) // self.dp_size, self._row_span
        mine = slice(span.start * per, (span.start + span.count) * per)
        return x[mine], y[mine]

    def _across_processes(self, grads, loss):
        if self._tp_span.local:
            return super()._across_processes(grads, loss)
        return tp_across_processes(self, grads, loss)

    def evaluate(self, state, x, y, batch: int = 512):
        """Token-level accuracy and mean loss over an ``(N, T)`` eval set."""
        common.check_live(state, "evaluate")
        correct, loss_sum, n = common.batched_count_eval(
            self._eval, state.params, x, y, batch, self.dp_size
        )
        tokens = n * x.shape[1]
        return correct / tokens, loss_sum / tokens
