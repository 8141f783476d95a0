"""Pipeline parallelism: GPipe, 1F1B and interleaved schedules over a
``(dp, pp)`` world; counterpart of ``mpit_tpu/parallel/pipeline.py``
(``PipelineParallelTrainer``, algo ``pp-sync``).

The reference shards the transformer's layer stack by STAGE over a ``pp``
mesh axis (device ``s`` holds layers ``[s·L/S, (s+1)·L/S)`` as stacked
leaves) and moves activations stage to stage with ``lax.ppermute``, the
batch cut into microbatches so the stages overlap. The port stacks the
stages on one card as it stacks workers (``comm/topology.py``): the state
keeps the reference's layout byte for byte, ``{"blocks": stacked (L, ...)
Block leaves in chunk storage order, "rest": embed/pos/lnf}``, and a step
runs the schedule as a host loop over its STATIC timetable, stage by stage
within a tick; the ppermute hop is a hand-over of stage slot ``s``'s
output to slot ``s + 1`` at the next tick. The dp groups are stacked on
the batch dim of each microbatch: microbatch ``i`` is every group's
``i``-th slice, in group order. Every op of a block is row-local, so the
mean loss over such a microbatch is the reference's ``pmean`` over dp of
the groups' losses, and its gradient the ``pmean``'d gradient.

- ``gpipe``: every tick forwards each stage's microbatch ``t − s``; the
  last stage's outputs go through the final norm, the tied head and the
  loss, and autograd transposes the whole loop afterwards (the reference's
  ``jax.grad`` of its forward scan), keeping every block's activations;
- ``1f1b`` and ``interleaved`` (``virtual`` chunks per stage, the Megatron
  virtual pipeline; the storage permutation ``_perm`` gives each stage its
  chunks): the forwards and backwards of :func:`schedule_pipeline`'s
  timetable on one loop. A forward saves only its chunk's per-layer
  inputs (in a ring of ``min(S, M)`` slots per chunk); its backward
  recomputes each layer under ``torch.func.vjp`` and transposes it, last
  to first: the reference's O(S·K) activation memory instead of GPipe's
  O((M+S−1)·K).

Boundary ownership is the reference's: only global chunk 0 consumes the
embedding, only the last chunk owns the final norm and head, and each
stage's share of the replicated ``rest`` gradient is summed over the
stages (the reference's ``psum`` over pp). The block is the port's
:class:`~mpit_tpu_torch.models.transformer.Block` in f32 with dense
attention, as the reference runs flax's ``Block``; the final norm is the
port's ``LayerNorm``. The optimizer is the built-in SGD with momentum
(state ``{"params", "momentum", "step"}``) or an elementwise one of
``optim`` (``{"params", "opt_state", "step"}``), with the reference's
``clip_norm``.

In a world of several processes (``Topology``) a process holds either
whole pp groups (pp inside the process: the dp groups' rows are cut
across the processes and the gradient and loss averaged over them) or an
equal share of one pp group's stages (pp spans processes,
``Topology.axis_span("pp")``). Then each process keeps only its stages'
rows ``[start·L/pp, (start+count)·L/pp)`` of every ``blocks`` leaf (in
storage order: under interleaving a stage's chunks are contiguous) and
of their momentum or optimizer state, and its dp group's rows of the
batch; activations and cotangents cross between processes only at its
edge stages, by send and receive on the pp line (:meth:`_exchange`: the
reference's ring ``ppermute``, every message of a tick posted at once and
paired by the same timetable on both sides). GPipe's backward is then
written out (the transpose of a ppermute is the reverse ppermute): the
forward keeps each local stage's graph per microbatch from a leaf input,
and a reverse tick loop transposes them, the last stage opening with the
head's loss. The ``rest`` gradient and the loss are summed over the pp
line in stage order, then everything is averaged over ``peers("pp")``, the
processes that hold the same stages; clipping sums the ``blocks`` leaves'
squares over the pp line. The state is a :class:`PipelineState`, whose
``process_cut`` makes a checkpoint gather the stages along the pp line
(the file is the one-process file) and cut them back on restore.

:func:`schedule_1f1b`, :func:`schedule_pipeline` (``_schedule_cached``) and
``_F_POLICIES`` are the reference's code: the timetables are equal array
for array (``tests/test_torch_pipeline.py``); :func:`init_params` lays the
tree out as the reference's does.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mpit_tpu_torch.comm.collectives import _bytes, line_gather
from mpit_tpu_torch.comm.topology import AxisSpan, Topology, in_process_group, line_group
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.models.layers import LayerNorm, params_tree
from mpit_tpu_torch.models.transformer import Block
from mpit_tpu_torch.parallel import common
from mpit_tpu_torch.utils.params import (
    flatten_params, tree_leaves, tree_map, tree_unflatten, unflatten_params,
)

SCHEDULES = ("gpipe", "1f1b", "interleaved")


def _is_blocks_leaf(path) -> bool:
    """Stage-sharded leaves live under the top-level ``blocks`` group."""
    return bool(path) and path[0] == "blocks"


class PipelineState(dict):
    """The trainer's state ``{"params", "momentum" | "opt_state", "step"}``
    (a dict, as the reference's), which tells a checkpoint how the
    processes hold it: where pp spans processes (``process_line`` not
    local) each holds its stages' rows of every ``blocks`` leaf, of the
    params and of their optimizer state, gathered along the line for the
    file and cut back on restore (``utils/checkpoint.py``)."""

    def __init__(self, items: dict, process_line: AxisSpan):
        super().__init__(items)
        self.process_line = process_line

    def process_cut(self, path) -> Optional[int]:
        """The stage dim (0) of a ``blocks`` leaf where the stages are cut
        across processes; None for every other leaf."""
        return 0 if not self.process_line.local and "blocks" in path else None

    def with_items(self, items: dict) -> "PipelineState":
        return PipelineState(items, self.process_line)


def _modules(d_model: int, num_heads: int, d_ff: int):
    """The block (f32, dense attention) and the final norm every layer
    runs through ``functional_call`` (their own tensors are never read)."""
    cpu = torch.device("cpu")
    return (Block(d_model, num_heads, d_ff, torch.float32, "xla", cpu),
            LayerNorm(d_model, torch.float32, cpu))


def _layer(blocks: dict, row: int) -> dict:
    """Row ``row`` of the stacked leaves, as ``functional_call``'s names."""
    return {f"{mod}.{leaf}": a[row] for mod, node in blocks.items()
            for leaf, a in node.items()}


def _block_apply(block, p: dict, x):
    return torch.func.functional_call(block, p, (x,))


def _final_norm(norm, x, scale, bias):
    return torch.func.functional_call(norm, {"scale": scale, "bias": bias}, (x,))


def _embed(rest: dict, x):
    return rest["embed"][x.long()] + rest["pos"][: x.shape[-1]]


def init_params(generator: torch.Generator, vocab_size: int, num_layers: int,
                d_model: int, d_ff: int, max_len: int, num_heads: int = 4,
                device=None) -> dict:
    """{"blocks": stacked (L, ...) Block leaves, "rest": embed/pos/final
    norm}: each layer drawn by the port's Block initializers, then the
    embedding and positions normal × 0.02 (the reference's layout; its
    values come from its own key)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    blk = Block(d_model, num_heads, d_ff, torch.float32, "xla", torch.device("cpu"))
    layers = []
    for _ in range(num_layers):
        blk.reset_parameters(generator)
        layers.append(params_tree(blk))
    blocks = tree_map(lambda *a: torch.stack(a).to(dev), *layers)
    rest = {
        "embed": (torch.randn(vocab_size, d_model, generator=generator) * 0.02).to(dev),
        "pos": (torch.randn(max_len, d_model, generator=generator) * 0.02).to(dev),
        "lnf_s": torch.ones(d_model, device=dev), "lnf_b": torch.zeros(d_model, device=dev),
    }
    return {"blocks": blocks, "rest": rest}


def schedule_1f1b(n_micro: int, stages: int) -> dict:
    """Static 1F1B timetable for ``n_micro`` microbatches over ``stages``.

    Greedy simulation with the 1F1B priority (run a backward whenever one
    is ready, else the next forward): per (tick, stage) an op code
    (0 idle / 1 fwd / 2 bwd) and microbatch index, plus arrival tables
    saying which microbatch's boundary activation (from stage−1) or
    cotangent (from stage+1) lands at the start of each tick. A unit run
    at tick ``t`` arrives at its neighbor at ``t+1`` (one ppermute hop).

    Properties (asserted by tests): the span is ``2(M+S−1)`` ticks — the
    same bubble as GPipe's forward+transposed-backward — and every stage
    holds at most ``min(S, M)`` microbatches in flight (early stages run
    one ahead of the textbook ``S−s`` because each boundary hop costs a
    ppermute tick), which is the schedule's actual win: saved
    activations stay O(S), not O(M).
    """
    tabs = schedule_pipeline(n_micro, stages, virtual=1)
    # v=1: drop the (all-zero) chunk columns for the original interface
    return {
        "op": tabs["op"],
        "mb": tabs["mb"],
        "arr_act": tabs["arr_act_mb"],
        "arr_ct": tabs["arr_ct_mb"],
        "ticks": tabs["ticks"],
        "max_inflight": tabs["max_inflight"],
    }


# forward-unit orderings tried by the interleaved scheduler; the
# min-span table wins (all are valid — they only reorder ready work)
_F_POLICIES = (
    lambda c, i, S: (i, c),            # microbatch-major
    lambda c, i, S: (c, i),            # chunk-major
    lambda c, i, S: (i // S, c, i),    # Megatron grouping: S-microbatch
                                       # blocks cycling through chunks
)


def schedule_pipeline(n_micro: int, stages: int, virtual: int = 1) -> dict:
    """Static interleaved-1F1B timetable: ``virtual`` chunks per device.

    Global chunk ``c`` (0..v·S) lives on device ``c % S`` as local chunk
    ``c // S`` and holds ``L/(v·S)`` consecutive layers; activations hop
    chunk ``c → c+1``, which is always ONE forward ring hop (cotangents
    the reverse), so the communication pattern is identical to plain
    1F1B — only the timetable changes. Each tick a device runs one unit
    (fwd or bwd of one (chunk, microbatch)); a unit's output arrives at
    its neighbor the next tick.

    The greedy simulation prefers a ready backward, then tries each
    forward ordering in ``_F_POLICIES`` and keeps the shortest-span
    table. Why interleaving wins: a unit is ``1/v`` of a device's
    per-microbatch work, so the (S−1)-deep fill/drain skew costs
    ``(S−1)/v`` device-work units instead of ``S−1`` — the Megatron
    virtual-pipeline argument. ``virtual=1`` reproduces plain 1F1B
    exactly.

    Results are cached per (M, S, v) — treat the tables as read-only.
    With one chunk per device every policy picks the same unit, so v=1
    skips the policy search.
    """
    return _schedule_cached(n_micro, stages, virtual)


@functools.lru_cache(maxsize=64)
def _schedule_cached(n_micro: int, stages: int, virtual: int) -> dict:
    M, S, v = n_micro, stages, virtual
    C = v * S  # total chunks

    def simulate(f_key):
        f_done = [[-1] * M for _ in range(C)]
        b_done = [[-1] * M for _ in range(C)]
        nf = [0] * C
        nb = [0] * C
        inflight_max = [0] * S
        rows = []  # per tick: per device (op, c_local, mb)
        t, total_b = 0, 0
        ring = min(S, M)
        while total_b < C * M:
            if t > 6 * v * (M + S) + 16:
                raise AssertionError("pipeline schedule failed to converge")
            row = []
            for s in range(S):
                chunks = [cl * S + s for cl in range(v)]
                pick = (0, 0, 0)
                b_ready = [
                    (c, nb[c]) for c in chunks
                    if nb[c] < M and (
                        0 <= f_done[c][nb[c]] < t if c == C - 1
                        else 0 <= b_done[c + 1][nb[c]] < t
                    )
                ]
                if b_ready:
                    # drain-first: the highest chunk's backward unblocks
                    # the longest dependency chain
                    c, i = max(b_ready, key=lambda ci: ci[0])
                    pick = (2, c // S, i)
                else:
                    f_ready = [
                        (c, nf[c]) for c in chunks
                        if nf[c] < M and (nf[c] - nb[c]) < ring and (
                            c == 0 or 0 <= f_done[c - 1][nf[c]] < t
                        )
                    ]
                    if f_ready:
                        c, i = min(
                            f_ready, key=lambda ci: f_key(ci[0], ci[1], S)
                        )
                        pick = (1, c // S, i)
                row.append(pick)
            for s, (op, cl, mb) in enumerate(row):
                c = cl * S + s
                if op == 1:
                    f_done[c][mb] = t
                    nf[c] += 1
                    inflight_max[s] = max(
                        inflight_max[s],
                        sum(nf[x] - nb[x] for x in range(s, C, S)),
                    )
                elif op == 2:
                    b_done[c][mb] = t
                    nb[c] += 1
                    total_b += 1
            rows.append(row)
            t += 1
        return t, rows, f_done, b_done, inflight_max

    best = None
    for key in (_F_POLICIES if v > 1 else _F_POLICIES[:1]):
        result = simulate(key)
        if best is None or result[0] < best[0]:
            best = result
    T, rows, f_done, b_done, inflight_max = best

    op = np.zeros((T, S), np.int32)
    chunk = np.zeros((T, S), np.int32)
    mb = np.zeros((T, S), np.int32)
    for t, row in enumerate(rows):
        for s, (o, cl, i) in enumerate(row):
            op[t, s], chunk[t, s], mb[t, s] = o, cl, i
    # arrivals: (local chunk, mb) landing at each (tick, device); -1 none
    arr_act_c = -np.ones((T, S), np.int32)
    arr_act_mb = -np.ones((T, S), np.int32)
    arr_ct_c = -np.ones((T, S), np.int32)
    arr_ct_mb = -np.ones((T, S), np.int32)
    for c in range(C):
        for i in range(M):
            if c + 1 < C and 0 <= f_done[c][i] and f_done[c][i] + 1 < T:
                td, dev = f_done[c][i] + 1, (c + 1) % S
                arr_act_c[td, dev] = (c + 1) // S
                arr_act_mb[td, dev] = i
            if c - 1 >= 0 and 0 <= b_done[c][i] and b_done[c][i] + 1 < T:
                td, dev = b_done[c][i] + 1, (c - 1) % S
                arr_ct_c[td, dev] = (c - 1) // S
                arr_ct_mb[td, dev] = i
    return {
        "op": op,
        "chunk": chunk,
        "mb": mb,
        "arr_act_c": arr_act_c,
        "arr_act_mb": arr_act_mb,
        "arr_ct_c": arr_ct_c,
        "arr_ct_mb": arr_ct_mb,
        "ticks": T,
        "max_inflight": inflight_max,
    }


def _hidden_rows(block, blocks: dict, h, rows):
    for r in rows:
        h = _block_apply(block, _layer(blocks, r), h)
    return h


def reference_apply(params, x, num_heads: int):
    """Unpipelined ground truth: the same function, all layers in order.
    ``d_model``/``d_ff`` are read off the param shapes."""
    blocks, rest = params["blocks"], params["rest"]
    d_model = blocks["Dense_0"]["kernel"].shape[1]
    d_ff = blocks["Dense_2"]["kernel"].shape[-1]
    block, norm = _modules(d_model, num_heads, d_ff)
    h = _hidden_rows(block, blocks, _embed(rest, x),
                     range(blocks["Dense_0"]["kernel"].shape[0]))
    h = _final_norm(norm, h, rest["lnf_s"], rest["lnf_b"])
    return h @ rest["embed"].T


class PipelineParallelTrainer:
    """Pipeline trainer for the transformer LM over a ``(dp, pp)`` world.

    Usage::

        topo = mpit_tpu_torch.init(axis_names=("dp", "pp"), mesh_shape=(2, 4))
        tr = PipelineParallelTrainer(
            vocab_size=V, num_layers=8, d_model=64, num_heads=4,
            seq_len=T, topo=topo, n_micro=4, lr=0.1, momentum=0.9)
        state = tr.init_state(torch.Generator().manual_seed(0))
        state, metrics = tr.step(state, x_global, y_global)

    Requires ``num_layers % (pp · virtual) == 0`` and the per-dp-group batch
    divisible by ``n_micro``. ``optimizer``: an elementwise ``optim``
    transform replacing the built-in SGD with momentum (``lr``/``momentum``
    are then ignored); ``clip_norm``: global-norm clipping of the reduced
    gradient over the whole model, with either optimizer;
    ``donate_state``: update this process's params rows and their momentum
    or optimizer state in place, consuming the given state (stepping,
    evaluating or checkpointing it again raises), as the reference donates
    it; without, each step keeps a second copy of the whole state alive.
    The batch axis is the mesh's first, whatever its name. The step runs
    eagerly (``eager_reasons`` says why; ``parallel/capture.py``).
    """

    # the reference's step is one compiled program; this one stays eager
    capture = False
    eager_reasons = ("the pipeline's schedule, a loop over its timetable, runs on the "
                     "host between its device calls",)

    def __init__(
        self,
        vocab_size: int,
        num_layers: int,
        d_model: int,
        num_heads: int,
        seq_len: int,
        topo: Optional[Topology] = None,
        d_ff: int = 0,
        n_micro: int = 4,
        lr: float = 0.1,
        momentum: float = 0.9,
        schedule: str = "gpipe",
        virtual: int = 2,
        optimizer=None,
        clip_norm: Optional[float] = None,
        donate_state: bool = True,
    ):
        self.topo = topo if topo is not None else _current_topology()
        self.donate_state = bool(donate_state)
        names = self.topo.axis_names
        if len(names) < 2 or names[1] != "pp":
            raise ValueError(
                "PipelineParallelTrainer needs a mesh whose second axis is "
                f"'pp'; got axes {names}"
            )
        self.pp = self.topo.mesh_shape[1]
        self.dp = self.topo.mesh_shape[0]
        # this process's stages and dp groups (raises where its workers
        # form no block of the mesh), and the processes holding its stages
        self._pp_span = self.topo.axis_span("pp")
        # the batch axis is the mesh's first, whatever its name (the
        # reference's by position)
        self._dp_span = self.topo.axis_span(names[0])
        self._dp_peers = self.topo.peers("pp")
        self._across = not self._pp_span.local
        self._stages = list(range(self._pp_span.start,
                                  self._pp_span.start + self._pp_span.count))
        if num_layers % self.pp:
            raise ValueError(
                f"num_layers={num_layers} not divisible by pp={self.pp}"
            )
        if d_model % num_heads:
            raise ValueError(
                f"d_model={d_model} not divisible by num_heads={num_heads}"
            )
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.d_model = d_model
        self.num_heads = num_heads
        self.d_ff = d_ff or 4 * d_model
        self.seq_len = seq_len
        self.n_micro = n_micro
        self.lr, self.momentum = lr, momentum
        self.optimizer = optimizer
        if optimizer is not None:
            common.assert_elementwise_optimizer(optimizer, "PipelineParallelTrainer")
        self.clip_norm = common.check_clip_norm(clip_norm)
        if schedule not in SCHEDULES:
            raise ValueError(
                f"schedule={schedule!r} must be 'gpipe', '1f1b', or "
                "'interleaved'"
            )
        self.schedule = schedule
        # virtual chunks per stage; only the interleaved schedule has more
        # than one
        self.virtual = virtual if schedule == "interleaved" else 1
        if self.virtual < 1:
            raise ValueError(f"virtual={virtual} must be >= 1")
        if num_layers % (self.pp * self.virtual):
            raise ValueError(
                f"num_layers={num_layers} not divisible by "
                f"pp x virtual = {self.pp}x{self.virtual}"
            )
        # storage permutation: stacked row r holds the layer that stage
        # r // K's local chunks cover (under interleaving stage s owns
        # chunks {s, s+S, ...}); identity for gpipe/1f1b
        kc = num_layers // (self.pp * self.virtual)
        self._perm = np.array([
            (cl * self.pp + s_) * kc + j
            for s_ in range(self.pp)
            for cl in range(self.virtual)
            for j in range(kc)
        ])
        self._inv_perm = np.argsort(self._perm)
        self._permuted = self.virtual > 1
        self._block, self._norm = _modules(d_model, num_heads, self.d_ff)

    # -- layout -------------------------------------------------------------

    def _unpermute(self, params: dict) -> dict:
        """Params with blocks in GLOBAL layer order (no-op unless the
        interleaved storage permutation is active)."""
        if not self._permuted:
            return params
        inv = torch.as_tensor(self._inv_perm)
        return {"blocks": tree_map(lambda a: a[inv.to(a.device)], params["blocks"]),
                "rest": params["rest"]}

    @property
    def ticks(self) -> int:
        """The timeline's span of one step, in schedule ticks: GPipe's
        forward ``M+S−1`` (autograd appends a backward of the same length),
        1F1B's ``2(M+S−1)`` carrying both directions; interleaved ticks are
        chunk units, ``1/virtual`` of a stage's work."""
        if self.schedule in ("1f1b", "interleaved"):
            return int(schedule_pipeline(self.n_micro, self.pp, self.virtual)["ticks"])
        return self.n_micro + self.pp - 1

    def _whole_blocks(self, params: dict) -> dict:
        """Params with the whole stack of blocks: where pp spans processes,
        the stages' rows gathered along the pp line (a collective)."""
        if not self._across:
            return params
        return {"blocks": tree_map(lambda a: line_gather(a, self._pp_span), params["blocks"]),
                "rest": params["rest"]}

    def init_state(self, generator: Optional[torch.Generator] = None,
                   sample_x=None, params=None) -> PipelineState:
        """``{"params", "momentum" | "opt_state", "step"}`` from ``params``
        (in global layer order) or :func:`init_params`; under interleaving
        the layers are permuted into chunk storage order (checkpoints carry
        this layout). Where pp spans processes the whole stack is drawn (or
        given) and this process keeps its stages' rows, so every process
        holds the one-process run's values. ``sample_x`` is accepted and
        ignored, as in the reference."""
        given = params is not None
        if params is None:
            params = init_params(
                generator, self.vocab_size, self.num_layers, self.d_model,
                self.d_ff, self.seq_len, num_heads=self.num_heads)
        dev = self.topo.device
        # a donated step writes over the state's tensors: never the caller's
        copy = given and self.donate_state
        params = tree_map(lambda a: a.detach().to(dev, copy=copy), params)
        if self._permuted:
            perm = torch.as_tensor(self._perm, device=dev)
            params = {"blocks": tree_map(lambda a: a[perm], params["blocks"]),
                      "rest": params["rest"]}
        if self._across:
            k = self.num_layers // self.pp
            mine = slice(self._stages[0] * k, (self._stages[-1] + 1) * k)
            params = {"blocks": tree_map(lambda a: a[mine].clone(), params["blocks"]),
                      "rest": params["rest"]}
        if self.optimizer is not None:
            state = {"params": params, "opt_state": self.optimizer.init(params), "step": 0}
        else:
            state = {"params": params, "momentum": tree_map(torch.zeros_like, params),
                     "step": 0}
        return PipelineState(state, self._pp_span)

    # -- the schedules ------------------------------------------------------

    def _micro(self, a: torch.Tensor) -> torch.Tensor:
        """This process's rows ``(B_l, ...)`` as ``(M, R, ...)``: microbatch
        ``i`` is each of its dp groups' ``i``-th slice, in group order."""
        m = self.n_micro
        groups = self._dp_span.count
        b = a.shape[0] // groups
        a = a.reshape(groups, m, b // m, *a.shape[1:]).transpose(0, 1)
        return a.reshape(m, -1, *a.shape[3:])

    def _stage_rows(self, s: int, cl: int) -> list:
        """The rows of this process's ``blocks`` leaves that stage ``s``'s
        local chunk ``cl`` runs."""
        k = self.num_layers // self.pp
        kc = k // self.virtual
        return [(s - self._stages[0]) * k + cl * kc + j for j in range(kc)]

    def _exchange(self, act_out, act_in: bool, ct_out, ct_in: bool, shape: tuple):
        """One hop of the pp line's ring between this process's edge stages
        and its neighbours: ``act_out`` (its last stage's output, or None)
        goes to the next process and ``ct_out`` (its first stage's input
        cotangent, or None) to the previous one; ``act_in``/``ct_in`` say
        whether an activation arrives from the previous process and a
        cotangent from the next (f32 of ``shape``). Both sides derive
        the same pairs from the same timetable; every message of the hop is
        posted at once (``batch_isend_irecv``, the bytes, tagged by kind)
        and waited for. Returns the (activation, cotangent) received."""
        import torch.distributed as dist

        line = self._pp_span.line
        me = line.index(self.topo.process_index)
        nxt, prv = line[(me + 1) % len(line)], line[(me - 1) % len(line)]
        ops, got = [], [None, None]
        for kind, (out, into, dst, src) in enumerate(((act_out, act_in, nxt, prv),
                                                      (ct_out, ct_in, prv, nxt))):
            if out is not None:
                ops.append(dist.P2POp(dist.isend, _bytes(out.detach().contiguous()), dst,
                                      tag=kind))
            if into:
                got[kind] = torch.empty(shape, device=self.topo.device)
                ops.append(dist.P2POp(dist.irecv, _bytes(got[kind]), src, tag=kind))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got[0], got[1]

    def _gpipe_forward(self, params, x_mb, tail=None):
        """The pipelined forward: tick ``t`` runs microbatch ``t − s`` on
        each of this process's stages ``s``; stage ``s > 0`` takes stage
        ``s − 1``'s output of the previous tick (the ppermute hop: across
        processes, :meth:`_exchange`). Returns the last stage's outputs in
        microbatch order (none where another process holds it). With
        ``tail(i, out)`` (the head's loss of the last stage's microbatch
        ``i``) each stage's graph per microbatch is kept, from a leaf input
        at its boundary: returns ``{(s, i): (input leaf or None, output)}``.
        Layers in storage order."""
        s_n, m, stages = self.pp, self.n_micro, self._stages
        rest, blocks = params["rest"], params["blocks"]
        first, last = stages[0], stages[-1]
        shape = (*x_mb.shape[1:], self.d_model)
        outs, graphs, prev = [], {}, [None] * len(stages)
        for t in range(m + s_n - 1):
            recv = None
            if self._across:
                recv, _ = self._exchange(
                    prev[-1] if last < s_n - 1 and 0 <= t - 1 - last < m else None,
                    first > 0 and 0 <= t - first < m, None, False, shape)
            cur = [None] * len(stages)
            for ls, s in enumerate(stages):
                i = t - s
                if not 0 <= i < m:
                    continue
                inp = None
                if s == 0:
                    h = _embed(rest, x_mb[i])
                else:
                    h = prev[ls - 1] if ls else recv
                    if tail is not None:
                        h = inp = h.detach().requires_grad_()
                h = cur[ls] = _hidden_rows(self._block, blocks, h, self._stage_rows(s, 0))
                if s == s_n - 1:
                    outs.append(h)
                    if tail is not None:
                        h = tail(i, h)
                if tail is not None:
                    graphs[s, i] = (inp, h)
            prev = cur
        return graphs if tail is not None else outs

    def _head_loss(self, rest, out, y_i):
        """Per-microbatch tail: final norm, tied head, mean CE over the
        microbatch, divided by M (the batch mean is the microbatches')."""
        h2 = _final_norm(self._norm, out, rest["lnf_s"], rest["lnf_b"])
        logits = (h2 @ rest["embed"].T).float()
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y_i.long().reshape(-1)) / self.n_micro

    def _gpipe_loss_and_grads(self, params, x_mb, y_mb):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        h = torch.stack(self._gpipe_forward(p, x_mb))
        rest = p["rest"]
        h = _final_norm(self._norm, h, rest["lnf_s"], rest["lnf_b"])
        loss = common.cross_entropy_loss(h @ rest["embed"].T, y_mb)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, list(grads))

    def _gpipe_across(self, params, x_mb, y_mb):
        """GPipe with the stages across processes: the forward keeps each
        local stage's graph per microbatch (:meth:`_gpipe_forward`), then a
        reverse tick loop transposes them, stage ``s`` taking microbatch
        ``t − s``'s output cotangent from stage ``s + 1`` of the tick after
        (the reverse hop) and the last stage opening with its loss. Returns
        this process's loss share and gradient shares."""
        s_n, m, stages = self.pp, self.n_micro, self._stages
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        p = tree_unflatten(params, leaves)
        graphs = self._gpipe_forward(
            p, x_mb, tail=lambda i, out: self._head_loss(p["rest"], out, y_mb[i]))
        first, last = stages[0], stages[-1]
        loss = torch.zeros((), device=x_mb.device)
        for i in range(m):
            if (s_n - 1, i) in graphs:
                loss = loss + graphs[s_n - 1, i][1].detach()
        shape = (*x_mb.shape[1:], self.d_model)
        grads = [None] * len(leaves)
        pb = [None] * len(stages)
        for t in reversed(range(m + s_n - 1)):
            _, recv = self._exchange(
                None, False, pb[0] if first > 0 and 0 <= t + 1 - first < m else None,
                last < s_n - 1 and 0 <= t - last < m, shape)
            cur = [None] * len(stages)
            for ls, s in enumerate(stages):
                i = t - s
                if not 0 <= i < m:
                    continue
                inp, out = graphs.pop((s, i))
                cot = None if s == s_n - 1 else (pb[ls + 1] if ls + 1 < len(stages) else recv)
                wrt = leaves + ([inp] if inp is not None else [])
                got = torch.autograd.grad(out, wrt, cot, allow_unused=True)
                for j, g in enumerate(got[:len(leaves)]):
                    if g is not None:
                        grads[j] = g if grads[j] is None else grads[j] + g
                if inp is not None:
                    cur[ls] = got[-1]
            pb = cur
        grads = [torch.zeros_like(a) if g is None else g for a, g in zip(leaves, grads)]
        return loss, tree_unflatten(params, grads)

    def _scheduled_loss_and_grads(self, params, x_mb, y_mb):
        """1F1B / interleaved: :func:`schedule_pipeline`'s forwards and
        backwards on one tick loop. A forward keeps its chunk's per-layer
        inputs and output in a ring of R = min(S, M) slots per chunk; a
        backward recomputes each layer under ``torch.func.vjp`` and
        transposes it, last to first; chunk 0 closes through the embedding
        at once, the last chunk opens with the head."""
        s_n, m, v, stages = self.pp, self.n_micro, self.virtual, self._stages
        n = len(stages)
        tabs = schedule_pipeline(m, s_n, v)
        ring_n = min(s_n, m)
        rest = {k: a.detach() for k, a in params["rest"].items()}
        blocks = tree_map(lambda a: a.detach(), params["blocks"])
        block = self._block
        s_first, s_last = stages[0], stages[-1]
        shape = (*x_mb.shape[1:], self.d_model)

        def slots():
            return [[[None] * ring_n for _ in range(v)] for _ in range(n)]

        act, cot, ring = slots(), slots(), slots()
        pf, pb = [None] * n, [None] * n
        gb = tree_map(torch.zeros_like, blocks)
        gr = [tree_map(torch.zeros_like, rest) for _ in range(n)]
        losses = [torch.zeros((), device=x_mb.device) for _ in range(n)]
        for tk in range(int(tabs["ticks"])):
            # the hop: last tick's outputs land at their neighbours, the edge
            # stages' from and to the neighbouring processes
            recv_a, recv_c = pf[-1], pb[0]
            if self._across:
                recv_a, recv_c = self._exchange(
                    pf[-1] if tabs["arr_act_mb"][tk, (s_last + 1) % s_n] >= 0 else None,
                    tabs["arr_act_mb"][tk, s_first] >= 0,
                    pb[0] if tabs["arr_ct_mb"][tk, (s_first - 1) % s_n] >= 0 else None,
                    tabs["arr_ct_mb"][tk, s_last] >= 0, shape)
            recv_a = [recv_a] + pf[:-1]
            recv_c = pb[1:] + [recv_c]
            for ls, s in enumerate(stages):
                if tabs["arr_act_mb"][tk, s] >= 0:
                    i = int(tabs["arr_act_mb"][tk, s])
                    act[ls][int(tabs["arr_act_c"][tk, s])][i % ring_n] = recv_a[ls]
                if tabs["arr_ct_mb"][tk, s] >= 0:
                    i = int(tabs["arr_ct_mb"][tk, s])
                    cot[ls][int(tabs["arr_ct_c"][tk, s])][i % ring_n] = recv_c[ls]
            for ls, s in enumerate(stages):
                op, cl, i = (int(tabs[k][tk, s]) for k in ("op", "chunk", "mb"))
                rows = self._stage_rows(s, cl)
                first = s == 0 and cl == 0
                if op == 1:
                    with torch.no_grad():
                        h = _embed(rest, x_mb[i]) if first else act[ls][cl][i % ring_n]
                        saved = [h]
                        for r in rows:
                            h = _block_apply(block, _layer(blocks, r), h)
                            saved.append(h)
                    ring[ls][cl][i % ring_n] = saved
                    pf[ls] = h
                elif op == 2:
                    entry = ring[ls][cl][i % ring_n]
                    if s == s_n - 1 and cl == v - 1:
                        loss_i, head_vjp = torch.func.vjp(
                            lambda r, o: self._head_loss(r, o, y_mb[i]), rest, entry[-1])
                        g_head, cc = head_vjp(torch.ones_like(loss_i))
                        gr[ls] = tree_map(torch.add, gr[ls], g_head)
                        losses[ls] = losses[ls] + loss_i
                    else:
                        cc = cot[ls][cl][i % ring_n]
                    for j in reversed(range(len(rows))):
                        _, vjp = torch.func.vjp(
                            lambda p, xx: _block_apply(block, p, xx),
                            _layer(blocks, rows[j]), entry[j])
                        gp, cc = vjp(cc)
                        for name, g in gp.items():
                            mod, leaf = name.split(".")
                            gb[mod][leaf][rows[j]] += g
                    if first:
                        _, emb_vjp = torch.func.vjp(lambda r: _embed(r, x_mb[i]), rest)
                        (g_emb,) = emb_vjp(cc)
                        gr[ls] = tree_map(torch.add, gr[ls], g_emb)
                    pb[ls] = cc
        # each stage's share of the replicated rest, summed (psum over pp)
        g_rest = gr[0]
        for g in gr[1:]:
            g_rest = tree_map(torch.add, g_rest, g)
        loss = losses[0]
        for l_s in losses[1:]:
            loss = loss + l_s
        return loss, {"blocks": gb, "rest": g_rest}

    def _step(self, state: dict, x, y):
        """One step on this process's rows ``(B_l, T)`` (device tensors)."""
        common.check_live(state)
        x_mb, y_mb = self._micro(x), self._micro(y)
        params = state["params"]
        if self.schedule != "gpipe":
            loss, grads = self._scheduled_loss_and_grads(params, x_mb, y_mb)
        elif self._across:
            loss, grads = self._gpipe_across(params, x_mb, y_mb)
        else:
            loss, grads = self._gpipe_loss_and_grads(params, x_mb, y_mb)
        if self._across:
            grads, loss = self._reduce_across(grads, loss)
        elif in_process_group():
            from mpit_tpu_torch.parallel.sync import _mean_across_processes

            grads, loss = _mean_across_processes((grads, loss), self.topo.process_count)
        if self.clip_norm is None:
            pass
        elif self._across:
            # the blocks are the pp line's disjoint shares: their squares
            # are summed over the line, the replicated rest counts once
            grads, _ = common.clip_by_global_norm_in_mesh(
                grads, self.clip_norm, "pp", is_sharded=_is_blocks_leaf, line=self._pp_span)
        else:
            # every stage lives in this process: the blocks are whole here,
            # so each leaf counts once
            grads, _ = common.clip_by_global_norm_in_mesh(
                grads, self.clip_norm, "pp", is_sharded=lambda path: False)
        donate = self.donate_state
        if self.optimizer is not None:
            params, opt_state = self.optimizer.update(params, grads, state["opt_state"],
                                                      inplace=donate)
            new = {"params": params, "opt_state": opt_state}
        elif donate:
            mom = state["momentum"]
            with torch.no_grad():
                # m·μ + g, then p − m·lr: the roundings of the branch below
                for p, m_, g in zip(tree_leaves(params), tree_leaves(mom), tree_leaves(grads)):
                    m_.mul_(self.momentum).add_(g)
                    p.sub_(m_ * self.lr)
            new = {"params": params, "momentum": mom}
        else:
            mom = tree_map(lambda m_, g: self.momentum * m_ + g, state["momentum"], grads)
            params = tree_map(lambda p, m_: p - self.lr * m_, params, mom)
            new = {"params": params, "momentum": mom}
        new["step"] = state["step"] + 1
        common.donated(state, donate)
        return PipelineState(new, self._pp_span), {"loss": loss}

    def _reduce_across(self, grads: dict, loss):
        """The step's gradient and loss where pp spans processes (the
        reference's ``psum`` over pp, then ``pmean`` over dp): the rest
        gradient and the loss, each process's stages' shares, summed over
        the pp line in stage order; then everything averaged over the
        processes that hold the same stages."""
        from mpit_tpu_torch.parallel.sync import _mean_across_processes

        flat, spec = flatten_params((grads["rest"], loss))
        parts = line_gather(flat[None], self._pp_span)
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        g_rest, loss = unflatten_params(spec, total)
        grads = {"blocks": grads["blocks"], "rest": g_rest}
        peers = self._dp_peers
        if len(peers.line) > 1:
            grads, loss = _mean_across_processes((grads, loss), len(peers.line),
                                                 line_group(peers))
        return grads, loss

    # -- public interface ---------------------------------------------------

    def _check(self, x):
        b = len(x)
        if b % self.dp or (b // self.dp) % self.n_micro:
            raise ValueError(
                f"global batch {b} must split into dp={self.dp} shards of "
                f"a multiple of n_micro={self.n_micro}"
            )
        if x.shape[1] > self.seq_len:
            raise ValueError(
                f"sequence of {x.shape[1]} exceeds the position "
                f"table (seq_len={self.seq_len})"
            )

    def _shard(self, x, y):
        """This process's rows of a global batch: its dp groups' (the
        processes of one pp line take the same rows)."""
        per = len(x) // self.dp
        mine = slice(self._dp_span.start * per,
                     (self._dp_span.start + self._dp_span.count) * per)
        return x[mine], y[mine]

    def step(self, state, x_global, y_global):
        """One pipelined step on a global ``(B, T)`` batch."""
        self._check(x_global)
        x, y = self._shard(torch.as_tensor(x_global), torch.as_tensor(y_global))
        dev = self.topo.device
        return self._step(state, x.to(dev), y.to(dev))

    def fit(self, batches, state, epochs: int = 1, log_every: int = 0,
            start_epoch: int = 0, skip_steps: int = 0, on_step=None,
            prefetch: int = 2):
        """Epoch loop (``common.synced_fit_loop``); returns (state,
        last_metrics)."""
        return common.synced_fit_loop(
            self._step, batches, state, device=self.topo.device, check=self._check,
            shard=self._shard, log_tag=f"pp-{self.schedule}", epochs=epochs,
            log_every=log_every, start_epoch=start_epoch, skip_steps=skip_steps,
            on_step=on_step, prefetch=prefetch,
        )

    @torch.no_grad()
    def _eval_batch(self, params, x, y):
        """(correct tokens, CE sum) of a global eval batch: the pipelined
        forward (across processes too), or under interleaving the whole
        stack in global order as one stage of L (``params`` gathered and
        unpermuted by :meth:`evaluate`, as the reference gathers them);
        the head ``EVAL_ROWS`` windows at a time, where the last stage
        lives. Summed over the world's processes (the others count 0)."""
        dev = self.topo.device
        x, y = self._shard(torch.as_tensor(x), torch.as_tensor(y))
        x, y = self._micro(x.to(dev)), self._micro(y.to(dev))
        blocks, rest = params["blocks"], params["rest"]
        owner = self._stages[-1] == self.pp - 1
        if self._permuted:
            h = torch.stack([_hidden_rows(self._block, blocks, _embed(rest, xi),
                                          range(self.num_layers)) for xi in x]) if owner else None
        else:
            outs = self._gpipe_forward(params, x)
            h = torch.stack(outs) if owner else None
        correct = torch.zeros((), dtype=torch.int64, device=dev)
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        hy = () if h is None else zip(h.reshape(-1, *h.shape[2:]).split(common.EVAL_ROWS),
                                      y.reshape(-1, y.shape[-1]).split(common.EVAL_ROWS))
        for hs, ys in hy:
            logits = _final_norm(self._norm, hs, rest["lnf_s"], rest["lnf_b"]) @ rest["embed"].T
            correct += (logits.argmax(-1) == ys).sum()
            loss_sum += common.cross_entropy_sum(logits, ys)
        if in_process_group():
            import torch.distributed as dist

            both = torch.stack([correct.double(), loss_sum.double()])
            dist.all_reduce(both)
            return both[0], both[1]
        return correct, loss_sum

    def evaluate(self, state, x, y, batch: int = 512):
        """Token-level accuracy and mean loss over an ``(N, T)`` eval set."""
        common.check_live(state, "evaluate")
        if x.shape[1] > self.seq_len:
            raise ValueError(
                f"sequence of {x.shape[1]} exceeds the position "
                f"table (seq_len={self.seq_len})"
            )
        params = state["params"]
        if self._permuted:
            params = self._unpermute(self._whole_blocks(params))
        correct, loss_sum, n = common.batched_count_eval(
            self._eval_batch, params, x, y, batch, self.dp * self.n_micro
        )
        tokens = n * x.shape[1]
        return correct / tokens, loss_sum / tokens
