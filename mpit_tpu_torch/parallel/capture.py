"""A training unit as a CUDA graph: the counterpart of the reference's
``jax.jit(..., donate_argnums=(0,))`` over each device trainer's unit: the
EASGD round (``mpit_tpu/parallel/easgd.py:107-153``), the fused sync-DP
step (``sync.py:240-248``) and the steps of its seq, tp and composed
subclasses (``seq.py:106-114``, ``tensor.py:211-212``,
``composed.py:124-125``), the ZeRO-1 step (``zero.py:239-247``), the MoE
step (``moe.py:192-200``) and the Downpour round (``downpour.py:147-155``).

The reference compiles a unit once and runs it as one program on its
donated state. Here a trainer runs its first unit eagerly (the warm-up: a
real unit, which builds the kernels and picks the libraries' plans),
captures the next with ``torch.cuda.graph``, and replays the graph for
that unit and every later one. Nothing runs while a graph is captured,
so a captured unit is performed by its first replay. A graph bakes in the
addresses it was captured with, so:

- the state's tensors are its static buffers. The trainers donate their
  state (updated in place, storage kept), and the graph is keyed on the
  address, shape, strides and dtype of every state tensor and on the
  inputs' shapes and dtypes: a state with other storage (a restored
  checkpoint, a new ``init_state``) makes the next unit a warm-up again,
  and the one after it captures anew;
- each batch is copied into static input buffers, one device-to-device
  copy each;
- the values the optimizers read on the host (a schedule's learning rate,
  Adam's bias corrections) live in one static float32 buffer, which the
  host fills before each unit from ``optimizer.host_scalars`` (one copy
  from pinned memory); the caller advances the optimizers' counts after a
  replay (``optimizer.advance``), since the Python that moved them does
  not run;
- the unit's metrics (a dict of 0-dim device tensors: the loss, and
  moe-sync's ``moe_*`` statistics) are the graph's static outputs, and
  each replay returns device copies of them, so every unit's metrics stay
  its own.

The kernels' launch counters (``ops.elastic.launches``,
``ops.flash_attention.launches``) move while a unit's Python runs, which
is once, at capture: the graph takes back what the capture added and adds
it again on every replay, so they count the launches made on the card.
:data:`replays` counts the replays of every graph, for a run to show
that it replayed.

Warm-up and capture run on one side stream of the graph's own, ordered
after and before the caller's stream. There is no fallback: a unit that
cannot be captured raises. :func:`eager_reasons` says which trainers stay
eager, and why; every device trainer carries its reasons
(:class:`Captured`).

A server's decode segments (``models/serving.py``, the counterpart of the
reference's ``_serve_segment`` and ``_serve_spec_segment``, each compiled
once per static shape over the donated resident cache) run through a
:class:`GraphSet`: one graph per segment length (the speculative server:
one round), all on one side stream and in one memory pool.

Captures may come from several threads of one process (a fleet runs its
replicas as threads, each with its own server). :func:`capture_graph`
holds a module lock for the whole of each capture, so no two overlap;
switches the collector off and on under that lock (it acts on the whole
process); and captures in ``"thread_local"`` error mode, under which
another thread's allocations and launches do not end the capture.
"""

from __future__ import annotations

import dataclasses
import gc
import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

# graph replays, over every trainer and server; a run resets it to 0 and
# reads it back
replays = 0

# held for the whole of each capture in the process (capture_graph)
_CAPTURING = threading.Lock()


def device_reasons(device) -> list:
    """Why work on ``device`` cannot be captured: the device, where it is
    not a CUDA one."""
    if torch.device(device).type != "cuda":
        return [f"its device is {device}, and a CUDA graph needs a CUDA device"]
    return []


def eager_reasons(device, donate_state: bool, optimizer, bucketed: bool = False,
                  server_optimizer=None) -> list:
    """Why a trainer with these settings runs its units eagerly: one
    reason each, none when it can capture them. ``server_optimizer`` is
    Downpour's (None: model averaging)."""
    from mpit_tpu_torch.comm.topology import in_process_group

    why = device_reasons(device)
    if not donate_state:
        why.append("donate_state=False: a graph updates the storage it was "
                   "captured with, in place")
    if in_process_group():
        why.append("it is one process of a world of several, whose collectives "
                   "are not captured")
    if bucketed:
        why.append("the bucketed or quantized exchange is not captured")
    for name, opt in (("optimizer", optimizer), ("server_optimizer", server_optimizer)):
        if opt is not None and not (hasattr(opt, "host_scalars") and hasattr(opt, "advance")):
            why.append(f"its {name} has no host_scalars/advance (an optim.Chain has)")
    return why


def resolve(capture: Optional[bool], reasons: Sequence[str]) -> bool:
    """Whether to capture: ``capture`` None captures where nothing stands
    in the way, False never does, True must (and raises, with the
    reasons, where it cannot)."""
    if capture is None:
        return not reasons
    if capture and reasons:
        raise ValueError("capture=True, but this runs eagerly: " + "; ".join(reasons))
    return bool(capture)


def tensors_of(*trees) -> list:
    """Every tensor of the trees, in order: dicts by sorted key, lists,
    tuples, and the fields of dataclasses (optimizer states)."""
    out = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for x in t:
                walk(x)
        elif dataclasses.is_dataclass(t) and not isinstance(t, type):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name))

    for tree in trees:
        walk(tree)
    return out


def _key(state: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor],
         n_scalars: int) -> tuple:
    return (tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in state),
            tuple((tuple(x.shape), x.dtype) for x in inputs), n_scalars)


def _launch_counts() -> dict:
    from mpit_tpu_torch.ops import elastic, flash_attention

    return {"elastic": elastic.launches, **flash_attention.launches}


def _add_launches(delta: dict, sign: int = 1) -> None:
    from mpit_tpu_torch.ops import elastic, flash_attention

    for name, n in delta.items():
        if name == "elastic":
            elastic.launches += sign * n
        else:
            flash_attention.launches[name] += sign * n


class Captured:
    """What every device trainer says of its units: ``capture`` (whether
    they replay a graph), ``eager_reasons`` (why not, one reason each) and
    :attr:`replays`. A trainer calls :meth:`_init_capture` from its
    ``__init__`` once its ``topo`` and ``donate_state`` are set."""

    capture = False
    eager_reasons: Sequence[str] = ()
    _graph: Optional["UnitGraph"] = None

    def _init_capture(self, capture: Optional[bool], optimizer, **obstacles) -> None:
        self.eager_reasons = eager_reasons(self.topo.device, self.donate_state, optimizer,
                                           **obstacles)
        self.capture = resolve(capture, self.eager_reasons)
        self._graph = UnitGraph(self.topo.device) if self.capture else None

    @property
    def replays(self) -> int:
        """Units run as graph replays."""
        return self._graph.replays if self._graph is not None else 0

    def _replayable_step(self, state, x, y) -> tuple:
        """A per-step trainer's ``_unit(state, x, y, scalars)`` on a state
        with ``params`` and ``opt_state`` (one optimizer update a step),
        eagerly or through its graph: ``((params, opt_state), metrics)``."""
        if self._graph is None:
            return self._unit(state, x, y)
        opt = state.opt_state
        out, metrics = self._graph.run(
            tensors_of(state.params, opt), (x, y), self.optimizer.host_scalars(opt),
            lambda inputs, scalars: self._unit(state, *inputs, scalars))
        if out is None:  # a replay: the counts move on the host
            out = state.params, self.optimizer.advance(opt, 1)
        return out, metrics

    def _replayable_round(self, state, x, y, fields: Sequence[str]) -> tuple:
        """A round trainer's ``_unit(state, x, y, scalars)``, eagerly or
        through its graph: ``(parts, metrics)``, ``parts`` the new values
        of the state's ``fields`` in turn. The host values are those of the
        τ worker updates in turn (``worker_opt``), then the server
        optimizer's one update (``server_opt``) where there is one; after a
        replay both optimizers' counts move on."""
        if self._graph is None:
            return self._unit(state, x, y)
        opt, server = self.optimizer, getattr(self, "server_optimizer", None)
        values = [v for t in range(self.tau) for v in opt.host_scalars(state.worker_opt, t)]
        if server is not None:
            values += server.host_scalars(state.server_opt)
        parts = tuple(getattr(state, f) for f in fields)
        out, metrics = self._graph.run(
            tensors_of(*parts), (x, y), values,
            lambda inputs, scalars: self._unit(state, *inputs, scalars))
        if out is None:  # a replay: the counts move on the host
            moved = {"worker_opt": opt.advance(state.worker_opt, self.tau)}
            if server is not None:
                moved["server_opt"] = server.advance(state.server_opt, 1)
            out = tuple(moved.get(f, p) for f, p in zip(fields, parts))
        return out, metrics


class UnitGraph:
    """One trainer's captured unit.

    :meth:`run` takes the state's tensors, the unit's inputs, the
    optimizers' host values for the unit and ``body(inputs, scalars)``,
    which does the unit's device work on that state, reading the given
    inputs and 0-dim float32 ``scalars``, and returns ``(result,
    metrics)``, ``metrics`` a dict of 0-dim device tensors. It returns
    ``(result, metrics)`` after a warm-up, and ``(None, metrics)`` after a
    replay: the state's tensors then hold the new state, and the caller
    moves its host bookkeeping on."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.replays = 0
        self._stream: Optional[torch.cuda.Stream] = None
        self._key: Optional[tuple] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._inputs: tuple = ()
        self._scalars: Optional[torch.Tensor] = None
        self._metrics: Optional[dict] = None
        self._launches: dict = {}

    def run(self, state: Sequence[torch.Tensor], inputs: Sequence[torch.Tensor],
            values: Sequence, body: Callable) -> tuple[Any, dict]:
        key = _key(state, inputs, len(values))
        if key != self._key:
            # the first unit, or a state with other storage: drop the graph
            # and its memory, warm up, and capture at the next unit
            self._key = self._graph = self._metrics = None
            result, metrics = self._warm_up(inputs, values, body)
            self._key = key
            return result, metrics
        if self._graph is None:
            self._capture(body)
        self._load(inputs, values)
        self._graph.replay()
        self._count_replay()
        return None, {k: v.clone() for k, v in self._metrics.items()}

    def _views(self) -> list:
        return list(self._scalars.unbind()) if self._scalars.numel() else []

    def _load(self, inputs, values) -> None:
        """The unit's inputs and host values into the static buffers, on
        the caller's stream."""
        for buf, x in zip(self._inputs, inputs, strict=True):
            buf.copy_(x)
        if len(values):
            host = torch.from_numpy(np.asarray(values, dtype=np.float32)).pin_memory()
            self._scalars.copy_(host, non_blocking=True)

    def _warm_up(self, inputs, values, body):
        """One real unit, eagerly, through the buffers the graph will read,
        on the stream it will be captured on."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        self._inputs = tuple(torch.empty_like(x, device=self.device) for x in inputs)
        self._scalars = torch.empty(len(values), dtype=torch.float32, device=self.device)
        self._load(inputs, values)
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            result, metrics = body(self._inputs, self._views())
        caller.wait_stream(self._stream)
        return result, metrics

    def _capture(self, body) -> None:
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._graph, (_, self._metrics), self._launches = capture_graph(
            self._stream, lambda: body(self._inputs, self._views()))

    def _count_replay(self) -> None:
        self.replays += 1
        _count_replay(self._launches)


def _count_replay(launches: dict) -> None:
    global replays
    replays += 1
    _add_launches(launches)


def capture_graph(stream, body: Callable, pool=None) -> tuple:
    """``body()`` captured on ``stream`` as a CUDA graph (in the memory
    pool ``pool``, None: a private one), nothing run. Returns ``(graph,
    body's result, launches)``, ``launches`` the kernel launches that the
    body's Python counted, which the counters take back: a replay adds
    them (:func:`_count_replay`).

    One capture at a time in the process (a module lock), the collector
    off meanwhile: a graph destroyed during a capture (an old trainer's,
    in a reference cycle, freed by the collector) ends the capture, and
    the collector's switch is the process's, so a second thread's capture
    must not turn it back on under the first. ``"thread_local"``: another
    thread's ``cudaMalloc`` or launch does not end this capture."""
    graph = torch.cuda.CUDAGraph()
    with _CAPTURING:
        before = _launch_counts()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                result = body()
        finally:
            if collecting:
                gc.enable()
        after = _launch_counts()
    launches = {k: after[k] - before[k] for k in before if after[k] != before[k]}
    _add_launches(launches, -1)  # nothing ran: the replays count
    return graph, result, launches


class GraphSet:
    """Named graphs, sharing one side stream and one memory pool: a
    server's decode segments, one graph per segment length (the
    speculative server's round: one).

    :meth:`run` takes a name, the resident tensors the work reads and
    writes, and ``body()``, which does that work (its inputs copied into
    resident tensors beforehand, its results written into them). The
    first call of a name runs ``body`` eagerly on the side stream (the
    warm-up), the second captures it and replays the graph, later ones
    replay. Each graph is keyed on its name and on the address, shape,
    strides and dtype of every tensor given with it: other storage warms
    that name up again. Nothing a graph allocates outlives its replay, so
    the graphs may share their pool whatever order they replay in.
    ``costs[name]`` holds the host seconds of the warm-up and of the
    capture."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.replays = 0
        self.costs: dict = {}
        self._stream: Optional[torch.cuda.Stream] = None
        self._pool = None
        self._graphs: dict = {}  # name -> (key, graph, launches); graph None once warm

    def run(self, name, state: Sequence[torch.Tensor], body: Callable) -> None:
        key = tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in state)
        held = self._graphs.get(name)
        if held is None or held[0] != key:
            self._warm_up(name, key, body)
            return
        _, graph, launches = held
        if graph is None:
            t0 = time.perf_counter()
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            graph, _, launches = capture_graph(self._stream, body, self._pool)
            self._graphs[name] = key, graph, launches
            self.costs[name]["capture_s"] = time.perf_counter() - t0
        graph.replay()
        self.replays += 1
        _count_replay(launches)

    def _warm_up(self, name, key, body) -> None:
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        self._graphs.pop(name, None)
        with torch.cuda.stream(self._stream):
            body()
        caller.wait_stream(self._stream)
        self._graphs[name] = key, None, {}
        self.costs[name] = {"warm_up_s": time.perf_counter() - t0}
