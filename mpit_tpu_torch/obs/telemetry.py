"""TelemetryTransport — wire telemetry + trace propagation over any Transport.

A copy of ``mpit_tpu/obs/telemetry.py`` over the port's
:class:`~mpit_tpu_torch.transport.base.Transport`. Payload sizes count a
torch tensor by its ``nbytes``, as an ndarray.

The observability twin of :class:`~mpit_tpu_torch.transport.chaos.ChaosTransport`
(same ``wrap_transports`` idiom, composable with it): wrap a rank's
transport and every send/recv is

- **counted** — per-(peer, tag) message/byte counters, error and timeout
  totals, power-of-two latency histograms, and a send-queue-depth gauge
  (sampled off the socket transport's per-dst queues when present);
- **journaled** — one JSONL record per wire event in the rank's
  :class:`~mpit_tpu_torch.obs.core.Journal` (sampled every Nth per stream via
  ``ObsConfig.sample``), which is what the Perfetto merger consumes;
- **traced** — when ``ObsConfig.trace`` is on, the payload rides inside a
  small envelope carrying ``(trace_id, span_id, lamport)``; the receiving
  wrapper strips it, advances its Lamport clock, and parks the context as
  the receiving thread's *remote parent* so the next send from that thread
  (a server's PARAM reply) lands in the same trace.

Composition order with chaos: wrap telemetry OUTERMOST
(``TelemetryTransport(ChaosTransport(inner))``) — the counters then see
every *attempted* send (what the application experienced, injected faults
included), latency includes injected delay, and the per-(dst, tag) stream
index ``n`` stays in lockstep with the chaos schedule's, which is the join
key the merger uses to place a replayed FaultLog on the timeline.

Overhead contract: when obs is not armed there is no wrapper at all
(:func:`maybe_wrap` returns the transport unchanged) and the protocol-side
hooks reduce to a getattr (:func:`mpit_tpu_torch.obs.core.span`); both are pinned
by the micro-benchmark in tests/test_obs.py.
"""

from __future__ import annotations

import os
import time
from typing import Any, Optional, Sequence

from mpit_tpu_torch.analysis.runtime import make_lock
from mpit_tpu_torch.obs.blackbox import BlackBox, arm_process_triggers
from mpit_tpu_torch.obs.live import LiveExporter, MetricsRegistry
from mpit_tpu_torch.obs.core import (
    _ENVELOPE_MARK,
    Journal,
    LogicalClock,
    ObsConfig,
    SpanContext,
    Tracer,
    _new_id,
    arm_faulthandler,
    config_from_env,
)
from mpit_tpu_torch.transport.base import RecvTimeout, Transport


def _approx_nbytes(obj: Any) -> int:
    """Cheap payload size estimate — NEVER serializes (a pickle.dumps per
    message would dwarf the send itself for inproc reference-passing).
    EXACT for ndarrays/bytes and for the PS chunked scatter envelopes
    ``(epoch, seq, chunk)`` — tuple members sum, the chunk contributes its
    true ``nbytes`` — so the per-(peer, tag) byte counters are a
    trustworthy baseline for the quantized-wire work. Flat guesses remain
    only for scalars and unknown objects."""
    if obj is None:
        return 0
    nb = getattr(obj, "nbytes", None)
    if nb is not None:
        kind = getattr(getattr(obj, "dtype", None), "kind", "")
        if kind == "O":
            # object-dtype ndarray: nbytes counts POINTERS, not contents —
            # recurse over the elements for the real payload size
            try:
                return sum(_approx_nbytes(o) for o in obj.flat)
            except Exception:
                return int(nb)
        return int(nb)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return len(obj)
    if isinstance(obj, (tuple, list)):
        return sum(_approx_nbytes(o) for o in obj)
    if isinstance(obj, str):
        return len(obj)
    if isinstance(obj, (int, float, bool)):
        return 8
    if isinstance(obj, dict):
        return sum(
            _approx_nbytes(k) + _approx_nbytes(v) for k, v in obj.items()
        )
    return 64


def _lat_bucket(seconds: float) -> int:
    """Histogram bucket: ceil(log2(µs)) — bucket ``b`` holds latencies in
    (2^(b-1), 2^b] µs; sub-µs lands in bucket 0."""
    return max(0, int(seconds * 1e6)).bit_length()


class _PeerTagStats:
    """Counters for one (peer, tag) direction; mutated under the owning
    transport's stats lock."""

    __slots__ = ("msgs", "bytes", "errs", "timeouts", "hist", "n", "phases")

    def __init__(self):
        self.msgs = 0
        self.bytes = 0
        self.errs = 0
        self.timeouts = 0
        self.hist: dict[int, int] = {}
        self.n = 0  # next stream index (pre-incremented on use)
        # wire-phase seconds (serialize / queue_wait / write) accumulated
        # from phase-aware transports' SendHandles; empty when the inner
        # stack measures no split (inproc, native, through chaos)
        self.phases: dict[str, float] = {}

    def to_dict(self) -> dict:
        out = {"msgs": self.msgs, "bytes": self.bytes}
        if self.errs:
            out["errs"] = self.errs
        if self.timeouts:
            out["timeouts"] = self.timeouts
        if self.hist:
            out["lat_hist_log2us"] = {
                str(k): v for k, v in sorted(self.hist.items())
            }
        if self.phases:
            out["phase_s"] = {
                k: round(v, 6) for k, v in sorted(self.phases.items())
            }
        return out


class TelemetryTransport(Transport):
    """Telemetry/tracing wrapper: accounting on both paths, passthrough
    semantics. The wrapped rank keeps its identity; protocol code finds
    the tracer via the ``obs_tracer`` attribute (the
    :func:`mpit_tpu_torch.obs.core.span` hook's contract)."""

    def __init__(
        self,
        inner: Transport,
        config: ObsConfig,
        journal: Optional[Journal] = None,
    ):
        self.inner = inner
        self.rank = inner.rank
        self.size = inner.size
        self.config = config
        self.journal = journal
        self.obs_tracer = Tracer(
            inner.rank, clock=LogicalClock(), journal=journal
        )
        self.clock = self.obs_tracer.clock
        self._stats_lock = make_lock("TelemetryTransport._stats_lock")
        self._send_stats: dict[tuple[int, int], _PeerTagStats] = {}
        self._recv_stats: dict[tuple[int, int], _PeerTagStats] = {}
        self._max_queue_depth = 0
        # live telemetry plane (MPIT_OBS_LIVE): a registry protocol code
        # publishes into via live_registry(transport), fed the aggregated
        # wire counters via a pull collector, exported by a background
        # thread when a run dir exists (registry only otherwise)
        self.obs_registry: Optional[MetricsRegistry] = None
        self._live_exporter: Optional[LiveExporter] = None
        if config.live:
            self.obs_registry = MetricsRegistry(inner.rank)
            self.obs_registry.add_collector("wire", self._live_wire_fragment)
            if journal is not None and journal.blackbox is not None:
                self.obs_registry.add_collector(
                    "blackbox", journal.blackbox.stats
                )
            if config.dir is not None:
                self._live_exporter = LiveExporter(
                    self.obs_registry,
                    os.path.join(config.dir, "live"),
                    interval_s=config.live_interval,
                )

    # -- accounting -------------------------------------------------------

    def _stat(self, table: dict, peer: int, tag: int) -> _PeerTagStats:
        s = table.get((peer, tag))
        if s is None:
            s = table[(peer, tag)] = _PeerTagStats()
        return s

    def _queue_depth(self) -> Optional[int]:
        """Outbound backlog, when the inner chain ends in a transport with
        per-dst send queues (SocketTransport); None otherwise. Reads the
        deque length without the queue's condition — a monitoring gauge
        may be momentarily stale, it must never contend with the drainer."""
        t: Any = self.inner
        for _ in range(4):  # telemetry -> chaos -> ... -> socket
            qs = getattr(t, "_send_queues", None)
            if qs is not None:
                return sum(len(q._items) for q in list(qs.values()))
            t = getattr(t, "inner", None)
            if t is None:
                return None
        return None

    # -- send path --------------------------------------------------------

    def _send_common(self, dst: int, tag: int, payload: Any, async_: bool):
        cfg = self.config
        clk = self.clock.tick()
        ctx = None
        parent_id = None
        wire = payload
        if cfg.trace:
            parent = self.obs_tracer.current_context()
            trace_id = parent.trace_id if parent is not None else _new_id()
            parent_id = parent.span_id if parent is not None else None
            ctx = SpanContext(trace_id, _new_id())
            wire = (_ENVELOPE_MARK, trace_id, ctx.span_id, clk, payload)
        nbytes = _approx_nbytes(payload)
        t0 = time.perf_counter()
        err: Optional[BaseException] = None
        handle = None
        try:
            # the sync path ALSO goes through isend: for SocketTransport
            # send() is literally isend().wait(), and the base Transport
            # defines isend as send + set_done — identical semantics either
            # way, but the returned handle carries the wire-phase split
            # (serialize / queue_wait / write) when the stack measures one
            handle = self.inner.isend(dst, tag, wire)
            if not async_:
                handle.wait()
        except BaseException as e:
            err = e
            raise
        finally:
            dt = time.perf_counter() - t0
            # a completed handle's phases are stable; an in-flight async
            # handle is left alone (its split lands in later sends' stats
            # only if still unread — phases are best-effort for isend)
            phases = (
                getattr(handle, "phases", None)
                if handle is not None and handle.done() and err is None
                else None
            )
            if phases is not None:
                # byte-counting transports (SocketTransport) stamp the
                # exact on-wire frame length next to the phase split —
                # prefer it over the estimate, so summary bytes equal
                # socket-level bytes (asserted by tests/test_obs.py)
                exact = getattr(handle, "wire_nbytes", None)
                if exact is not None:
                    nbytes = exact
            depth = None
            with self._stats_lock:
                s = self._stat(self._send_stats, dst, tag)
                s.n += 1
                n = s.n - 1
                s.msgs += 1
                s.bytes += nbytes
                if err is not None:
                    s.errs += 1
                bucket = _lat_bucket(dt)
                s.hist[bucket] = s.hist.get(bucket, 0) + 1
                if phases:
                    for k, v in phases.items():
                        s.phases[k] = s.phases.get(k, 0.0) + v
                sampled = n % cfg.sample == 0
            if sampled:
                depth = self._queue_depth()
                if depth is not None:
                    with self._stats_lock:
                        if depth > self._max_queue_depth:
                            self._max_queue_depth = depth
            if self.journal is not None and sampled:
                # "mtag" not "tag": MetricsLogger's record schema already
                # uses "tag" for the run identifier ("obs")
                fields: dict[str, Any] = {
                    "dst": dst, "mtag": tag, "n": n,
                    "bytes": nbytes, "dur": dt,
                }
                if ctx is not None:
                    fields["trace"] = ctx.trace_id
                    fields["span"] = ctx.span_id
                    if parent_id is not None:
                        fields["parent"] = parent_id
                if depth is not None:
                    fields["qdepth"] = depth
                if phases:
                    # short keys, journal-budget style: serialize /
                    # queue_wait / write wall-clock for THIS send
                    if "serialize" in phases:
                        fields["ser"] = phases["serialize"]
                    if "queue_wait" in phases:
                        fields["qw"] = phases["queue_wait"]
                    if "write" in phases:
                        fields["wr"] = phases["write"]
                if err is not None:
                    fields["err"] = type(err).__name__
                self.journal.event(
                    "isend" if async_ else "send", clk, **fields
                )
        return handle

    def send(self, dst: int, tag: int, payload: Any) -> None:
        self._send_common(dst, tag, payload, async_=False)

    def isend(self, dst: int, tag: int, payload: Any):
        return self._send_common(dst, tag, payload, async_=True)

    # -- recv path --------------------------------------------------------

    def recv(self, src: int = -1, tag: int = -1,
             timeout: Optional[float] = None):
        t0 = time.perf_counter()
        try:
            msg = self.inner.recv(src, tag, timeout)
        except RecvTimeout:
            # counted, never journaled: a watchdog's poll loop would spam
            # one record per poll interval
            with self._stats_lock:
                self._stat(self._recv_stats, src, tag).timeouts += 1
            raise
        wait = time.perf_counter() - t0
        payload = msg.payload
        ctx: Optional[SpanContext] = None
        remote_clk: Optional[int] = None
        if (
            type(payload) is tuple
            and len(payload) == 5
            and payload[0] == _ENVELOPE_MARK
        ):
            _, trace_id, span_id, remote_clk, payload = payload
            msg.payload = payload
            ctx = SpanContext(trace_id, span_id)
            clk = self.clock.observe(remote_clk)
        else:
            clk = self.clock.tick()
        if self.config.trace:
            # parent the receiving thread's NEXT sends on this message
            # (None clears a stale parent when the sender wasn't tracing)
            self.obs_tracer.set_remote_parent(ctx)
        # exact on-wire frame length when the inner stack counted it
        # (SocketTransport stamps every delivered message); the estimate
        # remains for reference-passing transports
        nbytes = getattr(msg, "wire_nbytes", None)
        if nbytes is None:
            nbytes = _approx_nbytes(payload)
        with self._stats_lock:
            s = self._stat(self._recv_stats, msg.src, msg.tag)
            s.n += 1
            n = s.n - 1
            s.msgs += 1
            s.bytes += nbytes
            bucket = _lat_bucket(wait)
            s.hist[bucket] = s.hist.get(bucket, 0) + 1
            sampled = n % self.config.sample == 0
        if self.journal is not None and sampled:
            fields = {
                "src": msg.src, "mtag": msg.tag, "n": n,
                "bytes": nbytes, "wait": wait,
            }
            if ctx is not None:
                fields["trace"] = ctx.trace_id
                fields["from_span"] = ctx.span_id
            if remote_clk is not None:
                # the sender's Lamport stamp: the post-mortem analyzer's
                # cross-rank alignment key (pairs this recv with the
                # sender's journal record carrying the same clock)
                fields["rclk"] = remote_clk
            self.journal.event("recv", clk, **fields)
        return msg

    # -- passthrough ------------------------------------------------------

    def probe(self, src: int = -1, tag: int = -1,
              timeout: Optional[float] = 0) -> bool:
        return self.inner.probe(src, tag, timeout)

    def close(self) -> None:
        try:
            self.inner.close()
        finally:
            try:
                self.obs_tracer.close()
            finally:
                self.close_live()

    def close_live(self) -> None:
        """Stop the live exporter (final snapshot lands on disk);
        idempotent, a no-op when live telemetry is not armed. Called from
        :meth:`close` and from the trainer teardown, which closes tracers
        explicitly rather than closing wrappers."""
        if self._live_exporter is not None:
            self._live_exporter.close()
            self._live_exporter = None

    def _live_wire_fragment(self) -> dict:
        """Live-snapshot collector: the per-(peer, tag) tables aggregated
        to rank totals (the dashboard wants a health line per rank, not
        the full matrix — ``summary()`` still has the split), plus the
        queue-depth gauge. Pulled at export time so the send/recv hot
        path pays nothing for the live plane."""
        tx = {"msgs": 0, "bytes": 0, "errs": 0}
        rx = {"msgs": 0, "bytes": 0, "errs": 0, "timeouts": 0}
        lat: dict[str, int] = {}
        with self._stats_lock:
            for s in self._send_stats.values():
                tx["msgs"] += s.msgs
                tx["bytes"] += s.bytes
                tx["errs"] += s.errs
                for b, c in s.hist.items():
                    lat[str(b)] = lat.get(str(b), 0) + c
            for s in self._recv_stats.values():
                rx["msgs"] += s.msgs
                rx["bytes"] += s.bytes
                rx["errs"] += s.errs
                rx["timeouts"] += s.timeouts
        out: dict[str, Any] = {"tx": tx, "rx": rx}
        if lat:
            out["send_lat_hist_log2us"] = lat
        depth = self._queue_depth()
        if depth is not None:
            out["queue_depth"] = depth
        return out

    # -- reporting --------------------------------------------------------

    def summary(self) -> dict:
        """JSON-able counters snapshot, folded into ``trainer.stats()``."""
        with self._stats_lock:
            out = {
                "rank": self.rank,
                "send": {
                    f"{dst}:{tag}": s.to_dict()
                    for (dst, tag), s in sorted(self._send_stats.items())
                },
                "recv": {
                    f"{src}:{tag}": s.to_dict()
                    for (src, tag), s in sorted(self._recv_stats.items())
                },
            }
            if self._max_queue_depth:
                out["max_queue_depth"] = self._max_queue_depth
        # receive-side phase split (transfer / deserialize per src:tag)
        # lives in the socket transport's read loop, not in this wrapper —
        # walk the inner chain for it, same depth bound as _queue_depth
        t: Any = self.inner
        for _ in range(4):  # telemetry -> chaos -> ... -> socket
            rx = getattr(t, "rx_phases", None)
            if callable(rx):
                snap = rx()
                if snap:
                    out["rx_phase_s"] = snap
                break
            t = getattr(t, "inner", None)
            if t is None:
                break
        return out


def _journal_for(config: ObsConfig, rank: int) -> Optional[Journal]:
    if config.dir is None:
        return None
    import os

    box = None
    if config.blackbox:
        box = BlackBox(
            config.dir, rank,
            max_records=config.blackbox_records,
            max_seconds=config.blackbox_seconds,
            gen=int(os.environ.get("MPIT_RESPAWN_GEN", "0") or 0),
        )
    return Journal(
        os.path.join(config.dir, f"obs_rank{rank}.jsonl"), rank,
        max_records=config.max_records,
        mode="ring" if config.ring else "cap",
        blackbox=box,
    )


def wrap_obs_transports(
    transports: Sequence[Transport], config: ObsConfig
) -> list[TelemetryTransport]:
    """Wrap a whole world (the chaos ``wrap_transports`` idiom); each rank
    gets its own journal file under ``config.dir`` (None = counters only).
    """
    return [
        TelemetryTransport(t, config, _journal_for(config, t.rank))
        for t in transports
    ]


def maybe_wrap(
    transport: Transport, config: Optional[ObsConfig]
) -> Transport:
    """The disabled fast path: with no config there is no wrapper — the
    transport is returned UNCHANGED (identity, pinned by tests)."""
    if config is None:
        return transport
    return TelemetryTransport(
        transport, config, _journal_for(config, transport.rank)
    )


def wrap_from_env(transport: Transport) -> Transport:
    """Process-mode hook (examples/ptest_proc.py): wrap iff ``MPIT_OBS_*``
    is armed in the environment — one line in a launch script instruments
    a whole run without code changes anywhere else. MPIT_OBS_FAULTHANDLER
    additionally arms periodic all-thread stack dumps for this process
    (``stacks_rank<r>.txt`` next to the journal) — hung-job forensics."""
    config = config_from_env()
    if config is not None:
        arm_faulthandler(config, f"rank{transport.rank}")
        if config.blackbox:
            # process mode owns its main thread: install the SIGTERM /
            # dump-signal triggers here (thread-mode worlds rely on the
            # atexit + dump-request triggers instead)
            arm_process_triggers(config.blackbox_dump_signal)
    return maybe_wrap(transport, config)
