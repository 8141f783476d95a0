"""obs core — span context, logical clock, per-rank event journal.

A copy of ``mpit_tpu/obs/core.py`` for the port. The journal writes through
the port's :class:`~mpit_tpu_torch.utils.metrics.MetricsLogger` in the
reference's record format, and a faulthandler that cannot open its file
raises instead of being skipped.

The reference debugged multi-rank training by reading interleaved per-rank
``print``s in the mpirun console (SURVEY.md §5); this package is the
do-better: every transport-level event (send, recv, span, fault) becomes
one JSONL record in a per-rank journal, causally linked across ranks by a
trace/span context that rides the wire inside a payload envelope
(:mod:`mpit_tpu_torch.obs.telemetry`), and ``python -m mpit_tpu_torch.obs merge``
joins the journals into one Chrome-trace/Perfetto timeline.

Span model
----------

- ``trace_id``  one logical *exchange* across ranks (a FETCH → PARAM
  round-trip, a push and its server-side apply). 64-bit random.
- ``span_id``   one timed operation inside a trace (a send, a recv wait,
  a ``span()`` region). Unique per process, also the flow-event id that
  draws the send→recv arrow in Perfetto.
- ``parent_id`` the enclosing span — a local ``span()`` region for sends
  made inside it, or the *remote* send span for operations a rank performs
  in response to a received message (the server's PARAM reply is parented
  by the client's FETCH send, which is what stitches one trace across the
  process boundary without the PS protocol code knowing).

Clocks: journals carry wall-clock ``t`` (merging assumes NTP-level skew —
single-host runs are exact) plus a Lamport logical clock ``clk`` that the
envelope propagates; ``clk`` gives a causal order that survives clock skew
and is what the merger validates cross-rank causality against.

Activation mirrors chaos (:func:`mpit_tpu_torch.transport.chaos.config_from_env`):
obs must never arm implicitly — only recognized ``MPIT_OBS_*`` knobs count.

  MPIT_OBS_DIR          path journal directory (arms obs; one
                             obs_rank<r>.jsonl per transport rank)
  MPIT_OBS_TRACE        0|1  wire trace envelopes + flow linking (default 1)
  MPIT_OBS_TELEMETRY    0|1  per-(peer, tag) counters/histograms (default 1)
  MPIT_OBS_SAMPLE       int  journal every Nth wire event per stream
                             (default 1 = all; counters always see all)
  MPIT_OBS_MAX_RECORDS  int  per-journal record cap: writes past it are
                             dropped and counted, and a ``journal_cap``
                             footer carrying ``dropped_records`` is kept
                             current on disk (default: unbounded)
  MPIT_OBS_RING         0|1  ring journal mode: keep the LAST
                             ``max_records`` (default 4096) instead of
                             the first — a long soak preserves its crash,
                             not its boring start; the evicted head is
                             counted in the ``journal_cap`` footer
                             (``mode: "ring"``) and conformance licenses
                             it like a churned tail (default 0)
  MPIT_OBS_BLACKBOX     0|1  flight recorder (docs/OBSERVABILITY.md
                             "Black box"): every journal also tees into
                             a bounded in-memory ring that dumps to
                             ``<dir>/blackbox/rank_<r>.jsonl`` on
                             SIGTERM/atexit/close/alert/dump-request
                             (default 1 — armed whenever a dir is set)
  MPIT_OBS_BLACKBOX_RECORDS
                        int  black-box ring capacity, records (2048)
  MPIT_OBS_BLACKBOX_SECONDS
                        sec  black-box ring horizon: records older than
                             this are evicted regardless of count (30)
  MPIT_OBS_BLACKBOX_DUMP_SIGNAL
                        str  extra dump trigger: a signal name/number
                             (e.g. ``USR1``) that dumps the ring and
                             continues running (default: unset)
  MPIT_OBS_LIVE         0|1  live telemetry plane: per-rank metrics
                             registry + background snapshot exporter
                             writing ``<dir>/live/rank_<r>.json``
                             (:mod:`mpit_tpu_torch.obs.live`; default 0)
  MPIT_OBS_LIVE_INTERVAL
                        sec  live snapshot export interval (default 1.0)
  MPIT_OBS_FAULTHANDLER 0|1|sec  hang forensics: arm
                             ``faulthandler.dump_traceback_later`` so a
                             wedged rank leaves an all-threads stack
                             dump in ``<dir>/stacks_rank<r>.txt`` (or
                             stderr with no dir) every interval instead
                             of nothing ("1" = 300 s default interval,
                             a number = that interval in seconds)
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
from typing import Any, Iterable, Mapping, Optional

from mpit_tpu_torch.analysis.runtime import make_lock

# wire envelope marker (telemetry.py wraps payloads as
# (_ENVELOPE_MARK, trace_id, span_id, clk, payload)); versioned so a
# mixed-version world fails visibly rather than mis-parsing
_ENVELOPE_MARK = "__mpit_obs1__"


def _new_id() -> int:
    """Random 63-bit id (json-safe positive int; os.urandom, not
    ``random`` — ids must not perturb or depend on seeded streams like
    the chaos schedule's)."""
    return struct.unpack(">Q", os.urandom(8))[0] >> 1


@dataclasses.dataclass(frozen=True)
class SpanContext:
    """What crosses the wire: enough to parent the receiver's next ops."""

    trace_id: int
    span_id: int


class LogicalClock:
    """Thread-safe Lamport clock: ``tick`` before local events, ``observe``
    on message receipt (clk = max(local, remote) + 1)."""

    def __init__(self):
        self._lock = make_lock("obs.LogicalClock._lock")
        self._value = 0

    def tick(self) -> int:
        with self._lock:
            self._value += 1
            return self._value

    def observe(self, remote: int) -> int:
        with self._lock:
            self._value = max(self._value, int(remote)) + 1
            return self._value

    def peek(self) -> int:
        with self._lock:
            return self._value


class Journal:
    """Per-rank JSONL event stream, one record per line in
    :class:`mpit_tpu_torch.utils.metrics.MetricsLogger`'s format (``ts``/``tag``/
    ``process``/``step`` plus event fields) so existing JSONL tooling reads
    it unchanged. ``step`` carries the Lamport clock; ``t`` is the precise
    wall-clock (MetricsLogger's ``ts`` is rounded to 1 ms — too coarse for
    a µs timeline). The lock serializes concurrent writers (a client
    thread and its heartbeat timer share one rank's journal) and ``t`` is
    stamped inside it, so per-rank journal timestamps are monotonically
    non-decreasing by construction — the property the merged timeline (and
    its test) relies on.

    ``max_records`` caps journal growth (a million-request load run must
    not fill the disk silently): writes past the cap are dropped and
    counted into a ``journal_cap`` footer record carrying the
    ``dropped_records`` total — readers see the loss explicitly instead
    of inferring it from absence. The footer is kept current on disk
    *incrementally* (appended on the first drop, rewritten in place
    every ``_FOOTER_EVERY`` drops and at close), so a SIGKILLed rank's
    journal still confesses its truncation to within ``_FOOTER_EVERY``
    drops — ``obs slo`` and conformance must not need a clean exit to
    learn that records are missing.

    ``mode="ring"`` inverts the cap: the journal buffers the LAST
    ``max_records`` in memory (evicting the oldest, counted as
    ``evicted_records``) and flushes the survivors at :meth:`close` —
    a week-long soak keeps its crash window, not its boring start. The
    flushed journal ends with the same ``journal_cap`` footer plus
    ``mode: "ring"`` so readers (and TC202's licensing) can tell an
    evicted head from lost messages. The memory-buffered tail is the
    honest cost: a SIGKILLed ring journal writes nothing — which is
    exactly the gap the black-box dump triggers exist to cover
    (:mod:`mpit_tpu_torch.obs.blackbox`).

    ``blackbox`` tees every record (including ones the cap drops) into
    the rank's in-memory flight recorder; the tee is a deque append —
    its cost on the journal hot path is pinned by
    tests/test_blackbox.py."""

    #: rewrite the on-disk footer every this-many drops (kill-safety
    #: granularity vs. one extra seek+write per drop)
    _FOOTER_EVERY = 64
    _RING_DEFAULT_RECORDS = 4096

    def __init__(
        self, path: str, rank: int, max_records: Optional[int] = None,
        mode: str = "cap", blackbox: Optional[Any] = None,
    ):
        from mpit_tpu_torch.utils.metrics import MetricsLogger

        if max_records is not None and max_records < 1:
            raise ValueError("max_records must be >= 1")
        if mode not in ("cap", "ring"):
            raise ValueError("mode must be 'cap' or 'ring'")
        if mode == "ring" and max_records is None:
            max_records = self._RING_DEFAULT_RECORDS
        self.path = path
        self.rank = rank
        self.mode = mode
        self.max_records = max_records
        self.dropped_records = 0
        self.evicted_records = 0
        self.blackbox = blackbox
        self._written = 0
        self._closed = False
        self._footer_off: Optional[int] = None
        self._lock = make_lock("obs.Journal._lock")
        self._ring: Optional[list] = [] if mode == "ring" else None
        self._m = MetricsLogger(path, tag="obs", echo=False)

    # MetricsLogger owns these record keys; caller fields that collide
    # (e.g. a span arg named "step") are prefixed rather than rejected
    _RESERVED = ("step", "ts", "tag", "process", "rank", "ev", "t")

    def event(self, ev: str, clk: int, **fields: Any) -> None:
        for k in self._RESERVED:
            if k in fields:
                fields[f"x_{k}"] = fields.pop(k)
        t = time.time()
        with self._lock:
            if self._closed:
                return
            if self.blackbox is not None:
                # the tee sees EVERY record — including ones the cap is
                # about to drop; that inversion (cap keeps the head, the
                # flight recorder keeps the tail) is the black box's job
                self.blackbox.record(t, clk, ev, fields)
            if self._ring is not None:
                self._ring.append((t, clk, ev, fields))
                if len(self._ring) > self.max_records:
                    del self._ring[0]
                    self.evicted_records += 1
                return
            if (
                self.max_records is not None
                and self._written >= self.max_records
            ):
                self.dropped_records += 1
                if (
                    self.dropped_records == 1
                    or self.dropped_records % self._FOOTER_EVERY == 0
                ):
                    self._write_footer_locked()
                return
            self._written += 1
            self._m.log(clk, rank=self.rank, ev=ev, t=t, **fields)

    def _write_footer_locked(self) -> None:
        """Append-or-rewrite the ``journal_cap`` footer as the journal's
        last line. The stream is opened in append mode, so a rewrite is
        truncate-to-remembered-offset + append — after the cap no
        regular record ever follows the footer, so the offset stays
        valid for the journal's lifetime. Never raises: drop accounting
        must not kill the run it describes."""
        f = getattr(self._m, "_f", None)
        if f is None:
            return
        try:
            f.flush()
            if self._footer_off is None:
                self._footer_off = f.tell()
            else:
                f.truncate(self._footer_off)
            extra = {}
            if self.mode == "ring":
                extra["mode"] = "ring"
                extra["evicted_records"] = self.evicted_records
            self._m.log(
                self._written, rank=self.rank, ev="journal_cap",
                t=time.time(), cap=self.max_records,
                dropped_records=self.dropped_records, **extra,
            )
        except (OSError, ValueError):
            pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._ring is not None:
                # flush the survivors in arrival order; their original
                # ``t`` stamps keep the per-rank monotonicity contract
                # (the footer's close-time t is >= all of them)
                for t, clk, ev, fields in self._ring:
                    self._written += 1
                    self._m.log(
                        clk, rank=self.rank, ev=ev, t=t, **fields
                    )
                self._ring = None
            if self.max_records is not None:
                # the footer rides OUTSIDE the cap (one fixed record),
                # and is written even at zero drops — "0 dropped" is an
                # assertion, absence is just a journal without a cap
                self._write_footer_locked()
            self._m.close()
        if self.blackbox is not None:
            # a cleanly-closed rank leaves its final window next to its
            # journal — post-mortems then cover the whole fleet, not
            # just the ranks something went wrong on
            self.blackbox.dump("close")
            self.blackbox.close()


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Observability knobs; one frozen config shared by a world's wrappers
    (the :class:`mpit_tpu_torch.transport.chaos.ChaosConfig` idiom).

    ``dir=None`` keeps counters/histograms but writes no journal (pure
    in-memory telemetry); ``trace=False`` drops the wire envelope (no
    cross-rank linking, zero payload growth); ``sample`` journals only
    every Nth send/recv per (peer, tag) stream — counters still see every
    message, so summaries stay exact while journal volume shrinks;
    ``max_records`` caps each journal's record count (drops are counted
    into the ``journal_cap`` footer — see :class:`Journal`);
    ``live=True`` arms the live telemetry plane — a per-rank
    :class:`mpit_tpu_torch.obs.live.MetricsRegistry` plus a background
    exporter snapshotting ``<dir>/live/rank_<r>.json`` every
    ``live_interval`` seconds (registry only when ``dir`` is None);
    ``faulthandler`` > 0 arms hang forensics — a repeating
    :func:`faulthandler.dump_traceback_later` timer at that interval in
    seconds, dumping all threads' stacks to ``<dir>/stacks_<label>.txt``
    (stderr when ``dir`` is None) so a wedged rank leaves evidence next
    to its journal instead of nothing (0.0 = off);
    ``ring=True`` flips each journal to last-``max_records`` ring mode
    (see :class:`Journal` — a soak keeps its crash, not its start);
    ``blackbox`` (default True) arms the per-rank flight recorder
    whenever ``dir`` is set — a bounded in-memory ring of the last
    ``blackbox_records`` records / ``blackbox_seconds`` seconds, dumped
    to ``<dir>/blackbox/rank_<r>.jsonl`` on SIGTERM, atexit, clean
    close, an alert-driven dump request, or the explicit
    ``blackbox_dump_signal`` (:mod:`mpit_tpu_torch.obs.blackbox`)."""

    dir: Optional[str] = None
    trace: bool = True
    telemetry: bool = True
    sample: int = 1
    max_records: Optional[int] = None
    live: bool = False
    live_interval: float = 1.0
    faulthandler: float = 0.0
    ring: bool = False
    blackbox: bool = True
    blackbox_records: int = 2048
    blackbox_seconds: float = 30.0
    blackbox_dump_signal: Optional[str] = None

    def __post_init__(self):
        if self.sample < 1:
            raise ValueError("sample must be >= 1")
        if self.max_records is not None and self.max_records < 1:
            raise ValueError("max_records must be >= 1")
        if self.live_interval <= 0:
            raise ValueError("live_interval must be > 0")
        if self.faulthandler < 0:
            raise ValueError("faulthandler must be >= 0 (0 = off)")
        if self.blackbox_records < 1:
            raise ValueError("blackbox_records must be >= 1")
        if self.blackbox_seconds <= 0:
            raise ValueError("blackbox_seconds must be > 0")


_ENV_KNOBS = frozenset(
    "MPIT_OBS_" + k
    for k in (
        "DIR", "TRACE", "TELEMETRY", "SAMPLE", "MAX_RECORDS",
        "LIVE", "LIVE_INTERVAL", "FAULTHANDLER", "RING",
        "BLACKBOX", "BLACKBOX_RECORDS", "BLACKBOX_SECONDS",
        "BLACKBOX_DUMP_SIGNAL",
    )
)

# MPIT_OBS_FAULTHANDLER=1 means "on, default cadence": dump every 5
# minutes — long enough that a healthy run never dumps (exchanges are
# sub-second), short enough that a wedged rank leaves evidence before
# anyone reaches for kill -9
_FAULTHANDLER_DEFAULT_S = 300.0


def _parse_faulthandler(raw: Optional[str]) -> float:
    if raw is None or raw in ("", "0", "false", "no"):
        return 0.0
    if raw in ("1", "true", "yes"):
        return _FAULTHANDLER_DEFAULT_S
    return float(raw)


def config_from_env(
    env: Mapping[str, str] = os.environ,
) -> Optional[ObsConfig]:
    """ObsConfig from ``MPIT_OBS_*`` knobs; None when none are set (obs
    never arms implicitly — same contract as chaos's env activation)."""
    if not any(k in _ENV_KNOBS for k in env):
        return None
    max_records = env.get("MPIT_OBS_MAX_RECORDS")
    return ObsConfig(
        dir=env.get("MPIT_OBS_DIR") or None,
        trace=env.get("MPIT_OBS_TRACE", "1") != "0",
        telemetry=env.get("MPIT_OBS_TELEMETRY", "1") != "0",
        sample=int(env.get("MPIT_OBS_SAMPLE", 1)),
        max_records=int(max_records) if max_records else None,
        live=env.get("MPIT_OBS_LIVE", "0") not in ("", "0"),
        live_interval=float(env.get("MPIT_OBS_LIVE_INTERVAL", 1.0)),
        faulthandler=_parse_faulthandler(env.get("MPIT_OBS_FAULTHANDLER")),
        ring=env.get("MPIT_OBS_RING", "0") not in ("", "0"),
        blackbox=env.get("MPIT_OBS_BLACKBOX", "1") != "0",
        blackbox_records=int(env.get("MPIT_OBS_BLACKBOX_RECORDS", 2048)),
        blackbox_seconds=float(env.get("MPIT_OBS_BLACKBOX_SECONDS", 30.0)),
        blackbox_dump_signal=env.get("MPIT_OBS_BLACKBOX_DUMP_SIGNAL")
        or None,
    )


# -- hang forensics ---------------------------------------------------------
# One arm per process: faulthandler.dump_traceback_later is process-global
# (a repeating timer over ALL threads), so the thread-mode trainer arms it
# once for the world and process mode arms it per rank. The dump file
# stays open for the process lifetime — faulthandler holds the fd.

_FAULTHANDLER_LOCK = make_lock("obs._FAULTHANDLER_LOCK")
_FAULTHANDLER_FILE = None


def arm_faulthandler(config: Optional["ObsConfig"], label: str) -> Optional[str]:
    """Arm the repeating all-threads stack dump when
    ``config.faulthandler`` > 0 — the MPIT_OBS_FAULTHANDLER knob's
    engine. Returns the dump path (``<dir>/stacks_<label>.txt``; None
    with the dump going to stderr, or when not armed). Idempotent per
    process: a second arm re-schedules the timer but keeps the first
    file. A dump file that cannot be opened raises: an armed plane that
    silently records nothing would hide the hang it exists to explain."""
    global _FAULTHANDLER_FILE
    if config is None or config.faulthandler <= 0:
        return None
    import faulthandler
    import sys

    # path work happens OUTSIDE the lock — only the file-slot check and
    # the (non-blocking) timer rearm sit in the critical section
    path = None
    if config.dir is not None:
        os.makedirs(config.dir, exist_ok=True)
        path = os.path.join(config.dir, f"stacks_{label}.txt")
    with _FAULTHANDLER_LOCK:
        if path is not None:
            if _FAULTHANDLER_FILE is None:
                _FAULTHANDLER_FILE = open(path, "w")
            else:
                path = _FAULTHANDLER_FILE.name
        out = (
            _FAULTHANDLER_FILE if _FAULTHANDLER_FILE is not None
            else sys.stderr
        )
        faulthandler.dump_traceback_later(
            config.faulthandler, repeat=True, file=out
        )
        return path


def disarm_faulthandler() -> None:
    """Cancel the pending dump timer (clean teardown: a finished run
    must not dump stacks from whatever outlives it). The dump file
    stays open — faulthandler may still hold it on some paths, and one
    fd per process is the documented cost."""
    import faulthandler

    faulthandler.cancel_dump_traceback_later()


class _NullSpan:
    """The disabled fast path: one shared no-op context manager, so an
    instrumentation site costs a getattr + an identity check when obs is
    off (pinned by the micro-benchmark in tests/test_obs.py)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """An open ``span()`` region: journals B/E events and sits on the
    tracer's thread-local stack so sends made inside it inherit its
    trace."""

    __slots__ = ("tracer", "name", "ctx", "parent_id", "args")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.ctx: Optional[SpanContext] = None
        self.parent_id: Optional[int] = None

    def __enter__(self) -> SpanContext:
        t = self.tracer
        # parent on the enclosing LOCAL span only — never on the thread's
        # remote parent. The remote parent exists to land a reply send in
        # the requester's trace (recv → handle → send); letting it parent
        # explicit spans would chain every exchange round into one
        # run-length trace via the previous round's PARAM recv.
        stack = t._stack()
        parent = stack[-1] if stack else None
        trace_id = parent.trace_id if parent is not None else _new_id()
        self.ctx = SpanContext(trace_id, _new_id())
        self.parent_id = parent.span_id if parent is not None else None
        t._stack().append(self.ctx)
        if t.journal is not None:
            t.journal.event(
                "span_b", t.clock.tick(), name=self.name,
                trace=self.ctx.trace_id, span=self.ctx.span_id,
                parent=self.parent_id, **self.args,
            )
        return self.ctx

    def __exit__(self, *exc):
        t = self.tracer
        stack = t._stack()
        if stack and stack[-1] is self.ctx:
            stack.pop()
        if t.journal is not None:
            t.journal.event(
                "span_e", t.clock.tick(), name=self.name,
                trace=self.ctx.trace_id, span=self.ctx.span_id,
            )
        return False


class Tracer:
    """Per-rank trace state: the logical clock, the journal, and the
    thread-local context stack + remote parent.

    Context resolution order for an outgoing send (``current_context``):

    1. the innermost open local ``span()`` on THIS thread, else
    2. the context of the last message THIS thread received (the remote
       parent — how a server's reply lands in the requester's trace), else
    3. nothing (the send starts a fresh single-span trace).

    Thread-locality is what makes 2 sound: the PS server is a recv →
    handle → reply loop on one thread, so "last received" is exactly the
    message being answered. Concurrent client threads each carry their
    own stack.
    """

    def __init__(self, rank: int, clock: Optional[LogicalClock] = None,
                 journal: Optional[Journal] = None):
        self.rank = rank
        self.clock = clock if clock is not None else LogicalClock()
        self.journal = journal
        self._tls = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current_context(self) -> Optional[SpanContext]:
        stack = getattr(self._tls, "stack", None)
        if stack:
            return stack[-1]
        return getattr(self._tls, "remote", None)

    def set_remote_parent(self, ctx: Optional[SpanContext]) -> None:
        self._tls.remote = ctx

    def span(self, name: str, **args: Any) -> _Span:
        return _Span(self, name, args)

    def close(self) -> None:
        if self.journal is not None:
            self.journal.close()


def span(transport, name: str, **args: Any):
    """Instrumentation hook for protocol code: a ``span()`` on the
    transport's tracer when the transport is obs-wrapped, the shared
    no-op otherwise. This getattr-and-check IS the guarded fast path —
    safe to leave in hot protocol loops unconditionally."""
    tracer = getattr(transport, "obs_tracer", None)
    if tracer is None:
        return NULL_SPAN
    return tracer.span(name, **args)


def write_fault_log(events: Iterable, path: str) -> int:
    """Persist a chaos :class:`~mpit_tpu_torch.transport.chaos.FaultLog`'s
    events as JSONL for the merger (``--faults``). FaultEvents carry no
    timestamp by design (they must compare equal across replays); the
    merger recovers timeline placement by joining ``(src, dst, tag, n)``
    against the telemetry send events. Returns the event count."""
    import json

    n = 0
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps({
                "ev": "fault", "kind": e.kind, "src": e.src,
                "dst": e.dst, "tag": e.tag, "n": e.n,
            }) + "\n")
            n += 1
    return n
