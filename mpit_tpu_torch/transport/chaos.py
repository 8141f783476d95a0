"""ChaosTransport — seeded, deterministic fault injection over any Transport.

A copy of ``mpit_tpu/transport/chaos.py``: the same seed and send sequence
give the same fault schedule, event for event (``tests/test_torch_chaos.py``).
:class:`CorruptedPayload` is defined in :mod:`mpit_tpu_torch.transport.base`
and re-exported here.

The permanent test substrate for the PS protocol's failure model
(docs/ROBUSTNESS.md): wrap any :class:`Transport` (inproc / socket /
native — anything with the send/recv surface) and every *send* is run
through a fault schedule derived purely from ``(seed, src, dst, tag, n)``
where ``n`` is the per-(dst, tag) message index on that stream. No
wall-clock, no global ``random`` state: the same seed replays the same
fault decisions byte-for-byte, which is what lets a failing chaos run be
re-run under a debugger with the identical schedule (the
determinism pin of the tests).

Fault kinds (all sender-side — the receiver's mailbox semantics stay
untouched, so per-(src, tag) FIFO of *delivered* messages is preserved):

- ``drop``       message silently not delivered (lossy link)
- ``duplicate``  message delivered twice back-to-back (retransmit storm)
- ``delay``      blocking sleep before delivery (congested link; in-order)
- ``reset``      the send raises ``ConnectionError`` (peer RST — a
                 *visible* fault the caller's retry path must absorb)
- ``blackhole``  this and the next ``blackhole_len - 1`` messages on the
                 stream vanish silently (grey failure / dead NIC burst)
- ``jitter``     constant extra latency on every send from a slow rank
- ``kill_after`` rank goes silent after its N-th sent message (a dead
                 host doesn't fail cleanly; it just stops talking)
- ``corrupt``    the frame arrives but its payload is garbage — delivered
                 as a :class:`CorruptedPayload` marker (bit-rot / bad
                 deserialization). Receivers must drop it and let the
                 sender's retry/timeout machinery absorb the loss.
- ``truncate``   the frame is cut mid-stream: every array in the payload
                 arrives at half length (envelope scalars survive — a
                 length-prefixed read that stopped early). Payloads with
                 nothing array-like to cut degrade to ``CorruptedPayload``.

Determinism scope: per-stream decisions are always seed-determined. The
*total order* of the fault log is deterministic whenever each (dst, tag)
stream is fed from one thread (the log is sorted by stream, not by
wall-clock); ``kill_after`` counts sends across all streams of one rank,
so its trigger point is only reproducible for single-threaded senders
(e.g. heartbeats off).

Env knobs (read by :func:`config_from_env`; any set knob activates chaos):

  MPIT_CHAOS_SEED          int     schedule seed            (default 0)
  MPIT_CHAOS_DROP          float   P(drop)                  (default 0)
  MPIT_CHAOS_DUP           float   P(duplicate)             (default 0)
  MPIT_CHAOS_DELAY         float   P(delay)                 (default 0)
  MPIT_CHAOS_DELAY_S       float   max delay seconds        (default 0.01)
  MPIT_CHAOS_RESET         float   P(connection reset)      (default 0)
  MPIT_CHAOS_BLACKHOLE     float   P(blackhole burst start) (default 0)
  MPIT_CHAOS_BLACKHOLE_LEN int     burst length in messages (default 8)
  MPIT_CHAOS_JITTER_S      float   slow-rank extra latency  (default 0)
  MPIT_CHAOS_SLOW_RANKS    csv     ranks the jitter applies to
  MPIT_CHAOS_KILL_RANK     int     rank to kill
  MPIT_CHAOS_KILL_AFTER    int     ...after this many sent messages
  MPIT_CHAOS_CORRUPT       float   P(payload corruption)     (default 0)
  MPIT_CHAOS_TRUNCATE      float   P(frame truncation)       (default 0)
  MPIT_CHAOS_TAGS          csv     restrict faults to these tags (all)
  MPIT_CHAOS_<K>_TAGS      csv     narrow one kind further; K in DROP,
                                   DUP, DELAY, RESET, BLACKHOLE,
                                   CORRUPT, TRUNCATE
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Any, Iterable, Mapping, Optional, Sequence

import numpy as np

from mpit_tpu_torch.analysis.runtime import make_lock
from mpit_tpu_torch.transport.base import CorruptedPayload, Transport
from mpit_tpu_torch.transport.wire import QuantArray

_MASK = (1 << 64) - 1


def _mix(*values: int) -> int:
    """Order-sensitive integer hash combine (boost-style), fully
    deterministic across runs and Python versions — ``hash()`` of str is
    randomized per process and tuples can't seed ``random.Random``."""
    h = 0x243F6A8885A308D3  # pi, nothing up the sleeve
    for v in values:
        v &= _MASK
        h ^= (v + 0x9E3779B97F4A7C15 + ((h << 6) & _MASK) + (h >> 2)) & _MASK
        h &= _MASK
    return h


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One logged fault decision (``n`` = per-(dst, tag) stream index)."""

    kind: str
    src: int
    dst: int
    tag: int
    n: int


def _truncate_payload(payload: Any) -> Optional[Any]:
    """Payload with every ndarray cut to half length (a length-prefixed
    frame whose stream ended early: envelope scalars — epoch/seq/trace
    ids — decoded before the cut survive, the bulk array data did not).
    Returns None when nothing was truncatable (caller degrades to
    :class:`CorruptedPayload` — a cut tiny frame is just unparseable)."""
    if isinstance(payload, np.ndarray):
        if payload.ndim >= 1 and payload.shape[0] > 1:
            return payload[: payload.shape[0] // 2]
        return None
    if isinstance(payload, (tuple, list)):
        out, cut = [], False
        for item in payload:
            t = _truncate_payload(item)
            out.append(item if t is None else t)
            cut = cut or t is not None
        return type(payload)(out) if cut else None
    # quantized chunks carry their bulk bytes in .data — cut those, same
    # early-stream-end model as a raw ndarray (no extra RNG draws: the
    # fault schedule for old seeds is unchanged)
    if isinstance(payload, QuantArray):
        t = _truncate_payload(payload.data)
        if t is None:
            return None
        return dataclasses.replace(payload, data=t)
    return None


class FaultLog:
    """Thread-safe fault event collector, shared by a world's wrappers.

    ``events()`` returns the log sorted by (src, dst, tag, n): a total
    order derived from stream coordinates, not arrival time, so two runs
    of the same seed compare equal even when thread scheduling differs.
    """

    def __init__(self):
        self._lock = make_lock("chaos.FaultLog._lock")
        self._events: list[FaultEvent] = []

    def append(self, event: FaultEvent) -> None:
        with self._lock:
            self._events.append(event)

    def events(self) -> tuple[FaultEvent, ...]:
        with self._lock:
            return tuple(
                sorted(
                    self._events,
                    key=lambda e: (e.src, e.dst, e.tag, e.n, e.kind),
                )
            )

    def counts(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for e in self.events():
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Fault schedule parameters. Frozen: one config is shared, lock-free,
    by every wrapper in the world; all mutable state lives per-transport.

    ``scripted`` pins exact faults for regression tests: a mapping from
    ``(src, dst, tag, n)`` to a fault kind (``"drop" | "duplicate" |
    "reset" | "corrupt" | "truncate"``) applied to exactly that message,
    ahead of any probability
    draw. ``tags``/``edges`` restrict the *probabilistic* faults (scripted
    entries already name their target precisely); the per-fault
    ``<kind>_tags`` fields narrow one fault kind further (None = inherit
    ``tags``) — e.g. drop only the retryable FETCH/PARAM path while
    duplicates and resets exercise the push dedup."""

    seed: int = 0
    drop: float = 0.0
    duplicate: float = 0.0
    delay: float = 0.0
    delay_s: float = 0.01
    reset: float = 0.0
    blackhole: float = 0.0
    blackhole_len: int = 8
    jitter_s: float = 0.0
    slow_ranks: tuple[int, ...] = ()
    kill_after: Mapping[int, int] = dataclasses.field(default_factory=dict)
    corrupt: float = 0.0
    truncate: float = 0.0
    tags: Optional[tuple[int, ...]] = None
    drop_tags: Optional[tuple[int, ...]] = None
    duplicate_tags: Optional[tuple[int, ...]] = None
    delay_tags: Optional[tuple[int, ...]] = None
    reset_tags: Optional[tuple[int, ...]] = None
    blackhole_tags: Optional[tuple[int, ...]] = None
    corrupt_tags: Optional[tuple[int, ...]] = None
    truncate_tags: Optional[tuple[int, ...]] = None
    edges: Optional[tuple[tuple[int, int], ...]] = None
    scripted: Mapping[tuple[int, int, int, int], str] = dataclasses.field(
        default_factory=dict
    )

    _KINDS = ("drop", "duplicate", "delay", "reset", "blackhole",
              "corrupt", "truncate")

    def __post_init__(self):
        for name in self._KINDS:
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be a probability, got {p}")
        if self.blackhole_len < 1:
            raise ValueError("blackhole_len must be >= 1")
        for key, kind in self.scripted.items():
            if kind not in ("drop", "duplicate", "reset", "corrupt",
                            "truncate"):
                raise ValueError(
                    f"scripted[{key}]: unknown fault kind {kind!r}"
                )
        if self.tags is not None:
            for name in self._KINDS:
                per = getattr(self, f"{name}_tags")
                if per is not None and not set(per) <= set(self.tags):
                    raise ValueError(
                        f"{name}_tags {per} must be a subset of tags "
                        f"{self.tags} (a tag outside `tags` never draws)"
                    )

    def applies(self, src: int, dst: int, tag: int) -> bool:
        """Do the *probabilistic* faults cover this message?"""
        if self.tags is not None and tag not in self.tags:
            return False
        if self.edges is not None and (src, dst) not in self.edges:
            return False
        return True

    def allows(self, kind: str, tag: int) -> bool:
        """Does fault ``kind`` cover ``tag``? (``applies`` already passed.)

        Gating is applied AFTER the probability draws, never instead of
        them: narrowing one kind's tags must not shift the other kinds'
        random streams, or per-kind filters would break seed replay."""
        per = getattr(self, f"{kind}_tags")
        return per is None or tag in per


_ENV_KNOBS = frozenset(
    "MPIT_CHAOS_" + k
    for k in (
        "SEED", "DROP", "DUP", "DELAY", "DELAY_S", "RESET", "BLACKHOLE",
        "BLACKHOLE_LEN", "JITTER_S", "SLOW_RANKS", "KILL_RANK",
        "KILL_AFTER", "CORRUPT", "TRUNCATE", "TAGS", "DROP_TAGS",
        "DUP_TAGS", "DELAY_TAGS", "RESET_TAGS", "BLACKHOLE_TAGS",
        "CORRUPT_TAGS", "TRUNCATE_TAGS",
    )
)


def config_from_env(env: Mapping[str, str] = os.environ) -> Optional[ChaosConfig]:
    """Build a config from ``MPIT_CHAOS_*`` knobs; None when none are set
    (chaos must never activate implicitly — only the RECOGNIZED knobs
    count, so e.g. the soak script's ``MPIT_CHAOS_SOAK_OFFSET`` doesn't
    arm an empty schedule)."""
    if not any(k in _ENV_KNOBS for k in env):
        return None

    def _f(name: str, default: float) -> float:
        return float(env.get(name, default))

    def _csv_ints(name: str) -> Optional[tuple[int, ...]]:
        raw = env.get(name)
        if raw is None or not raw.strip():
            return None
        return tuple(int(p) for p in raw.split(",") if p.strip())

    kill_after: dict[int, int] = {}
    if "MPIT_CHAOS_KILL_RANK" in env:
        kill_after[int(env["MPIT_CHAOS_KILL_RANK"])] = int(
            env.get("MPIT_CHAOS_KILL_AFTER", 0)
        )
    return ChaosConfig(
        seed=int(env.get("MPIT_CHAOS_SEED", 0)),
        drop=_f("MPIT_CHAOS_DROP", 0.0),
        duplicate=_f("MPIT_CHAOS_DUP", 0.0),
        delay=_f("MPIT_CHAOS_DELAY", 0.0),
        delay_s=_f("MPIT_CHAOS_DELAY_S", 0.01),
        reset=_f("MPIT_CHAOS_RESET", 0.0),
        blackhole=_f("MPIT_CHAOS_BLACKHOLE", 0.0),
        blackhole_len=int(env.get("MPIT_CHAOS_BLACKHOLE_LEN", 8)),
        jitter_s=_f("MPIT_CHAOS_JITTER_S", 0.0),
        slow_ranks=_csv_ints("MPIT_CHAOS_SLOW_RANKS") or (),
        kill_after=kill_after,
        corrupt=_f("MPIT_CHAOS_CORRUPT", 0.0),
        truncate=_f("MPIT_CHAOS_TRUNCATE", 0.0),
        tags=_csv_ints("MPIT_CHAOS_TAGS"),
        drop_tags=_csv_ints("MPIT_CHAOS_DROP_TAGS"),
        duplicate_tags=_csv_ints("MPIT_CHAOS_DUP_TAGS"),
        delay_tags=_csv_ints("MPIT_CHAOS_DELAY_TAGS"),
        reset_tags=_csv_ints("MPIT_CHAOS_RESET_TAGS"),
        blackhole_tags=_csv_ints("MPIT_CHAOS_BLACKHOLE_TAGS"),
        corrupt_tags=_csv_ints("MPIT_CHAOS_CORRUPT_TAGS"),
        truncate_tags=_csv_ints("MPIT_CHAOS_TRUNCATE_TAGS"),
    )


class ChaosTransport(Transport):
    """Fault-injecting wrapper: chaos on the send path, passthrough recv.

    The wrapped rank keeps its identity (``rank``/``size``); ``rng`` per
    message is derived from the stream coordinates, never shared or
    advanced across messages — see the module docstring's determinism
    contract. Inherited :meth:`Transport.isend` routes through
    :meth:`send`, so async sends see the same schedule.
    """

    def __init__(
        self,
        inner: Transport,
        config: ChaosConfig,
        log: Optional[FaultLog] = None,
    ):
        self.inner = inner
        self.rank = inner.rank
        self.size = inner.size
        self.config = config
        self.log = log if log is not None else FaultLog()
        self._lock = make_lock(f"chaos.ChaosTransport._lock[{inner.rank}]")
        self._stream_n: dict[tuple[int, int], int] = {}
        self._blackhole_until: dict[tuple[int, int], int] = {}
        self._sent_total = 0

    # -- schedule ---------------------------------------------------------

    def _next(self, dst: int, tag: int) -> tuple[int, int]:
        with self._lock:
            n = self._stream_n.get((dst, tag), 0)
            self._stream_n[(dst, tag)] = n + 1
            self._sent_total += 1
            return n, self._sent_total

    def _record(self, kind: str, dst: int, tag: int, n: int) -> None:
        self.log.append(FaultEvent(kind, self.rank, dst, tag, n))

    def send(self, dst: int, tag: int, payload: Any) -> None:
        cfg = self.config
        n, total = self._next(dst, tag)

        limit = cfg.kill_after.get(self.rank)
        if limit is not None and total > limit:
            # dead rank: silence, not an error — the layers above must
            # detect this via timeouts/watchdog, not a clean exception
            self._record("kill", dst, tag, n)
            return

        scripted = cfg.scripted.get((self.rank, dst, tag, n))
        if scripted == "drop":
            self._record("drop", dst, tag, n)
            return
        if scripted == "reset":
            self._record("reset", dst, tag, n)
            raise ConnectionError(
                f"chaos: scripted connection reset on "
                f"{self.rank}->{dst} tag {tag} msg {n}"
            )

        deliveries = 2 if scripted == "duplicate" else 1
        if scripted == "duplicate":
            self._record("duplicate", dst, tag, n)

        wire = payload  # what actually goes down; mangled by corrupt/truncate
        if scripted == "corrupt":
            self._record("corrupt", dst, tag, n)
            wire = CorruptedPayload(self.rank, dst, tag, n)
        elif scripted == "truncate":
            self._record("truncate", dst, tag, n)
            cut = _truncate_payload(payload)
            wire = (
                cut if cut is not None
                else CorruptedPayload(self.rank, dst, tag, n)
            )

        if cfg.applies(self.rank, dst, tag) and scripted is None:
            rng = random.Random(_mix(cfg.seed, self.rank, dst, tag, n))
            # fixed draw order — the replay contract; new kinds append
            # their draws at the END so old seeds replay old schedules
            r_drop = rng.random()
            r_dup = rng.random()
            r_delay = rng.random()
            delay_amount = rng.random() * cfg.delay_s
            r_reset = rng.random()
            r_black = rng.random()
            r_corrupt = rng.random()
            r_trunc = rng.random()

            with self._lock:
                in_hole = n < self._blackhole_until.get((dst, tag), 0)
                if (
                    not in_hole
                    and r_black < cfg.blackhole
                    and cfg.allows("blackhole", tag)
                ):
                    self._blackhole_until[(dst, tag)] = n + cfg.blackhole_len
                    in_hole = True
            if in_hole:
                self._record("blackhole", dst, tag, n)
                return
            if r_reset < cfg.reset and cfg.allows("reset", tag):
                self._record("reset", dst, tag, n)
                raise ConnectionError(
                    f"chaos: connection reset on {self.rank}->{dst} "
                    f"tag {tag} msg {n}"
                )
            if r_drop < cfg.drop and cfg.allows("drop", tag):
                self._record("drop", dst, tag, n)
                return
            # at most one mangle per message (elif): a frame is either
            # corrupted whole or cut short, and the draws above already
            # happened so the elif can't shift anyone's random stream
            if r_corrupt < cfg.corrupt and cfg.allows("corrupt", tag):
                self._record("corrupt", dst, tag, n)
                wire = CorruptedPayload(self.rank, dst, tag, n)
            elif r_trunc < cfg.truncate and cfg.allows("truncate", tag):
                self._record("truncate", dst, tag, n)
                cut = _truncate_payload(payload)
                wire = (
                    cut if cut is not None
                    else CorruptedPayload(self.rank, dst, tag, n)
                )
            if cfg.jitter_s > 0 and self.rank in cfg.slow_ranks:
                self._record("jitter", dst, tag, n)
                time.sleep(cfg.jitter_s)
            if r_delay < cfg.delay and cfg.allows("delay", tag):
                self._record("delay", dst, tag, n)
                time.sleep(delay_amount)
            if r_dup < cfg.duplicate and cfg.allows("duplicate", tag):
                self._record("duplicate", dst, tag, n)
                deliveries = 2

        for _ in range(deliveries):
            self.inner.send(dst, tag, wire)

    # -- passthrough ------------------------------------------------------

    def recv(self, src=-1, tag=-1, timeout=None):
        return self.inner.recv(src, tag, timeout)

    def probe(self, src=-1, tag=-1, timeout=0):
        return self.inner.probe(src, tag, timeout)

    def close(self) -> None:
        self.inner.close()


def wrap_transports(
    transports: Sequence[Transport],
    config: ChaosConfig,
    log: Optional[FaultLog] = None,
) -> tuple[list[ChaosTransport], FaultLog]:
    """Wrap a whole world's transports around one shared fault log."""
    log = log if log is not None else FaultLog()
    return [ChaosTransport(t, config, log) for t in transports], log


def iter_fault_lines(events: Iterable[FaultEvent]) -> Iterable[str]:
    """Stable text rendering of a fault log (soak-script output format)."""
    for e in events:
        yield f"{e.kind} {e.src}->{e.dst} tag={e.tag} n={e.n}"
