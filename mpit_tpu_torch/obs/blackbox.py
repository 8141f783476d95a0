"""Black-box flight recorder: a bounded in-memory ring of the last few
seconds of a rank's observability stream, dumped atomically on trigger.

A copy of ``mpit_tpu/obs/blackbox.py`` for the port; a dump signal that
does not name a signal raises instead of being ignored.

The live plane (``MPIT_OBS_LIVE``) answers "how is the run doing *now*";
the journals answer "what happened" — but only for ranks that exited
cleanly (a SIGKILLed process flushes nothing) and only within the
journal cap, which keeps the *head* of a run. This module is the
aviation-style third leg: every :class:`~mpit_tpu_torch.obs.core.Journal`
tees its records (spans, wire telemetry, dynamics, serve lifecycle —
including records the cap drops) into a :class:`BlackBox`, a ring
bounded by BOTH record count and wall-clock horizon, that costs a list
append while healthy and writes ``<dir>/blackbox/rank_<r>.jsonl``
when something goes wrong.

Dump triggers (all with per-incident dedup):

- **close** — a cleanly-finished rank leaves its final window, so a
  post-mortem covers the whole fleet, not just the ranks that died;
- **atexit** — interpreter teardown catches ranks that never reached
  ``close()`` (an uncaught exception, ``sys.exit``);
- **SIGTERM** — the dump runs before the default handler re-raises, so
  a polite kill (the launcher's ``terminate()``, a scheduler's
  preemption warning) still captures the window. SIGKILL cannot be
  caught — that gap is exactly what the *cross-rank* triggers cover:
- **dump request** — any process may call :func:`request_dump` to write
  ``<dir>/blackbox/dump_request.json``; a per-process watcher thread
  (one poll every ~0.3 s) sees it and dumps EVERY local box, so one
  observer (the alert engine in ``obs live``, the elastic supervisor in
  ``mpit_tpu_torch.launch`` observing a kill) freezes the incident window on
  every surviving rank of the fleet;
- **signal** — ``MPIT_OBS_BLACKBOX_DUMP_SIGNAL=USR1`` arms an explicit
  dump-and-continue signal for interactive forensics.

Dumps are atomic (tmp + ``os.replace``) and *accumulate*: each dump
appends one segment — a ``blackbox`` header record (rank, gen, trigger,
incident, window, eviction counters) followed by the ring's records in
journal format — to the rank's file, so an incident dump is never
overwritten by the quieter close dump that follows it. The analyzer
(``python -m mpit_tpu_torch.obs postmortem``, :mod:`mpit_tpu_torch.obs.postmortem`)
reassembles the segments into a cross-rank incident report.

Like the rest of the reader/boundary surface this module is
stdlib-only — it must be importable from the launcher and the CLI
without jax or the transport stack.
"""

from __future__ import annotations

import atexit
import json
import os
import signal as signal_mod
import threading
import time
from typing import Any, Callable, Optional

from mpit_tpu_torch.analysis.runtime import make_lock

#: dump_request.json poll cadence for the watcher thread — fast enough
#: that survivors freeze their windows while the incident is still in
#: the ring horizon, slow enough to be free (one stat per poll)
_WATCH_INTERVAL_S = 0.3

REQUEST_FILE = "dump_request.json"


def _blackbox_dir(obs_dir: str) -> str:
    return os.path.join(obs_dir, "blackbox")


class BlackBox:
    """One rank's flight recorder: a ring bounded by record count AND
    wall-clock horizon, teed from the rank's Journal (see
    :meth:`~mpit_tpu_torch.obs.core.Journal.event`).

    ``record`` is the hot path — a list append plus an amortized
    head-trim, pinned by the micro-benchmark in tests/test_blackbox.py.
    ``dump`` is the cold path — it snapshots the ring under the lock
    and does all formatting/IO outside it."""

    def __init__(
        self,
        obs_dir: str,
        rank: int,
        max_records: int = 2048,
        max_seconds: float = 30.0,
        gen: int = 0,
    ):
        if max_records < 1:
            raise ValueError("max_records must be >= 1")
        if max_seconds <= 0:
            raise ValueError("max_seconds must be > 0")
        self.dir = _blackbox_dir(obs_dir)
        self.rank = rank
        self.gen = gen
        self.max_records = max_records
        self.max_seconds = max_seconds
        self.path = os.path.join(self.dir, f"rank_{rank}.jsonl")
        self.evicted = 0
        self.dumps = 0
        self.last_trigger: Optional[str] = None
        self._ring: list = []  # (t, clk, ev, fields)
        self._lock = make_lock(f"obs.BlackBox._lock[{rank}]")
        self._closed = False
        self._seen_incidents: set = set()
        self._sources: list = []  # (name, callable) extra dump content
        _register(self)

    # -- hot path ---------------------------------------------------------

    def record(self, t: float, clk: int, ev: str, fields: dict) -> None:
        """Tee one journal record into the ring. Caller (Journal.event)
        already holds ITS lock; this takes the box's own so signal/
        watcher-thread dumps stay safe against concurrent writers."""
        with self._lock:
            if self._closed:
                return
            ring = self._ring
            ring.append((t, clk, ev, fields))
            if len(ring) > self.max_records:
                del ring[0]
                self.evicted += 1
            # horizon trim: amortized O(1) — each record is appended
            # once and evicted at most once
            horizon = t - self.max_seconds
            n = 0
            while n < len(ring) and ring[n][0] < horizon:
                n += 1
            if n:
                del ring[:n]
                self.evicted += n

    # -- dump path --------------------------------------------------------

    def add_source(self, name: str, fn: Callable[[], list]) -> None:
        """Register extra dump-time content: ``fn`` returns a list of
        JSON-able dicts appended to every dump segment under
        ``x_source: name`` (the chaos FaultLog's schedule rides along
        this way — see examples/ptest_proc.py)."""
        with self._lock:
            self._sources.append((name, fn))

    def stats(self) -> dict:
        """Live-plane collector fragment: the recorder's own health."""
        with self._lock:
            return {
                "records": len(self._ring),
                "evicted": self.evicted,
                "dumps": self.dumps,
                "last_trigger": self.last_trigger,
            }

    def dump(
        self, trigger: str, incident: Optional[str] = None
    ) -> Optional[str]:
        """Write one dump segment; returns the file path, or None when
        this incident was already dumped (per-incident dedup) or the
        ring is empty. Never raises — a flight recorder that can crash
        the plane is worse than none."""
        try:
            return self._dump(trigger, incident)
        except Exception:
            return None

    def _dump(self, trigger: str, incident: Optional[str]) -> Optional[str]:
        with self._lock:
            if incident is not None:
                if incident in self._seen_incidents:
                    return None
                self._seen_incidents.add(incident)
            ring = list(self._ring)
            sources = list(self._sources)
            self.dumps += 1
            self.last_trigger = trigger
        if not ring and trigger in ("atexit", "close"):
            return None
        header = {
            "ts": round(time.time(), 3),
            "tag": "obs",
            "process": 0,
            "step": ring[-1][1] if ring else 0,
            "rank": self.rank,
            "ev": "blackbox",
            "t": time.time(),
            "gen": self.gen,
            "trigger": trigger,
            "records": len(ring),
            "evicted": self.evicted,
            "cap": self.max_records,
            "horizon_s": self.max_seconds,
        }
        if incident is not None:
            header["incident"] = incident
        if ring:
            header["t_first"] = ring[0][0]
            header["t_last"] = ring[-1][0]
        lines = [json.dumps(header)]
        for t, clk, ev, fields in ring:
            rec = {
                "ts": round(t, 3), "tag": "obs", "process": 0,
                "step": clk, "rank": self.rank, "ev": ev, "t": t,
            }
            for k, v in fields.items():
                rec[k] = _jsonable(v)
            lines.append(json.dumps(rec))
        for name, fn in sources:
            try:
                extra = fn()
            except Exception:
                continue
            for item in extra:
                rec = dict(item)
                rec.setdefault("rank", self.rank)
                rec["x_source"] = name
                lines.append(json.dumps(rec))
        os.makedirs(self.dir, exist_ok=True)
        # accumulate-atomically: new file = old segments + this one,
        # swapped in with os.replace — an earlier incident segment is
        # never clobbered by the close dump that follows it, and a
        # reader never sees a torn file
        prev = b""
        try:
            with open(self.path, "rb") as f:
                prev = f.read()
        except OSError:
            pass
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(prev)
            f.write(("\n".join(lines) + "\n").encode())
        os.replace(tmp, self.path)
        return self.path

    def close(self) -> None:
        """Stop recording and leave the registry (the Journal dumps a
        final ``close`` segment *before* calling this)."""
        with self._lock:
            self._closed = True
            self._ring = []
        _unregister(self)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, bool, int, float, type(None), list, dict)):
        return v
    if hasattr(v, "tolist"):
        return v.tolist()
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


# -- process-wide trigger plumbing ------------------------------------------
# One registry of live boxes per process (thread mode has one box per
# rank in a single process; process mode has one per OS process), one
# watcher thread, one atexit hook, at most one handler per signal.

_REG_LOCK = make_lock("obs.blackbox._REG_LOCK")
_BOXES: list = []
_WATCHER: Optional[threading.Thread] = None
_WATCHER_STOP = threading.Event()
_ATEXIT_ARMED = False
_SIGTERM_ARMED = False
_DUMP_SIGNALS: set = set()


def _register(box: BlackBox) -> None:
    global _WATCHER, _ATEXIT_ARMED
    with _REG_LOCK:
        _BOXES.append(box)
        if not _ATEXIT_ARMED:
            atexit.register(_dump_all, "atexit")
            _ATEXIT_ARMED = True
        if _WATCHER is None:
            _WATCHER_STOP.clear()
            _WATCHER = threading.Thread(
                target=_watch, daemon=True, name="mpit-blackbox-watch"
            )
            _WATCHER.start()


def _unregister(box: BlackBox) -> None:
    global _WATCHER
    with _REG_LOCK:
        try:
            _BOXES.remove(box)
        except ValueError:
            pass
        if not _BOXES:
            # park the watcher when the last box leaves; a fresh box
            # restarts it (tests create/destroy many worlds per process)
            _WATCHER_STOP.set()
            _WATCHER = None


def _boxes() -> list:
    with _REG_LOCK:
        return list(_BOXES)


def _dump_all(trigger: str, incident: Optional[str] = None) -> list:
    return [
        p for b in _boxes()
        if (p := b.dump(trigger, incident)) is not None
    ]


def _watch() -> None:
    """Poll each live box's ``dump_request.json`` (watcher thread). One
    request file per obs dir; the incident id dedups per box, so every
    box dumps exactly once per incident however often the file is
    re-read."""
    stop = _WATCHER_STOP
    while not stop.wait(_WATCH_INTERVAL_S):
        boxes = _boxes()
        if not boxes:
            continue
        by_dir: dict[str, list] = {}
        for b in boxes:
            by_dir.setdefault(b.dir, []).append(b)
        for d, group in by_dir.items():
            req = _read_request(os.path.join(d, REQUEST_FILE))
            if req is None:
                continue
            incident = req.get("incident") or "request"
            for b in group:
                b.dump("request", incident)


def _read_request(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            req = json.load(f)
    except (OSError, ValueError):
        return None
    return req if isinstance(req, dict) else None


def request_dump(
    obs_dir: str, reason: str, incident: Optional[str] = None
) -> str:
    """Ask every rank of the run under ``obs_dir`` to freeze its window:
    writes ``<dir>/blackbox/dump_request.json`` atomically; each rank's
    watcher thread sees it within ~{interval} and dumps (deduped per
    ``incident``). Callable from any process that can see the obs dir —
    the alert engine, the elastic supervisor, a human. Returns the
    incident id (auto-derived from the reason + wall-clock when not
    given)."""
    if incident is None:
        incident = f"{reason}@{int(time.time() * 1000)}"
    d = _blackbox_dir(obs_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, REQUEST_FILE)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(
            {"incident": incident, "reason": reason, "t": time.time()}, f
        )
    os.replace(tmp, path)
    # the requester's own boxes (thread mode: observer == observed
    # process) dump immediately rather than waiting out the poll
    for b in _boxes():
        if b.dir == d:
            b.dump("request", incident)
    return incident


def arm_process_triggers(
    dump_signal: Optional[str] = None,
) -> None:
    """Install the process-level dump triggers: a chaining SIGTERM
    handler (dump all boxes, restore the previous handler, re-raise so
    the exit status still says SIGTERM), and optionally an explicit
    dump-and-continue signal (``MPIT_OBS_BLACKBOX_DUMP_SIGNAL`` — name
    with or without the SIG prefix, or a number). Idempotent; a no-op
    off the main thread, where handlers cannot be installed — the atexit
    and dump-request triggers still cover such worlds. A dump signal
    that names no signal, or one that cannot be handled, raises
    ``ValueError``."""
    global _SIGTERM_ARMED
    signum = None
    if dump_signal:
        signum = _parse_signal(dump_signal)
        if signum is None:
            raise ValueError(
                f"blackbox dump signal {dump_signal!r} names no signal"
            )
    if threading.current_thread() is not threading.main_thread():
        return
    with _REG_LOCK:
        want_sigterm = not _SIGTERM_ARMED
        _SIGTERM_ARMED = True
    if want_sigterm:
        try:
            prev = signal_mod.getsignal(signal_mod.SIGTERM)

            def _on_term(signum, frame):
                _dump_all("sigterm")
                if callable(prev) and prev not in (
                    signal_mod.SIG_IGN, signal_mod.SIG_DFL
                ):
                    prev(signum, frame)
                else:
                    signal_mod.signal(signum, signal_mod.SIG_DFL)
                    signal_mod.raise_signal(signum)

            signal_mod.signal(signal_mod.SIGTERM, _on_term)
        except (ValueError, OSError):
            with _REG_LOCK:
                _SIGTERM_ARMED = False
    if signum is not None and signum not in _DUMP_SIGNALS:
        try:
            signal_mod.signal(
                signum,
                lambda s, f: _dump_all(
                    "signal", f"signal-{s}@{int(time.time())}"
                ),
            )
        except (ValueError, OSError) as e:
            raise ValueError(
                f"blackbox dump signal {dump_signal!r} cannot be handled"
            ) from e
        _DUMP_SIGNALS.add(signum)


def _parse_signal(name: str) -> Optional[int]:
    try:
        return int(name)
    except ValueError:
        pass
    key = name.upper()
    if not key.startswith("SIG"):
        key = "SIG" + key
    sig = getattr(signal_mod, key, None)
    return int(sig) if isinstance(sig, signal_mod.Signals) else None


def box_for(transport) -> Optional[BlackBox]:
    """The flight recorder behind an obs-wrapped transport (None when
    obs or the black box is unarmed) — how protocol-adjacent code (e.g.
    the chaos fault-log source in examples/ptest_proc.py) reaches it
    without knowing the wrapper layout."""
    journal = getattr(transport, "journal", None)
    return getattr(journal, "blackbox", None)
