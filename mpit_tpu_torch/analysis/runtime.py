"""Runtime lock-order and tag-concurrency checker for the transport layer.

A copy of ``mpit_tpu/analysis/runtime.py`` for the port. RT104 also takes
torch tensors: armed, it copies a tensor to the host (``np.asarray`` of a
CUDA tensor raises); unarmed, nothing is copied.

Opt-in instrumentation (zero overhead when off — the transports call
:func:`make_lock` at construction and :func:`active_checker` per recv, both
of which short-circuit on the module-level ``_ACTIVE`` being None):

- **RT101 lock-order cycles.** Every :class:`_TrackedLock` acquisition
  records, per thread, the set of locks already held and adds *order edges*
  ``held -> acquiring`` to a global directed graph. A cycle in that graph is
  a potential deadlock EVEN IF the runs that built the two halves of the
  cycle never overlapped in time — which is exactly why a graph beats
  timeout-based detection: the inversion is caught on a clean single-run
  test, not on the unlucky production schedule.
- **RT102 concurrent tag reuse.** :class:`~mpit_tpu_torch.transport.inproc.Broker`
  registers every blocking ``get`` (recv) as a *waiter* keyed by
  ``(broker, dst, src, tag)``. Two waiters on the same mailbox whose
  filters can match the same message — same concrete tag, sources equal or
  either a wildcard, different threads — mean two protocol roles are
  racing for one tag: whichever recv matches first steals the other role's
  message. (Wildcard-tag waiters are exempt: ``recv(ANY_TAG)`` is the
  single-threaded dispatcher pattern, e.g. the pserver loop.)
- **RT103 happens-before races** (opt-in on top of a checker: ``race=True``
  or ``MPIT_RT_RACE=1``). Every tracked lock/condition carries a vector
  clock: release publishes the holder's clock into the lock and advances
  the holder; acquire joins the lock's clock into the acquirer. Annotated
  shared structures (PServer center/version/counts, Broker mailboxes —
  via :func:`note`) record per-variable last-write/read epochs; an access
  not ordered after the previous conflicting access by that clock algebra
  is a data race REGARDLESS of how the schedule happened to interleave —
  the dynamic complement of static MPT013, reported with both stacks.
- **RT104 numerics sanitizer** (opt-in: ``numerics=True`` or
  ``MPIT_RT_NUMERICS=1``). The dynamic complement of static MPT020-022:
  the quant kernels' host faces (:mod:`mpit_tpu_torch.quant` peeks for an armed
  checker, never the other way round), the PServer apply path, and the
  sync/PS error-feedback state report into :func:`note_numeric_array` /
  ``on_quantize`` / :func:`note_residual_norm`. Checks: NaN/Inf reaching
  a quantize or the server center, int8 absmax overflow (non-finite or
  non-positive scale), the zero-absmax pin (scale 1, codes all zero —
  quant.py's hardened contract), and EF-residual norm boundedness — the
  same per-round norm the dynamics plane journals as ``elastic`` must
  stay finite and not grow without bound. One finding per call site,
  with the caller's stack.

Usage::

    from mpit_tpu_torch.analysis import runtime
    with runtime.checking() as checker:
        ...construct transports / brokers and run traffic...
    assert not checker.findings

Locks created BEFORE the checker was enabled stay untracked (they were
handed out as plain ``threading.Lock``): enable the checker first, then
construct the transports under test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import sys
import threading
import traceback
from typing import Iterator, Optional

ANY = -1  # mirrors transport.ANY_SOURCE/ANY_TAG without importing transport


@dataclasses.dataclass(frozen=True)
class RuntimeFinding:
    rule: str  # "RT101" | "RT102" | "RT103" | "RT104"
    message: str

    def format(self) -> str:
        return f"{self.rule}: {self.message}"


@dataclasses.dataclass(frozen=True)
class _Waiter:
    token: int
    thread: int
    thread_name: str
    broker: int  # id() of the broker — scoping is per broker
    dst: int
    src: int
    tag: int

    def overlaps(self, other: "_Waiter") -> bool:
        if self.broker != other.broker or self.dst != other.dst:
            return False
        if self.thread == other.thread:
            return False  # one role draining sequentially
        if self.tag == ANY or other.tag == ANY:
            return False  # wildcard dispatcher pattern
        if self.tag != other.tag:
            return False
        return (
            self.src == other.src or self.src == ANY or other.src == ANY
        )


class RuntimeChecker:
    """Collects RT101/RT102 findings; thread-safe; activate via
    :func:`checking` (or :func:`enable`/:func:`disable` for long-lived
    diagnostics sessions)."""

    def __init__(self, race: bool = False, numerics: bool = False):
        self._mu = threading.Lock()
        self.findings: list = []
        # lock-order graph over lock INSTANCES (ids) — names alias freely
        # (every per-dst lock shares one name) so identity is the node
        self._edges: dict = {}  # id -> set(id)
        self._names: dict = {}  # id -> name
        self._reported_edges: set = set()
        self._held = threading.local()
        self._waiters: dict = {}  # token -> _Waiter
        self._token_counter = itertools.count(1)
        self._reported_tags: set = set()
        # -- RT103 vector-clock state (race=True only) --
        self.race = race
        self._race_tids = threading.local()  # small stable per-thread ids
        self._race_tid_counter = itertools.count(1)
        self._clocks: dict = {}  # tid -> {tid: clk}
        self._vars: dict = {}  # key -> {"w": epoch|None, "r": {tid: epoch}}
        self._reported_races: set = set()
        # -- RT104 numerics state (numerics=True only) --
        self.numerics = numerics
        self._reported_numerics: set = set()  # (caller file:line, kind)
        self._resid_norms: dict = {}  # key -> [observed finite norms]

    # -- lock-order graph -------------------------------------------------

    def _held_stack(self) -> list:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    def on_acquire(self, lock: "_TrackedLock") -> None:
        """Called BEFORE the underlying acquire blocks, so a deadlock in
        progress still records the edge that explains it."""
        stack = self._held_stack()
        me = id(lock)
        with self._mu:
            self._names[me] = lock.name
            for held in stack:
                if held == me:
                    continue  # reentrant misuse; RT101 is not that check
                self._add_edge(held, me)
        stack.append(me)

    def on_release(self, lock: "_TrackedLock") -> None:
        stack = self._held_stack()
        me = id(lock)
        # remove the most recent occurrence; out-of-order release is legal
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == me:
                del stack[i]
                break

    def _add_edge(self, a: int, b: int) -> None:
        """a held while acquiring b. Caller holds self._mu."""
        if b in self._edges.setdefault(a, set()):
            return
        self._edges[a].add(b)
        path = self._find_path(b, a)
        if path is not None:
            key = frozenset(path)
            if key not in self._reported_edges:
                self._reported_edges.add(key)
                names = " -> ".join(
                    self._names.get(n, f"lock@{n:#x}") for n in path + [b]
                )
                self.findings.append(
                    RuntimeFinding(
                        "RT101",
                        "lock-order cycle (potential deadlock): "
                        f"{names} — two threads acquire these locks in "
                        "opposite orders",
                    )
                )

    def _find_path(self, start: int, goal: int) -> Optional[list]:
        """DFS path start..goal in the edge graph, else None."""
        stack = [(start, [start])]
        seen = set()
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            if node in seen:
                continue
            seen.add(node)
            for nxt in self._edges.get(node, ()):
                stack.append((nxt, path + [nxt]))
        return None

    # -- tag concurrency --------------------------------------------------

    def on_recv_enter(
        self, broker, dst: int, src: int, tag: int
    ) -> int:
        """Register a blocking recv; returns a token for
        :meth:`on_recv_exit`. Emits RT102 when an already-active waiter on
        the same mailbox can match the same messages."""
        th = threading.current_thread()
        waiter = _Waiter(
            token=next(self._token_counter),
            thread=th.ident or 0,
            thread_name=th.name,
            broker=id(broker),
            dst=dst,
            src=src,
            tag=tag,
        )
        with self._mu:
            for other in self._waiters.values():
                if waiter.overlaps(other):
                    key = (waiter.broker, dst, tag)
                    if key not in self._reported_tags:
                        self._reported_tags.add(key)
                        self.findings.append(
                            RuntimeFinding(
                                "RT102",
                                f"tag {tag} on rank {dst} is being "
                                "received concurrently by threads "
                                f"{other.thread_name!r} (src filter "
                                f"{other.src}) and "
                                f"{waiter.thread_name!r} (src filter "
                                f"{waiter.src}) — two protocol roles "
                                "share one tag; whichever matches first "
                                "steals the other's message",
                            )
                        )
            self._waiters[waiter.token] = waiter
        return waiter.token

    def on_recv_exit(self, token: int) -> None:
        with self._mu:
            self._waiters.pop(token, None)

    # -- RT103 happens-before races ---------------------------------------
    #
    # Djit+-style vector clocks. Each thread t keeps C_t; each tracked
    # lock keeps the clock its last releaser published. release(m):
    # m.vc = C_t; C_t[t] += 1. acquire(m): C_t = join(C_t, m.vc). An
    # access epoch (u, c) happens-before the current thread iff
    # c <= C_t[u] — i.e. some lock hand-off chain carried u's work here.
    # Per variable we keep the last write epoch and the reads since: a
    # write must be ordered after ALL of them, a read after the write.

    def _race_tid(self) -> int:
        tid = getattr(self._race_tids, "id", None)
        if tid is None:
            # NOT threading.get_ident(): the OS reuses those when threads
            # die, which would merge two distinct threads' clocks
            tid = self._race_tids.id = next(self._race_tid_counter)
        return tid

    def _clock(self, tid: int) -> dict:
        """Caller holds self._mu."""
        clock = self._clocks.get(tid)
        if clock is None:
            clock = self._clocks[tid] = {tid: 1}
        return clock

    def on_acquired(self, lock) -> None:
        """After the underlying acquire succeeded: join the lock's clock
        into the acquiring thread's."""
        if not self.race:
            return
        tid = self._race_tid()
        with self._mu:
            clock = self._clock(tid)
            for t, c in lock._vc.items():
                if clock.get(t, 0) < c:
                    clock[t] = c

    def on_before_release(self, lock) -> None:
        """Just before the underlying release: publish the holder's clock
        into the lock and advance the holder's own component."""
        if not self.race:
            return
        tid = self._race_tid()
        with self._mu:
            clock = self._clock(tid)
            lock._vc = dict(clock)
            clock[tid] = clock.get(tid, 1) + 1

    def on_var_access(self, key: str, write: bool) -> None:
        """An annotated shared-structure access (see module-level
        :func:`note`). Reports at most one race per key."""
        tid = self._race_tid()
        tname = threading.current_thread().name
        # drop the note()/on_var_access frames; keep the caller's tail
        stack = "".join(
            traceback.format_list(traceback.extract_stack()[-8:-2])
        )
        with self._mu:
            clock = self._clock(tid)
            st = self._vars.setdefault(key, {"w": None, "r": {}})

            def _ordered(epoch) -> bool:
                e_tid, e_clk, _, _ = epoch
                return e_clk <= clock.get(e_tid, 0) or e_tid == tid

            race, kind = None, None
            if st["w"] is not None and not _ordered(st["w"]):
                race = st["w"]
                kind = "write-write" if write else "read-write"
            if write and race is None:
                for prev in st["r"].values():
                    if not _ordered(prev):
                        race, kind = prev, "read-write"
                        break
            if race is not None and key not in self._reported_races:
                self._reported_races.add(key)
                o_tid, _, o_name, o_stack = race
                self.findings.append(
                    RuntimeFinding(
                        "RT103",
                        f"{kind} race on {key}: no happens-before edge "
                        f"between thread {o_name!r} (t{o_tid}) at:\n"
                        f"{o_stack}  and thread {tname!r} (t{tid}) at:\n"
                        f"{stack}  — the accesses can interleave; guard "
                        "both with one tracked lock",
                    )
                )
            me = (tid, clock.get(tid, 1), tname, stack)
            if write:
                st["w"] = me
                st["r"] = {}
            else:
                st["r"][tid] = me

    # -- RT104 numerics sanitizer -------------------------------------------
    #
    # Armed-only cost (every hook is behind ``checker.numerics``); numpy
    # is imported lazily inside the methods so this module stays
    # stdlib-only at import time for the reader tools that sit on it.

    #: EF-residual boundedness: a norm this many times the largest norm
    #: seen in the first observations of a stream is divergence, not the
    #: bounded O(scale) rounding floor the EF recurrence guarantees
    RESIDUAL_GROWTH_BOUND = 1000.0
    _RESID_WARMUP = 3

    def _numerics_site(self) -> tuple:
        """(file:line, stack tail) of the first frame outside this module
        and quant.py — the USER call site, so one buggy caller reports
        once however many chunks it pushes."""
        frames = traceback.extract_stack()[:-3]
        skip = (os.sep + "quant.py", os.sep + "runtime.py")
        caller = None
        for fr in reversed(frames):
            if not fr.filename.endswith(skip):
                caller = fr
                break
        where = (
            f"{caller.filename}:{caller.lineno}" if caller else "<unknown>"
        )
        stack = "".join(traceback.format_list(frames[-6:]))
        return where, stack

    def _numerics_report(self, kind: str, message: str) -> None:
        where, stack = self._numerics_site()
        with self._mu:
            if (where, kind) in self._reported_numerics:
                return
            self._reported_numerics.add((where, kind))
            self.findings.append(
                RuntimeFinding(
                    "RT104", f"{message} at {where}:\n{stack}"
                )
            )

    def on_quantize(self, face: str, arr, mode: str, scale, codes) -> None:
        """Called by the host quant kernels (quant.py) when armed."""
        import numpy as np

        a = np.asarray(_host(arr))
        n_bad = int(a.size - np.count_nonzero(np.isfinite(a)))
        if n_bad:
            self._numerics_report(
                "non-finite-input",
                f"{n_bad} non-finite value(s) reached {face}[{mode}] "
                f"(shape {a.shape}) — a NaN/Inf is about to cross the "
                "wire; the quantizer pins it, but the producer is broken",
            )
        if mode != "int8" or not a.size:
            return
        s = np.asarray(_host(scale))
        if not bool(np.all(np.isfinite(s))) or not bool(np.all(s > 0)):
            self._numerics_report(
                "scale-overflow",
                f"{face}[int8] produced a non-finite or non-positive "
                f"scale (absmax overflow) — codes are garbage",
            )
            return
        # the zero-absmax pin (quant.py's hardened contract): a row with
        # no finite signal must quantize to scale 1 / all-zero codes so
        # it dequantizes to exact zeros
        finite_amax = np.max(
            np.where(np.isfinite(a), np.abs(a), 0),
            axis=-1 if s.ndim else None,
        )
        c = np.asarray(_host(codes))
        zero_rows = finite_amax == 0
        if bool(np.any(zero_rows)):
            row_codes = c if not s.ndim else c[np.asarray(zero_rows)]
            if bool(np.any(row_codes)):
                self._numerics_report(
                    "zero-absmax",
                    f"{face}[int8] emitted nonzero codes for a "
                    "zero-absmax row — the hardened zero/NaN pin "
                    "regressed; dequantize will fabricate signal",
                )

    def on_dequantize(self, face: str, scale, mode: str) -> None:
        import numpy as np

        if mode != "int8":
            return
        s = np.asarray(_host(scale))
        if not bool(np.all(np.isfinite(s))) or not bool(np.all(s > 0)):
            self._numerics_report(
                "bad-dequant-scale",
                f"{face}[int8] called with a non-finite or non-positive "
                "scale — the codes' scale was dropped or corrupted in "
                "transit",
            )

    def on_numeric_array(self, site: str, arr) -> None:
        """NaN/Inf check on a host-boundary array (server apply path,
        collective accumulation exits). Traced values don't convert —
        callers only hand in concrete host arrays."""
        import numpy as np

        try:
            a = np.asarray(_host(arr))
        except Exception:
            return  # a non-array: not checkable here
        if a.dtype.kind != "f":
            return
        n_bad = int(a.size - np.count_nonzero(np.isfinite(a)))
        if n_bad:
            self._numerics_report(
                f"nonfinite:{site}",
                f"{n_bad} non-finite value(s) in {site} "
                f"(shape {a.shape}) — poisoned state is being applied",
            )

    def on_residual_norm(self, key: str, norm: float) -> None:
        """EF-residual boundedness, cross-checked against the same norm
        the dynamics plane journals as ``elastic``: the residual is the
        quantizer's one-step rounding error and must stay O(scale) —
        finite always, and never orders of magnitude above the stream's
        early rounds."""
        import math

        if not math.isfinite(norm):
            self._numerics_report(
                f"resid-nonfinite:{key}",
                f"error-feedback residual norm for {key} is {norm!r} — "
                "the EF state is poisoned and every future push "
                "inherits it",
            )
            return
        with self._mu:
            seen = self._resid_norms.setdefault(key, [])
            if len(seen) < self._RESID_WARMUP:
                seen.append(norm)
                return
            bound = self.RESIDUAL_GROWTH_BOUND * max(max(seen), 1e-12)
        if norm > bound:
            self._numerics_report(
                f"resid-growth:{key}",
                f"error-feedback residual norm for {key} reached "
                f"{norm:.3e}, over {self.RESIDUAL_GROWTH_BOUND:.0f}x the "
                "warmup rounds' ceiling — the EF recurrence is diverging "
                "instead of carrying bounded rounding error",
            )


def _host(arr):
    """``arr`` where numpy can read it: a torch tensor (CUDA or not) is
    detached and copied to the host, anything else passes through. Only
    the armed checker calls this, so an unarmed run copies nothing."""
    if hasattr(arr, "detach") and hasattr(arr, "cpu"):
        t = arr.detach().cpu()
        # numpy has no bfloat16: widen it (exact) so the finiteness
        # checks still see every value
        if str(t.dtype) == "torch.bfloat16":
            t = t.float()
        return t.numpy()
    return arr


class _TrackedLock:
    """threading.Lock wrapper reporting acquisition order to a checker.

    Bound to the checker active at CREATION time, so a checker torn down
    mid-flight (the ``checking()`` block exited while a transport thread
    still runs) keeps receiving events instead of the thread crashing."""

    def __init__(self, name: str, checker: RuntimeChecker):
        self._lock = threading.Lock()
        self.name = name
        self._checker = checker
        self._vc: dict = {}  # RT103: last releaser's vector clock

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._checker.on_acquire(self)
        got = self._lock.acquire(blocking, timeout)
        if not got:
            self._checker.on_release(self)
        else:
            self._checker.on_acquired(self)
        return got

    def release(self) -> None:
        self._checker.on_before_release(self)
        self._lock.release()
        self._checker.on_release(self)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


class _TrackedCondition:
    """threading.Condition wrapper with the same RT101/RT103 hooks as
    :class:`_TrackedLock` — ``with cond:`` IS a lock acquisition, and
    ``wait()`` is a release/reacquire pair for the clock algebra (the
    hand-off from ``notify``'s releaser to the woken waiter flows through
    the publish-on-release / join-on-acquire edges)."""

    def __init__(self, name: str, checker: RuntimeChecker):
        self._cond = threading.Condition()
        self.name = name
        self._checker = checker
        self._vc: dict = {}

    def acquire(self, *args) -> bool:
        self._checker.on_acquire(self)
        got = self._cond.acquire(*args)
        if not got:
            self._checker.on_release(self)
        else:
            self._checker.on_acquired(self)
        return got

    def release(self) -> None:
        self._checker.on_before_release(self)
        self._cond.release()
        self._checker.on_release(self)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        self._checker.on_before_release(self)
        self._checker.on_release(self)
        try:
            return self._cond.wait(timeout)
        finally:
            self._checker.on_acquire(self)
            self._checker.on_acquired(self)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # threading.Condition.wait_for's loop, routed through our wait()
        # so every park/wake keeps the clock algebra consistent
        import time as _time

        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = _time.monotonic() + timeout
                waittime = endtime - _time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


_ACTIVE: Optional[RuntimeChecker] = None


def active_checker() -> Optional[RuntimeChecker]:
    return _ACTIVE


def make_lock(name: str):
    """The transport lock factory: a plain ``threading.Lock`` normally, a
    tracked lock while a checker is active. ``name`` is the diagnostic
    role label (instances may share it; identity drives the graph)."""
    checker = _ACTIVE
    if checker is None:
        return threading.Lock()
    return _TrackedLock(name, checker)


def make_condition(name: str):
    """Sibling factory for condition variables (Broker mailboxes, send
    queues): plain ``threading.Condition`` when no checker is active."""
    checker = _ACTIVE
    if checker is None:
        return threading.Condition()
    return _TrackedCondition(name, checker)


def note(key: str, write: bool) -> None:
    """Annotate one access to a shared structure for RT103. Free when no
    race-mode checker is active — the instrumented hot paths pay one
    global read and one attribute check."""
    checker = _ACTIVE
    if checker is not None and checker.race:
        checker.on_var_access(key, write)


def note_numeric_array(site: str, arr) -> None:
    """Annotate one host-boundary array for RT104 (server apply path,
    collective-accumulation exits). Free when no numerics-mode checker
    is active."""
    checker = _ACTIVE
    if checker is not None and checker.numerics:
        checker.on_numeric_array(site, arr)


def note_residual_norm(key: str, norm: float) -> None:
    """Annotate one error-feedback residual norm for RT104 — callers
    hand in the SAME value the dynamics plane journals as ``elastic``,
    so the sanitizer and the journal can never disagree about what the
    residual was."""
    checker = _ACTIVE
    if checker is not None and checker.numerics:
        checker.on_residual_norm(key, float(norm))


def enable(
    checker: Optional[RuntimeChecker] = None,
    race: bool = False,
    numerics: bool = False,
) -> RuntimeChecker:
    global _ACTIVE
    _ACTIVE = checker or RuntimeChecker(race=race, numerics=numerics)
    return _ACTIVE


def disable() -> None:
    global _ACTIVE
    _ACTIVE = None


@contextlib.contextmanager
def checking(
    race: bool = False, numerics: bool = False
) -> Iterator[RuntimeChecker]:
    """Enable a fresh checker for the block; disables on exit (the checker
    object and its findings stay readable afterwards)."""
    checker = enable(race=race, numerics=numerics)
    try:
        yield checker
    finally:
        disable()


def _env_on(name: str) -> bool:
    return os.environ.get(name, "0") not in ("", "0")


def _arm_from_env() -> None:
    """``MPIT_RT_RACE=1`` / ``MPIT_RT_NUMERICS=1`` arm one shared
    process-wide checker (each launch.py rank imports this module early,
    so transport locks are created tracked and the quant kernels see the
    checker) and report findings at exit — the chaos-soak wiring. Each
    armed plane prints its own banner and its own finding count, so the
    soak can gate the two independently."""
    race, numerics = _env_on("MPIT_RT_RACE"), _env_on("MPIT_RT_NUMERICS")
    if not race and not numerics:
        return
    checker = enable(race=race, numerics=numerics)
    if race:
        print(
            "[rt-race] vector-clock race sanitizer armed "
            f"(pid {os.getpid()})",
            file=sys.stderr,
        )
    if numerics:
        print(
            f"[rt-numerics] numerics sanitizer armed (pid {os.getpid()})",
            file=sys.stderr,
        )
    import atexit

    @atexit.register
    def _report() -> None:
        for finding in checker.findings:
            print(finding.format(), file=sys.stderr)
        if race:
            n = sum(1 for f in checker.findings if f.rule != "RT104")
            print(f"[rt-race] {n} finding(s)", file=sys.stderr)
        if numerics:
            n = sum(1 for f in checker.findings if f.rule == "RT104")
            print(f"[rt-numerics] {n} finding(s)", file=sys.stderr)


_arm_from_env()
