"""Trace conformance: replay obs journals against the extracted protocol.

The static half of this package proves properties of the protocol
*model* (:mod:`mpit_tpu_torch.analysis.mcheck`); this module closes the loop
on real executions: ``python -m mpit_tpu_torch.analysis conform <obs-dir>``
reads the per-rank ``obs_rank*.jsonl`` journals that
:class:`mpit_tpu_torch.obs.telemetry.TelemetryTransport` writes (plus the
chaos ``faults*.jsonl`` log when present) and checks the observed run
against the same role model and fault semantics the linter and model
checker extracted from the source — turning every chaos soak and
``tests/test_obs.py`` run into a protocol audit.

Checked properties:

- **TC201 causality** — every traced recv names, via ``from_span``, a
  send that actually happened; the recv landed on that send's
  destination rank, from its source rank, with its tag; and the
  receiver's Lamport clock is strictly ahead of the sender's at the
  send (``clock.observe`` guarantees this — a violation means the
  journals are from different runs, hand-edited, or the envelope was
  mis-threaded);
- **TC202 stream conservation** — per ``(src, dst, tag)`` stream,
  ``sends_ok - lost - orphans <= recvs <= sends_ok + duplicated`` where
  ``sends_ok`` counts err-free journaled sends and the fault log
  supplies the loss/duplication allowances (no fault log = no
  allowance). ``orphans`` licenses one undrained reply per duplication
  fault on the *reverse request stream*: a duplicated FETCH makes the
  server send an extra PARAM, and when the duplicate lands after the
  requester's last round that reply is legitimately never received.
  More receives than explicable = phantom messages; fewer = messages
  lost with no fault to blame;
- **TC203 role conformance** — each rank's sent-tag alphabet fits
  inside ONE extracted role (a rank sending both FETCH and PARAM is
  playing client and server at once, which the role model forbids), and
  every tag on the wire belongs to the extracted protocol alphabet;
- **TC204 version monotonicity** — per server rank, the center
  ``version`` stamped into PARAM replies (journaled as
  ``param_version`` records by the dynamics plane) never decreases in
  journal order. Journals are per-rank monotone by construction, so a
  decrease means the version counter itself regressed — the staleness
  accounting built on it would be garbage. Vacuous for pre-dynamics
  journals (no ``param_version`` records).

Caveat: journals record what the *sampler* kept. Conformance needs the
complete event stream, so runs checked here must use ``sample=1`` (the
default for ``MPIT_OBS_DIR``-driven test runs); a sampled journal fails
TC202 honestly rather than silently passing.

Elastic runs (docs/ROBUSTNESS.md): the launcher's supervisor journals
membership transitions to ``membership.jsonl`` in the same directory.
When that file shows churn (``kill``/``respawn`` events), the checks
relax EXACTLY where preemption makes journals honest-but-incomplete —
a SIGKILLed process cannot flush its journal tail, so its in-flight
sends may be received with no surviving send record (TC201) and its
stream counts may not balance (TC202); both relaxations are scoped to
the churned ranks, every other rank stays fully checked. TC204 becomes
per-generation: a restored server resumes from its last snapshot, so
the version counter may legitimately step back across a ``gen`` bump
(the PARAM journal records carry ``gen``); within a generation it must
still never decrease.

Truncated journals: a journal may also declare ITSELF incomplete via
its ``journal_cap`` footer — cap mode drops the tail once
``MPIT_OBS_MAX_RECORDS`` is hit, ring mode (``MPIT_OBS_RING``) evicts
the head to keep the newest window. Ranks whose footer shows non-zero
drops/evictions get the same scoped licensing as churned ranks (a recv
may name an evicted send, streams touching them may not balance);
see :func:`truncated_ranks`. A footer with zero drops declares the
journal complete and licenses nothing.

Like the rest of the analysis package this module imports neither torch
nor the transport stack — journals are just files.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

from mpit_tpu_torch.analysis import protocol
from mpit_tpu_torch.obs import merge

#: fault kinds whose message is delivered anyway (possibly late/mangled)
_DELIVERED_KINDS = {"delay", "corrupt", "truncate"}
#: fault kinds that add a delivery
_DUP_KINDS = {"duplicate"}


@dataclasses.dataclass(frozen=True)
class Violation:
    rule: str  # TC201 | TC202 | TC203 | TC204
    detail: str

    def __str__(self) -> str:
        return f"{self.rule}: {self.detail}"


@dataclasses.dataclass
class ConformanceReport:
    journals: list
    events: int
    sends: int
    recvs: int
    faults: int
    violations: list
    churned: list = dataclasses.field(default_factory=list)
    truncated: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def load_membership(obs_dir: str) -> list:
    """Membership transition records from the launcher's supervisor
    journal (``membership.jsonl``); empty for non-elastic runs."""
    path = os.path.join(obs_dir, "membership.jsonl")
    if not os.path.exists(path):
        return []
    return [
        r for r in merge.read_journal(path)
        if r.get("ev") == "membership"
    ]


def churned_ranks(membership: list) -> frozenset:
    """Ranks that lost a process mid-run (killed or respawned) — the
    ranks whose journals are licensed to be incomplete."""
    return frozenset(
        r["rank"] for r in membership
        if r.get("kind") in ("kill", "respawn")
        and isinstance(r.get("rank"), int)
    )


def _load(obs_dir: str, faults_path: Optional[str]):
    paths = merge.expand_journal_paths([obs_dir])
    records = []
    for p in paths:
        records.extend(
            r for r in merge.read_journal(p) if r.get("ev") in
            ("send", "isend", "recv", "param_version", "journal_cap")
        )
    faults = merge.read_fault_log(faults_path or obs_dir)
    return paths, records, faults


def truncated_ranks(records: list) -> frozenset:
    """Ranks whose own journal declares itself incomplete via a
    ``journal_cap`` footer (written incrementally, so it survives even
    a SIGKILL): cap mode dropped the stream's TAIL
    (``dropped_records > 0``), ring mode evicted its HEAD
    (``evicted_records > 0``). Either way the rank's record set is an
    honest subset — license it exactly like a churned rank. A footer
    with zero drops/evictions declares the journal COMPLETE and earns
    no license. Unlike membership licensing this is never disabled by
    ``--strict``/``elastic=False``: the evidence is in the journal
    itself, not in a side file."""
    out = set()
    for r in records:
        if r.get("ev") != "journal_cap":
            continue
        if r.get("dropped_records", 0) or r.get("evicted_records", 0):
            rank = merge._rec_rank(r)
            if isinstance(rank, int):
                out.add(rank)
    return frozenset(out)


def _tc201_causality(
    records: list, churned: frozenset = frozenset()
) -> Iterable[Violation]:
    by_span = {}
    for r in records:
        if r["ev"] in ("send", "isend") and "span" in r:
            by_span[r["span"]] = r
    for r in records:
        if r["ev"] != "recv" or "from_span" not in r:
            continue
        src = merge._rec_rank(r)  # receiver rank
        s = by_span.get(r["from_span"])
        if s is None:
            if r.get("src") in churned:
                # the claimed sender lost a process mid-run: its journal
                # tail (including this send's record) died unflushed
                # with it — an honest gap, not an outside message
                continue
            yield Violation(
                "TC201",
                f"rank {src} recv (tag {r.get('mtag')}, clk "
                f"{r.get('step')}) names span {r['from_span']:#x} but no "
                "journaled send carries that span — a message from "
                "outside the run",
            )
            continue
        if s.get("dst") != src:
            yield Violation(
                "TC201",
                f"send span {s['span']:#x} was addressed to rank "
                f"{s.get('dst')} but was received on rank {src}",
            )
        if r.get("src", -1) >= 0 and merge._rec_rank(s) != r["src"]:
            yield Violation(
                "TC201",
                f"rank {src} recv attributes span {s['span']:#x} to "
                f"rank {r['src']} but rank {merge._rec_rank(s)} sent it",
            )
        if s.get("mtag") != r.get("mtag"):
            yield Violation(
                "TC201",
                f"span {s['span']:#x} sent with tag {s.get('mtag')} but "
                f"received with tag {r.get('mtag')}",
            )
        if (
            isinstance(r.get("step"), int)
            and isinstance(s.get("step"), int)
            and r["step"] <= s["step"]
        ):
            yield Violation(
                "TC201",
                f"Lamport order inverted for span {s['span']:#x}: send "
                f"clk {s['step']} >= recv clk {r['step']} (the receiver "
                "never observed the sender's clock)",
            )


def _tc202_conservation(
    records, faults, sem=None, churned: frozenset = frozenset()
) -> Iterable[Violation]:
    sends_ok: dict = {}
    recvs: dict = {}
    for r in records:
        if r["ev"] in ("send", "isend"):
            if "err" in r:
                continue  # the transport raised: the message never left
            key = (merge._rec_rank(r), r.get("dst"), r.get("mtag"))
            sends_ok[key] = sends_ok.get(key, 0) + 1
        elif r["ev"] == "recv" and r.get("src", -1) >= 0:
            key = (r["src"], merge._rec_rank(r), r.get("mtag"))
            recvs[key] = recvs.get(key, 0) + 1
    dup: dict = {}
    lost: dict = {}
    for f in faults:
        key = (f.get("src"), f.get("dst"), f.get("tag"))
        kind = f.get("kind")
        if kind in _DUP_KINDS:
            dup[key] = dup.get(key, 0) + 1
        elif kind not in _DELIVERED_KINDS:
            # drop / blackhole / reset / kill: the copy never arrives
            lost[key] = lost.get(key, 0) + 1
    # A duplicated *request* makes the responder send one extra reply;
    # when the duplicate lands after the requester's last round, that
    # reply sits undrained in the socket at process exit. License the
    # deficit on the reply stream by the duplication faults journaled
    # on the reverse request stream (an upper bound: drained extras
    # show up as stale-attempt recvs and need no allowance).
    orphan: dict = {}
    if sem is not None and sem.reply_tag is not None:
        for (fsrc, fdst, ftag), n in dup.items():
            if ftag == sem.request_tag:
                rkey = (fdst, fsrc, sem.reply_tag)
                orphan[rkey] = orphan.get(rkey, 0) + n
    for key in sorted(set(sends_ok) | set(recvs), key=str):
        src, dst, tag = key
        if src in churned or dst in churned:
            # a killed endpoint loses buffered journal records AND
            # in-flight messages with no fault-log entry to blame —
            # this stream's counts cannot be expected to balance
            continue
        ns, nr = sends_ok.get(key, 0), recvs.get(key, 0)
        hi = ns + dup.get(key, 0)
        lo = max(0, ns - lost.get(key, 0) - orphan.get(key, 0))
        name = merge._tag_name(tag)
        if nr > hi:
            yield Violation(
                "TC202",
                f"stream {src}->{dst} {name}: {nr} recv(s) but only "
                f"{ns} err-free send(s) + {dup.get(key, 0)} duplication "
                "fault(s) — phantom deliveries",
            )
        elif nr < lo:
            extra = (
                f" + {orphan[key]} dup-request orphan(s)"
                if orphan.get(key) else ""
            )
            yield Violation(
                "TC202",
                f"stream {src}->{dst} {name}: {nr} recv(s) for {ns} "
                f"err-free send(s) with only {lost.get(key, 0)} "
                f"loss fault(s){extra} to blame — messages vanished",
            )


def _tc203_roles(records, roles) -> Iterable[Violation]:
    if not roles:
        return
    alphabet = set()
    for rm in roles.values():
        alphabet |= rm.sent_tags
    sent_by_rank: dict = {}
    for r in records:
        if r["ev"] in ("send", "isend") and r.get("mtag") is not None:
            sent_by_rank.setdefault(merge._rec_rank(r), set()).add(
                r["mtag"]
            )
    for rank in sorted(sent_by_rank):
        tags = sent_by_rank[rank]
        unknown = tags - alphabet
        if unknown:
            yield Violation(
                "TC203",
                f"rank {rank} sent tag(s) "
                f"{sorted(unknown)} that no extracted role ever sends — "
                "outside the protocol alphabet",
            )
            tags = tags - unknown
        if tags and not any(
            tags <= rm.sent_tags for rm in roles.values()
        ):
            parts = {
                name: sorted(tags & rm.sent_tags)
                for name, rm in sorted(roles.items())
                if tags & rm.sent_tags
            }
            yield Violation(
                "TC203",
                f"rank {rank} sent {sorted(tags)} — an alphabet no "
                f"single role owns (split across {parts}); one rank is "
                "playing several protocol roles at once",
            )


def _tc204_version_monotonic(records) -> Iterable[Violation]:
    # journal-file order IS per-rank real-time order (the journal lock
    # stamps t monotonically; a respawned process appends to the same
    # file), so a simple last-seen scan suffices. Ordering is (gen,
    # version) lexicographic: a restored server's counter may step back
    # across a gen bump (it resumed from its last snapshot — licensed),
    # never within one generation and never to an earlier generation.
    last: dict = {}
    for r in records:
        if r["ev"] != "param_version":
            continue
        v = r.get("version")
        if not isinstance(v, int):
            continue
        g = r.get("gen", 0)
        if not isinstance(g, int):
            g = 0
        rank = merge._rec_rank(r)
        prev = last.get(rank)
        if prev is not None and (g, v) < prev:
            pg, pv = prev
            yield Violation(
                "TC204",
                f"server rank {rank} PARAM reply carries version {v} "
                f"(gen {g}) after already replying with {pv} (gen {pg}) "
                "— the center version counter went backwards",
            )
        last[rank] = max((g, v), prev) if prev is not None else (g, v)


def check_conformance(
    obs_dir: str,
    project,
    faults_path: Optional[str] = None,
    elastic: Optional[bool] = None,
) -> ConformanceReport:
    """Audit one run directory against the protocol extracted from
    ``project`` (a :class:`mpit_tpu_torch.analysis.lint.Project` over the
    package that implements the roles).

    ``elastic``: ``None`` (default) auto-detects from the supervisor's
    ``membership.jsonl``; ``False`` forces strict mode even when the
    file shows churn; ``True`` only matters as documentation — with no
    membership records there is nothing to license, so it is strict
    anyway (licensing is always scoped to *specific* churned ranks,
    never a blanket waiver)."""
    paths, records, faults = _load(obs_dir, faults_path)
    membership = load_membership(obs_dir) if elastic is not False else []
    churned = churned_ranks(membership)
    truncated = truncated_ranks(records)
    licensed = churned | truncated
    roles = project.roles
    sem = protocol.extract_semantics(project)
    violations = list(_tc201_causality(records, licensed))
    violations.extend(_tc202_conservation(records, faults, sem, licensed))
    violations.extend(_tc203_roles(records, roles))
    violations.extend(_tc204_version_monotonic(records))
    return ConformanceReport(
        journals=paths,
        events=len(records),
        sends=sum(1 for r in records if r["ev"] in ("send", "isend")),
        recvs=sum(1 for r in records if r["ev"] == "recv"),
        faults=len(faults),
        violations=violations,
        churned=sorted(churned),
        truncated=sorted(truncated),
    )
