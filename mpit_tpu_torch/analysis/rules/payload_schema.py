"""MPT016-018: payload-schema rules over the wire-schema model
(:mod:`mpit_tpu_torch.analysis.schema`, ``project.schema``).

MPT016 compares what each tag's senders construct against what its
receivers destructure. A receiver with an *opaque* consumption path
(``np.asarray(msg.payload)`` fallthrough, the message escaping into
unmodeled code) accepts everything — only a fully-constrained receiver
can falsify a sender shape, so "no finding" stays the conservative
default. The receiver-side half flags a constant-index read beyond every
sender's arity: a field the reader expects that no writer ever packs.

MPT017 classifies EVERY transport send payload (role-marked or not):
any construction containing a dict/set/comprehension/custom-object kind
falls off ``encode_frame`` onto the per-message pickle fallback — a 2x
serialize regression on a hot-path envelope, and a silent one.

MPT018 diffs the snapshot schema: string keys written through
``save_shard_state`` vs keys the ``load_shard_state`` consumer reads.
A read with no writer is the restore-time KeyError/default-drift bug
class; a write nothing reads is dead freight that masks it.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, List, Optional

from mpit_tpu_torch.analysis import schema as schema_mod
from mpit_tpu_torch.analysis.findings import Finding

RULES = {
    "MPT016": (
        "sender/receiver payload-shape divergence",
        "a tag's sender constructs a payload shape its (fully "
        "constrained) receiver never destructures — the message is "
        "dropped or mis-unpacked at dispatch",
    ),
    "MPT017": (
        "payload rides the pickle fallback",
        "a send constructs a dict/set/custom object that falls off the "
        "structural wire codec onto per-message pickle — 2x serialize "
        "cost and no schema, silently",
    ),
    "MPT018": (
        "snapshot schema drift",
        "fields written by save_shard_state and fields restore reads "
        "have diverged — restore sees defaults (or nothing) where the "
        "snapshot meant data",
    ),
}


def _emit(by_rel, rule, site, message) -> Optional[Finding]:
    mod = by_rel.get(site.rel)
    if mod is None:
        return None
    anchor = ast.Pass()
    anchor.lineno = site.line
    anchor.col_offset = site.col
    f = mod.finding(rule, anchor, message)
    return dataclasses.replace(f, symbol=site.symbol)


def _kinds_match(sender_kind, recv_kind) -> bool:
    if sender_kind == recv_kind:
        return True
    if sender_kind == "bool" and recv_kind == "int":
        return True  # bools are ints everywhere the protocol cares
    if schema_mod.is_tuple_kind(sender_kind) and recv_kind == "tuple":
        return True
    return False


def _field_overlap(sender_kinds, recv_kinds) -> bool:
    return any(
        _kinds_match(s, r) for s in sender_kinds for r in recv_kinds
    )


def _shape_compatible(shape, rec) -> bool:
    if shape == "unknown":
        return True
    if shape == "none":
        return bool(rec.none_sites)
    if schema_mod.is_tuple_kind(shape):
        k = len(shape[1])
        if rec.tuple_any:
            return True
        if not rec.arities:
            # the receiver only subscripts the payload (no len/unpack
            # check): any tuple covering every read index is fine
            if rec.field_reads:
                return all(i < k for i in rec.field_reads)
            return False  # receiver accepts only scalars/None
        if k not in rec.arities:
            return False
        fields = rec.arities[k]
        for i, sender_kinds in enumerate(shape[1]):
            recv_kinds = fields.get(i)
            if not recv_kinds:
                continue  # receiver doesn't constrain this field
            if not sender_kinds or "unknown" in sender_kinds:
                continue  # sender side unresolved: no claim
            if not _field_overlap(sender_kinds, recv_kinds):
                return False
        return True
    # scalar/array kinds need an isinstance acceptance on the receiver
    return _field_overlap({shape}, set(rec.kinds))


def _mpt016(model, by_rel) -> Iterable[Finding]:
    for tag in sorted(model.senders):
        rec = model.receivers.get(tag)
        if rec is None or rec.opaque or not rec.constrained:
            continue
        accepted = schema_mod.receiver_repr(rec)
        for s in model.senders[tag]:
            if _shape_compatible(s.shape, rec):
                continue
            f = _emit(
                by_rel,
                "MPT016",
                s.site,
                f"{model.tag_name(tag)} sender payload "
                f"{schema_mod.kind_repr(s.shape)} matches none of the "
                f"receiver's accepted shapes {accepted} — the receiver "
                "mis-unpacks or drops this message",
            )
            if f is not None:
                yield f
    for tag in sorted(model.receivers):
        senders = model.senders.get(tag)
        if not senders:
            continue
        shapes = [s.shape for s in senders]
        if not all(schema_mod.is_tuple_kind(sh) for sh in shapes):
            continue  # a non-tuple/unknown sender could carry anything
        max_arity = max(len(sh[1]) for sh in shapes)
        rec = model.receivers[tag]
        for i in sorted(rec.field_reads):
            if i < max_arity:
                continue
            f = _emit(
                by_rel,
                "MPT016",
                rec.field_reads[i],
                f"{model.tag_name(tag)} receiver reads payload field "
                f"[{i}] but every sender packs at most {max_arity} "
                "fields — this index can never exist",
            )
            if f is not None:
                yield f


def _offending_kinds(kinds) -> List[str]:
    out: List[str] = []
    for k in kinds:
        if isinstance(k, str) and k.startswith("unencodable:"):
            out.append(k.split(":", 1)[1])
        elif schema_mod.is_tuple_kind(k):
            for fs in k[1]:
                out.extend(_offending_kinds(fs))
    return out


def _mpt017(model, by_rel) -> Iterable[Finding]:
    for ps in model.payload_sites:
        offenders = sorted(set(_offending_kinds(ps.kinds)))
        if not offenders:
            continue
        f = _emit(
            by_rel,
            "MPT017",
            ps.site,
            "send payload contains "
            + ", ".join(offenders)
            + " — unencodable by the structural wire codec, so the "
            "whole message rides the per-message pickle fallback",
        )
        if f is not None:
            yield f


def _mpt018(model, by_rel) -> Iterable[Finding]:
    writes, reads = model.snapshot_writes, model.snapshot_reads
    if not writes or not reads:
        return  # only diff when both halves are statically visible
    for key in sorted(set(reads) - set(writes)):
        f = _emit(
            by_rel,
            "MPT018",
            reads[key],
            f"restore reads snapshot field {key!r} that no "
            "save_shard_state writer ever packs — it always lands on "
            "the default (or KeyErrors)",
        )
        if f is not None:
            yield f
    for key in sorted(set(writes) - set(reads)):
        f = _emit(
            by_rel,
            "MPT018",
            writes[key],
            f"snapshot writes field {key!r} that restore never reads — "
            "dead freight that hides real schema drift",
        )
        if f is not None:
            yield f


def run(project) -> Iterable[Finding]:
    model = project.schema
    by_rel = {m.rel: m for m in project.modules}
    out: List[Finding] = []
    out.extend(_mpt016(model, by_rel))
    out.extend(_mpt017(model, by_rel))
    out.extend(_mpt018(model, by_rel))
    return out
