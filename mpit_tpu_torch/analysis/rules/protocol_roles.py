"""MPT008 — protocol role divergence across the pserver/pclient boundary.

The cross-rank half of the RT102 story, caught before anything runs. Using
the role models from :mod:`mpit_tpu_torch.analysis.protocol` (markered modules,
tags resolved through the module graph), three statically-decidable
divergence shapes are flagged:

- **unpaired send**: a role sends a concrete tag its counterpart can
  neither recv concretely nor route through a wildcard-recv dispatch
  branch. The message parks in the peer's mailbox forever — at best a
  leak, at worst (the pserver's ``else: raise``) a crash, and either way
  the roles' protocols have drifted apart;
- **unpaired recv**: a role blocks in ``recv`` on a concrete tag the
  counterpart never sends — a guaranteed hang at the first call;
- **cross-wait**: function f in role A recvs tag T1 *before* sending T2,
  while function g in role B recvs T2 before sending T1. Each side's recv
  is satisfied only by the other's later send: the classic head-of-line
  protocol deadlock, decidable from the two orderings alone.

Conservatism: tags that don't resolve to integers are skipped; a
counterpart with a wildcard recv but NO visible dispatch comparisons is
assumed to handle everything (we can't see its routing); roles whose
counterpart is outside the scan set are not checked. A dispatch branch for
a tag nobody sends is dead code, not a divergence, and is deliberately NOT
flagged (the wildcard recv never blocks on it).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable

from mpit_tpu_torch.analysis import protocol

RULES = {
    "MPT008": (
        "protocol-role-divergence",
        "send/recv tag sets or orders of paired protocol roles have "
        "drifted apart — unpaired tags park or hang, crossed orders "
        "deadlock",
    ),
}


def _anchor(op: protocol.ProtoOp) -> ast.AST:
    node = ast.Constant(op.tag)
    node.lineno, node.col_offset = op.line, op.col
    return node


def _emit(by_rel, op: protocol.ProtoOp, message: str):
    mod = by_rel.get(op.rel)
    if mod is not None:
        f = mod.finding("MPT008", _anchor(op), message)
        # the synthetic anchor has no parents entry; the ProtoOp already
        # carries the real enclosing symbol
        yield dataclasses.replace(f, symbol=op.symbol)


def _unpaired_sends(role, cp, by_rel) -> Iterable:
    blind_dispatcher = cp.has_wildcard_recv and not cp.dispatch_tags
    if blind_dispatcher:
        return
    seen = set()
    for op in role.sends:
        if op.tag in cp.handled_tags or op.tag in seen:
            continue
        if op.tag in role.handled_tags:
            # intra-role traffic: the SENDING role's own dispatch handles
            # this tag (peer-to-peer exchange between instances of one
            # role, e.g. server->server shard handoff) — the counterpart
            # never needs a branch for it
            continue
        seen.add(op.tag)  # one finding per divergent tag, not per site
        yield from _emit(
            by_rel,
            op,
            f"role {role.role!r} sends {op.tag_text} (tag {op.tag}) but "
            f"counterpart role {cp.role!r} has no recv or dispatch branch "
            "for it — the message parks in the peer's mailbox (or trips "
            "its unknown-tag path) forever",
        )


def _unpaired_recvs(role, cp, by_rel) -> Iterable:
    seen = set()
    for op in role.concrete_recvs:
        if op.tag in cp.sent_tags or op.tag in seen:
            continue
        seen.add(op.tag)
        yield from _emit(
            by_rel,
            op,
            f"role {role.role!r} blocks in recv on {op.tag_text} "
            f"(tag {op.tag}) but counterpart role {cp.role!r} never sends "
            "it — this recv can never complete",
        )


def _cross_waits(role, cp, by_rel) -> Iterable:
    """recv(T1)-before-send(T2) in one role vs recv(T2)-before-send(T1)
    in the counterpart: neither side can make progress."""
    for f_ops in role.sequences().values():
        for i, r1 in enumerate(f_ops):
            if r1.kind != "recv" or r1.is_wildcard:
                continue
            later_sends = {
                op.tag for op in f_ops[i + 1 :] if op.kind == "send"
            }
            if not later_sends:
                continue
            for g_ops in cp.sequences().values():
                for k, r2 in enumerate(g_ops):
                    if (
                        r2.kind != "recv"
                        or r2.is_wildcard
                        or r2.tag not in later_sends
                    ):
                        continue
                    if any(
                        op.kind == "send" and op.tag == r1.tag
                        for op in g_ops[k + 1 :]
                    ):
                        yield from _emit(
                            by_rel,
                            r1,
                            f"cross-wait deadlock: {role.role!r}."
                            f"{r1.symbol} recvs tag {r1.tag} before "
                            f"sending tag {r2.tag}, while {cp.role!r}."
                            f"{r2.symbol} recvs tag {r2.tag} before "
                            f"sending tag {r1.tag} — neither side can "
                            "reach the send the other is blocked on",
                        )
                        break
                else:
                    continue
                break


def run(project) -> Iterable:
    roles = project.roles
    by_rel = {m.rel: m for m in project.modules}
    for role in roles.values():
        cp = roles.get(role.counterpart)
        if cp is None:
            continue  # counterpart outside the scan set: nothing checkable
        yield from _unpaired_sends(role, cp, by_rel)
        yield from _unpaired_recvs(role, cp, by_rel)
        if role.role < cp.role:  # one report per role pair
            yield from _cross_waits(role, cp, by_rel)
            yield from _cross_waits(cp, role, by_rel)
