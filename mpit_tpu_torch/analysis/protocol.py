"""Protocol-role model: per-role send/recv tag sequences, statically.

The host-async PS protocol is a conversation between two roles — the
pserver's wildcard-recv dispatch loop and the pclient's send/recv call
pattern — and its hardest failure class is cross-rank: a tag one role sends
that the counterpart never receives (the message parks forever and teardown
hangs), or both roles blocking in recv for a tag only the *other* side's
later send would satisfy. Rank-local lint rules cannot see either; this
module extracts the static halves from the AST so MPT008 can.

A module opts into a role with a marker comment anywhere at the top level::

    # mpit-analysis: protocol-role[client->server]

meaning "this module implements role ``client``, whose counterpart role is
``server``". Several modules may share one role (``pclient.py`` and
``ps_roles.py`` are both ``client``); their operations merge. The markers
live with the code — ``parallel/pserver.py``, ``parallel/pclient.py`` and
``parallel/ps_roles.py`` carry them — so the model needs no path
configuration and fixture packages participate the same way.

Extracted per role, with tags resolved to integers through the module graph
(``TAG_PARAM`` imported from ``pserver`` resolves to 4; unresolvable tag
expressions are skipped — conservative, no finding):

- **sends**: ``send``/``isend`` call sites (3+ args: the transport shape),
  including module-local indirection to a fixpoint — a function that
  forwards a tag parameter toward a transport send, directly
  (``PClient._send_with_retry``) or through another wrapper
  (``PClient._scatter`` riding the retry helper), counts its call sites
  (``self._scatter(TAG_PUSH_EASGD, ...)``) as sends of the resolved tag;
- **recvs**: ``recv``/``irecv``/``probe`` sites; a missing/``-1``/
  ``ANY_TAG`` tag is a *wildcard* recv (the dispatcher pattern);
- **dispatch tags**: ``== TAG_X`` / ``!= TAG_X`` / ``in (TAG_X, ...)``
  comparisons against ``TAG_``-named constants in a module that also has a
  wildcard recv — the tags its dispatch loop actually handles.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Iterable, Optional

from mpit_tpu_torch.analysis import astutil

ROLE_MARKER_RE = re.compile(
    r"#\s*mpit-analysis:\s*protocol-role\[\s*([A-Za-z0-9_]+)\s*->"
    r"\s*([A-Za-z0-9_]+)\s*\]"
)

_TAG_NAME_RE = re.compile(r"^TAG_[A-Z0-9_]+$")
_SEND_NAMES = {"send", "isend"}
_RECV_NAMES = {"recv", "irecv", "probe"}
_WILDCARD_NAMES = {"ANY_TAG"}


@dataclasses.dataclass(frozen=True)
class ProtoOp:
    """One protocol operation at one source location."""

    kind: str  # "send" | "recv" | "dispatch"
    tag: Optional[int]  # None = wildcard (recv only)
    tag_text: str  # the tag expression as written (for messages)
    rel: str
    line: int
    col: int
    symbol: str  # enclosing function qualname

    @property
    def is_wildcard(self) -> bool:
        return self.tag is None


@dataclasses.dataclass
class RoleModel:
    """The merged protocol surface of every module claiming one role."""

    role: str
    counterpart: str
    rels: list  # contributing module rel paths
    ops: list  # all ProtoOps

    @property
    def sends(self) -> list:
        return [op for op in self.ops if op.kind == "send"]

    @property
    def concrete_recvs(self) -> list:
        return [
            op
            for op in self.ops
            if op.kind == "recv" and not op.is_wildcard
        ]

    @property
    def has_wildcard_recv(self) -> bool:
        return any(
            op.kind == "recv" and op.is_wildcard for op in self.ops
        )

    @property
    def dispatch_tags(self) -> set:
        return {op.tag for op in self.ops if op.kind == "dispatch"}

    @property
    def sent_tags(self) -> set:
        return {op.tag for op in self.sends}

    @property
    def handled_tags(self) -> set:
        """Tags this role can consume: concrete recvs + dispatch branches."""
        return self.dispatch_tags | {
            op.tag for op in self.concrete_recvs
        }

    def sequences(self) -> dict:
        """Per enclosing function: its send/recv ops in source order (the
        input to the cross-wait check; dispatch ops are capabilities, not
        blocking points, and stay out)."""
        seqs: dict = {}
        for op in self.ops:
            if op.kind == "dispatch":
                continue
            seqs.setdefault((op.rel, op.symbol), []).append(op)
        for seq in seqs.values():
            seq.sort(key=lambda op: (op.line, op.col))
        return seqs


def module_role(source_lines) -> Optional[tuple]:
    """(role, counterpart) from the marker comment, or None. Only real
    COMMENT tokens count — a marker quoted in a docstring is not an
    opt-in (this module's own docstring shows one)."""
    for _, text in astutil.iter_comments(source_lines):
        m = ROLE_MARKER_RE.search(text)
        if m:
            return m.group(1), m.group(2)
    return None


def _tag_value(graph, info, node) -> tuple:
    """(resolved | None, is_wildcard). Unresolvable -> (None, False)."""
    if node is None:
        return None, True  # recv() default tag is ANY_TAG
    dotted = astutil.dotted_name(node)
    if dotted is not None and dotted.split(".")[-1] in _WILDCARD_NAMES:
        return None, True
    # the graph folds literal arithmetic AND resolves names through the
    # import graph, so ``TAG_BASE + 1`` and ``pserver.TAG_PARAM`` both
    # land on integers here
    val = graph.resolve_constant(info, node)
    if not isinstance(val, int) or isinstance(val, bool):
        return None, False
    if val == -1:
        return None, True
    return val, False


def _send_wrappers(tree: ast.Module) -> dict:
    """Module-local functions that forward a parameter into a transport
    send's tag slot: name -> index of that parameter in the call signature
    (``self`` excluded for methods — callers don't pass it).

    Computed to a fixpoint: a function forwarding its tag parameter into
    a *known wrapper* is itself a wrapper, so chains like
    ``PClient._scatter -> PClient._send_with_retry -> transport.send``
    still resolve their call sites' concrete tags."""
    out: dict = {}
    changed = True
    while changed:
        changed = False
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if node.name in out:
                continue
            params = [a.arg for a in node.args.posonlyargs + node.args.args]
            call_params = params[1:] if params[:1] == ["self"] else params
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                callee = astutil.call_last_name(sub)
                if callee in _SEND_NAMES:
                    if len(sub.args) + len(sub.keywords) < 3:
                        continue
                    tag_idx = 1
                elif callee in out and callee != node.name:
                    tag_idx = out[callee]
                else:
                    continue
                tag_arg = astutil.get_arg(sub, tag_idx, "tag")
                if (
                    isinstance(tag_arg, ast.Name)
                    and tag_arg.id in call_params
                ):
                    out[node.name] = call_params.index(tag_arg.id)
                    changed = True
                    break
    return out


def _op(mod, node, kind, tag, text) -> ProtoOp:
    return ProtoOp(
        kind=kind,
        tag=tag,
        tag_text=text,
        rel=mod.rel,
        line=getattr(node, "lineno", 0),
        col=getattr(node, "col_offset", 0),
        symbol=astutil.enclosing_symbol(node, mod.parents),
    )


def _dispatch_tag_nodes(node: ast.Compare) -> Iterable:
    """TAG_*-named operands of an ==/!=/in comparison."""
    if not all(
        isinstance(op, (ast.Eq, ast.NotEq, ast.In)) for op in node.ops
    ):
        return
    for operand in (node.left, *node.comparators):
        cands = (
            operand.elts
            if isinstance(operand, (ast.Tuple, ast.List, ast.Set))
            else [operand]
        )
        for cand in cands:
            dotted = astutil.dotted_name(cand)
            if dotted and _TAG_NAME_RE.match(dotted.split(".")[-1]):
                yield cand, dotted


def extract_module_ops(mod, graph) -> list:
    """Every protocol op in one role module (tags graph-resolved)."""
    info = graph.module_for_rel(mod.rel)
    wrappers = _send_wrappers(mod.tree)
    ops: list = []
    saw_wildcard_recv = False
    dispatch_candidates: list = []
    for node in mod.nodes:
        if isinstance(node, ast.Compare):
            for cand, dotted in _dispatch_tag_nodes(node):
                val = graph.resolve_constant(info, dotted)
                if val is not None:
                    dispatch_candidates.append(
                        _op(mod, node, "dispatch", val, dotted)
                    )
            continue
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_last_name(node)
        if name in _SEND_NAMES:
            if len(node.args) + len(node.keywords) < 3:
                continue
            tag_arg = astutil.get_arg(node, 1, "tag")
            val, wild = _tag_value(graph, info, tag_arg)
            if val is not None and not wild:
                ops.append(
                    _op(mod, node, "send", val, ast.unparse(tag_arg))
                )
        elif name in _RECV_NAMES:
            tag_arg = astutil.get_arg(node, 1, "tag")
            val, wild = _tag_value(graph, info, tag_arg)
            if wild:
                saw_wildcard_recv = True
                ops.append(_op(mod, node, "recv", None, "ANY_TAG"))
            elif val is not None:
                ops.append(
                    _op(mod, node, "recv", val, ast.unparse(tag_arg))
                )
        elif name in wrappers:
            tag_arg = astutil.get_arg(node, wrappers[name], "tag")
            if tag_arg is None:
                continue
            val, wild = _tag_value(graph, info, tag_arg)
            if val is not None and not wild:
                ops.append(
                    _op(mod, node, "send", val, ast.unparse(tag_arg))
                )
    if saw_wildcard_recv:
        # dispatch branches only mean "handled" when a wildcard recv
        # actually routes messages into them
        ops.extend(dispatch_candidates)
    return ops


def extract_roles(project) -> dict:
    """role name -> RoleModel, merged over every marked module in scope."""
    graph = project.graph
    roles: dict = {}
    for mod in project.modules:
        # module_role tokenizes the whole source for comments — gate it
        # behind a cheap substring scan (the marker is a literal)
        if not any("protocol-role[" in ln for ln in mod.source_lines):
            continue
        marked = module_role(mod.source_lines)
        if marked is None:
            continue
        role, counterpart = marked
        model = roles.get(role)
        if model is None:
            model = roles[role] = RoleModel(
                role=role, counterpart=counterpart, rels=[], ops=[]
            )
        model.rels.append(mod.rel)
        model.ops.extend(extract_module_ops(mod, graph))
    return roles


# ---------------------------------------------------------------------------
# protocol *semantics* — the fault-tolerance machinery behind the tag model
#
# The role model above answers "which tags cross the wire"; the model
# checker (analysis/mcheck.py) additionally needs "what the protocol DOES
# about faults": whether FETCH attempt ids are echoed in the PARAM reply
# and checked by the client, whether the reply wait has a timeout escape,
# and the exact shape of the server's push dedup window. All of it is
# extracted syntactically from the same marked modules — recognized
# idioms, never imports — and anything that doesn't match a modeled idiom
# degrades conservatively (``None`` / opaque, meaning "don't check what
# you can't see").


@dataclasses.dataclass(frozen=True)
class DedupSemantics:
    """The server-side sliding dedup window, as written.

    Recognized shape (``_DedupWindow.admit`` in ``parallel/pserver.py``):
    a method literally named ``admit`` whose last parameter is the
    sequence number, rejecting on a boundary comparison against
    ``high - size`` plus a membership test on the seen-set.
    ``rejects_at_boundary`` is the off-by-one bit: ``seq <= high - size``
    (True, correct — a seq AT the boundary is rejected) vs ``seq <
    high - size`` (False — the boundary seq is re-admitted after the
    seen-set pruned past it, the classic window off-by-one)."""

    rel: str
    line: int
    col: int
    symbol: str
    rejects_at_boundary: bool
    checks_seen: bool
    prunes_seen: bool
    window_default: Optional[int]
    #: the window key is a tuple of several identity parameters (the
    #: ``key = (src, epoch)`` idiom) — a replacement client's fresh
    #: epoch gets a fresh window instead of inheriting its
    #: predecessor's seen-set; False = keyed by source only (or not
    #: at all), where a replacement's re-used seqs would be swallowed
    keyed_by_epoch: bool = False


@dataclasses.dataclass(frozen=True)
class ProtocolSemantics:
    """Everything the model checker needs about one client/server pair."""

    client_role: str
    server_role: str
    request_tag: int  # dispatch branch that sends the reply (FETCH)
    reply_tag: int  # server-sent, client-recv'd concretely (PARAM)
    push_tags: tuple  # dispatch branches feeding the dedup admit
    stop_tag: Optional[int]
    attempt_echoed: bool  # reply tuple carries the request's payload back
    attempt_checked: bool  # client compares the echoed id to the live one
    reply_recv_timeout: bool  # the reply recv can time out (retry escape)
    dedup: Optional[DedupSemantics]
    dedup_opaque: bool  # an admit exists but matches no modeled idiom
    reply_send: Optional[ProtoOp]  # anchors for findings
    reply_recv: Optional[ProtoOp]
    #: does the server's shard snapshot persist the dedup window next
    #: to the center+version (the crash-consistency idiom of
    #: ``_snapshot_state``)? True/False when a snapshot dict was found
    #: and classified; None = no snapshot machinery in the scan set
    #: (the model checker then skips restart schedules entirely)
    snapshot_includes_dedup: Optional[bool] = None
    #: does the server's shard HANDOFF (the reshard envelope that moves
    #: a shard's ownership to another server) ship the dedup window
    #: along with the shard data? True/False when handoff machinery was
    #: found and classified; None = no handoff machinery in the scan
    #: set (the model checker then skips the sharded configuration)
    handoff_includes_dedup: Optional[bool] = None

    @property
    def has_fault_machinery(self) -> bool:
        """Does this protocol *claim* fault tolerance? Only then is there
        anything for the model checker to verify — a bare request/reply
        fixture without attempt ids or dedup has no failure semantics,
        and flagging it for lacking them would drown MPT008's signal."""
        return self.attempt_echoed or self.dedup is not None


def _enclosing_function(node, parents):
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = parents.get(cur)
    return None


def _is_transport_send(call: ast.Call) -> bool:
    return (
        astutil.call_last_name(call) in _SEND_NAMES
        and len(call.args) + len(call.keywords) >= 3
    )


def _classify_dispatch(server, by_rel, graph, reply_tag):
    """(request_tag, push_tags, stop_tag) from the server's dispatch Ifs:
    the branch that sends the reply is the request; branches feeding an
    ``admit``-named call are pushes; a branch recording the source in a
    set (``.add``) is the stop."""
    request_tag = None
    push_tags: set = set()
    stop_tag = None
    for rel in server.rels:
        mod = by_rel.get(rel)
        if mod is None:
            continue
        info = graph.module_for_rel(rel)
        for node in mod.nodes:
            if not isinstance(node, ast.If) or not isinstance(
                node.test, ast.Compare
            ):
                continue
            tags = []
            for _cand, dotted in _dispatch_tag_nodes(node.test):
                val = graph.resolve_constant(info, dotted)
                if val is not None:
                    tags.append(val)
            if not tags:
                continue
            body_calls = [
                sub
                for stmt in node.body
                for sub in ast.walk(stmt)
                if isinstance(sub, ast.Call)
            ]
            sends_reply = any(
                _is_transport_send(c)
                and _tag_value(
                    graph, info, astutil.get_arg(c, 1, "tag")
                )[0] == reply_tag
                for c in body_calls
            )
            calls_admit = any(
                "admit" in (astutil.call_last_name(c) or "")
                for c in body_calls
            )
            marks_stopped = any(
                astutil.call_last_name(c) == "add" for c in body_calls
            )
            for t in tags:
                if sends_reply:
                    if request_tag is None:
                        request_tag = t
                elif calls_admit:
                    push_tags.add(t)
                elif marks_stopped and stop_tag is None:
                    stop_tag = t
    return request_tag, push_tags, stop_tag


def _reply_is_echoed(server, by_rel, graph, reply_tag) -> bool:
    """Does the function sending the reply build a tuple containing the
    request's ``.payload`` (the attempt-id echo idiom)?"""
    for rel in server.rels:
        mod = by_rel.get(rel)
        if mod is None:
            continue
        info = graph.module_for_rel(rel)
        for node in mod.nodes:
            if not (
                isinstance(node, ast.Call) and _is_transport_send(node)
            ):
                continue
            val, _w = _tag_value(
                graph, info, astutil.get_arg(node, 1, "tag")
            )
            if val != reply_tag:
                continue
            scope = _enclosing_function(node, mod.parents) or mod.tree
            for sub in ast.walk(scope):
                if isinstance(sub, ast.Tuple) and any(
                    isinstance(e, ast.Attribute) and e.attr == "payload"
                    for e in sub.elts
                ):
                    return True
    return False


def _client_reply_handling(client, by_rel, graph, reply_tag):
    """(attempt_checked, reply_recv_timeout) from the client function(s)
    blocking on the reply tag: a ``timeout=`` argument on the recv is the
    deadlock escape; a Name-vs-Name ==/!= comparison in the same function
    is the attempt-id check (``got_id != attempt_id``)."""
    checked = False
    has_timeout = False
    for rel in client.rels:
        mod = by_rel.get(rel)
        if mod is None:
            continue
        info = graph.module_for_rel(rel)
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            if astutil.call_last_name(node) not in _RECV_NAMES:
                continue
            val, wild = _tag_value(
                graph, info, astutil.get_arg(node, 1, "tag")
            )
            if wild or val != reply_tag:
                continue
            to = astutil.get_arg(node, 2, "timeout")
            if to is not None and not (
                isinstance(to, ast.Constant) and to.value is None
            ):
                has_timeout = True
            scope = _enclosing_function(node, mod.parents) or mod.tree
            for sub in ast.walk(scope):
                if (
                    isinstance(sub, ast.Compare)
                    and len(sub.ops) == 1
                    and isinstance(sub.ops[0], (ast.Eq, ast.NotEq))
                    and isinstance(sub.left, ast.Name)
                    and isinstance(sub.comparators[0], ast.Name)
                ):
                    checked = True
    return checked, has_timeout


def _admit_window_default(fn, mod) -> Optional[int]:
    """The window-size default from the admit method's class ``__init__``
    (first non-self parameter), when statically visible."""
    cls = mod.parents.get(fn)
    while cls is not None and not isinstance(cls, ast.ClassDef):
        cls = mod.parents.get(cls)
    if cls is None:
        return None
    for node in cls.body:
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == "__init__"
            and node.args.defaults
        ):
            return astutil.int_constant(node.args.defaults[-1])
    return None


def _extract_dedup(server, by_rel):
    """(DedupSemantics | None, found_admit). ``found_admit`` True with a
    None semantics means "there IS dedup machinery but it matches no
    modeled idiom" — the checker then assumes it correct rather than
    absent (resolve-or-skip, the graph's contract)."""
    for rel in server.rels:
        mod = by_rel.get(rel)
        if mod is None:
            continue
        for node in mod.nodes:
            if (
                not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                or node.name != "admit"
            ):
                continue
            params = [
                a.arg for a in node.args.posonlyargs + node.args.args
            ]
            if not params:
                continue
            seq = params[-1]
            rejects_at_boundary = None
            checks_seen = False
            anchor = node
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Compare) or len(sub.ops) != 1:
                    continue
                op = sub.ops[0]
                left, right = sub.left, sub.comparators[0]
                if (
                    isinstance(op, ast.In)
                    and isinstance(left, ast.Name)
                    and left.id == seq
                ):
                    checks_seen = True
                elif (
                    isinstance(op, (ast.Lt, ast.LtE))
                    and isinstance(left, ast.Name)
                    and left.id == seq
                    and isinstance(right, ast.BinOp)
                    and isinstance(right.op, ast.Sub)
                ):
                    rejects_at_boundary = isinstance(op, ast.LtE)
                    anchor = sub
                elif (  # mirrored form: high - size >= seq
                    isinstance(op, (ast.Gt, ast.GtE))
                    and isinstance(right, ast.Name)
                    and right.id == seq
                    and isinstance(left, ast.BinOp)
                    and isinstance(left.op, ast.Sub)
                ):
                    rejects_at_boundary = isinstance(op, ast.GtE)
                    anchor = sub
            if rejects_at_boundary is None:
                return None, True
            prunes = any(
                isinstance(sub, (ast.SetComp, ast.ListComp))
                for sub in ast.walk(node)
            )
            # the `key = (src, epoch)` idiom: a tuple of TWO OR MORE
            # identity parameters (the seq param excluded) built inside
            # admit means the window is keyed per client incarnation —
            # the property that keeps a replacement's re-used seqs from
            # being swallowed by its predecessor's window
            keyed = any(
                isinstance(sub, ast.Tuple)
                and len(sub.elts) >= 2
                and all(
                    isinstance(e, ast.Name)
                    and e.id in params
                    and e.id != seq
                    for e in sub.elts
                )
                for sub in ast.walk(node)
            )
            return (
                DedupSemantics(
                    rel=mod.rel,
                    line=anchor.lineno,
                    col=anchor.col_offset,
                    symbol=astutil.enclosing_symbol(anchor, mod.parents),
                    rejects_at_boundary=rejects_at_boundary,
                    checks_seen=checks_seen,
                    prunes_seen=prunes,
                    window_default=_admit_window_default(node, mod),
                    keyed_by_epoch=keyed,
                ),
                True,
            )
    return None, False


def _extract_snapshot_dedup(server, by_rel) -> Optional[bool]:
    """Does the server's shard-snapshot dict carry the dedup window next
    to the center and version counter? Recognized idiom: a server-role
    function whose name mentions ``persist`` or ``snapshot`` building a
    dict literal with string keys including both ``"center"`` and
    ``"version"`` — that dict IS the snapshot; the verdict is whether a
    ``"dedup"`` key rides in it. None when no such dict exists (no
    snapshot machinery — nothing for restart schedules to model)."""
    for rel in server.rels:
        mod = by_rel.get(rel)
        if mod is None:
            continue
        for node in mod.nodes:
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) or not (
                "persist" in node.name or "snapshot" in node.name
            ):
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Dict):
                    continue
                keys = {
                    k.value
                    for k in sub.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)
                }
                if "center" in keys and "version" in keys:
                    return "dedup" in keys
    return None


def _extract_handoff_dedup(server, by_rel) -> Optional[bool]:
    """Does the server's shard-handoff path move the dedup window along
    with the shard data? Recognized idiom: server-role functions whose
    name mentions ``handoff`` or ``reshard`` — the send side extracts
    what travels, the receive side absorbs it — referencing the dedup
    machinery (any ``dedup``-named attribute or variable). True when
    any such function touches it, False when handoff functions exist
    but none does (exactly-once then dies at the ownership move), None
    when there is no handoff machinery at all."""
    found = None
    for rel in server.rels:
        mod = by_rel.get(rel)
        if mod is None:
            continue
        for node in mod.nodes:
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ) or not (
                "handoff" in node.name or "reshard" in node.name
            ):
                continue
            mentions = any(
                "dedup"
                in (
                    sub.attr
                    if isinstance(sub, ast.Attribute)
                    else sub.id if isinstance(sub, ast.Name) else ""
                )
                for sub in ast.walk(node)
            )
            if mentions:
                return True
            found = False
    return found


# ---------------------------------------------------------------------------
# serving-fleet semantics — the router/replica routing protocol
#
# The fleet roles (mpit_tpu_torch/fleet/) speak a different conversation from
# the PS pair: a ROUTE/REPLY request lane plus auxiliary weight-refresh
# and stop lanes. What the model checker needs from it is small: which
# tag pair is the request lane, whether the router's reply wait can time
# out (the death-detection escape), and whether a redispatch path exists
# (a router-role send of the route tag from a ``redispatch``-named
# function — the recovery idiom ``fleet/router.py`` carries). Extraction
# is recognized-idiom, resolve-or-skip, like everything above.


@dataclasses.dataclass(frozen=True)
class FleetSemantics:
    """Everything the fleet-route model checker needs."""

    router_role: str
    replica_role: str
    route_tag: int  # the request lane (lowest shared tag — see extract)
    reply_tag: int
    stop_tag: Optional[int]
    #: a router-role function whose name mentions ``redispatch`` re-sends
    #: the route tag — the orphan-recovery path exists
    redispatch_on_death: bool
    #: the router's reply recv carries a timeout (it can notice a dead
    #: replica instead of blocking forever)
    reply_recv_timeout: bool
    route_send: Optional[ProtoOp]  # finding anchor


def extract_fleet_semantics(project) -> Optional[FleetSemantics]:
    """The routed-serving pair's semantics, or None when the scan set has
    no replica-style role (a wildcard-recv dispatcher whose role name
    contains ``replica``) talking to a marked counterpart.

    Tag-pair selection: the request lane is the LOWEST router-sent tag
    the replica dispatches on, answered by the LOWEST replica-sent tag
    the router concretely recvs — the registry orders a protocol's
    request/reply lane before its auxiliary lanes (ROUTE=11/REPLY=12
    precede the weight lanes 13/14), and the rule keeps extraction
    deterministic without guessing at payload flow."""
    roles = project.roles
    replica = None
    for name in sorted(roles):
        cand = roles[name]
        if (
            "replica" in name
            and cand.has_wildcard_recv
            and roles.get(cand.counterpart) is not None
        ):
            replica = cand
            break
    if replica is None:
        return None
    router = roles[replica.counterpart]
    route_cands = sorted(
        t for t in (router.sent_tags & replica.dispatch_tags)
        if t is not None
    )
    reply_cands = sorted(
        t for t in (
            replica.sent_tags
            & {op.tag for op in router.concrete_recvs}
        )
        if t is not None
    )
    if not route_cands or not reply_cands:
        return None
    route_tag, reply_tag = route_cands[0], reply_cands[0]

    by_rel = {m.rel: m for m in project.modules}
    graph = project.graph
    # the stop lane: a replica dispatch branch whose body sets a
    # ``stop``-named attribute (``self.stopped = True``)
    stop_tag = None
    for rel in replica.rels:
        mod = by_rel.get(rel)
        if mod is None:
            continue
        info = graph.module_for_rel(rel)
        for node in mod.nodes:
            if not isinstance(node, ast.If) or not isinstance(
                node.test, ast.Compare
            ):
                continue
            tags = [
                graph.resolve_constant(info, dotted)
                for _c, dotted in _dispatch_tag_nodes(node.test)
            ]
            tags = [t for t in tags if t is not None]
            if not tags:
                continue
            sets_stop = any(
                isinstance(sub, ast.Assign)
                and any(
                    isinstance(t, ast.Attribute) and "stop" in t.attr
                    for t in sub.targets
                )
                for stmt in node.body
                for sub in ast.walk(stmt)
            )
            if sets_stop and stop_tag is None:
                stop_tag = tags[0]
    redispatch = any(
        op.tag == route_tag and "redispatch" in op.symbol
        for op in router.sends
    )
    _checked, reply_recv_timeout = _client_reply_handling(
        router, by_rel, graph, reply_tag
    )
    route_send = min(
        (op for op in router.sends if op.tag == route_tag),
        key=lambda op: (op.rel, op.line, op.col),
        default=None,
    )
    return FleetSemantics(
        router_role=router.role,
        replica_role=replica.role,
        route_tag=route_tag,
        reply_tag=reply_tag,
        stop_tag=stop_tag,
        redispatch_on_death=redispatch,
        reply_recv_timeout=reply_recv_timeout,
        route_send=route_send,
    )


def extract_semantics(project) -> Optional[ProtocolSemantics]:
    """The modeled client/server pair's fault semantics, or None when the
    scan set has no recognizable request/reply protocol (no role pair, no
    unique reply tag, or no dispatch branch answering a request)."""
    roles = project.roles
    client = server = None
    for name in sorted(roles):
        cand = roles[name]
        cp = roles.get(cand.counterpart)
        if cp is None or not cand.has_wildcard_recv:
            continue
        client, server = cp, cand
        break
    if server is None:
        return None
    reply_tags = server.sent_tags & {
        op.tag for op in client.concrete_recvs
    }
    if len(reply_tags) != 1:
        return None
    reply_tag = next(iter(reply_tags))

    by_rel = {m.rel: m for m in project.modules}
    graph = project.graph
    request_tag, push_tags, stop_tag = _classify_dispatch(
        server, by_rel, graph, reply_tag
    )
    if request_tag is None or request_tag not in client.sent_tags:
        return None
    attempt_echoed = _reply_is_echoed(server, by_rel, graph, reply_tag)
    attempt_checked, reply_recv_timeout = _client_reply_handling(
        client, by_rel, graph, reply_tag
    )
    dedup, found_admit = _extract_dedup(server, by_rel)

    def _first(ops):
        return min(ops, key=lambda op: (op.rel, op.line, op.col), default=None)

    return ProtocolSemantics(
        client_role=client.role,
        server_role=server.role,
        request_tag=request_tag,
        reply_tag=reply_tag,
        push_tags=tuple(sorted(push_tags)),
        stop_tag=stop_tag,
        attempt_echoed=attempt_echoed,
        attempt_checked=attempt_checked,
        reply_recv_timeout=reply_recv_timeout,
        dedup=dedup,
        dedup_opaque=found_admit and dedup is None,
        reply_send=_first(
            [op for op in server.sends if op.tag == reply_tag]
        ),
        reply_recv=_first(
            [op for op in client.concrete_recvs if op.tag == reply_tag]
        ),
        snapshot_includes_dedup=_extract_snapshot_dedup(server, by_rel),
        handoff_includes_dedup=_extract_handoff_dedup(server, by_rel),
    )
