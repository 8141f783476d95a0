"""Whole-program payload-schema inference for the wire protocol.

The role model (:mod:`mpit_tpu_torch.analysis.protocol`) answers *which tags*
cross the wire; this pass answers *what rides inside them*. For every
wire tag it collects

- **sender construction sites**: the payload expression at each transport
  ``send``/``isend`` (and each call into the module-local send-wrapper
  chains MPT004/MPT008 already track), classified into a small kind
  lattice — ``none``/``bool``/``int``/``float``/``str``/``bytes``/
  ``ndarray``/``quant``/``list``, tuple shapes with per-field kind sets,
  ``unencodable:<what>`` for anything that falls off ``encode_frame``
  onto the per-message pickle fallback, and ``unknown`` when resolution
  fails (resolve-or-skip: no claim beats a wrong claim);
- **receiver consumption sites**: for each dispatch branch of a
  wildcard-recv loop (``if msg.tag == TAG_X:``) and each concrete-tag
  recv, the unpacking patterns (``a, b, c = msg.payload``), arity checks
  (``len(payload) == 4``), ``isinstance`` acceptances, constant index
  subscripts, ``payload is None`` guards, and opaque uses — followed
  through module-local helper calls (``self._admit_push(msg)``).

The unified per-tag table is the input to three rules
(:mod:`mpit_tpu_torch.analysis.rules.payload_schema`): MPT016
sender/receiver shape divergence, MPT017 pickle-fallback payloads, and
MPT018 snapshot schema drift (``save_shard_state`` writes vs restore
reads). It is also what ``python -m mpit_tpu_torch.analysis schema`` renders
and what ``wire-schema.lock.json`` pins: protocol-shape changes must be
*declared* with ``--update-lock``, or lint gate 9 fails.

Everything here is stdlib-only and purely syntactic — scanned code is
parsed, never imported.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from mpit_tpu_torch.analysis import astutil, protocol

SCHEMA_LOCK_FILENAME = "wire-schema.lock.json"
SCHEMA_LOCK_VERSION = 1

#: kind-resolution recursion bound (alias/attr chains; also the cycle guard)
MAX_CLASSIFY_DEPTH = 8
#: how deep receiver analysis follows module-local helper calls
MAX_HELPER_DEPTH = 3

_TAG_NAME_RE = re.compile(r"^TAG_[A-Z0-9_]+$")

UNKNOWN: FrozenSet = frozenset({"unknown"})

#: numpy constructors whose result is an ndarray (classification only —
#: the wire codec accepts any ndarray of its registered dtypes)
_NDARRAY_FACTORIES = {
    "asarray",
    "array",
    "ascontiguousarray",
    "arange",
    "concatenate",
    "empty",
    "empty_like",
    "frombuffer",
    "full",
    "ones",
    "ones_like",
    "stack",
    "zeros",
    "zeros_like",
}

#: isinstance() type name (last dotted component) -> payload kind
_ISINSTANCE_KINDS = {
    "bool": "bool",
    "bytes": "bytes",
    "dict": "unencodable:dict",
    "float": "float",
    "int": "int",
    "list": "list",
    "ndarray": "ndarray",
    "QuantArray": "quant",
    "set": "unencodable:set",
    "str": "str",
    "tuple": "tuple",
}


# ---------------------------------------------------------------------------
# data model


@dataclasses.dataclass(frozen=True)
class Site:
    """One source location, line-anchored for findings and the CLI dump."""

    rel: str
    line: int
    col: int
    symbol: str


def _site(mod, node) -> Site:
    return Site(
        rel=mod.rel,
        line=getattr(node, "lineno", 0),
        col=getattr(node, "col_offset", 0),
        symbol=astutil.enclosing_symbol(node, mod.parents),
    )


@dataclasses.dataclass(frozen=True)
class SenderShape:
    """One possible payload shape at one sender site. A site whose
    classification is a union (``reply`` assigned in three branches)
    contributes one shape per branch."""

    tag: int
    shape: object  # kind string, or ("tuple", (kindset, ...))
    site: Site
    text: str  # flagged source line (finding fingerprint stability)


@dataclasses.dataclass
class TagRecv:
    """Everything one tag's receivers were seen to accept."""

    none_sites: List[Site] = dataclasses.field(default_factory=list)
    any_sites: List[Site] = dataclasses.field(default_factory=list)
    ignored_sites: List[Site] = dataclasses.field(default_factory=list)
    tuple_any: List[Site] = dataclasses.field(default_factory=list)
    # accepted arity -> {field index: set of accepted kinds}
    arities: Dict[int, Dict[int, Set[str]]] = dataclasses.field(
        default_factory=dict
    )
    arity_sites: Dict[int, Site] = dataclasses.field(default_factory=dict)
    # constant-index subscript reads outside arity checks
    field_reads: Dict[int, Site] = dataclasses.field(default_factory=dict)
    # scalar isinstance acceptances: kind -> site
    kinds: Dict[str, Site] = dataclasses.field(default_factory=dict)

    @property
    def constrained(self) -> bool:
        return bool(
            self.none_sites
            or self.tuple_any
            or self.arities
            or self.kinds
            or self.field_reads
        )

    @property
    def opaque(self) -> bool:
        """Some path consumes the payload without shape constraints —
        every sender shape is then admissible (conservative)."""
        return bool(self.any_sites or self.ignored_sites)


@dataclasses.dataclass(frozen=True)
class PayloadSite:
    """One classified send payload (every module, tag not required) —
    the MPT017 input."""

    site: Site
    kinds: FrozenSet
    text: str


@dataclasses.dataclass
class SchemaModel:
    tag_names: Dict[int, str] = dataclasses.field(default_factory=dict)
    senders: Dict[int, List[SenderShape]] = dataclasses.field(
        default_factory=dict
    )
    receivers: Dict[int, TagRecv] = dataclasses.field(default_factory=dict)
    payload_sites: List[PayloadSite] = dataclasses.field(
        default_factory=list
    )
    snapshot_writes: Dict[str, Site] = dataclasses.field(
        default_factory=dict
    )
    snapshot_reads: Dict[str, Site] = dataclasses.field(default_factory=dict)

    def tag_name(self, tag: int) -> str:
        return self.tag_names.get(tag, f"tag {tag}")

    def to_json(self) -> dict:
        tags = sorted(set(self.senders) | set(self.receivers))
        doc: dict = {"version": SCHEMA_LOCK_VERSION, "tags": {}}
        for tag in tags:
            sender = sorted(
                {kind_repr(s.shape) for s in self.senders.get(tag, ())}
            )
            receiver = receiver_repr(self.receivers.get(tag))
            doc["tags"][str(tag)] = {
                "name": self.tag_names.get(tag, ""),
                "sender": sender,
                "receiver": receiver,
                "precision": tag_precision(sender, receiver),
            }
        doc["snapshot"] = {
            "writes": sorted(self.snapshot_writes),
            "reads": sorted(self.snapshot_reads),
        }
        return doc


def tag_precision(sender_reprs, receiver_reprs) -> list:
    """The per-tag payload precision column (the MPT022 wire-drift
    anchor): ``"codes"`` when any modeled shape on either side carries
    quantized codes (a ``quant`` kind — QuantArray in transit), ``"f32"``
    when raw float32 ndarrays ride the tag. Control tags get ``[]``.
    Derived from the same kind strings the lock already pins, so a PR
    that flips a tag between raw and quantized payloads shows up as a
    one-line lock diff — the lockfile, not prose, is the authority."""
    blob = " ".join(list(sender_reprs) + list(receiver_reprs))
    out = []
    if "quant" in blob:
        out.append("codes")
    if "ndarray" in blob:
        out.append("f32")
    return out


def is_tuple_kind(kind) -> bool:
    return isinstance(kind, tuple) and kind and kind[0] == "tuple"


def kind_repr(kind) -> str:
    if is_tuple_kind(kind):
        return "(" + ", ".join(kindset_repr(fs) for fs in kind[1]) + ")"
    return "?" if kind == "unknown" else str(kind)


def kindset_repr(kinds) -> str:
    if not kinds:
        return "?"
    return "|".join(sorted(kind_repr(k) for k in kinds))


def receiver_repr(rec: Optional[TagRecv]) -> List[str]:
    if rec is None:
        return []
    out: Set[str] = set()
    if rec.none_sites:
        out.add("none")
    if rec.any_sites:
        out.add("any")
    if rec.ignored_sites:
        out.add("ignored")
    if rec.tuple_any:
        out.add("tuple")
    for k in rec.arities:
        fields = rec.arities[k]
        parts = [
            kindset_repr(frozenset(fields[i])) if fields.get(i) else "?"
            for i in range(k)
        ]
        out.add(f"tuple{k}({', '.join(parts)})")
    for kind in rec.kinds:
        out.add(kind_repr(kind))
    covered = max(rec.arities, default=0)
    for i in rec.field_reads:
        if i >= covered:
            out.add(f"field[{i}]")
    return sorted(out)


# ---------------------------------------------------------------------------
# expression -> kind classification


class _Classifier:
    """Per-module payload-kind resolution: local assignment chains,
    ``self.X`` attribute assignments anywhere in the class, and
    module-level bindings (through the module graph's info), to a depth
    bound. Anything unmodeled is ``unknown`` — never a guess."""

    def __init__(self, mod, info, class_names: Set[str]):
        self.mod = mod
        self.info = info  # graph ModuleInfo (module-level bindings)
        self.class_names = class_names
        self._fn_assigns: dict = {}
        self._attr_assigns: Optional[dict] = None

    # -- binding collection

    def _collect_scope(self, stmts, out: dict) -> None:
        """Name bindings in a statement list, NOT descending into nested
        def/class scopes. A non-Assign binding (loop target, with-as,
        augmented) records ``None`` = unknown."""
        for stmt in stmts:
            if isinstance(
                stmt,
                (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef),
            ):
                continue
            for node in ast.walk(stmt):
                if isinstance(node, ast.Assign):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            out.setdefault(tgt.id, []).append(node.value)
                        elif isinstance(tgt, (ast.Tuple, ast.List)):
                            for e in tgt.elts:
                                if isinstance(e, ast.Name):
                                    out.setdefault(e.id, []).append(None)
                elif isinstance(node, ast.AnnAssign):
                    if isinstance(node.target, ast.Name):
                        out.setdefault(node.target.id, []).append(
                            node.value
                        )
                elif isinstance(node, ast.AugAssign):
                    if isinstance(node.target, ast.Name):
                        out.setdefault(node.target.id, []).append(None)
                elif isinstance(node, ast.NamedExpr):
                    if isinstance(node.target, ast.Name):
                        out.setdefault(node.target.id, []).append(
                            node.value
                        )
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    for e in ast.walk(node.target):
                        if isinstance(e, ast.Name):
                            out.setdefault(e.id, []).append(None)
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        if item.optional_vars is not None:
                            for e in ast.walk(item.optional_vars):
                                if isinstance(e, ast.Name):
                                    out.setdefault(e.id, []).append(None)

    def fn_assigns(self, fn) -> dict:
        key = id(fn) if fn is not None else None
        cached = self._fn_assigns.get(key)
        if cached is None:
            cached = {}
            if fn is not None:
                self._collect_scope(fn.body, cached)
            self._fn_assigns[key] = cached
        return cached

    def attr_assigns(self) -> dict:
        if self._attr_assigns is None:
            out: dict = {}
            for node in self.mod.nodes:
                if isinstance(node, ast.Assign):
                    value = node.value
                    targets = node.targets
                elif isinstance(node, ast.AugAssign):
                    value = None
                    targets = [node.target]
                else:
                    continue
                for tgt in targets:
                    if (
                        isinstance(tgt, ast.Attribute)
                        and isinstance(tgt.value, ast.Name)
                        and tgt.value.id == "self"
                    ):
                        fn = protocol._enclosing_function(
                            node, self.mod.parents
                        )
                        out.setdefault(tgt.attr, []).append((value, fn))
            self._attr_assigns = out
        return self._attr_assigns

    # -- classification

    def classify(self, node, fn, depth=0, seen=frozenset()) -> FrozenSet:
        if node is None or depth > MAX_CLASSIFY_DEPTH:
            return UNKNOWN
        if isinstance(node, ast.Constant):
            v = node.value
            if v is None:
                return frozenset({"none"})
            if isinstance(v, bool):
                return frozenset({"bool"})
            if isinstance(v, int):
                return frozenset({"int"})
            if isinstance(v, float):
                return frozenset({"float"})
            if isinstance(v, str):
                return frozenset({"str"})
            if isinstance(v, bytes):
                return frozenset({"bytes"})
            return UNKNOWN
        if isinstance(node, ast.Tuple):
            if any(isinstance(e, ast.Starred) for e in node.elts):
                return UNKNOWN
            fields = tuple(
                self.classify(e, fn, depth + 1, seen) for e in node.elts
            )
            return frozenset({("tuple", fields)})
        if isinstance(node, (ast.List, ast.ListComp)):
            return frozenset({"list"})
        if isinstance(node, (ast.Dict, ast.DictComp)):
            return frozenset({"unencodable:dict"})
        if isinstance(node, (ast.Set, ast.SetComp)):
            return frozenset({"unencodable:set"})
        if isinstance(node, (ast.GeneratorExp, ast.Lambda)):
            return frozenset({"unencodable:" + type(node).__name__.lower()})
        if isinstance(node, ast.IfExp):
            return self.classify(
                node.body, fn, depth + 1, seen
            ) | self.classify(node.orelse, fn, depth + 1, seen)
        if isinstance(node, ast.UnaryOp):
            return self.classify(node.operand, fn, depth + 1, seen)
        if isinstance(node, ast.JoinedStr):
            return frozenset({"str"})
        if isinstance(node, ast.Name):
            return self._classify_name(node.id, fn, depth, seen)
        if isinstance(node, ast.Attribute):
            if (
                isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                return self._classify_attr(node.attr, depth, seen)
            return UNKNOWN
        if isinstance(node, ast.Subscript):
            return self._classify_subscript(node, fn, depth, seen)
        if isinstance(node, ast.BinOp):
            left = self.classify(node.left, fn, depth + 1, seen)
            right = self.classify(node.right, fn, depth + 1, seen)
            if "ndarray" in left or "ndarray" in right:
                return frozenset({"ndarray"})
            if left <= {"int", "bool"} and right <= {"int", "bool"}:
                return frozenset({"int"})
            if left <= {"int", "float", "bool"} and right <= {
                "int",
                "float",
                "bool",
            }:
                return frozenset({"float"})
            return UNKNOWN
        if isinstance(node, ast.Call):
            return self._classify_call(node, fn, depth, seen)
        return UNKNOWN

    def _classify_name(self, name, fn, depth, seen) -> FrozenSet:
        key = ("name", name, id(fn) if fn is not None else None)
        if key in seen:
            return UNKNOWN
        seen = seen | {key}
        exprs = self.fn_assigns(fn).get(name) if fn is not None else None
        scope_fn = fn
        if not exprs:
            # fall through to module-level bindings (the graph's view)
            if self.info is not None and name in self.info.constants:
                return self._const_kind(self.info.constants[name])
            if self.info is not None and name in self.info.assigns:
                exprs = [self.info.assigns[name]]
                scope_fn = None
            else:
                return UNKNOWN
        out: Set = set()
        for e in exprs:
            if e is None:
                out |= UNKNOWN
            else:
                out |= self.classify(e, scope_fn, depth + 1, seen)
        return frozenset(out) if out else UNKNOWN

    @staticmethod
    def _const_kind(value) -> FrozenSet:
        if value is None:
            return frozenset({"none"})
        if isinstance(value, bool):
            return frozenset({"bool"})
        if isinstance(value, int):
            return frozenset({"int"})
        if isinstance(value, float):
            return frozenset({"float"})
        if isinstance(value, str):
            return frozenset({"str"})
        if isinstance(value, bytes):
            return frozenset({"bytes"})
        return UNKNOWN

    def _classify_attr(self, attr, depth, seen) -> FrozenSet:
        key = ("attr", attr)
        if key in seen:
            return UNKNOWN
        entries = self.attr_assigns().get(attr)
        if not entries:
            return UNKNOWN
        seen = seen | {key}
        out: Set = set()
        for expr, afn in entries:
            if expr is None:
                out |= UNKNOWN
            else:
                out |= self.classify(expr, afn, depth + 1, seen)
        return frozenset(out) if out else UNKNOWN

    def _classify_subscript(self, node, fn, depth, seen) -> FrozenSet:
        base = self.classify(node.value, fn, depth + 1, seen)
        out: Set = set()
        for k in base:
            if k == "ndarray":
                out.add("ndarray")  # index or slice of an array: array
            elif is_tuple_kind(k):
                idx = astutil.int_constant(node.slice)
                if idx is not None and 0 <= idx < len(k[1]):
                    out |= k[1][idx]
                else:
                    out.add("unknown")
            else:
                out.add("unknown")
        return frozenset(out) if out else UNKNOWN

    def _classify_call(self, node, fn, depth, seen) -> FrozenSet:
        name = astutil.call_last_name(node)
        dotted = astutil.dotted_name(node.func)
        if name in ("quantize", "QuantArray"):
            return frozenset({"quant"})
        if name == "dequantize":
            return frozenset({"ndarray"})
        if (
            dotted
            and dotted.split(".")[0] in ("np", "numpy")
            and name in _NDARRAY_FACTORIES
        ):
            return frozenset({"ndarray"})
        if isinstance(node.func, ast.Attribute):
            if name == "astype":
                return frozenset({"ndarray"})
            if name == "copy" and not node.args:
                return self.classify(node.func.value, fn, depth + 1, seen)
            if name == "get" and len(node.args) == 2:
                return self.classify(node.args[1], fn, depth + 1, seen)
        if name == "from_bytes":
            return frozenset({"int"})
        if dotted in ("itertools.count", "count"):
            return frozenset({"_int_iter"})
        if name == "next" and node.args:
            inner = self.classify(node.args[0], fn, depth + 1, seen)
            return (
                frozenset({"int"}) if "_int_iter" in inner else UNKNOWN
            )
        if dotted in ("int", "len"):
            return frozenset({"int"})
        if dotted == "float":
            return frozenset({"float"})
        if dotted == "str":
            return frozenset({"str"})
        if dotted == "bytes":
            return frozenset({"bytes"})
        if dotted == "bool":
            return frozenset({"bool"})
        if (
            name in self.class_names
            and name != "QuantArray"
            and dotted == name  # a bare constructor call, not a method
        ):
            return frozenset({f"unencodable:{name}"})
        return UNKNOWN


# ---------------------------------------------------------------------------
# sender extraction


def _wrapper_payload_info(mod, wrappers: dict) -> dict:
    """For each send wrapper: (call-frame index of the forwarded payload
    parameter, its name) — or (None, None) when the wrapper constructs
    the payload itself (``_scatter`` building the push tuple), in which
    case its *inner* call is the construction site and the wrapper's own
    call sites carry no payload expression."""
    out: dict = {}
    changed = True
    while changed:
        changed = False
        for node in ast.walk(mod.tree):
            if not isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef)
            ):
                continue
            if node.name not in wrappers or node.name in out:
                continue
            params = [
                a.arg for a in node.args.posonlyargs + node.args.args
            ]
            call_params = params[1:] if params[:1] == ["self"] else params
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                callee = astutil.call_last_name(sub)
                if (
                    callee in protocol._SEND_NAMES
                    and len(sub.args) + len(sub.keywords) >= 3
                ):
                    pay = astutil.get_arg(sub, 2, "payload")
                elif callee in wrappers and callee != node.name:
                    if callee not in out:
                        continue  # resolved on a later fixpoint round
                    ppos = out[callee][0]
                    if ppos is None:
                        pay = None
                    else:
                        pay = astutil.get_arg(sub, ppos, "payload")
                else:
                    continue
                if isinstance(pay, ast.Name) and pay.id in call_params:
                    out[node.name] = (call_params.index(pay.id), pay.id)
                else:
                    out[node.name] = (None, None)
                changed = True
                break
    for name in wrappers:
        out.setdefault(name, (None, None))
    return out


def _fn_call_params(fn) -> list:
    params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    return params[1:] if params[:1] == ["self"] else params


def _incoming_tags(mod, graph, info, wrappers: dict) -> dict:
    """Concrete tag values flowing into each wrapper from its call
    sites, to a fixpoint — ``_send_with_retry`` called from ``_scatter``
    with ``_scatter``'s own tag parameter inherits ``_scatter``'s
    incoming set (``{TAG_PUSH_EASGD, TAG_PUSH_DELTA}``)."""
    incoming = {name: set() for name in wrappers}
    changed = True
    while changed:
        changed = False
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            callee = astutil.call_last_name(node)
            if callee not in wrappers:
                continue
            tag_arg = astutil.get_arg(node, wrappers[callee], "tag")
            if tag_arg is None:
                continue
            val, wild = protocol._tag_value(graph, info, tag_arg)
            add: set = set()
            if val is not None:
                add = {val}
            elif isinstance(tag_arg, ast.Name):
                encl = protocol._enclosing_function(node, mod.parents)
                if encl is not None and encl.name in wrappers:
                    cp = _fn_call_params(encl)
                    ti = wrappers[encl.name]
                    if ti < len(cp) and cp[ti] == tag_arg.id:
                        add = incoming[encl.name]
            new = add - incoming[callee]
            if new:
                incoming[callee] |= new
                changed = True
    return incoming


def _extract_senders(model, mod, graph, info, classifier, is_role) -> None:
    # wrapper discovery is a whole-tree fixpoint; a module with no
    # direct send/isend call can't define send wrappers (the fixpoint
    # seeds from those calls) and contributes no sender sites — the
    # prefilter keeps the whole-package build inside the <5 s budget
    if not any(
        isinstance(n, ast.Call)
        and astutil.call_last_name(n) in protocol._SEND_NAMES
        for n in mod.nodes
    ):
        return
    wrappers = protocol._send_wrappers(mod.tree)
    payload_info = _wrapper_payload_info(mod, wrappers)
    incoming = _incoming_tags(mod, graph, info, wrappers)
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        callee = astutil.call_last_name(node)
        if (
            callee in protocol._SEND_NAMES
            and len(node.args) + len(node.keywords) >= 3
        ):
            tag_arg = astutil.get_arg(node, 1, "tag")
            payload_expr = astutil.get_arg(node, 2, "payload")
        elif callee in wrappers:
            tag_arg = astutil.get_arg(node, wrappers[callee], "tag")
            ppos, _ = payload_info[callee]
            if ppos is None:
                continue  # payload built inside: the inner site covers it
            payload_expr = astutil.get_arg(node, ppos, "payload")
        else:
            continue
        if payload_expr is None:
            continue
        encl = protocol._enclosing_function(node, mod.parents)
        if (
            encl is not None
            and encl.name in wrappers
            and isinstance(payload_expr, ast.Name)
            and payload_info[encl.name][1] == payload_expr.id
        ):
            # the wrapper's own forwarded parameter — classified (with a
            # concrete tag) at each of its call sites instead
            continue
        kinds = classifier.classify(payload_expr, encl)
        site = _site(mod, node)
        text = astutil.line_text(mod.source_lines, node)
        model.payload_sites.append(
            PayloadSite(site=site, kinds=kinds, text=text)
        )
        if not is_role:
            continue
        val, wild = protocol._tag_value(graph, info, tag_arg)
        if val is not None and not wild:
            tags = {val}
        elif (
            isinstance(tag_arg, ast.Name)
            and encl is not None
            and encl.name in wrappers
        ):
            cp = _fn_call_params(encl)
            ti = wrappers[encl.name]
            if ti < len(cp) and cp[ti] == tag_arg.id:
                tags = set(incoming[encl.name])
            else:
                tags = set()
        else:
            tags = set()  # unresolvable tag: skip, never guess
        for t in sorted(tags):
            for k in kinds:
                model.senders.setdefault(t, []).append(
                    SenderShape(tag=t, shape=k, site=site, text=text)
                )


# ---------------------------------------------------------------------------
# receiver extraction


class _RecvExtractor:
    def __init__(self, model, mod, graph, info):
        self.model = model
        self.mod = mod
        self.graph = graph
        self.info = info
        self.local_fns = {
            n.name: n
            for n in mod.nodes
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }

    def run(self) -> None:
        mod = self.mod
        wildcard_vars: Set[str] = set()
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_last_name(node)
            if name not in protocol._RECV_NAMES:
                continue
            tag_arg = astutil.get_arg(node, 1, "tag")
            val, wild = protocol._tag_value(self.graph, self.info, tag_arg)
            parent = mod.parents.get(node)
            msgvar = None
            if (
                isinstance(parent, ast.Assign)
                and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)
            ):
                msgvar = parent.targets[0].id
            if wild:
                if msgvar is not None:
                    wildcard_vars.add(msgvar)
            elif val is not None and msgvar is not None:
                # concrete-tag recv: the whole enclosing function is the
                # consumption scope
                encl = protocol._enclosing_function(node, mod.parents)
                scope = encl.body if encl is not None else mod.tree.body
                self._consume(scope, msgvar, set(), val, 0)
        if not wildcard_vars:
            return
        for node in mod.nodes:
            if not isinstance(node, ast.If):
                continue
            tags, msgvar = self._branch_tags(node.test)
            if not tags or msgvar not in wildcard_vars:
                continue
            for t in sorted(tags):
                self._consume(node.body, msgvar, set(), t, 0)

    def _branch_tags(self, test) -> Tuple[Set[int], Optional[str]]:
        comps = []
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
            comps = [
                v for v in test.values if isinstance(v, ast.Compare)
            ]
        elif isinstance(test, ast.Compare):
            comps = [test]
        tags: Set[int] = set()
        msgvar = None
        for c in comps:
            for _cand, dotted in protocol._dispatch_tag_nodes(c):
                val = self.graph.resolve_constant(self.info, dotted)
                if val is not None:
                    tags.add(val)
            for operand in (c.left, *c.comparators):
                if (
                    isinstance(operand, ast.Attribute)
                    and operand.attr == "tag"
                    and isinstance(operand.value, ast.Name)
                ):
                    msgvar = operand.value.id
        return tags, msgvar

    # -- consumption analysis

    def _consume(self, stmts, msgvar, payload_names, tag, depth) -> None:
        rec = self.model.receivers.setdefault(tag, TagRecv())
        mod = self.mod
        roots = set(payload_names)

        def is_root(expr) -> bool:
            if isinstance(expr, ast.Name) and expr.id in roots:
                return True
            return (
                msgvar is not None
                and isinstance(expr, ast.Attribute)
                and expr.attr == "payload"
                and isinstance(expr.value, ast.Name)
                and expr.value.id == msgvar
            )

        nodes = [n for s in stmts for n in ast.walk(s)]
        # alias fixpoint: `payload = msg.payload` (aliases are never
        # killed on rebind — a rebound name's LATER checks, like
        # _admit_push's legacy `len(payload) == 3` after
        # `payload = (epoch, seq, chunk)`, still describe what this
        # branch accepts)
        changed = True
        while changed:
            changed = False
            for n in nodes:
                if (
                    isinstance(n, ast.Assign)
                    and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and is_root(n.value)
                    and n.targets[0].id not in roots
                ):
                    roots.add(n.targets[0].id)
                    changed = True

        consumed: Set[int] = set()

        def consume_expr(expr) -> None:
            consumed.add(id(expr))

        for n in nodes:
            if isinstance(n, (ast.If, ast.While)):
                self._test_patterns(n, rec, is_root, consume_expr)
            elif isinstance(n, ast.Assign):
                if (
                    len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and is_root(n.value)
                ):
                    consume_expr(n.value)  # the alias itself
                elif (
                    len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Tuple)
                    and all(
                        isinstance(e, ast.Name)
                        for e in n.targets[0].elts
                    )
                    and is_root(n.value)
                ):
                    k = len(n.targets[0].elts)
                    rec.arities.setdefault(k, {})
                    rec.arity_sites.setdefault(k, _site(mod, n))
                    consume_expr(n.value)
            elif isinstance(n, ast.Subscript):
                if is_root(n.value) and isinstance(n.ctx, ast.Load):
                    idx = astutil.int_constant(n.slice)
                    if idx is not None and idx >= 0:
                        rec.field_reads.setdefault(idx, _site(mod, n))
                        consume_expr(n.value)
            elif isinstance(n, ast.Compare):
                # `payload is None` / `payload is not None`
                if (
                    len(n.ops) == 1
                    and isinstance(n.ops[0], (ast.Is, ast.IsNot))
                    and isinstance(n.comparators[0], ast.Constant)
                    and n.comparators[0].value is None
                    and is_root(n.left)
                ):
                    rec.none_sites.append(_site(mod, n))
                    consume_expr(n.left)
            elif isinstance(n, ast.Call):
                self._helper_call(
                    n, rec, msgvar, roots, is_root, consume_expr, tag,
                    depth,
                )

        touched = False
        for n in nodes:
            if is_root(n):
                touched = True
                if id(n) in consumed:
                    continue
                if isinstance(n, ast.Name) and not isinstance(
                    n.ctx, ast.Load
                ):
                    continue
                parent = self.mod.parents.get(n)
                if id(parent) in consumed:
                    continue
                rec.any_sites.append(_site(mod, n))
            elif (
                msgvar is not None
                and isinstance(n, ast.Name)
                and n.id == msgvar
                and isinstance(n.ctx, ast.Load)
                and id(n) not in consumed
            ):
                # the message object escaping into an unmodeled call can
                # have its payload consumed any way at all (attribute
                # accesses like msg.tag / msg.src stay transparent)
                parent = self.mod.parents.get(n)
                if isinstance(parent, ast.Call) and n in parent.args:
                    rec.any_sites.append(_site(mod, n))
                    touched = True
        if depth == 0 and not touched:
            # dispatch branch (or recv scope) that never touches the
            # payload — STOP/HEARTBEAT/LEAVE style control messages
            rec.ignored_sites.append(
                _site(mod, stmts[0]) if stmts else Site(mod.rel, 0, 0, "")
            )

    def _test_patterns(self, stmt, rec, is_root, consume_expr) -> None:
        """Arity and isinstance acceptances inside ONE if/while test —
        `len(P) == k` conjoined with `isinstance(P[i], T)` in the same
        test yields an arity-k acceptance with field kinds."""
        test = stmt.test
        len_arities: List[int] = []
        field_types: Dict[int, Set[str]] = {}
        scalar_types: List[Tuple[str, ast.AST]] = []
        tuple_any = None
        for n in ast.walk(test):
            if isinstance(n, ast.Compare) and len(n.ops) == 1:
                left, right = n.left, n.comparators[0]
                if isinstance(n.ops[0], ast.Eq):
                    for a, b in ((left, right), (right, left)):
                        if (
                            isinstance(a, ast.Call)
                            and astutil.call_last_name(a) == "len"
                            and a.args
                            and is_root(a.args[0])
                        ):
                            k = astutil.int_constant(b)
                            if k is not None:
                                len_arities.append(k)
                                consume_expr(a.args[0])
            elif (
                isinstance(n, ast.Call)
                and astutil.call_last_name(n) == "isinstance"
                and len(n.args) == 2
            ):
                subject, types = n.args
                kinds = self._type_kinds(types)
                if is_root(subject):
                    consume_expr(subject)
                    for kind in kinds:
                        if kind == "tuple":
                            tuple_any = n
                        else:
                            scalar_types.append((kind, n))
                elif (
                    isinstance(subject, ast.Subscript)
                    and is_root(subject.value)
                ):
                    idx = astutil.int_constant(subject.slice)
                    if idx is not None and idx >= 0:
                        consume_expr(subject.value)
                        field_types.setdefault(idx, set()).update(
                            k for k in kinds if k != "tuple"
                        )
        mod = self.mod
        if len_arities:
            for k in len_arities:
                fields = rec.arities.setdefault(k, {})
                rec.arity_sites.setdefault(k, _site(mod, stmt))
                for i, kinds in field_types.items():
                    if i < k and kinds:
                        fields.setdefault(i, set()).update(kinds)
        else:
            if tuple_any is not None:
                rec.tuple_any.append(_site(mod, tuple_any))
            for i, kinds in field_types.items():
                rec.field_reads.setdefault(i, _site(mod, stmt))
        for kind, n in scalar_types:
            rec.kinds.setdefault(kind, _site(mod, n))

    @staticmethod
    def _type_kinds(types) -> List[str]:
        cands = (
            types.elts if isinstance(types, ast.Tuple) else [types]
        )
        out = []
        for c in cands:
            dotted = astutil.dotted_name(c)
            if dotted is None:
                continue
            kind = _ISINSTANCE_KINDS.get(dotted.split(".")[-1])
            if kind is not None:
                out.append(kind)
        return out

    def _helper_call(
        self, call, rec, msgvar, roots, is_root, consume_expr, tag, depth
    ) -> None:
        """Follow `self._admit_push(msg)` / `self._parse_join(msg.payload)`
        style module-local helpers: the matching parameter becomes the
        payload root (or message var) inside the helper body."""
        if depth >= MAX_HELPER_DEPTH:
            return
        name = astutil.call_last_name(call)
        fn = self.local_fns.get(name)
        if fn is None:
            return
        params = _fn_call_params(fn)
        new_msgvar = None
        new_payload: Set[str] = set()
        consumed_args = []
        for i, arg in enumerate(call.args):
            if i >= len(params):
                break
            if is_root(arg):
                new_payload.add(params[i])
                consumed_args.append(arg)
            elif (
                msgvar is not None
                and isinstance(arg, ast.Name)
                and arg.id == msgvar
            ):
                new_msgvar = params[i]
                consumed_args.append(arg)
        if not new_payload and new_msgvar is None:
            return
        for arg in consumed_args:
            consume_expr(arg)
        self._consume(fn.body, new_msgvar, new_payload, tag, depth + 1)


# ---------------------------------------------------------------------------
# snapshot schema (save_shard_state writes vs restore reads)


def _snapshot_dict_keys(expr, mod, local_fns, encl, classifier) -> Set[str]:
    """String keys of the dict literal ``expr`` resolves to: a literal,
    a local name assigned one, or a call into a same-module function
    returning one."""

    def keys_of(d: ast.Dict) -> Set[str]:
        return {
            k.value
            for k in d.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)
        }

    if isinstance(expr, ast.Dict):
        return keys_of(expr)
    if isinstance(expr, ast.Name) and encl is not None:
        out: Set[str] = set()
        for e in classifier.fn_assigns(encl).get(expr.id, ()):
            if isinstance(e, ast.Dict):
                out |= keys_of(e)
        return out
    if isinstance(expr, ast.Call):
        fn = local_fns.get(astutil.call_last_name(expr))
        if fn is None:
            return set()
        out = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and isinstance(
                node.value, ast.Dict
            ):
                out |= keys_of(node.value)
            elif (
                isinstance(node, ast.Return)
                and isinstance(node.value, ast.Name)
            ):
                for e in classifier.fn_assigns(fn).get(
                    node.value.id, ()
                ):
                    if isinstance(e, ast.Dict):
                        out |= keys_of(e)
        return out
    return set()


def _extract_snapshot(model, mod, classifier) -> None:
    local_fns = {
        n.name: n
        for n in mod.nodes
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    for node in mod.nodes:
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_last_name(node)
        if name == "save_shard_state":
            state = astutil.get_arg(node, 1, "state")
            if state is None:
                continue
            encl = protocol._enclosing_function(node, mod.parents)
            for key in _snapshot_dict_keys(
                state, mod, local_fns, encl, classifier
            ):
                model.snapshot_writes.setdefault(key, _site(mod, node))
        elif name == "load_shard_state":
            parent = mod.parents.get(node)
            if not (
                isinstance(parent, ast.Assign)
                and len(parent.targets) == 1
                and isinstance(parent.targets[0], ast.Name)
            ):
                continue
            var = parent.targets[0].id
            encl = protocol._enclosing_function(node, mod.parents)
            scope = encl if encl is not None else mod.tree
            for sub in ast.walk(scope):
                if (
                    isinstance(sub, ast.Subscript)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == var
                    and isinstance(sub.slice, ast.Constant)
                    and isinstance(sub.slice.value, str)
                    and isinstance(sub.ctx, ast.Load)
                ):
                    model.snapshot_reads.setdefault(
                        sub.slice.value, _site(mod, sub)
                    )
                elif (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Attribute)
                    and sub.func.attr == "get"
                    and isinstance(sub.func.value, ast.Name)
                    and sub.func.value.id == var
                    and sub.args
                    and isinstance(sub.args[0], ast.Constant)
                    and isinstance(sub.args[0].value, str)
                ):
                    model.snapshot_reads.setdefault(
                        sub.args[0].value, _site(mod, sub)
                    )


# ---------------------------------------------------------------------------
# entry point


def build_schema(project) -> SchemaModel:
    graph = project.graph
    model = SchemaModel()
    class_names = {
        n.name
        for mod in project.modules
        for n in mod.nodes
        if isinstance(n, ast.ClassDef)
    }
    for mod in sorted(project.modules, key=lambda m: m.rel):
        info = graph.module_for_rel(mod.rel)
        if info is not None:
            for cname in sorted(info.constants):
                val = info.constants[cname]
                if (
                    _TAG_NAME_RE.match(cname)
                    and isinstance(val, int)
                    and not isinstance(val, bool)
                ):
                    model.tag_names.setdefault(val, cname)
        classifier = _Classifier(mod, info, class_names)
        # module_role tokenizes the whole source for comments — gate it
        # behind a cheap substring scan (the marker is a literal)
        is_role = any(
            "protocol-role[" in ln for ln in mod.source_lines
        ) and protocol.module_role(mod.source_lines) is not None
        _extract_senders(model, mod, graph, info, classifier, is_role)
        if is_role:
            _RecvExtractor(model, mod, graph, info).run()
        _extract_snapshot(model, mod, classifier)
    return model
