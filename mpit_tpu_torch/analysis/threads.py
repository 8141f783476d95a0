"""Whole-program concurrency model for the static linter (stdlib-only).

Built on the module graph (:mod:`mpit_tpu_torch.analysis.graph`): where the
graph answers *what does this name mean across modules*, this pass answers
*which thread runs this code and what locks does it hold* — the three
ingredients of every static race/deadlock rule:

1. **Thread-root discovery.** Every ``threading.Thread(target=...)`` /
   ``threading.Timer(..., fn)`` construction is a root; the target is
   resolved through the same alias/partial/pass-through chains the graph
   follows for callables, plus three shapes the graph alone can't see:
   ``self._method`` bound targets, nested-``def`` closures (the launch
   supervisor's ``_killer``, ``spawn_server_thread``'s ``run``), and
   methods reached through parameter type annotations
   (``def spawn_server_thread(server: PServer)``). Everything not
   reachable from a spawned root belongs to the synthetic ``main`` root.

2. **Shared-state inference.** ``self.`` attributes (identity: the class
   that owns them), module globals written through ``global``
   declarations, and closure variables of thread-spawning functions.
   An attribute/variable holding a synchronization primitive
   (``Lock``/``Event``/``Condition``/``Thread``/``make_lock``...) is the
   *protection*, not the protected — excluded from state tracking.

3. **Per-access locksets.** A DFS from each root walks ``with <lock>:``
   scopes (the MPT006 lock-name heuristic, with condition variables
   INCLUDED — ``with cond:`` acquires the condition's lock and protects
   state exactly like a lock; only the *blocking* rules exempt them) and
   carries the held set through the call graph — the generalisation of
   the one-level helper-wrapper taint :mod:`mpit_tpu_torch.analysis.protocol`
   applies to sends. Along the way it records lock-order edges
   (held → acquiring, for MPT014 cycles) and blocking calls made while a
   lock acquired in an *ancestor* frame is held (MPT015 — the
   cross-function escalation of the intraprocedural MPT006).

Lock identity is static, not per-instance: ``self._dst_lock(dst)`` is one
lock node even though every destination gets its own instance — the sound
direction for lockset consistency (instances of one role protect one
role's state), and the same collapsing RT101 documents for names.

Like every analysis module: scanned code is parsed, NEVER imported.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Optional

from mpit_tpu_torch.analysis import astutil

#: call-graph depth bound per root (also the recursion guard)
MAX_CALL_DEPTH = 12
#: virtual-dispatch fan-out bound when an annotated base class's method is
#: an abstract stub and the concrete overrides are walked instead
MAX_DISPATCH = 6

#: constructors whose result is a synchronization primitive (or a thread
#: handle): an attribute/variable initialized from one of these is the
#: protection mechanism itself, not shared data to protect
_SYNC_CONSTRUCTORS = {
    "Lock", "RLock", "Condition", "Event", "Semaphore", "BoundedSemaphore",
    "Barrier", "Thread", "Timer", "local",
    "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "make_lock", "make_condition",
}

#: sync constructors whose product is lock-like: entering it as a context
#: manager (or .acquire()) protects state
_LOCK_CONSTRUCTORS = {
    "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "make_lock", "make_condition",
}

#: method names that mutate their receiver in place — a call on a tracked
#: state expression counts as a write to it
_MUTATORS = {
    "append", "appendleft", "add", "remove", "discard", "pop", "popleft",
    "clear", "update", "extend", "insert", "setdefault", "sort", "reverse",
}

#: indefinitely-blocking call names (rules/locks.py's MPT006 set, plus the
#: sleep/subprocess names only a call-graph-deep rule can afford to flag —
#: intraprocedurally they are too common under short critical sections)
_BLOCKING = {
    "sendall", "connect", "create_connection", "accept", "recv", "irecv",
    "send", "isend", "wait", "join",
    "sleep", "communicate", "check_call", "check_output",
}
#: names blocking only with a fully-qualified prefix ("run" alone would
#: flag every worker loop; subprocess.run is the blocking one)
_BLOCKING_DOTTED = {"subprocess.run", "subprocess.check_call",
                    "subprocess.check_output"}
_SEND_MIN_ARGS = {"send": 1, "isend": 1}

_THREAD_CTORS = {"Thread": (1, "target"), "Timer": (1, "function")}


def _lockish(name: Optional[str]) -> bool:
    if not name:
        return False
    low = name.lower()
    return "lock" in low or "mutex" in low or "cond" in low


# ---------------------------------------------------------------------------
# data model


@dataclasses.dataclass(frozen=True)
class StateKey:
    """Identity of one piece of tracked state (or one static lock).

    kind: ``attr`` (owner = defining class, dotted), ``global`` (owner =
    module) or ``local`` (owner = the closure-owning function)."""

    kind: str
    owner: str
    name: str

    def label(self) -> str:
        return f"{self.owner}.{self.name}"

    def short(self) -> str:
        return f"{self.owner.rsplit('.', 1)[-1]}.{self.name}"


@dataclasses.dataclass
class Access:
    state: StateKey
    write: bool
    root: str
    lockset: frozenset  # of StateKey lock ids
    init: bool  # __init__/pre-spawn setup phase — exempt from race pairing
    const_write: bool  # ``x = <literal>`` — the GIL-atomic stop-flag idiom
    mod: object  # ModuleCtx
    node: ast.AST


@dataclasses.dataclass
class LockEdge:
    held: StateKey
    acquired: StateKey
    root: str
    mod: object
    node: ast.AST
    symbol: str


@dataclasses.dataclass
class BlockingSite:
    call: str
    lockset: frozenset  # effective held set (receiver cond excluded)
    cross_locks: frozenset  # held locks acquired in an ANCESTOR frame
    root: str
    mod: object
    node: ast.AST


@dataclasses.dataclass
class ThreadRoot:
    name: str  # thread name= literal when present, else target qualname
    target_desc: str
    mod: object  # ModuleCtx of the spawn site
    node: ast.AST  # the Thread(...) call
    resolved: bool


@dataclasses.dataclass
class _ClassInfo:
    key: str  # absolute dotted "pkg.mod.Class"
    name: str
    mod: object  # ModuleCtx
    node: ast.ClassDef
    methods: dict  # name -> FunctionDef
    bases: list = dataclasses.field(default_factory=list)  # resolved keys
    attr_types: dict = dataclasses.field(default_factory=dict)
    sync_attrs: set = dataclasses.field(default_factory=set)
    # the subset of sync_attrs that are lock-LIKE (usable as ``with x:``
    # protection): self._cv = threading.Condition() guards state even
    # though nothing in the attr name says so
    lock_attrs: set = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class _ClosureInfo:
    owner: str  # dotted qualname of the spawning function
    names: set  # names shared between the owner's scope and nested defs
    spawn_line: int  # first Thread() construction in the owner's own body
    sync_names: set  # closure names bound to sync constructors


class ThreadModel:
    """The whole-program concurrency map the MPT013–015 rules consume."""

    def __init__(self, roots, accesses, edges, blocking):
        self.roots: list = roots
        self.accesses: list = accesses
        self.edges: list = edges
        self.blocking: list = blocking

    # -- aggregation ------------------------------------------------------

    def state_map(self) -> dict:
        """state -> root -> {reads, writes, locksets, example accesses}."""
        out: dict = {}
        for a in self.accesses:
            if a.init:
                continue
            per_root = out.setdefault(a.state, {})
            entry = per_root.setdefault(
                a.root,
                {"reads": 0, "writes": 0, "locksets": set(),
                 "write_locksets": set(), "example": a,
                 "write_example": None, "all_const_writes": True},
            )
            entry["reads" if not a.write else "writes"] += 1
            entry["locksets"].add(a.lockset)
            if a.write:
                entry["write_locksets"].add(a.lockset)
                if not a.const_write:
                    entry["all_const_writes"] = False
                if entry["write_example"] is None or (
                    not a.lockset and entry["write_example"].lockset
                ):
                    entry["write_example"] = a
        return out

    def shared_state(self, min_roots: int = 2) -> dict:
        return {
            state: per_root
            for state, per_root in self.state_map().items()
            if len(per_root) >= min_roots
        }

    def owner_state(self, owner_suffix: str) -> dict:
        """Every tracked state of one owner (class/module), shared or not
        — the threading-model doc's per-subsystem enumeration."""
        return {
            state: per_root
            for state, per_root in self.state_map().items()
            if state.owner.endswith(owner_suffix)
        }

    def lock_cycles(self) -> list:
        """Simple cycles in the static lock-order graph, deduplicated by
        node set; each as (cycle_nodes, example_edges)."""
        graph: dict = {}
        edge_by_pair: dict = {}
        for e in self.edges:
            if e.held == e.acquired:
                continue  # reentrant/per-instance aliasing, not an order
            graph.setdefault(e.held, set()).add(e.acquired)
            edge_by_pair.setdefault((e.held, e.acquired), e)
        cycles: list = []
        seen_sets: set = set()
        for start in graph:
            stack = [(start, [start])]
            while stack:
                node, path = stack.pop()
                for nxt in graph.get(node, ()):
                    if nxt == start and len(path) > 1:
                        key = frozenset(path)
                        if key not in seen_sets:
                            seen_sets.add(key)
                            pairs = list(zip(path, path[1:] + [start]))
                            cycles.append(
                                (path, [edge_by_pair[p] for p in pairs])
                            )
                    elif nxt not in path:
                        stack.append((nxt, path + [nxt]))
        return cycles

    # -- serialization ----------------------------------------------------

    def to_json(self) -> dict:
        roots = [
            {
                "name": r.name,
                "target": r.target_desc,
                "spawned_at": f"{r.mod.rel}:{r.node.lineno}",
                "resolved": r.resolved,
            }
            for r in sorted(self.roots, key=lambda r: r.name)
        ]
        shared = []
        for state, per_root in sorted(
            self.shared_state().items(), key=lambda kv: kv[0].label()
        ):
            shared.append({
                "state": state.label(),
                "kind": state.kind,
                "roots": {
                    root: {
                        "reads": e["reads"],
                        "writes": e["writes"],
                        "locksets": sorted(
                            sorted(l.short() for l in ls)
                            for ls in e["locksets"]
                        ),
                    }
                    for root, e in sorted(per_root.items())
                },
            })
        return {
            "roots": roots,
            "shared_state": shared,
            "lock_edges": sorted({
                f"{e.held.short()} -> {e.acquired.short()}"
                for e in self.edges if e.held != e.acquired
            }),
        }


# ---------------------------------------------------------------------------
# scopes


@dataclasses.dataclass
class _Scope:
    fn: ast.AST  # FunctionDef
    mod: object  # ModuleCtx
    info: object  # ModuleInfo (graph)
    self_class: Optional[str]
    types: dict  # local name -> class key
    aliases: dict  # local name -> simple assigned expr (lock aliasing)
    globals_: set  # names declared ``global`` in this function
    assigned: set  # names stored anywhere in this function's own scope
    nonlocals: set
    closure: Optional[_ClosureInfo]
    closure_is_owner: bool  # walking the spawning function itself?
    nested: dict  # name -> nested FunctionDef


@dataclasses.dataclass
class _Frame:
    """One call-graph frame's walk state (lockset is carried, not copied
    per statement: With scopes push/pop)."""

    scope: _Scope
    root: str
    init: bool
    depth: int  # call-graph depth (frame index)


class _Analyzer:
    def __init__(self, project):
        self.project = project
        self.graph = project.graph
        self.modules = list(project.modules)
        self.classes: dict = {}  # key -> _ClassInfo
        self.class_local: dict = {}  # mod.rel -> {local name: key}
        self.subclasses: dict = {}  # key -> [subclass keys]
        self.global_written: dict = {}  # mod.rel -> set of global names
        self.roots: list = []
        self.accesses: list = []
        self.edges: list = []
        self.blocking: list = []
        self._root_entries: list = []  # (root_name, callee-tuple)
        self._closures: dict = {}  # id(owner fn) -> _ClosureInfo
        self._root_reached: set = set()  # id(fn) reached from spawned roots
        self._memo: set = set()
        self._fn_prescan: dict = {}  # id(fn) -> (assigned, globals, nonlocals, nested)
        self._init_only: set = set()  # id(fn) reachable ONLY from __init__

    # -- indexing ---------------------------------------------------------

    def _info(self, mod):
        return self.graph.module_for_rel(mod.rel)

    def build_index(self) -> None:
        for mod in self.modules:
            info = self._info(mod)
            if info is None:
                continue
            local: dict = {}
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef):
                    methods = {
                        n.name: n
                        for n in node.body
                        if isinstance(
                            n, (ast.FunctionDef, ast.AsyncFunctionDef)
                        )
                    }
                    key = f"{info.name}.{node.name}"
                    self.classes[key] = _ClassInfo(
                        key=key, name=node.name, mod=mod, node=node,
                        methods=methods,
                    )
                    local[node.name] = key
            self.class_local[mod.rel] = local
            written = set()
            for node in mod.nodes:
                if isinstance(node, ast.Global):
                    written.update(node.names)
            self.global_written[mod.rel] = written
        self._compute_init_only()
        # second pass: bases and attribute types need the full class table
        for ci in self.classes.values():
            info = self._info(ci.mod)
            for base in ci.node.bases:
                dotted = astutil.dotted_name(base)
                key = self._resolve_class(info, dotted) if dotted else None
                if key is not None:
                    ci.bases.append(key)
                    self.subclasses.setdefault(key, []).append(ci.key)
            self._scan_attr_types(ci, info)

    def _compute_init_only(self) -> None:
        """Functions whose every (name-matched) call site sits inside
        construction code are init-phase: ``PServer._restore_shard`` and
        the ``load_state`` helpers run strictly before the server thread
        exists. Name-matched = conservative: a same-named method called
        anywhere in steady state keeps the whole name steady-state."""
        call_sites: dict = {}  # callee last-name -> [caller fn id or None]
        all_fns: dict = {}  # id -> fn
        for mod in self.modules:
            for node in mod.nodes:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    all_fns[id(node)] = node
                    continue
                if not isinstance(node, ast.Call):
                    continue
                name = astutil.call_last_name(node)
                if not name:
                    continue
                cur = mod.parents.get(node)
                while cur is not None and not isinstance(
                    cur, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    cur = mod.parents.get(cur)
                call_sites.setdefault(name, []).append(
                    id(cur) if cur is not None else None
                )
        init_ids = {
            fid for fid, fn in all_fns.items()
            if fn.name in ("__init__", "__post_init__")
        }
        changed = True
        while changed:
            changed = False
            for fid, fn in all_fns.items():
                if fid in init_ids:
                    continue
                callers = call_sites.get(fn.name)
                if callers and all(
                    c is not None and c in init_ids for c in callers
                ):
                    init_ids.add(fid)
                    changed = True
        self._init_only = init_ids

    def _scan_attr_types(self, ci: _ClassInfo, info) -> None:
        for mname, fn in ci.methods.items():
            ann_types = self._param_types(fn, info)
            for node in ast.walk(fn):
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and isinstance(node.targets[0].value, ast.Name)
                    and node.targets[0].value.id == "self"
                ):
                    continue
                attr = node.targets[0].attr
                val = node.value
                # ``x if cond else Ctor()``: either arm types the attr
                vals = (
                    [val.body, val.orelse] if isinstance(val, ast.IfExp)
                    else [val]
                )
                for v in vals:
                    if isinstance(v, ast.Call):
                        last = astutil.call_last_name(v)
                        if last in _SYNC_CONSTRUCTORS:
                            ci.sync_attrs.add(attr)
                            if last in _LOCK_CONSTRUCTORS:
                                ci.lock_attrs.add(attr)
                            break
                        dotted = astutil.dotted_name(v.func)
                        key = (
                            self._resolve_class(info, dotted)
                            if dotted else None
                        )
                        if key is not None:
                            ci.attr_types.setdefault(attr, key)
                    elif isinstance(v, ast.Name) and v.id in ann_types:
                        ci.attr_types.setdefault(attr, ann_types[v.id])

    def _param_types(self, fn, info) -> dict:
        out: dict = {}
        args = list(fn.args.posonlyargs) + list(fn.args.args) + list(
            fn.args.kwonlyargs
        )
        for a in args:
            if a.annotation is None:
                continue
            ann = a.annotation
            dotted = None
            if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
                dotted = ann.value  # forward reference
            else:
                dotted = astutil.dotted_name(ann)
            if dotted:
                key = self._resolve_class(info, dotted)
                if key is not None:
                    out[a.arg] = key
        return out

    def _resolve_class(self, info, dotted: Optional[str]) -> Optional[str]:
        if info is None or not dotted:
            return None
        parts = dotted.split(".")
        local = self.class_local.get(info.rel, {})
        if len(parts) == 1 and parts[0] in local:
            return local[parts[0]]
        head = parts[0]
        if head in info.imports:
            target = info.imports[head]
            rest = ".".join(parts[1:])
            return self._resolve_class_abs(
                f"{target}.{rest}" if rest else target
            )
        if len(parts) > 1:
            return self._resolve_class_abs(dotted)
        return None

    def _resolve_class_abs(
        self, dotted: str, depth: int = 0
    ) -> Optional[str]:
        if depth > 8:
            return None
        if dotted in self.classes:
            return dotted
        parts = dotted.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            modname = ".".join(parts[:cut])
            mod = self.graph.by_name.get(modname)
            if mod is None:
                continue
            rest = parts[cut:]
            if len(rest) != 1:
                return None
            name = rest[0]
            key = f"{modname}.{name}"
            if key in self.classes:
                return key
            if name in mod.imports:  # package __init__ re-export
                return self._resolve_class_abs(mod.imports[name], depth + 1)
            return None
        return None

    def _find_method(self, key: str, name: str, depth: int = 0):
        """(defining-ish class key, FunctionDef) through the base chain."""
        if depth > 6:
            return None
        ci = self.classes.get(key)
        if ci is None:
            return None
        if name in ci.methods:
            return key, ci.methods[name]
        for base in ci.bases:
            hit = self._find_method(base, name, depth + 1)
            if hit is not None:
                return hit
        return None

    def _all_subclasses(self, key: str) -> list:
        out, frontier = [], list(self.subclasses.get(key, ()))
        while frontier and len(out) < MAX_DISPATCH:
            k = frontier.pop()
            if k in out:
                continue
            out.append(k)
            frontier.extend(self.subclasses.get(k, ()))
        return out

    @staticmethod
    def _is_stub(fn) -> bool:
        body = fn.body
        if body and isinstance(body[0], ast.Expr) and isinstance(
            body[0].value, ast.Constant
        ):
            body = body[1:]  # docstring
        return all(
            isinstance(s, (ast.Raise, ast.Pass))
            or (
                isinstance(s, ast.Expr)
                and isinstance(s.value, ast.Constant)
                and s.value.value is Ellipsis
            )
            for s in body
        ) if body else True

    def _dispatch(self, key: str, mname: str) -> list:
        """Concrete (class key, fn) targets for ``obj.m()`` where obj has
        static class ``key`` — subclass overrides when the statically
        found method is an abstract stub (the Transport pattern)."""
        hit = self._find_method(key, mname)
        if hit is not None and not self._is_stub(hit[1]):
            return [(key, hit[1])]
        out = []
        for sub in self._all_subclasses(key):
            sci = self.classes.get(sub)
            if sci and mname in sci.methods and not self._is_stub(
                sci.methods[mname]
            ):
                out.append((sub, sci.methods[mname]))
        if not out and hit is not None:
            out.append((key, hit[1]))
        return out[:MAX_DISPATCH]

    # -- function prescan --------------------------------------------------

    def _prescan(self, fn):
        cached = self._fn_prescan.get(id(fn))
        if cached is not None:
            return cached
        assigned: set = set()
        globals_: set = set()
        nonlocals: set = set()
        nested: dict = {}
        aliases: dict = {}

        def scan(body):
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    nested[node.name] = node
                    assigned.add(node.name)
                    continue
                if isinstance(node, ast.ClassDef):
                    assigned.add(node.name)
                    continue
                if isinstance(node, ast.Global):
                    globals_.update(node.names)
                elif isinstance(node, ast.Nonlocal):
                    nonlocals.update(node.names)
                for sub in ast.walk(node):
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef,
                                        ast.ClassDef)):
                        # compound statements re-enter via scan(); walk
                        # from a stmt can still reach a def nested in an
                        # if/for body — record, don't descend further
                        nested.setdefault(sub.name, sub)
                        assigned.add(sub.name)
                    elif isinstance(sub, ast.Name) and isinstance(
                        sub.ctx, (ast.Store, ast.Del)
                    ):
                        assigned.add(sub.id)
                    elif isinstance(sub, ast.Assign) and len(
                        sub.targets
                    ) == 1 and isinstance(sub.targets[0], ast.Name):
                        aliases.setdefault(sub.targets[0].id, sub.value)

        scan(fn.body)
        for a in (
            list(fn.args.posonlyargs) + list(fn.args.args)
            + list(fn.args.kwonlyargs)
            + ([fn.args.vararg] if fn.args.vararg else [])
            + ([fn.args.kwarg] if fn.args.kwarg else [])
        ):
            assigned.add(a.arg)
        out = (assigned, globals_, nonlocals, nested, aliases)
        self._fn_prescan[id(fn)] = out
        return out

    def _make_scope(
        self, fn, mod, self_class, closure, closure_is_owner,
        inherited_types=None,
    ) -> _Scope:
        info = self._info(mod)
        assigned, globals_, nonlocals, nested, aliases = self._prescan(fn)
        types = dict(inherited_types or {})
        types.update(self._param_types(fn, info))
        if self_class is not None:
            types["self"] = self_class
        # local constructor calls type locals: ``broker = Broker(n)``
        for name, expr in aliases.items():
            if isinstance(expr, ast.Call):
                dotted = astutil.dotted_name(expr.func)
                key = self._resolve_class(info, dotted) if dotted else None
                if key is not None:
                    types.setdefault(name, key)
        return _Scope(
            fn=fn, mod=mod, info=info, self_class=self_class,
            types=types, aliases=aliases, globals_=globals_,
            assigned=assigned, nonlocals=nonlocals, closure=closure,
            closure_is_owner=closure_is_owner, nested=nested,
        )

    # -- thread-root discovery ---------------------------------------------

    def discover_roots(self) -> None:
        for mod in self.modules:
            info = self._info(mod)
            for node in mod.nodes:
                if not isinstance(node, ast.Call):
                    continue
                last = astutil.call_last_name(node)
                if last not in _THREAD_CTORS:
                    continue
                dotted = astutil.dotted_name(node.func)
                if dotted is not None and "." in dotted and not (
                    dotted.startswith("threading.")
                ):
                    continue  # some other Thread-named constructor
                pos, kw = _THREAD_CTORS[last]
                target = astutil.get_arg(node, pos, kw)
                if target is None:
                    continue
                self._register_root(mod, info, node, target)

    def _thread_name(self, node: ast.Call) -> Optional[str]:
        arg = astutil.get_arg(node, 2, "name")
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value
        return None

    def _enclosing_fn_chain(self, mod, node) -> list:
        """Innermost-first FunctionDefs (and the enclosing ClassDef, last)
        containing ``node``."""
        chain = []
        cur = mod.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                chain.append(cur)
            cur = mod.parents.get(cur)
        return chain

    def _register_root(self, mod, info, node, target) -> None:
        chain = self._enclosing_fn_chain(mod, node)
        fns = [c for c in chain if isinstance(
            c, (ast.FunctionDef, ast.AsyncFunctionDef))]
        cls = next((c for c in chain if isinstance(c, ast.ClassDef)), None)
        cls_key = (
            self.class_local.get(mod.rel, {}).get(cls.name) if cls else None
        )
        name = self._thread_name(node)
        desc = astutil.dotted_name(target) or "<expr>"
        entry = None  # (fn, mod, self_class, closure, inherited_types)

        if (
            isinstance(target, ast.Attribute)
            and isinstance(target.value, ast.Name)
        ):
            base = target.value.id
            recv_key = None
            if base == "self" and cls_key is not None:
                recv_key = cls_key
            else:
                # a typed local/param: spawn_server_thread-style
                for fn in fns:
                    sc_types = self._param_types(fn, info)
                    if base in sc_types:
                        recv_key = sc_types[base]
                        break
            if recv_key is not None:
                for tkey, tfn in self._dispatch(recv_key, target.attr):
                    entry = (tfn, self.classes[tkey].mod, tkey, None, None)
                    break
                desc = f"{recv_key.rsplit('.', 1)[-1]}.{target.attr}"
        elif isinstance(target, ast.Name):
            # nearest enclosing function defining it as a nested def
            for depth_i, fn in enumerate(fns):
                _, _, _, nested, _ = self._prescan(fn)
                if target.id in nested:
                    closure = self._closure_for(fn, mod, fns[depth_i + 1:])
                    inherited = self._make_scope(
                        fn, mod,
                        cls_key if fn is fns[-1] and cls else None,
                        None, False,
                    ).types
                    entry = (nested[target.id], mod, None, closure,
                             inherited)
                    desc = f"{fn.name}.<{target.id}>"
                    break
            if entry is None:
                ci = self.graph.resolve_callable(info, target)
                if ci is not None:
                    cmod = self._ctx_for_info(ci.module)
                    if cmod is not None:
                        entry = (ci.fn, cmod, None, None, None)
                        desc = f"{ci.module.name}.{ci.fn.name}"
        else:
            ci = self.graph.resolve_callable(info, target)
            if ci is not None:
                cmod = self._ctx_for_info(ci.module)
                if cmod is not None:
                    entry = (ci.fn, cmod, None, None, None)
                    desc = f"{ci.module.name}.{ci.fn.name}"

        root_name = name or desc
        self.roots.append(ThreadRoot(
            name=root_name, target_desc=desc, mod=mod, node=node,
            resolved=entry is not None,
        ))
        if entry is not None:
            self._root_entries.append((root_name, entry))

    def _ctx_for_info(self, info):
        for m in self.modules:
            if m.rel == info.rel:
                return m
        return None

    def _closure_for(self, owner_fn, mod, outer_fns) -> _ClosureInfo:
        ci = self._closures.get(id(owner_fn))
        if ci is not None:
            return ci
        info = self._info(mod)
        owner_assigned, _, _, nested, aliases = self._prescan(owner_fn)
        referenced: set = set()
        for nfn in nested.values():
            n_assigned, _, n_nonlocals, _, _ = self._prescan(nfn)
            for sub in ast.walk(nfn):
                if isinstance(sub, ast.Name):
                    if sub.id in n_assigned and sub.id not in n_nonlocals:
                        continue  # the nested def's own local
                    referenced.add(sub.id)
        shared = owner_assigned & referenced
        sync_names = {
            n for n in shared
            if isinstance(aliases.get(n), ast.Call)
            and astutil.call_last_name(aliases[n]) in _SYNC_CONSTRUCTORS
        }
        # first Thread construction in the owner's own body (nested defs
        # excluded): assignments before it are pre-spawn setup — the
        # closure equivalent of the __init__ exemption
        spawn_line = 10 ** 9
        for node in ast.walk(owner_fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node is not owner_fn:
                    continue
            if isinstance(node, ast.Call) and astutil.call_last_name(
                node
            ) in _THREAD_CTORS:
                chain = []
                # cheap containment check: is this call inside a nested def?
                pass
        spawn_line = self._first_spawn_line(owner_fn, nested)
        qual = f"{info.name}.{owner_fn.name}" if info else owner_fn.name
        ci = _ClosureInfo(
            owner=qual, names=shared - sync_names, spawn_line=spawn_line,
            sync_names=sync_names,
        )
        self._closures[id(owner_fn)] = ci
        return ci

    @staticmethod
    def _first_spawn_line(owner_fn, nested) -> int:
        nested_ids = {id(n) for n in nested.values()}
        first = 10 ** 9

        def walk(node):
            nonlocal first
            for child in ast.iter_child_nodes(node):
                if id(child) in nested_ids:
                    continue
                if isinstance(child, ast.Call) and astutil.call_last_name(
                    child
                ) in _THREAD_CTORS:
                    first = min(first, child.lineno)
                walk(child)

        walk(owner_fn)
        return first

    # -- traversal ---------------------------------------------------------

    def run(self) -> ThreadModel:
        self.build_index()
        self.discover_roots()
        for root_name, entry in self._root_entries:
            self._walk_entry(root_name, entry, init=False,
                             record_reach=True)
        # everything not reachable from a spawned root runs on the main
        # thread (or a thread this pass cannot see — same conservative
        # bucket); __init__ bodies are construction, not steady state
        for mod in self.modules:
            info = self._info(mod)
            if info is None:
                continue
            for fn in info.functions.values():
                if id(fn) in self._root_reached:
                    continue
                closure = self._closures.get(id(fn))
                self._walk_entry(
                    "main", (fn, mod, None, closure, None),
                    init=id(fn) in self._init_only, record_reach=False,
                    closure_is_owner=closure is not None,
                )
            for cls_key in self.class_local.get(mod.rel, {}).values():
                ci = self.classes[cls_key]
                for mname, mfn in ci.methods.items():
                    if id(mfn) in self._root_reached:
                        continue
                    closure = self._closures.get(id(mfn))
                    self._walk_entry(
                        "main", (mfn, mod, cls_key, closure, None),
                        init=(
                            mname in ("__init__", "__post_init__")
                            or id(mfn) in self._init_only
                        ),
                        record_reach=False,
                        closure_is_owner=closure is not None,
                    )
        return ThreadModel(
            self.roots, self.accesses, self.edges, self.blocking
        )

    def _walk_entry(
        self, root, entry, init, record_reach, closure_is_owner=False
    ) -> None:
        fn, mod, self_class, closure, inherited = entry
        self._walk_fn(
            fn, mod, self_class, closure, closure_is_owner, inherited,
            root=root, lockset={}, init=init, depth=0,
            record_reach=record_reach,
        )

    def _walk_fn(
        self, fn, mod, self_class, closure, closure_is_owner, inherited,
        root, lockset, init, depth, record_reach,
    ) -> None:
        if depth > MAX_CALL_DEPTH:
            return
        key = (id(fn), self_class, root, frozenset(lockset), init)
        if key in self._memo:
            return
        self._memo.add(key)
        if record_reach:
            self._root_reached.add(id(fn))
        scope = self._make_scope(
            fn, mod, self_class, closure, closure_is_owner, inherited
        )
        frame = _Frame(scope=scope, root=root, init=init, depth=depth)
        self._walk_body(
            fn.body, frame, dict(lockset), record_reach
        )

    # lockset is a dict lock-id -> frame-depth-at-acquisition

    def _walk_body(self, body, frame, lockset, record_reach) -> None:
        for stmt in body:
            self._walk_stmt(stmt, frame, lockset, record_reach)

    def _walk_stmt(self, stmt, frame, lockset, record_reach) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # analyzed when called / as a thread target
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in stmt.items:
                self._scan_expr(item.context_expr, frame, lockset,
                                record_reach)
                lid = self._lock_id(item.context_expr, frame.scope)
                if lid is not None and lid not in lockset:
                    for held in lockset:
                        self._record_edge(held, lid, frame, stmt)
                    lockset[lid] = frame.depth
                    acquired.append(lid)
            self._walk_body(stmt.body, frame, lockset, record_reach)
            for lid in acquired:
                del lockset[lid]
            return
        if isinstance(stmt, (ast.If, ast.For, ast.AsyncFor, ast.While)):
            for expr in ast.iter_child_nodes(stmt):
                if not isinstance(expr, ast.stmt):
                    self._scan_expr(expr, frame, lockset, record_reach)
            for sub in getattr(stmt, "body", ()):
                self._walk_stmt(sub, frame, lockset, record_reach)
            for sub in getattr(stmt, "orelse", ()):
                self._walk_stmt(sub, frame, lockset, record_reach)
            return
        if isinstance(stmt, ast.Try):
            for part in (stmt.body, stmt.orelse, stmt.finalbody):
                self._walk_body(part, frame, lockset, record_reach)
            for h in stmt.handlers:
                self._walk_body(h.body, frame, lockset, record_reach)
            return
        if isinstance(stmt, ast.Assign):
            const = isinstance(stmt.value, ast.Constant)
            for tgt in stmt.targets:
                self._record_store(tgt, frame, lockset, const)
            self._scan_expr(stmt.value, frame, lockset, record_reach)
            return
        if isinstance(stmt, ast.AugAssign):
            self._record_store(stmt.target, frame, lockset, False)
            self._scan_expr(stmt.value, frame, lockset, record_reach)
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._record_store(
                    stmt.target, frame, lockset,
                    isinstance(stmt.value, ast.Constant),
                )
                self._scan_expr(stmt.value, frame, lockset, record_reach)
            return
        if isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                self._record_store(tgt, frame, lockset, False)
            return
        # Return/Expr/Raise/Assert/...: scan contained expressions
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                self._walk_stmt(child, frame, lockset, record_reach)
            else:
                self._scan_expr(child, frame, lockset, record_reach)

    # -- expression scan ---------------------------------------------------

    def _scan_expr(self, expr, frame, lockset, record_reach) -> None:
        stack = [expr]
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                continue
            if isinstance(node, ast.Call):
                self._handle_call(node, frame, lockset, record_reach)
                stack.extend(ast.iter_child_nodes(node))
                continue
            if isinstance(node, ast.Attribute):
                state = self._state_of(node, frame.scope)
                if state is not None:
                    self._record(
                        state,
                        isinstance(node.ctx, (ast.Store, ast.Del)),
                        frame, lockset, node, const=False,
                    )
                stack.append(node.value)
                continue
            if isinstance(node, ast.Name):
                state = self._state_of(node, frame.scope)
                if state is not None:
                    self._record(
                        state,
                        isinstance(node.ctx, (ast.Store, ast.Del)),
                        frame, lockset, node, const=False,
                    )
                continue
            stack.extend(ast.iter_child_nodes(node))

    def _record_store(self, target, frame, lockset, const) -> None:
        if isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._record_store(el, frame, lockset, const)
            return
        if isinstance(target, ast.Starred):
            self._record_store(target.value, frame, lockset, const)
            return
        if isinstance(target, ast.Subscript):
            # a[k] = v mutates a: the container write the lockset rules
            # care about (const exemption never applies to item stores)
            base = target.value
            while isinstance(base, ast.Subscript):
                base = base.value
            state = self._state_of(base, frame.scope)
            if state is not None:
                self._record(state, True, frame, lockset, target, False)
            self._scan_expr(target.slice, frame, lockset, False)
            return
        state = self._state_of(target, frame.scope)
        if state is not None:
            self._record(state, True, frame, lockset, target, const)
        elif isinstance(target, ast.Attribute):
            self._scan_expr(target.value, frame, lockset, False)

    def _record(self, state, write, frame, lockset, node, const) -> None:
        self.accesses.append(Access(
            state=state, write=write, root=frame.root,
            lockset=frozenset(lockset),
            init=frame.init or self._is_presetup(frame, node),
            const_write=const and write,
            mod=frame.scope.mod, node=node,
        ))

    @staticmethod
    def _is_presetup(frame, node) -> bool:
        """Closure-owner writes before the first thread spawn are setup."""
        sc = frame.scope
        return (
            sc.closure is not None
            and sc.closure_is_owner
            and getattr(node, "lineno", 0) < sc.closure.spawn_line
        )

    def _record_edge(self, held, acquired, frame, node) -> None:
        if held == acquired:
            return
        self.edges.append(LockEdge(
            held=held, acquired=acquired, root=frame.root,
            mod=frame.scope.mod, node=node,
            symbol=astutil.enclosing_symbol(node, frame.scope.mod.parents),
        ))

    # -- state / lock identity ---------------------------------------------

    def _receiver_class(self, expr, scope) -> Optional[str]:
        if isinstance(expr, ast.Name):
            return scope.types.get(expr.id)
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
        ):
            base_cls = scope.types.get(expr.value.id)
            if base_cls is not None:
                ci = self.classes.get(base_cls)
                if ci is not None:
                    return ci.attr_types.get(expr.attr)
        return None

    def _state_of(self, expr, scope) -> Optional[StateKey]:
        if isinstance(expr, ast.Attribute):
            recv = expr.value
            if isinstance(recv, ast.Subscript):
                recv = recv.value
            cls = self._receiver_class(recv, scope)
            if cls is None:
                return None
            ci = self.classes.get(cls)
            if ci is None:
                return None
            attr = expr.attr
            if (
                _lockish(attr)
                or attr in ci.sync_attrs
                or attr in ci.methods
            ):
                return None
            return StateKey("attr", cls, attr)
        if isinstance(expr, ast.Name):
            name = expr.id
            if _lockish(name):
                return None
            sc = scope
            if sc.closure is not None and name in sc.closure.names:
                if sc.closure_is_owner or (
                    name not in sc.assigned or name in sc.nonlocals
                ):
                    return StateKey("local", sc.closure.owner, name)
            if name in sc.globals_ or (
                isinstance(expr.ctx, ast.Load)
                and sc.info is not None
                and name in self.global_written.get(sc.mod.rel, ())
            ):
                if sc.info is not None:
                    return StateKey("global", sc.info.name, name)
            return None
        return None

    def _lock_id(
        self, expr, scope, depth: int = 0
    ) -> Optional[StateKey]:
        if depth > 4:
            return None
        cur = expr
        if isinstance(cur, ast.Call):
            cur = cur.func  # self._dst_lock(dst)
        if isinstance(cur, ast.Subscript):
            cur = cur.value  # self._conds[i]
        if isinstance(cur, ast.Attribute):
            recv = cur.value
            if isinstance(recv, ast.Subscript):
                recv = recv.value
            cls = self._receiver_class(recv, scope)
            if cls is not None:
                ci = self.classes.get(cls)
                if _lockish(cur.attr) or (
                    ci is not None and cur.attr in ci.lock_attrs
                ):
                    return StateKey("attr", cls, cur.attr)
            if not _lockish(cur.attr):
                return None
            dotted = astutil.dotted_name(cur)
            if dotted is not None and scope.info is not None:
                # module-attribute lock: mod._lock
                r = self.graph.resolve(scope.info, dotted)
                if r is not None and r.module is not None:
                    return StateKey("global", r.module.name, cur.attr)
            if isinstance(cur.value, ast.Name) and cur.value.id == "self":
                owner = scope.self_class or (
                    scope.info.name if scope.info else scope.mod.rel
                )
                return StateKey("attr", owner, cur.attr)
            return None
        if isinstance(cur, ast.Name):
            name = cur.id
            aliased = scope.aliases.get(name)
            if (
                aliased is not None
                and not isinstance(aliased, ast.Name)
                # a constructor call IS the lock: the local name is its
                # identity — following the alias would collapse every
                # ``x = make_lock(...)`` local onto the factory's name
                and not (
                    isinstance(aliased, ast.Call)
                    and astutil.call_last_name(aliased)
                    in _LOCK_CONSTRUCTORS
                )
            ):
                via = self._lock_id(aliased, scope, depth + 1)
                if via is not None:
                    return via
            if not _lockish(name):
                return None
            sc = scope
            if sc.closure is not None and (
                name in sc.closure.names or name in sc.closure.sync_names
            ):
                return StateKey("local", sc.closure.owner, name)
            if sc.info is not None and (
                name in sc.globals_
                or name in sc.info.assigns
                or name in sc.info.constants
            ):
                return StateKey("global", sc.info.name, name)
            owner = f"{sc.info.name}.{sc.fn.name}" if sc.info else sc.fn.name
            return StateKey("local", owner, name)
        return None

    # -- calls -------------------------------------------------------------

    def _handle_call(self, call, frame, lockset, record_reach) -> None:
        name = astutil.call_last_name(call)
        scope = frame.scope
        # explicit .acquire(): an order edge even without a with-scope
        if name == "acquire" and isinstance(call.func, ast.Attribute):
            lid = self._lock_id(call.func.value, scope)
            if lid is not None:
                for held in lockset:
                    self._record_edge(held, lid, frame, call)
        # blocking call while holding a lock acquired in an ancestor frame
        if lockset and (
            name in _BLOCKING
            or (astutil.dotted_name(call.func) in _BLOCKING_DOTTED)
        ):
            self._check_blocking(call, name, frame, lockset)
        # mutating method on tracked state — unless the receiver's class
        # defines the method itself (FaultLog.append locks internally;
        # _descend walks the real body instead of guessing)
        if (
            name in _MUTATORS
            and isinstance(call.func, ast.Attribute)
        ):
            recv = call.func.value
            recv_cls = self._receiver_class(
                recv.value if isinstance(recv, ast.Subscript) else recv,
                scope,
            )
            if recv_cls is None or self._find_method(
                recv_cls, name
            ) is None:
                state = self._state_of(recv, scope)
                if state is None and isinstance(recv, ast.Subscript):
                    state = self._state_of(recv.value, scope)
                if state is not None:
                    self._record(state, True, frame, lockset, call, False)
        # descend into resolvable callees
        self._descend(call, frame, lockset, record_reach)

    def _check_blocking(self, call, name, frame, lockset) -> None:
        if name in _SEND_MIN_ARGS and (
            len(call.args) + len(call.keywords) < _SEND_MIN_ARGS[name]
        ):
            return
        if name == "join" and len(call.args) == 1:
            return  # "sep".join(parts)
        effective = dict(lockset)
        if name == "wait" and isinstance(call.func, ast.Attribute):
            # cond.wait() releases cond itself; only OTHER held locks are
            # held across the sleep
            recv = self._lock_id(call.func.value, frame.scope)
            if recv is not None:
                effective.pop(recv, None)
        if not effective:
            return
        cross = frozenset(
            l for l, d in effective.items() if d < frame.depth
        )
        if not cross:
            return  # same-frame: MPT006's intraprocedural jurisdiction
        self.blocking.append(BlockingSite(
            call=name, lockset=frozenset(effective), cross_locks=cross,
            root=frame.root, mod=frame.scope.mod, node=call,
        ))

    def _descend(self, call, frame, lockset, record_reach) -> None:
        scope = frame.scope
        func = call.func
        targets = []  # (fn, mod, self_class, closure, inherited_types)
        if isinstance(func, ast.Attribute):
            recv = func.value
            if isinstance(recv, ast.Subscript):
                recv = recv.value
            cls = self._receiver_class(recv, scope)
            if cls is not None:
                for tkey, tfn in self._dispatch(cls, func.attr):
                    targets.append(
                        (tfn, self.classes[tkey].mod, tkey, None, None)
                    )
            elif isinstance(recv, ast.Name) or isinstance(
                func.value, ast.Name
            ):
                ci = self.graph.resolve_callable(scope.info, func)
                if ci is not None:
                    cmod = self._ctx_for_info(ci.module)
                    if cmod is not None:
                        targets.append((ci.fn, cmod, None, None, None))
        elif isinstance(func, ast.Name):
            if func.id in scope.nested:
                # sibling/nested def: same closure family
                targets.append((
                    scope.nested[func.id], scope.mod, scope.self_class,
                    scope.closure
                    or self._closures.get(id(scope.fn)),
                    scope.types,
                ))
            else:
                local_cls = self.class_local.get(scope.mod.rel, {})
                if func.id in local_cls or self._resolve_class(
                    scope.info, func.id
                ):
                    targets = []  # constructor: __init__ walked as init
                else:
                    ci = self.graph.resolve_callable(scope.info, func)
                    if ci is not None:
                        cmod = self._ctx_for_info(ci.module)
                        if cmod is not None:
                            targets.append((ci.fn, cmod, None, None, None))
        for fn, mod, self_class, closure, inherited in targets[
            :MAX_DISPATCH
        ]:
            closure_is_owner = False
            if closure is not None and fn is not scope.fn:
                closure_is_owner = False
            self._walk_fn(
                fn, mod, self_class, closure, closure_is_owner, inherited,
                root=frame.root, lockset=lockset, init=frame.init,
                depth=frame.depth + 1, record_reach=record_reach,
            )


def build_model(project) -> ThreadModel:
    """Entry point: rules reach this through ``project.threads``."""
    return _Analyzer(project).run()
