"""Whole-program module graph for the static linter (stdlib-only).

The per-file rules (MPT001–MPT006) see one AST at a time; the cross-module
rules (MPT007/MPT008, wrapper-taint MPT004) need to know what a *name* in
one module means in another: which integer ``TAG_PARAM`` resolves to inside
``pclient.py``, whether ``protocol=WIRE_PICKLE_PROTOCOL`` in ``native/``
names the same constant the socket transport pins, and which actual ``def``
sits at the bottom of a ``functools.partial``/alias/decorator-factory chain.

This module builds that index from the parsed trees alone — scanned code is
NEVER imported (the linter must run in bare CI containers without
initializing a CUDA context), so resolution is purely syntactic:

- module names derive from scan-root-relative paths
  (``mpit_tpu_torch/parallel/pserver.py`` → ``mpit_tpu_torch.parallel.pserver``,
  ``__init__.py`` collapsing onto its package);
- ``import a.b as c`` / ``from a.b import x as y`` (absolute and relative)
  are followed; ``from a.b import *`` is recorded but deliberately REFUSED
  during resolution — a star import makes every unqualified name in the
  module ambiguous, and a linter that guesses wrong produces false
  positives, so names that could only come from a star import resolve to
  None (the conservative direction: no finding);
- only module-level bindings participate (the registry convention for tags
  and wire constants; function-local state is out of scope);
- callable chains follow plain aliases, ``functools.partial`` (tracking how
  many leading positional parameters the partial consumes and which names
  it binds by keyword), and pure pass-through wrappers
  (``def w(*a, **k): return inner(*a, **k)``), depth-limited so a cycle of
  assignments cannot hang the scan.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import PurePosixPath
from typing import Any, Optional, Union

from mpit_tpu_torch.analysis import astutil

#: resolution depth limit: alias/partial/import chains longer than this are
#: abandoned (also the cycle guard — ``a = b; b = a`` terminates here)
MAX_DEPTH = 16

_CONST_TYPES = (int, float, str, bytes, bool, type(None))


def module_name_for_rel(rel: str) -> str:
    """Dotted module name for a scan-root-relative posix path.

    ``mpit_tpu_torch/parallel/pserver.py`` → ``mpit_tpu_torch.parallel.pserver``;
    a package ``__init__.py`` names the package itself."""
    parts = list(PurePosixPath(rel).parts)
    if parts and parts[-1].endswith(".py"):
        parts[-1] = parts[-1][: -len(".py")]
    if parts and parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


@dataclasses.dataclass
class ModuleInfo:
    """One module's name-resolution surface (module level only)."""

    rel: str  # scan-root-relative posix path
    name: str  # dotted module name
    tree: ast.Module
    package: str  # enclosing package's dotted name ("" at the top)
    imports: dict  # local name -> absolute dotted target
    star_imports: list  # modules star-imported (resolution refused)
    constants: dict  # name -> literal constant value
    functions: dict  # name -> ast.FunctionDef / ast.AsyncFunctionDef
    assigns: dict  # name -> ast.expr (module-level, non-constant value)


@dataclasses.dataclass(frozen=True)
class Resolved:
    """One resolution step's answer: what ``dotted`` names in ``module``."""

    kind: str  # "constant" | "function" | "assign" | "module"
    value: Any  # const value | FunctionDef | expr | None (module)
    module: Optional[ModuleInfo]  # defining module (None: const folded)


@dataclasses.dataclass(frozen=True)
class CallableInfo:
    """A callable chain resolved down to its underlying ``def``.

    ``bound_pos`` leading positional parameters (and ``bound_names``
    keyword-bound parameters) have been consumed by ``functools.partial``
    links along the chain; ``depth`` counts the links followed."""

    fn: Union[ast.FunctionDef, ast.AsyncFunctionDef]
    module: ModuleInfo
    bound_pos: int = 0
    bound_names: frozenset = frozenset()
    depth: int = 0


def _resolve_relative_base(info_name: str, is_package: bool, level: int) -> str:
    """The absolute package a ``from ...x import y`` resolves against."""
    parts = info_name.split(".") if info_name else []
    if not is_package:
        parts = parts[:-1]  # a plain module's level-1 base is its package
    drop = level - 1
    if drop:
        parts = parts[: -drop] if drop <= len(parts) else []
    return ".".join(parts)


def build_module_info(rel: str, tree: ast.Module) -> ModuleInfo:
    name = module_name_for_rel(rel)
    is_package = PurePosixPath(rel).name == "__init__.py"
    package = name if is_package else ".".join(name.split(".")[:-1])
    imports: dict = {}
    star_imports: list = []
    constants: dict = {}
    functions: dict = {}
    assigns: dict = {}
    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    imports[alias.asname] = alias.name
                else:
                    # ``import a.b.c`` binds only ``a`` — dotted uses are
                    # resolved as absolute paths by the graph lookup
                    head = alias.name.split(".")[0]
                    imports.setdefault(head, head)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = _resolve_relative_base(name, is_package, node.level)
                mod = f"{base}.{node.module}" if node.module else base
                mod = mod.lstrip(".")
            else:
                mod = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    star_imports.append(mod)
                else:
                    imports[alias.asname or alias.name] = (
                        f"{mod}.{alias.name}" if mod else alias.name
                    )
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            functions[node.name] = node
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                _record_binding(tgt.id, node.value, constants, assigns)
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name):
                _record_binding(
                    node.target.id, node.value, constants, assigns
                )
    return ModuleInfo(
        rel=rel,
        name=name,
        tree=tree,
        package=package,
        imports=imports,
        star_imports=star_imports,
        constants=constants,
        functions=functions,
        assigns=assigns,
    )


def _record_binding(name: str, value: ast.expr, constants, assigns) -> None:
    if isinstance(value, ast.Constant) and isinstance(
        value.value, _CONST_TYPES
    ):
        constants[name] = value.value
        return
    folded = astutil.int_constant(value)  # -1 and friends
    if folded is not None:
        constants[name] = folded
        return
    assigns[name] = value


class ModuleGraph:
    """Cross-module name resolution over a scan set.

    Built once per lint run from the already-parsed ``ModuleCtx`` list
    (anything with ``.rel`` and ``.tree``); rules reach it through
    ``project.graph``."""

    def __init__(self, modules) -> None:
        self.by_name: dict = {}
        self.by_rel: dict = {}
        for m in modules:
            info = build_module_info(m.rel, m.tree)
            self.by_name[info.name] = info
            self.by_rel[info.rel] = info

    # -- lookup ----------------------------------------------------------

    def module(self, name: str) -> Optional[ModuleInfo]:
        return self.by_name.get(name)

    def module_for_rel(self, rel: str) -> Optional[ModuleInfo]:
        return self.by_rel.get(rel)

    # -- core resolution -------------------------------------------------

    def resolve(
        self, info: Optional[ModuleInfo], dotted: str, depth: int = 0
    ) -> Optional[Resolved]:
        """What ``dotted`` names when written inside ``info``.

        Follows import aliases across the scan set; returns None for
        anything outside it (stdlib, torch, ...), for class attributes, and
        for names reachable only through a ``from x import *`` (refused —
        see the module docstring)."""
        if depth > MAX_DEPTH or not dotted:
            return None
        parts = dotted.split(".")
        head = parts[0]
        if info is not None:
            if len(parts) == 1:
                hit = self._local(info, head)
                if hit is not None:
                    return hit
            if head in info.imports:
                target = info.imports[head]
                rest = ".".join(parts[1:])
                full = f"{target}.{rest}" if rest else target
                return self._resolve_absolute(full, depth + 1)
        if len(parts) > 1:
            return self._resolve_absolute(dotted, depth + 1)
        return None

    def _local(self, info: ModuleInfo, name: str) -> Optional[Resolved]:
        if name in info.constants:
            return Resolved("constant", info.constants[name], info)
        if name in info.functions:
            return Resolved("function", info.functions[name], info)
        if name in info.assigns:
            return Resolved("assign", info.assigns[name], info)
        return None

    def _resolve_absolute(
        self, dotted: str, depth: int
    ) -> Optional[Resolved]:
        if depth > MAX_DEPTH:
            return None
        parts = dotted.split(".")
        # longest module prefix wins (a name can shadow a subpackage only
        # through __init__ re-exports, which the imports table handles)
        for cut in range(len(parts), 0, -1):
            mod = self.by_name.get(".".join(parts[:cut]))
            if mod is None:
                continue
            rest = parts[cut:]
            if not rest:
                return Resolved("module", None, mod)
            if len(rest) > 1:
                return None  # Class.attr etc. — out of scope
            name = rest[0]
            hit = self._local(mod, name)
            if hit is not None:
                return hit
            if name in mod.imports:
                return self._resolve_absolute(mod.imports[name], depth + 1)
            # name not found; a star import COULD provide it — refuse
            # rather than guess (documented star-import rejection)
            return None
        return None

    # -- constants -------------------------------------------------------

    def resolve_constant(
        self,
        info: Optional[ModuleInfo],
        node_or_dotted,
        depth: int = 0,
    ) -> Optional[Any]:
        """Literal value of an expression/name, following alias chains.

        Accepts an AST node (Constant / Name / Attribute) or a dotted
        string. Returns None when the chain leaves the scan set, hits a
        star import, or ends on anything but a literal."""
        if depth > MAX_DEPTH:
            return None
        if isinstance(node_or_dotted, ast.AST):
            node = node_or_dotted
            folded = astutil.int_constant(node)
            if folded is not None:
                return folded
            if isinstance(node, ast.Constant) and isinstance(
                node.value, _CONST_TYPES
            ):
                return node.value
            if isinstance(node, ast.BinOp):
                # fold arithmetic/concatenation whose operands resolve —
                # ``TAG_BASE + 1`` is a real registry idiom, and skipping
                # it silently exempted such tags from MPT002/MPT008
                return astutil.fold_binop(
                    node.op,
                    self.resolve_constant(info, node.left, depth + 1),
                    self.resolve_constant(info, node.right, depth + 1),
                )
            if isinstance(node, ast.UnaryOp):
                return astutil.fold_unaryop(
                    node.op,
                    self.resolve_constant(info, node.operand, depth + 1),
                )
            dotted = astutil.dotted_name(node)
            if dotted is None:
                return None
        else:
            dotted = node_or_dotted
        r = self.resolve(info, dotted, depth)
        if r is None:
            return None
        if r.kind == "constant":
            return r.value
        if r.kind == "assign":
            return self.resolve_constant(r.module, r.value, depth + 1)
        return None

    # -- callables -------------------------------------------------------

    def resolve_callable(
        self,
        info: Optional[ModuleInfo],
        node_or_dotted,
        depth: int = 0,
    ) -> Optional[CallableInfo]:
        """Follow a wrapper chain down to its defining ``def``.

        Links followed: name/attribute aliases (within and across
        modules), ``functools.partial(inner, ...)`` (accumulating bound
        leading positionals and keyword-bound names), and pure
        pass-through wrappers (``def w(*a, **k): return inner(*a, **k)``).
        Returns None when the chain can't be tracked — unknown call
        shapes, star imports, lambdas, or anything off the scan set."""
        if depth > MAX_DEPTH:
            return None
        node = node_or_dotted
        if isinstance(node, str) or isinstance(
            node, (ast.Name, ast.Attribute)
        ):
            dotted = (
                node if isinstance(node, str) else astutil.dotted_name(node)
            )
            if dotted is None:
                return None
            r = self.resolve(info, dotted, depth)
            if r is None:
                return None
            if r.kind == "function":
                return self._unwrap_passthrough(
                    CallableInfo(r.value, r.module, 0, frozenset(), depth),
                    depth,
                )
            if r.kind == "assign":
                return self.resolve_callable(r.module, r.value, depth + 1)
            return None
        if isinstance(node, ast.Call):
            fn_dotted = astutil.dotted_name(node.func)
            if (
                fn_dotted is not None
                and fn_dotted.split(".")[-1] == "partial"
                and node.args
            ):
                inner = self.resolve_callable(info, node.args[0], depth + 1)
                if inner is None:
                    return None
                return CallableInfo(
                    fn=inner.fn,
                    module=inner.module,
                    bound_pos=inner.bound_pos + len(node.args) - 1,
                    bound_names=inner.bound_names
                    | {k.arg for k in node.keywords if k.arg},
                    depth=inner.depth + 1,
                )
            return None
        return None

    def _unwrap_passthrough(
        self, ci: CallableInfo, depth: int
    ) -> Optional[CallableInfo]:
        """``def w(*a, **k): return inner(*a, **k)`` contributes nothing to
        the signature — resolve through it to ``inner``."""
        fn = ci.fn
        a = fn.args
        if (
            a.posonlyargs
            or a.args
            or a.kwonlyargs
            or a.vararg is None
            or len(fn.body) != 1
            or not isinstance(fn.body[0], ast.Return)
            or not isinstance(fn.body[0].value, ast.Call)
        ):
            return ci
        call = fn.body[0].value
        if not (
            len(call.args) == 1
            and isinstance(call.args[0], ast.Starred)
            and isinstance(call.args[0].value, ast.Name)
            and call.args[0].value.id == a.vararg.arg
        ):
            return ci
        inner = self.resolve_callable(ci.module, call.func, depth + 1)
        if inner is None:
            return ci  # can't see through: report against the wrapper
        return CallableInfo(
            fn=inner.fn,
            module=inner.module,
            bound_pos=ci.bound_pos + inner.bound_pos,
            bound_names=ci.bound_names | inner.bound_names,
            depth=inner.depth + 1,
        )
