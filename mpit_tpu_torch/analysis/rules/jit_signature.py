"""MPT004 — declared positions drift from the wrapped signature.

The failure class of the reference's commit c166392: a function gains or
loses a parameter, the declaration on its wrapper silently keeps pointing
at the old positions, and the first symptom is an error far from the
edit. The reference checks ``jax.jit``'s ``static_argnums``; the port has
no ``jax.jit``, and the same hazard in two forms of its own:

- a ``torch.func.vmap`` whose ``in_dims`` tuple must have one entry per
  positional argument of the wrapped function (``vmap`` raises at the
  first call otherwise). Flagged when the tuple is longer than the
  positional parameters or shorter than those without a default; skipped
  when the function takes ``*args`` or ``in_dims`` is not a literal
  tuple. The wrapped function is followed as the reference follows a jit
  target: function-scope defs, aliases, ``functools.partial`` links (each
  SHIFTS the positional frame past the arguments it binds) and pure
  pass-through wrappers, across modules. Both the
  call (``vmap(f, in_dims=...)``) and the decorator
  (``@functools.partial(torch.func.vmap, in_dims=...)``) are checked;
- a ``torch.autograd.Function`` whose ``backward`` must return one value
  per input of ``forward`` (after ``ctx``, unless the class has a
  ``setup_context``). Checked where both are literal: a ``forward``
  without ``*args`` and a ``return`` of a tuple display.

Non-literal expressions and chains the module graph cannot resolve (star
imports, dynamic dispatch) are skipped — conservative in the no-finding
direction.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from mpit_tpu_torch.analysis import astutil
from mpit_tpu_torch.analysis.graph import CallableInfo

RULES = {
    "MPT004": (
        "wrapped-signature-drift",
        "vmap in_dims or an autograd.Function's backward arity out of "
        "step with the wrapped signature (wrapper chains included)",
    ),
}

_VMAP_NAMES = {"vmap"}


def _is_vmap(func: ast.AST) -> bool:
    dotted = astutil.dotted_name(func)
    return dotted is not None and dotted.split(".")[-1] in _VMAP_NAMES


def _in_dims(call: ast.Call, pos: int) -> Optional[int]:
    """Entry count of a literal ``in_dims`` tuple, else None."""
    node = astutil.get_arg(call, pos, "in_dims")
    if isinstance(node, (ast.Tuple, ast.List)) and not any(
        isinstance(e, ast.Starred) for e in node.elts
    ):
        return len(node.elts)
    return None


def _check_vmap(mod, site: ast.AST, n_dims: int, target: CallableInfo):
    """Validate an ``in_dims`` length against the resolved callable's
    EFFECTIVE positional frame (shifted past partial-bound leading
    parameters, cut at the first keyword-bound one)."""
    fn = target.fn
    if fn.args.vararg is not None:
        return
    params = fn.args.posonlyargs + fn.args.args
    eff = []
    for a in params[target.bound_pos:]:
        if a.arg in target.bound_names:
            break
        eff.append(a.arg)
    n_defaults = len(fn.args.defaults)
    required = max(0, len(params) - n_defaults - target.bound_pos)
    required = min(required, len(eff))
    if required <= n_dims <= len(eff):
        return
    via = (
        f" (reached through a {target.depth}-link wrapper chain)"
        if target.depth
        else ""
    )
    yield mod.finding(
        "MPT004",
        site,
        f"vmap in_dims has {n_dims} entries for {fn.name}() with "
        f"{len(eff)} positional parameters{via} — signature drifted "
        "under its vmap wrapper",
    )


def _resolve_target(local_defs, graph, info, node) -> Optional[CallableInfo]:
    """Resolve a vmap target: function-scope defs first (the trainer
    pattern — ``vmap(step)`` right under ``def step`` in a method), then
    the module graph's alias/partial/wrapper chains."""
    if isinstance(node, ast.Name) and node.id in local_defs:
        return CallableInfo(fn=local_defs[node.id], module=info)
    if graph is None:
        return None
    return graph.resolve_callable(info, node)


def _vmap_partial_dims(dec: ast.AST) -> Optional[int]:
    """``@functools.partial(torch.func.vmap, in_dims=...)``: the entry
    count of its literal in_dims."""
    if not isinstance(dec, ast.Call):
        return None
    dotted = astutil.dotted_name(dec.func)
    if (
        dotted is not None
        and dotted.split(".")[-1] == "partial"
        and dec.args
        and _is_vmap(dec.args[0])
    ):
        return _in_dims(dec, 1)
    return None


def _is_autograd_function(cls: ast.ClassDef, from_autograd: set) -> bool:
    for base in cls.bases:
        dotted = astutil.dotted_name(base)
        if dotted is None:
            continue
        parts = dotted.split(".")
        if parts[-1] != "Function":
            continue
        if "autograd" in parts[:-1] or dotted in from_autograd:
            return True
    return False


def _autograd_imports(tree: ast.Module) -> set:
    """Names bound by ``from torch.autograd import Function [as F]``."""
    out = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module in (
            "torch.autograd",
            "torch.autograd.function",
        ):
            for alias in node.names:
                if alias.name == "Function":
                    out.add(alias.asname or alias.name)
    return out


def _own_returns(fn) -> Iterable[ast.Return]:
    """``return`` statements of ``fn`` itself (nested defs excluded)."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Return):
            yield node
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                   ast.ClassDef)
        ):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _check_autograd(mod, cls: ast.ClassDef):
    methods = {
        n.name: n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    fwd = methods.get("forward")
    if fwd is None or fwd.args.vararg is not None:
        return
    params = [a.arg for a in fwd.args.posonlyargs + fwd.args.args]
    inputs = params if "setup_context" in methods else params[1:]
    n_in = len(inputs)
    bwd = methods.get("backward")
    if bwd is not None:
        for ret in _own_returns(bwd):
            if not isinstance(ret.value, ast.Tuple) or any(
                isinstance(e, ast.Starred) for e in ret.value.elts
            ):
                continue
            k = len(ret.value.elts)
            if k != n_in:
                yield mod.finding(
                    "MPT004",
                    ret,
                    f"{cls.name}.backward returns {k} gradient(s) for the "
                    f"{n_in} input(s) of forward() — signature drifted "
                    "under its autograd.Function (backward fails at the "
                    "first gradient)",
                )


def run(project) -> Iterable:
    graph = project.graph
    for mod in project.modules:
        info = graph.module_for_rel(mod.rel)
        # every def in the module by bare name (function-scope included),
        # for vmap targets the graph's module-level view misses
        local_defs = {
            n.name: n
            for n in mod.nodes
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        from_autograd = _autograd_imports(mod.tree)
        for node in mod.nodes:
            if isinstance(node, ast.ClassDef):
                if _is_autograd_function(node, from_autograd):
                    yield from _check_autograd(mod, node)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    n_dims = _vmap_partial_dims(dec)
                    if n_dims is not None:
                        target = CallableInfo(fn=node, module=info)
                        yield from _check_vmap(mod, dec, n_dims, target)
            elif isinstance(node, ast.Call):
                if not (_is_vmap(node.func) and node.args):
                    continue
                n_dims = _in_dims(node, 1)
                if n_dims is None:
                    continue
                target = _resolve_target(
                    local_defs, graph, info, node.args[0]
                )
                if target is not None:
                    yield from _check_vmap(mod, node, n_dims, target)
