"""MPT001 — a mesh axis named by a literal the module never binds.

The port names its mesh axes by literals too: ``topo.axis_span("pp")``,
``topo.peers("tp")``, ``ppermute_ring(x, axis_name="sp")``. ``Topology``
refuses an unknown axis only at run time (``unknown mesh axis``, in
``comm/topology.py``), on the first step of a world whose mesh was built
with other names. Functions that take the axis as a *parameter* (the repo
convention — ``self.topo.axis_span(self.batch_axis)``) are exempt by
construction: only string literals are checked, and a literal is fine
when the same module also names that axis in a mesh context (module
granularity — the linter does no interprocedural binding analysis, it
catches the "copied an axis call out of its mesh context" class of bug).

The reference's rule (``mpit_tpu/analysis/rules/collectives.py``) read
onto the port's forms:

- the checked calls: ``lax.psum``-family collectives give way to the
  methods of ``Topology`` that take an axis name (``axis_span``,
  ``peers``, ``_lines``: attribute calls, the axis first) and to
  ``ppermute_ring`` (``axis_name``, third positional);
- the binding contexts: ``axis_names=`` keywords, the
  ``init``/``Topology``/``P``/``PartitionSpec`` calls, and a comparison
  of the mesh's axis names with literals (``names[1] != "pp"`` after
  ``names = self.topo.axis_names``: the trainer's guard, which refuses
  another mesh before any axis call). ``shard_map``/``Mesh``, the
  ``lax`` collectives and ``axis_name=`` (which binds an axis in
  ``pmap``/``shard_map`` but only names one in the port's
  ``ppermute_ring``), which the port cannot contain, are dropped.
"""

from __future__ import annotations

import ast
from typing import Iterable, Iterator

from mpit_tpu_torch.analysis import astutil

RULES = {
    "MPT001": (
        "unbound-collective-axis",
        "Topology axis call (axis_span/peers/ppermute_ring) with a literal "
        "axis name not bound by any mesh context in the module",
    ),
}

#: Topology methods whose first argument names a mesh axis
AXIS_METHODS = {"axis_span", "peers", "_lines"}
#: module-level collectives taking a mesh axis: name -> (position, keyword)
AXIS_FUNCTIONS = {"ppermute_ring": (2, "axis_name")}

# calls whose string constants (axis_names tuples, specs) bind axis names.
# P/PartitionSpec count: a module that writes P(None, "tp") specs is
# evidently sharding for a mesh that has the axis.
_BINDING_CALLS = {"init", "Topology", "P", "PartitionSpec"}
_BINDING_KEYWORDS = {"axis_names"}
_AXIS_NAMES_ATTR = "axis_names"


def _mentions(node: ast.AST, aliases: set) -> bool:
    """Does ``node`` read the mesh's axis names (``x.axis_names`` or a
    name bound from it)?"""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr == _AXIS_NAMES_ATTR:
            return True
        if isinstance(sub, ast.Name) and sub.id in aliases:
            return True
    return False


def _bound_axes(tree: ast.Module) -> set:
    bound = set()
    aliases = set()  # names bound from ``<topology>.axis_names``
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _mentions(node.value, set()):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    aliases.add(tgt.id)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            name = astutil.call_last_name(node)
            if name in _BINDING_CALLS:
                bound.update(astutil.string_constants(node))
        if isinstance(node, ast.keyword) and node.arg in _BINDING_KEYWORDS:
            bound.update(astutil.string_constants(node.value))
        if isinstance(node, ast.Compare):
            sides = [node.left, *node.comparators]
            if any(_mentions(side, aliases) for side in sides):
                for side in sides:
                    if not _mentions(side, aliases):
                        bound.update(astutil.string_constants(side))
    return bound


def _axis_literals(arg: ast.AST) -> Iterator[str]:
    """String literal(s) in an axis argument (a name or a tuple of names)."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        yield arg.value
    elif isinstance(arg, (ast.Tuple, ast.List)):
        for elt in arg.elts:
            if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                yield elt.value


def _axis_arg(node: ast.Call):
    """The axis argument of an axis call, or None for any other call."""
    name = astutil.call_last_name(node)
    if name in AXIS_METHODS and isinstance(node.func, ast.Attribute):
        return astutil.get_arg(node, 0, "axis")
    if name in AXIS_FUNCTIONS:
        pos, kw = AXIS_FUNCTIONS[name]
        return astutil.get_arg(node, pos, kw)
    return None


def run(project) -> Iterable:
    for mod in project.modules:
        bound = None  # computed on the module's first axis call
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            axis_arg = _axis_arg(node)
            if axis_arg is None:
                continue
            if bound is None:
                bound = _bound_axes(mod.tree)
            dotted = astutil.dotted_name(node.func) or (
                astutil.call_last_name(node)
            )
            for lit in _axis_literals(axis_arg):
                if lit not in bound:
                    yield mod.finding(
                        "MPT001",
                        node,
                        f"axis call {dotted!r} names axis {lit!r}, which "
                        "no mesh context in this module binds — on a mesh "
                        "without it the call fails at run time (unknown "
                        "mesh axis)",
                    )
