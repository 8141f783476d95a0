"""MPT012 — live metric names must come from the registered namespace.

The live telemetry plane (:mod:`mpit_tpu_torch.obs.live`) keys every series by
a string: ``reg.inc("train.samples")`` and ``reg.inc("train.sample")``
are both perfectly legal Python and produce two silently diverging
series — the dashboard, the straggler alert, and the SLO burn rate all
read specific keys, so a typo'd publish doesn't fail, it just makes a
metric flatline. The namespace is therefore a registry: the module-level
``M_*`` string constants in ``mpit_tpu_torch/obs/live.py``, and every publish
(``inc`` / ``set_gauge`` / ``observe`` first argument) must name one of
them *by constant*.

Checked only in modules that import the live plane (``mpit_tpu_torch.obs.live``
or one of its hooks) — ``observe`` is a common method name
(``LogicalClock.observe``, ``SLOAggregator.observe``) and modules outside
the live plane's import closure can't be publishing into a registry.
Within scope:

- a string literal first argument is always flagged, even when its value
  matches a registered name (the MPT007 idiom: a later rename of the
  constant would silently strand the literal);
- a name/attribute that resolves (through the import graph's alias
  chains) to a string not among the registered values is flagged;
- an unresolvable name spelled like a namespace constant (``M_FOO``)
  that is NOT defined in the namespace is flagged — that is exactly what
  a typo'd import or a deleted constant looks like;
- anything else unresolvable (locals, computed names) is out of static
  scope, same stance as MPT007 on dynamic protocol expressions.

The canonical namespace is AST-parsed from the scan set when it covers
``obs/live.py``, else from the installed package next to this rule —
never imported (the linter must stay side-effect free).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, Optional

from mpit_tpu_torch.analysis import astutil

RULES = {
    "MPT012": (
        "unregistered-metric-name",
        "registry publish (inc/set_gauge/observe) whose metric name is a "
        "string literal or does not resolve to an M_* constant in "
        "mpit_tpu_torch.obs.live — typo'd keys fork or flatline a series "
        "silently",
    ),
}

_PUBLISH_METHODS = frozenset({"inc", "set_gauge", "observe"})
_NAMESPACE_REL_SUFFIX = "obs/live.py"
_LIVE_MODULE = "mpit_tpu_torch.obs.live"
_LIVE_HOOKS = frozenset({"live_registry", "NULL_REGISTRY", "MetricsRegistry"})
_M_NAME_RE = re.compile(r"^M_[A-Z0-9_]+$")


def _module_metric_names(tree: ast.Module) -> dict:
    """Module-level ``M_* = "literal"`` assigns — the namespace shape."""
    out: dict = {}
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if not (isinstance(tgt, ast.Name) and _M_NAME_RE.match(tgt.id)):
            continue
        if isinstance(node.value, ast.Constant) and isinstance(
            node.value.value, str
        ):
            out[tgt.id] = node.value.value
    return out


def canonical_namespace(project) -> Optional[tuple]:
    """({constant name: value}, where) for the registered metric
    namespace, or None when it can't be located (then nothing is
    checked — there is no registry to drift from)."""
    for mod in project.modules:
        if mod.rel.endswith(_NAMESPACE_REL_SUFFIX):
            names = _module_metric_names(mod.tree)
            if names:
                return names, mod.rel
    # scan set doesn't cover the live module: fall back to the installed
    # package relative to this file (parsed, never imported)
    canon = Path(__file__).resolve().parents[2] / "obs" / "live.py"
    try:
        tree = ast.parse(canon.read_text())
    except (OSError, SyntaxError):
        return None
    names = _module_metric_names(tree)
    if names:
        return names, "mpit_tpu_torch/" + _NAMESPACE_REL_SUFFIX
    return None


def _imports_live(tree: ast.Module) -> bool:
    """Does this module pull in the live plane? Import of the module (any
    spelling) or of one of its hook names from the obs package."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name == _LIVE_MODULE for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            m = node.module or ""
            if m == _LIVE_MODULE:
                return True
            if m.endswith("obs") and any(
                a.name == "live" or a.name in _LIVE_HOOKS
                for a in node.names
            ):
                return True
    return False


def _check_publish(mod, info, graph, call, dotted_fn, names, where):
    values = set(names.values())
    arg = astutil.get_arg(call, 0, "name")
    if arg is None:
        return
    if isinstance(arg, ast.Constant):
        if not isinstance(arg.value, str):
            return  # some other .observe()/.inc() API — not a metric name
        verdict = (
            "is not a registered metric name"
            if arg.value not in values
            else "matches a registered name by value, but a rename of "
            "the constant would silently strand it"
        )
        yield mod.finding(
            "MPT012",
            call,
            f"{dotted_fn}({arg.value!r}, ...) publishes a literal metric "
            f"name — {verdict}; use the M_* constant from "
            f"{_LIVE_MODULE} ({where})",
        )
        return
    dotted = astutil.dotted_name(arg)
    if dotted is None:
        return  # computed name: out of static scope
    last = dotted.split(".")[-1]
    resolved = graph.resolve_constant(info, arg)
    if isinstance(resolved, str):
        if resolved not in values:
            yield mod.finding(
                "MPT012",
                call,
                f"{dotted_fn}({dotted}, ...): {dotted} resolves to "
                f"{resolved!r}, which is not a registered metric name "
                f"in {_LIVE_MODULE} ({where}) — this series is "
                "invisible to the dashboard and alerts",
            )
    elif resolved is None:
        # unresolvable: accept only spellings the namespace defines
        # (covers linting a single file whose imports are off the scan
        # set); a namespace-shaped name the registry lacks is a typo
        if _M_NAME_RE.match(last) and last not in names:
            yield mod.finding(
                "MPT012",
                call,
                f"{dotted_fn}({dotted}, ...) names {last}, which is not "
                f"defined in the metric namespace ({where}) — typo or "
                "deleted constant",
            )
    # non-string resolution (int, tuple): a different API, not a metric


def run(project) -> Iterable:
    canon = canonical_namespace(project)
    if canon is None:
        return
    names, where = canon
    graph = project.graph
    for mod in project.modules:
        if mod.rel.endswith(_NAMESPACE_REL_SUFFIX):
            continue  # the registry itself (its helpers take computed names)
        if not _imports_live(mod.tree):
            continue
        info = graph.module_for_rel(mod.rel)
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            if not isinstance(node.func, ast.Attribute):
                continue  # bare inc()/observe() is some other function
            if node.func.attr not in _PUBLISH_METHODS:
                continue
            dotted_fn = astutil.dotted_name(node.func) or node.func.attr
            yield from _check_publish(
                mod, info, graph, node, dotted_fn, names, where
            )
