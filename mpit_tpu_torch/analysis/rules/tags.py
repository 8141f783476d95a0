"""MPT002/MPT003 — transport tag discipline.

The PS protocol's tags (``TAG_FETCH``.. in ``parallel/pserver.py``) are the
wire contract: mpiT's dominant failure class is a misused tag silently
routing a message to the wrong consumer (SURVEY.md §5). Two rules:

- MPT002: a hard-coded *literal* tag at a transport ``send``/``isend``/
  ``recv``/``irecv``/``probe`` call site. Literal tags bypass the registry,
  so nothing stops two modules from claiming the same integer — use a
  ``TAG_*`` constant. (``-1`` = ANY_TAG is exempt: it's a wildcard, not a
  claim.)
- MPT003: two ``TAG_*`` constants with the same value in different modules
  (or two names for one value inside a module) — a tag collision against
  the registry extracted from ``parallel/``. Distinct protocol roles
  sharing an integer corrupt each other's mailboxes the moment they share
  a broker.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable

from mpit_tpu_torch.analysis import astutil

RULES = {
    "MPT002": (
        "literal-transport-tag",
        "transport send/recv call site with a hard-coded literal tag "
        "instead of a TAG_* registry constant",
    ),
    "MPT003": (
        "tag-collision",
        "two TAG_* constants share one integer value across modules — "
        "colliding protocol roles corrupt each other's mailboxes",
    ),
}

_TAG_NAME_RE = re.compile(r"^TAG_[A-Z0-9_]+$")

# (attr name, positional index of the tag argument)
_SEND_SITES = {"send": 1, "isend": 1}
_RECV_SITES = {"recv": 1, "irecv": 1, "probe": 1}


@dataclasses.dataclass(frozen=True)
class TagDef:
    name: str
    value: int
    rel: str
    line: int


def _module_tags(tree: ast.Module, rel: str) -> list:
    out = []
    for node in tree.body:  # module level only: the registry convention
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and _TAG_NAME_RE.match(tgt.id):
                val = astutil.int_constant(node.value)
                if val is not None:
                    out.append(TagDef(tgt.id, val, rel, node.lineno))
    return out


def _canonical_registry() -> list:
    """TAG_* defs from the installed mpit_tpu_torch/parallel package — the
    protocol's source of truth, included even when the scan path doesn't
    cover it (a plugin module claiming TAG_FETCH's value must collide).
    Located relative to THIS file, never imported: importing the parallel
    package would import torch, and the linter must stay runnable in
    bare containers (see lint.py's module docstring)."""
    pdir = Path(__file__).resolve().parents[2] / "parallel"
    if not pdir.is_dir():
        return []
    out = []
    for py in sorted(pdir.glob("*.py")):
        try:
            tree = ast.parse(py.read_text())
        except (OSError, SyntaxError):
            continue
        out.extend(_module_tags(tree, f"mpit_tpu_torch/parallel/{py.name}"))
    return out


def iter_literal_tag_sites(tree: ast.Module) -> Iterable:
    """(call node, tag literal node, value) for every MPT002-shaped site —
    shared by the rule (findings) and ``--fix`` (rewrites)."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = astutil.call_last_name(node)
        if name in _SEND_SITES:
            # transport sends are (dst, tag, payload): 3+ args keeps
            # socket.send(bytes) and queue.send(x) out of scope
            if len(node.args) + len(node.keywords) < 3:
                continue
            tag_arg = astutil.get_arg(node, _SEND_SITES[name], "tag")
        elif name in _RECV_SITES:
            tag_arg = astutil.get_arg(node, _RECV_SITES[name], "tag")
        else:
            continue
        if tag_arg is None:
            continue
        val = astutil.int_constant(tag_arg)
        if val is None or val == -1:  # ANY_TAG wildcard
            continue
        yield node, tag_arg, val


def _literal_tag_findings(mod) -> Iterable:
    for node, _tag_arg, val in iter_literal_tag_sites(mod.tree):
        name = astutil.call_last_name(node)
        yield mod.finding(
            "MPT002",
            node,
            f"literal tag {val} at a transport {name}() site — use a "
            "TAG_* constant from the protocol registry so collisions "
            "are checkable",
        )


def run(project) -> Iterable:
    defs: list = []
    scanned_keys = set()
    by_rel = {}
    for mod in project.modules:
        tags = _module_tags(mod.tree, mod.rel)
        defs.extend(tags)
        by_rel[mod.rel] = mod
        scanned_keys.update(
            (Path(t.rel).name, t.name) for t in tags
        )
        yield from _literal_tag_findings(mod)

    if project.config.canonical_tag_registry:
        for t in _canonical_registry():
            # don't double-count a file present in both the scan set and
            # the installed package (the self-check case)
            if (Path(t.rel).name, t.name) not in scanned_keys:
                defs.append(t)

    by_value: dict = {}
    for t in defs:
        by_value.setdefault(t.value, []).append(t)
    for value, group in sorted(by_value.items()):
        if len({(t.rel, t.name) for t in group}) < 2:
            continue
        # report at each definition site inside the scan set
        for t in group:
            mod = by_rel.get(t.rel)
            if mod is None:
                continue  # canonical-registry-only side of the collision
            others = ", ".join(
                f"{o.name} ({o.rel}:{o.line})"
                for o in group
                if (o.rel, o.name) != (t.rel, t.name)
            )
            node = ast.Constant(value)
            node.lineno, node.col_offset = t.line, 0
            yield mod.finding(
                "MPT003",
                node,
                f"{t.name} = {value} collides with {others} — distinct "
                "protocol roles must not share a tag value",
            )
