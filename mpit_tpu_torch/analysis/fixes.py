"""``--fix`` rewrites for MPT002: literal transport tag → ``TAG_*`` name.

A hard-coded ``transport.send(dst, 2, x)`` bypasses the tag registry; when
the literal is a KNOWN protocol tag (a value with exactly one ``TAG_*``
name in the canonical registry extracted from ``mpit_tpu_torch/parallel/`` —
1–6 today), the call is mechanically rewritable: replace the literal with
its registry name and add the import. That is what this module does,
behind ``python -m mpit_tpu_torch.analysis --fix``.

Scope is deliberately narrow — this is the one rule whose fix is a pure,
behavior-preserving identity (the integer on the wire is unchanged):

- only int literals whose value maps to exactly ONE registry name are
  rewritten (ambiguous or unknown values — e.g. the fixture's ``42`` —
  are left for a human);
- lines carrying an ``# mpit-analysis: ignore`` for MPT002 are left
  alone (a suppressed finding is a decision already made);
- the import (``from mpit_tpu_torch.parallel.pserver import TAG_X, ...``) is
  inserted after the last top-level import — or after the module
  docstring when there are none — unless the name is already bound at
  module level;
- files are rewritten in place and re-parsed afterwards; a rewrite that
  would not parse is abandoned (original content kept) and reported.
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, Optional

from mpit_tpu_torch.analysis import lint
from mpit_tpu_torch.analysis.graph import module_name_for_rel
from mpit_tpu_torch.analysis.rules import tags as tags_rule


@dataclasses.dataclass
class FileFix:
    """What ``--fix`` did (or could not do) to one file."""

    path: Path
    replaced: int = 0  # literal sites rewritten
    imported: tuple = ()  # names a new import line now provides
    skipped: int = 0  # known-literal sites left alone (ignored lines)
    error: Optional[str] = None


def registry_by_value() -> dict:
    """value -> TAG_* name, for values with exactly one canonical name
    (an ambiguous value cannot be fixed mechanically), plus the defining
    module per name."""
    names_by_value: dict = {}
    module_by_name: dict = {}
    for t in tags_rule._canonical_registry():
        names_by_value.setdefault(t.value, set()).add(t.name)
        module_by_name[t.name] = module_name_for_rel(t.rel)
    return {
        value: (next(iter(names)), module_by_name[next(iter(names))])
        for value, names in names_by_value.items()
        if len(names) == 1
    }


def _module_level_names(tree: ast.Module) -> set:
    """Names already bound at module level (imports, defs, assigns) — an
    import line must not shadow or duplicate them."""
    bound: set = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                bound.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name != "*":
                    bound.add(alias.asname or alias.name)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    bound.add(tgt.id)
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            bound.add(node.target.id)
    return bound


def _import_insert_line(tree: ast.Module) -> int:
    """0-based line index AFTER which a new import belongs: the last
    top-level import, else the module docstring, else the top."""
    last = 0
    for i, node in enumerate(tree.body):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            last = node.end_lineno
        elif (
            i == 0
            and isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            last = node.end_lineno
    return last


def fix_file(path: Path, registry: Optional[dict] = None) -> FileFix:
    """Rewrite every fixable literal-tag site in one file, in place."""
    result = FileFix(path=path)
    registry = registry_by_value() if registry is None else registry
    if not registry:
        return result
    ctx = lint.load_module(path, path.name)
    if ctx is None:
        result.error = "unreadable or not parseable"
        return result
    lines = list(ctx.source_lines)
    edits = []  # (lineno, col, end_col, name)
    needed: dict = {}  # name -> defining module
    for _call, tag_node, val in tags_rule.iter_literal_tag_sites(ctx.tree):
        if val not in registry:
            continue
        ignored = ctx.ignores.get(tag_node.lineno, ())
        if "*" in ignored or "MPT002" in ignored:
            result.skipped += 1
            continue
        if tag_node.lineno != tag_node.end_lineno:
            continue  # a multi-line int literal is not a thing we emit
        name, module = registry[val]
        edits.append(
            (tag_node.lineno, tag_node.col_offset,
             tag_node.end_col_offset, name)
        )
        needed[name] = module
    if not edits:
        return result
    # apply right-to-left so earlier columns stay valid
    for lineno, col, end_col, name in sorted(edits, reverse=True):
        line = lines[lineno - 1]
        lines[lineno - 1] = line[:col] + name + line[end_col:]
    bound = _module_level_names(ctx.tree)
    missing = {n: m for n, m in needed.items() if n not in bound}
    if missing:
        insert_at = _import_insert_line(ctx.tree)
        by_module: dict = {}
        for name, module in missing.items():
            by_module.setdefault(module, []).append(name)
        for module in sorted(by_module, reverse=True):
            names = ", ".join(sorted(by_module[module]))
            lines.insert(insert_at, f"from {module} import {names}")
        result.imported = tuple(sorted(missing))
    new_source = "\n".join(lines) + ("\n" if lines else "")
    try:
        ast.parse(new_source)
    except SyntaxError as e:  # never leave a broken file behind
        result.error = f"rewrite would not parse ({e}); file unchanged"
        return result
    path.write_text(new_source)
    result.replaced = len(edits)
    return result


def fix_paths(paths: Iterable) -> list:
    """Fix every .py under ``paths``; returns the per-file results that
    did something (or failed)."""
    registry = registry_by_value()
    out = []
    for ap, _rel in lint.collect_files(paths):
        r = fix_file(ap, registry)
        if r.replaced or r.skipped or r.error:
            out.append(r)
    return out
