"""Static pass of the distributed-correctness linter.

Drives the AST rules in :mod:`mpit_tpu_torch.analysis.rules` over a file set,
applies inline suppressions and the checked-in baseline, and returns
:class:`~mpit_tpu_torch.analysis.findings.Finding` lists. The analysis modules
are stdlib-only: scanned code is parsed, never imported, and no CUDA
context is ever created (the parent package's import does pull in torch,
but linting touches no devices) — safe for pre-commit hooks, bare CI
containers and the card's machine, where JAX is not installed. This is
``mpit_tpu/analysis/lint.py`` with the port's names: the hot-path set and
the suppression layers are the reference's, the baseline is the port's own.

Suppression layers, outermost first:

1. baseline file (``baseline.json`` beside this module — the root
   ``analysis-baseline.json`` is the reference's): accepted deviations, counted per fingerprint — the build fails only on NEW
   findings (see :func:`mpit_tpu_torch.analysis.findings.new_findings`);
2. inline ``# mpit-analysis: ignore[MPT005]`` (or bare ``ignore`` for all
   rules) on the flagged line;
3. barrier functions: a def annotated ``# mpit-analysis: host-sync-barrier``
   (see ``utils/profiling.force_completion``) is exempt from the host-sync
   rule, body and call sites both.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from pathlib import Path
from typing import Iterable, Optional, Sequence

from mpit_tpu_torch.analysis import astutil
from mpit_tpu_torch.analysis.findings import Finding

_IGNORE_RE = re.compile(
    r"#\s*mpit-analysis:\s*ignore(?:\[([A-Z0-9,\s]+)\])?"
)
_BARRIER_RE = re.compile(r"#\s*mpit-analysis:\s*host-sync-barrier")

BASELINE_FILENAME = "baseline.json"
#: the port's baseline ships inside the package, found relative to it
BASELINE_PATH = Path(__file__).resolve().parent / BASELINE_FILENAME


@dataclasses.dataclass
class Config:
    """Knobs the rules read. Defaults describe THIS repo; tests override
    (e.g. ``hot_all=True`` to lint a fixture as if it were a hot path)."""

    # path components marking latency-critical modules for the host-sync
    # rule (run.py, parallel/, ops/ — the hot-path set)
    hot_parts: Sequence[str] = ("parallel", "ops")
    hot_basenames: Sequence[str] = ("run.py",)
    hot_all: bool = False  # treat every scanned file as hot (fixtures)
    # functions whose calls/bodies are sanctioned host syncs, on top of the
    # `# mpit-analysis: host-sync-barrier` markers discovered in sources
    host_sync_barriers: Sequence[str] = ("force_completion",)
    # include mpit_tpu_torch/parallel's TAG_* registry even when linting a path
    # that doesn't contain it (cross-module collisions against the
    # canonical protocol tags)
    canonical_tag_registry: bool = True
    # path components marking transport-boundary modules for the pickle
    # wire-format rule (modules may also opt in with a
    # `# mpit-analysis: wire-boundary` marker comment)
    wire_parts: Sequence[str] = ("transport", "native")
    # the canonical wire pickle-protocol constant: its name, and an
    # optional value override for tests (default: extracted from
    # transport/socket_transport.py — scan set first, installed package
    # as fallback; never imported)
    wire_protocol_name: str = "WIRE_PICKLE_PROTOCOL"
    wire_pickle_protocol: Optional[int] = None
    # the canonical binary-frame version constant: its name, and an
    # optional value override for tests (default: extracted from
    # transport/wire.py the same way — scan set first, installed package
    # as fallback; never imported)
    wire_version_name: str = "WIRE_FORMAT_VERSION"
    wire_format_version: Optional[int] = None
    # restrict the run to these rule ids (``--only MPT013,MPT014``); None
    # runs everything. Rule modules owning no selected id are skipped
    # entirely, so one rule can be iterated without the full-pass cost
    only_rules: Optional[Sequence[str]] = None


@dataclasses.dataclass
class ModuleCtx:
    path: Path  # absolute
    rel: str  # posix, relative to the scan root
    tree: ast.Module
    source_lines: list
    parents: dict
    nodes: list  # flat ast.walk order — rules iterate this, never re-walk
    ignores: dict  # line -> set of rule ids, or {"*"}
    barrier_defs: set  # function names marked host-sync-barrier

    def is_hot(self, config: Config) -> bool:
        if config.hot_all:
            return True
        parts = Path(self.rel).parts
        return (
            parts[-1] in config.hot_basenames
            or any(p in config.hot_parts for p in parts[:-1])
        )

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=rule,
            path=self.rel,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            symbol=astutil.enclosing_symbol(node, self.parents),
            message=message,
            text=astutil.line_text(self.source_lines, node),
        )


@dataclasses.dataclass
class Project:
    modules: list  # list[ModuleCtx]
    config: Config
    # lazily-built cross-module name-resolution index (analysis/graph.py);
    # per-file rules never touch it, cross-module rules share one build
    _graph: object = dataclasses.field(default=None, repr=False)
    # lazily-extracted role models (analysis/protocol.py) — the protocol
    # rules, the model check, and conformance all need the same extraction
    _roles: object = dataclasses.field(default=None, repr=False)
    # lazily-built whole-program concurrency model (analysis/threads.py) —
    # the MPT013-015 rules and the `threads` CLI share one build
    _threads: object = dataclasses.field(default=None, repr=False)
    # lazily-built wire payload-schema model (analysis/schema.py) — the
    # MPT016-018 rules and the `schema` CLI/lockfile share one build
    _schema: object = dataclasses.field(default=None, repr=False)
    # lazily-built precision-dataflow model (analysis/numerics.py) — the
    # MPT020-022 rules and the `numerics` CLI share one build
    _numerics: object = dataclasses.field(default=None, repr=False)

    @property
    def graph(self):
        if self._graph is None:
            from mpit_tpu_torch.analysis import graph as graph_mod

            self._graph = graph_mod.ModuleGraph(self.modules)
        return self._graph

    @property
    def roles(self):
        if self._roles is None:
            from mpit_tpu_torch.analysis import protocol

            self._roles = protocol.extract_roles(self)
        return self._roles

    @property
    def threads(self):
        if self._threads is None:
            from mpit_tpu_torch.analysis import threads as threads_mod

            self._threads = threads_mod.build_model(self)
        return self._threads

    @property
    def numerics(self):
        if self._numerics is None:
            from mpit_tpu_torch.analysis import numerics as numerics_mod

            self._numerics = numerics_mod.build_model(self)
        return self._numerics

    @property
    def schema(self):
        if self._schema is None:
            from mpit_tpu_torch.analysis import schema as schema_mod

            self._schema = schema_mod.build_schema(self)
        return self._schema


def _parse_ignores(source_lines: list) -> dict:
    out: dict = {}
    for i, line in enumerate(source_lines, start=1):
        m = _IGNORE_RE.search(line)
        if not m:
            continue
        if m.group(1):
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
        else:
            out[i] = {"*"}
    return out


def _parse_barriers(nodes: list, source_lines: list) -> set:
    """Function names whose def line (or the line above it) carries the
    host-sync-barrier marker."""
    out = set()
    for node in nodes:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for ln in (node.lineno, node.lineno - 1):
            if 1 <= ln <= len(source_lines) and _BARRIER_RE.search(
                source_lines[ln - 1]
            ):
                out.add(node.name)
                break
    return out


def load_module(path: Path, rel: str) -> Optional[ModuleCtx]:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (OSError, SyntaxError):
        return None  # unreadable / non-parse files are out of scope
    lines = source.splitlines()
    nodes, parents = astutil.walk_and_parents(tree)
    return ModuleCtx(
        path=path,
        rel=rel,
        tree=tree,
        source_lines=lines,
        parents=parents,
        nodes=nodes,
        ignores=_parse_ignores(lines),
        barrier_defs=_parse_barriers(nodes, lines),
    )


def collect_files(paths: Iterable) -> list:
    """(abs_path, rel) pairs for every .py under ``paths`` (files pass
    through; directories recurse, skipping __pycache__/hidden dirs)."""
    out = []
    for p in paths:
        p = Path(p)
        if p.is_file():
            out.append((p.resolve(), p.name))
            continue
        root = p.resolve()
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [
                d
                for d in sorted(dirnames)
                if d != "__pycache__" and not d.startswith(".")
            ]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    ap = Path(dirpath) / fn
                    out.append((ap, ap.relative_to(root.parent).as_posix()))
    return out


def run_lint(
    paths: Iterable, config: Optional[Config] = None
) -> list:
    """Lint ``paths`` (files and/or directories) and return the suppressed,
    sorted finding list (baseline NOT applied — that's the caller's
    policy decision; see :func:`mpit_tpu_torch.analysis.findings.new_findings`)."""
    from mpit_tpu_torch.analysis import rules

    config = config or Config()
    modules = []
    for ap, rel in collect_files(paths):
        ctx = load_module(ap, rel)
        if ctx is not None:
            modules.append(ctx)
    project = Project(modules=modules, config=config)
    only = set(config.only_rules) if config.only_rules else None
    findings = []
    for rule_mod in rules.RULE_MODULES:
        if only is not None and not only & set(rule_mod.RULES):
            continue
        findings.extend(rule_mod.run(project))
    findings = [
        f
        for f in findings
        if not _suppressed(f, {m.rel: m for m in modules})
        and (only is None or f.rule in only)
    ]
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def _suppressed(f: Finding, by_rel: dict) -> bool:
    mod = by_rel.get(f.path)
    if mod is None:
        return False
    ignored = mod.ignores.get(f.line, ())
    return "*" in ignored or f.rule in ignored


def find_repo_root(start: Path) -> Optional[Path]:
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    for candidate in (cur, *cur.parents):
        if (candidate / "pyproject.toml").exists():
            return candidate
    return None


def default_baseline_path(scan_path) -> Optional[Path]:
    """``$MPIT_ANALYSIS_BASELINE``, else the package's ``baseline.json``
    (its fingerprints name ``mpit_tpu_torch/`` paths, so it applies to any
    scan of the port; other paths find no entries in it)."""
    del scan_path
    env = os.environ.get("MPIT_ANALYSIS_BASELINE")
    if env:
        return Path(env)
    return BASELINE_PATH
