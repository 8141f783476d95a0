"""MPT007 — pickle protocol drift at a transport boundary.

The wire format is ``length + pickle(payload)`` and both brokers (socket
and native) must keep emitting the SAME pickle protocol: readers
auto-detect (the protocol id is embedded in the stream, which is why
``pickle.loads`` has nothing to pin and is not checked), but a *writer*
that drifts — a module hard-coding a different number, omitting
``protocol=`` (the interpreter default moves across versions), or passing
``pickle.HIGHEST_PROTOCOL``/``-1`` (explicitly version-dependent) — makes
frames that a mixed-version peer may not parse, and the failure is a
corrupted-looking stream on the OTHER rank, far from the bad dumps call.

The canonical protocol is the ``WIRE_PICKLE_PROTOCOL`` constant in
``transport/socket_transport.py`` (taken from the scan set when covered,
else from the installed package next to this rule — never imported).
Checked only at transport boundaries: modules under a ``transport/`` or
``native/`` path component (``Config.wire_parts``), or any module carrying
a ``# mpit-analysis: wire-boundary`` marker comment. Every ``pickle.dumps``
there must pin ``protocol=`` to the canonical constant *by name* — a
literal equal to the canonical value is still flagged, because a future
bump of the constant would silently strand it.

The binary framing codec (docs/WIRE.md) has the identical drift surface:
frame *readers* dispatch on the version byte in the preamble (nothing to
pin), but a frame *writer* — any ``encode_frame`` call at a wire
boundary — that omits ``version=`` or pins something other than the
``WIRE_FORMAT_VERSION`` constant in ``transport/wire.py`` produces frames
a peer may reject, and again the failure surfaces as a decode error on
the OTHER rank. Same rule id, same boundary set, same by-name
requirement; the canonical constant is located the same way
(``Config.wire_version_name`` / ``wire_format_version`` override).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path, PurePosixPath
from typing import Iterable, Optional

from mpit_tpu_torch.analysis import astutil

RULES = {
    "MPT007": (
        "pickle-protocol-drift",
        "wire writer at a transport boundary (pickle.dumps protocol= or "
        "encode_frame version=) that is absent, literal, "
        "interpreter-dependent, or resolves to a value other than the "
        "canonical wire constant",
    ),
}

WIRE_MARKER_RE = re.compile(r"#\s*mpit-analysis:\s*wire-boundary")

_CANONICAL_REL_SUFFIX = "transport/socket_transport.py"
_CANONICAL_FRAME_REL_SUFFIX = "transport/wire.py"
_VERSION_DEPENDENT = {"HIGHEST_PROTOCOL", "DEFAULT_PROTOCOL"}


def _pickle_dumps_names(tree: ast.Module) -> tuple:
    """(module aliases of ``pickle``, bare names bound to ``dumps``)."""
    mod_aliases, fn_names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "pickle":
                    mod_aliases.add(alias.asname or "pickle")
        elif isinstance(node, ast.ImportFrom) and node.module == "pickle":
            for alias in node.names:
                if alias.name == "dumps":
                    fn_names.add(alias.asname or "dumps")
    return mod_aliases, fn_names


def _is_dumps_call(call: ast.Call, mod_aliases, fn_names) -> bool:
    dotted = astutil.dotted_name(call.func)
    if dotted is None:
        return False
    parts = dotted.split(".")
    if len(parts) == 1:
        return parts[0] in fn_names
    return parts[-1] == "dumps" and parts[0] in mod_aliases


def _canonical_constant(
    project, rel_suffix: str, name: str, override
) -> Optional[tuple]:
    """(value, constant name, where) for a canonical wire constant, or
    None when it can't be located (then nothing is checked — there is no
    contract to drift from)."""
    if override is not None:
        return int(override), name, "config override"
    graph = project.graph
    for mod in project.modules:
        if not mod.rel.endswith(rel_suffix):
            continue
        info = graph.module_for_rel(mod.rel)
        if info is not None and name in info.constants:
            return info.constants[name], name, mod.rel
    # scan set doesn't cover the transport: fall back to the installed
    # package relative to this file (parsed, never imported)
    canon = Path(__file__).resolve().parents[2] / PurePosixPath(rel_suffix)
    try:
        tree = ast.parse(canon.read_text())
    except (OSError, SyntaxError):
        return None
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == name:
                val = astutil.int_constant(node.value)
                if val is not None:
                    return val, name, "mpit_tpu_torch/" + rel_suffix
    return None


def canonical_protocol(project) -> Optional[tuple]:
    """(value, constant name, where) for the wire's canonical pickle
    protocol (``transport/socket_transport.py``)."""
    return _canonical_constant(
        project,
        _CANONICAL_REL_SUFFIX,
        project.config.wire_protocol_name,
        project.config.wire_pickle_protocol,
    )


def canonical_wire_version(project) -> Optional[tuple]:
    """(value, constant name, where) for the binary frame version
    (``transport/wire.py``)."""
    return _canonical_constant(
        project,
        _CANONICAL_FRAME_REL_SUFFIX,
        project.config.wire_version_name,
        project.config.wire_format_version,
    )


def _encode_frame_names(tree: ast.Module) -> tuple:
    """(aliases naming the wire codec module, bare names bound to
    ``encode_frame``). Recognizes every import spelling in use: ``import
    mpit_tpu_torch.transport.wire [as w]``, ``from mpit_tpu_torch.transport import
    wire [as w]``, ``from [mpit_tpu_torch.transport.]wire import encode_frame
    [as f]`` — including relative forms (``from . import wire``)."""
    mod_aliases, fn_names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "wire" or alias.name.endswith(".wire"):
                    mod_aliases.add(alias.asname or alias.name)
        elif isinstance(node, ast.ImportFrom):
            m = node.module or ""
            if m == "wire" or m.endswith(".wire"):
                for alias in node.names:
                    if alias.name == "encode_frame":
                        fn_names.add(alias.asname or "encode_frame")
            else:
                for alias in node.names:
                    if alias.name == "wire":
                        mod_aliases.add(alias.asname or "wire")
    return mod_aliases, fn_names


def _is_encode_frame_call(call: ast.Call, mod_aliases, fn_names) -> bool:
    dotted = astutil.dotted_name(call.func)
    if dotted is None:
        return False
    parts = dotted.split(".")
    if len(parts) == 1:
        return parts[0] in fn_names
    return (
        parts[-1] == "encode_frame"
        and ".".join(parts[:-1]) in mod_aliases
    )


def _check_encode_frame(
    mod, info, graph, call, canon_value, canon_name, where
):
    """Mirror of :func:`_check_dumps` for frame writers: ``version=`` is
    keyword-only on ``encode_frame`` and must name the canonical
    constant. (Readers dispatch on the preamble's version byte — nothing
    to pin — so only ``encode_frame`` is checked.)"""
    ver = astutil.get_arg(call, 3, "version")
    if ver is None:
        yield mod.finding(
            "MPT007",
            call,
            "frame writer without version= — a codec bump would change "
            "what this site emits underneath its peers; pin "
            f"version={canon_name} (={canon_value}, {where})",
        )
        return
    lit = astutil.int_constant(ver)
    if lit is not None:
        if lit != canon_value:
            yield mod.finding(
                "MPT007",
                call,
                f"frame version drift: encode_frame pins version={lit} "
                f"but the wire contract is {canon_name}={canon_value} "
                f"({where}) — peers negotiate against the canonical "
                "version and will reject these frames",
            )
        else:
            yield mod.finding(
                "MPT007",
                call,
                f"encode_frame hard-codes version={lit}; it matches "
                f"{canon_name} today, but a bump of the constant would "
                f"silently strand this site — use {canon_name} itself",
            )
        return
    dotted = astutil.dotted_name(ver)
    if dotted is None:
        return  # dynamic expression: out of static scope
    resolved = graph.resolve_constant(info, ver)
    if resolved is None:
        if dotted.split(".")[-1] != canon_name:
            yield mod.finding(
                "MPT007",
                call,
                f"encode_frame version= names {dotted!r}, which does "
                f"not resolve to the wire contract {canon_name}="
                f"{canon_value} ({where})",
            )
    elif resolved != canon_value:
        yield mod.finding(
            "MPT007",
            call,
            f"frame version drift: {dotted} resolves to {resolved} but "
            f"the wire contract is {canon_name}={canon_value} ({where})",
        )


def _is_wire_module(mod, config) -> bool:
    parts = PurePosixPath(mod.rel).parts[:-1]
    if any(p in config.wire_parts for p in parts):
        return True
    # real COMMENT tokens only — this rule's own docstring quotes the
    # marker; substring scan first so unmarked modules skip the tokenize
    if not any("wire-boundary" in ln for ln in mod.source_lines):
        return False
    return any(
        WIRE_MARKER_RE.search(text)
        for _, text in astutil.iter_comments(mod.source_lines)
    )


def _check_dumps(mod, info, graph, call, canon_value, canon_name, where):
    proto = astutil.get_arg(call, 1, "protocol")
    if proto is None:
        yield mod.finding(
            "MPT007",
            call,
            "pickle.dumps on the wire without protocol= — the "
            "interpreter default drifts across versions; pin "
            f"protocol={canon_name} (={canon_value}, {where})",
        )
        return
    lit = astutil.int_constant(proto)
    if lit is not None:
        if lit == -1:
            yield mod.finding(
                "MPT007",
                call,
                "pickle.dumps(protocol=-1) is interpreter-dependent "
                f"(highest available) — pin protocol={canon_name} "
                f"(={canon_value})",
            )
        elif lit != canon_value:
            yield mod.finding(
                "MPT007",
                call,
                f"pickle protocol drift: dumps pins protocol={lit} but "
                f"the wire contract is {canon_name}={canon_value} "
                f"({where}) — mixed ranks on one socket corrupt frames "
                "silently",
            )
        else:
            yield mod.finding(
                "MPT007",
                call,
                f"pickle.dumps hard-codes protocol={lit}; it matches "
                f"{canon_name} today, but a bump of the constant would "
                f"silently strand this site — use {canon_name} itself",
            )
        return
    dotted = astutil.dotted_name(proto)
    if dotted is None:
        return  # dynamic expression: out of static scope
    if dotted.split(".")[-1] in _VERSION_DEPENDENT:
        yield mod.finding(
            "MPT007",
            call,
            f"pickle.dumps(protocol={dotted}) is interpreter-dependent "
            f"— pin protocol={canon_name} (={canon_value})",
        )
        return
    resolved = graph.resolve_constant(info, proto)
    if resolved is None:
        # unresolvable name: accept only the canonical spelling (covers
        # linting a single file whose import chain is off the scan set)
        if dotted.split(".")[-1] != canon_name:
            yield mod.finding(
                "MPT007",
                call,
                f"pickle.dumps protocol= names {dotted!r}, which does "
                f"not resolve to the wire contract {canon_name}="
                f"{canon_value} ({where})",
            )
    elif resolved != canon_value:
        yield mod.finding(
            "MPT007",
            call,
            f"pickle protocol drift: {dotted} resolves to {resolved} "
            f"but the wire contract is {canon_name}={canon_value} "
            f"({where})",
        )


def run(project) -> Iterable:
    pkl = canonical_protocol(project)
    frm = canonical_wire_version(project)
    if pkl is None and frm is None:
        return
    graph = project.graph
    for mod in project.modules:
        if not _is_wire_module(mod, project.config):
            continue
        p_mods, p_fns = _pickle_dumps_names(mod.tree)
        f_mods, f_fns = _encode_frame_names(mod.tree)
        if not (p_mods or p_fns or f_mods or f_fns):
            continue
        info = graph.module_for_rel(mod.rel)
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            if pkl is not None and _is_dumps_call(node, p_mods, p_fns):
                yield from _check_dumps(mod, info, graph, node, *pkl)
            elif frm is not None and _is_encode_frame_call(
                node, f_mods, f_fns
            ):
                yield from _check_encode_frame(
                    mod, info, graph, node, *frm
                )
