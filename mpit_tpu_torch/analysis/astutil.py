"""Small AST helpers shared by the lint rules (stdlib-only, no torch import —
the linter must run in a bare CI container and never initialize a backend).
"""

from __future__ import annotations

import ast
import io
import tokenize
from typing import Iterator, Optional


def iter_comments(source_lines: list) -> Iterator[tuple]:
    """(lineno, text) for every real COMMENT token. Marker scans must use
    this rather than regexing raw lines: a marker QUOTED inside a docstring
    (e.g. this package documenting its own ``# mpit-analysis: ...`` syntax)
    is not an opt-in."""
    readline = io.StringIO("\n".join(source_lines) + "\n").readline
    try:
        for tok in tokenize.generate_tokens(readline):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return


def walk_and_parents(tree: ast.AST) -> tuple:
    """(flat node list in ``ast.walk`` order, child -> parent map), both in
    ONE traversal. Loaded once per module: a dozen rules each re-walking
    every tree is the dominant cost of the whole-package scan, so rules
    iterate ``mod.nodes`` instead."""
    nodes = [tree]
    parents: dict = {}
    for node in nodes:  # appending while indexing = the same BFS as walk
        for child in ast.iter_child_nodes(node):
            parents[child] = node
            nodes.append(child)
    return nodes, parents


def build_parents(tree: ast.AST) -> dict:
    """child node -> parent node, for upward walks (enclosing fn, loops)."""
    return walk_and_parents(tree)[1]


def enclosing_symbol(node: ast.AST, parents: dict) -> str:
    """Dotted qualname of the innermost enclosing def/class, or <module>."""
    names = []
    cur = parents.get(node)
    while cur is not None:
        if isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            names.append(cur.name)
        cur = parents.get(cur)
    return ".".join(reversed(names)) if names else "<module>"


def dotted_name(func: ast.AST) -> Optional[str]:
    """'jax.lax.psum' for nested Attribute/Name chains; None for anything
    whose base isn't a plain name (calls, subscripts...)."""
    parts = []
    cur = func
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def call_last_name(call: ast.Call) -> Optional[str]:
    """Last component of the callee: 'sendall' for x.y.sendall(...),
    'psum' for psum(...). None when the callee base is itself a call or
    subscript — but the final attribute still names the operation, so
    ``self._connection(dst).sendall(f)`` resolves to 'sendall'."""
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def string_constants(node: ast.AST) -> Iterator[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


# arithmetic the folder evaluates; Pow is deliberately absent (a folded
# ``2 ** 10**6`` would eat the scan's memory budget for no lint value)
_BIN_FOLDS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Mod: lambda a, b: a % b,
    ast.LShift: lambda a, b: a << b,
    ast.RShift: lambda a, b: a >> b,
    ast.BitOr: lambda a, b: a | b,
    ast.BitAnd: lambda a, b: a & b,
    ast.BitXor: lambda a, b: a ^ b,
}
_UNARY_FOLDS = {
    ast.USub: lambda a: -a,
    ast.UAdd: lambda a: +a,
    ast.Invert: lambda a: ~a,
}
#: folded results larger than this are abandoned (a registry tag or wire
#: constant is small; anything bigger is data, not protocol)
_FOLD_INT_BOUND = 1 << 63
_FOLD_STR_BOUND = 4096


def _fold_leaf(value) -> Optional[object]:
    if isinstance(value, bool):
        return None  # True == 1 but is not a tag
    if isinstance(value, (int, str)):
        return value
    return None


def fold_binop(op: ast.operator, left, right) -> Optional[object]:
    """``left <op> right`` for already-folded int/str operands, or None
    when the combination doesn't fold (mixed types, div-by-zero, huge
    results). Shared with the module graph so ``TAG_BASE + 1`` folds the
    same whether the operands are literals or cross-module constants."""
    if left is None or right is None:
        return None
    if isinstance(left, str) or isinstance(right, str):
        # concatenation is the one string fold protocols use ("obs" + "1"
        # wire-version strings); everything else stays unfolded
        if (
            isinstance(op, ast.Add)
            and isinstance(left, str)
            and isinstance(right, str)
            and len(left) + len(right) <= _FOLD_STR_BOUND
        ):
            return left + right
        return None
    fold = _BIN_FOLDS.get(type(op))
    if fold is None:
        return None
    try:
        out = fold(left, right)
    except (ZeroDivisionError, ValueError, OverflowError):
        return None
    if isinstance(out, int) and abs(out) > _FOLD_INT_BOUND:
        return None
    return out


def fold_unaryop(op: ast.unaryop, operand) -> Optional[object]:
    fold = _UNARY_FOLDS.get(type(op))
    if fold is None or not isinstance(operand, int) or isinstance(
        operand, bool
    ):
        return None
    return fold(operand)


def fold_constant(node: ast.AST) -> Optional[object]:
    """Evaluate a pure-literal int/str expression: constants plus the
    arithmetic/concatenation in ``_BIN_FOLDS``/``_UNARY_FOLDS`` —
    ``(1 << 4) | 2`` folds to 18, ``"obs" + "1"`` to ``"obs1"``. Names
    don't fold here (that's the module graph's job); None = no fold."""
    if isinstance(node, ast.Constant):
        return _fold_leaf(node.value)
    if isinstance(node, ast.UnaryOp):
        return fold_unaryop(node.op, fold_constant(node.operand))
    if isinstance(node, ast.BinOp):
        return fold_binop(
            node.op, fold_constant(node.left), fold_constant(node.right)
        )
    return None


def int_constant(node: ast.AST) -> Optional[int]:
    """The int value of a pure-literal expression (bools excluded) —
    a plain Constant, or folded arithmetic like ``-1`` or ``2 + 1``;
    else None."""
    val = fold_constant(node)
    return val if isinstance(val, int) else None


def get_arg(
    call: ast.Call, pos: int, kw: str
) -> Optional[ast.AST]:
    """Argument at positional index ``pos`` or keyword ``kw``."""
    if len(call.args) > pos and not any(
        isinstance(a, ast.Starred) for a in call.args[: pos + 1]
    ):
        return call.args[pos]
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    return None


def in_loop(node: ast.AST, parents: dict) -> bool:
    """Is ``node`` syntactically inside a for/while body, without an
    intervening function boundary (a closure DEFINED in a loop does not
    itself run per iteration)?"""
    cur = parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
            return True
        cur = parents.get(cur)
    return False


def line_text(source_lines: list, node: ast.AST) -> str:
    try:
        return source_lines[node.lineno - 1].strip()
    except (AttributeError, IndexError):
        return ""
