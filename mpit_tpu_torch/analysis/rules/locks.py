"""MPT006 — blocking transport/socket call made while holding a lock.

The deadlock shape the runtime checker (RT101) hunts dynamically, caught at
the source: a ``sendall``/``connect``/``recv`` that can block indefinitely
inside a ``with <lock>:`` body serializes every other thread needing that
lock behind one slow peer — and if the blocked peer needs a lock the stalled
thread holds, the process deadlocks. The socket transport's *per-destination*
send lock is the deliberate, baselined exception (one slow rank must not
stall traffic to healthy ranks, and the per-dst lock guarantees exactly
that isolation); a NEW blocking call under the outbound-cache or any other
shared lock fails the build.

Heuristic: a ``with`` item whose expression's last name component contains
``lock`` (case-insensitive, ``cond`` excluded — condition-variable waits
are the documented sleep-holding-the-lock pattern) guards the body; any
call in the body whose final attribute is a known blocking primitive is
flagged.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from mpit_tpu_torch.analysis import astutil

RULES = {
    "MPT006": (
        "blocking-call-under-lock",
        "indefinitely-blocking socket/transport call inside a held "
        "threading.Lock — serializes peers and risks deadlock",
    ),
}

_BLOCKING = {
    "sendall",
    "connect",
    "create_connection",
    "accept",
    "recv",
    "irecv",
    "send",
    "isend",
    "wait",
    "join",
}
# .send is only transport/socket-shaped with these arg counts (socket.send
# takes bytes; transport send takes (dst, tag, payload))
_SEND_MIN_ARGS = {"send": 1, "isend": 1}


def _lockish_name(expr: ast.AST) -> Optional[str]:
    """The guarding name if ``expr`` looks like a lock acquisition."""
    cur = expr
    if isinstance(cur, ast.Call):
        cur = cur.func  # self._dst_lock(dst)
    if isinstance(cur, ast.Subscript):
        cur = cur.value  # self._locks[i]
    name = None
    if isinstance(cur, ast.Attribute):
        name = cur.attr
    elif isinstance(cur, ast.Name):
        name = cur.id
    if name is None:
        return None
    low = name.lower()
    if "cond" in low:
        return None
    return name if "lock" in low or "mutex" in low else None


def run(project) -> Iterable:
    for mod in project.modules:
        for node in mod.nodes:
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            guards = [
                n
                for n in (
                    _lockish_name(item.context_expr) for item in node.items
                )
                if n
            ]
            if not guards:
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                name = astutil.call_last_name(sub)
                if name not in _BLOCKING:
                    continue
                if name in _SEND_MIN_ARGS and (
                    len(sub.args) + len(sub.keywords)
                    < _SEND_MIN_ARGS[name]
                ):
                    continue
                if name == "join" and len(sub.args) == 1:
                    continue  # "sep".join(parts) — the str method
                yield mod.finding(
                    "MPT006",
                    sub,
                    f"{name}() can block indefinitely while "
                    f"{guards[0]!r} is held — every thread needing the "
                    "lock stalls behind the slowest peer (move the "
                    "blocking I/O outside the critical section or use a "
                    "per-peer lock)",
                )
