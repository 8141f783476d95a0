"""MPT005 — host-device synchronization inside a hot-path loop.

A ``.item()`` / ``float(loss)`` / ``.cpu()`` / ``torch.cuda.synchronize()``
in a step loop stalls the launch queue every iteration: PyTorch returns
from a CUDA call before the card has run it, and a host read of a result
waits for everything queued before it (the measured failure documented at
``parallel/ps_roles.client_train_loop``: batch the fetch at the τ boundary
instead). Flagged only in the hot-path modules (``run.py``, ``parallel/``,
``ops/``) and only syntactically inside a loop body.

The reference's rule (``mpit_tpu/analysis/rules/host_sync.py``) read onto
the port's forms of the same sync:

- kept: ``.item()``, ``np.asarray``/``np.array`` of a value, and
  ``float()``/``int()`` of a non-constant;
- added: ``.cpu()``, ``.tolist()``, ``.numpy()`` (each copies a tensor to
  the host) and ``.synchronize()`` (``torch.cuda.synchronize()``,
  ``Event.synchronize()``, ``Stream.synchronize()``: a wait on the card);
- dropped: ``block_until_ready`` and ``jax.device_get``, which the port
  cannot contain.

Sanctioned syncs: calls to barrier functions (``force_completion`` — the
documented proof-of-completion barrier in ``utils/profiling.py`` — plus any
def carrying the ``# mpit-analysis: host-sync-barrier`` marker), code inside
such a barrier's own body, and lines carrying an inline
``# mpit-analysis: ignore[MPT005]``. Accepted per-iteration syncs (e.g. the
τ-boundary flatten in ``ps_roles``) live in the baseline.
"""

from __future__ import annotations

import ast
from typing import Iterable

from mpit_tpu_torch.analysis import astutil

RULES = {
    "MPT005": (
        "host-sync-in-loop",
        ".item()/float()/np.asarray()/.cpu()/synchronize() inside a loop "
        "in a hot-path module stalls the dispatch pipeline every iteration",
    ),
}

# methods that copy a tensor to the host
_SYNC_ATTRS = {"item", "cpu", "tolist", "numpy"}
# methods that wait for the card (torch.cuda / Event / Stream)
_WAIT_ATTRS = {"synchronize"}
# only NUMPY asarray/array force a device->host transfer; torch.as_tensor
# is a device-side cast and stays out of scope
_NUMPY_ALIASES = {"np", "numpy", "onp"}
_CAST_BUILTINS = {"float", "int"}


def _numpy_names(tree: ast.Module) -> set:
    names = set(_NUMPY_ALIASES)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "numpy":
                    names.add(alias.asname or "numpy")
    return names


def _sync_reason(node: ast.Call, np_names: set) -> str:
    """Why this call is a host sync, or '' if it isn't one."""
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in _SYNC_ATTRS:
        if isinstance(func.value, ast.Call) and _sync_reason(
            func.value, np_names
        ):
            return ""  # x.cpu().numpy(): one copy, reported at .cpu()
        return f".{func.attr}() forces a device->host transfer"
    if isinstance(func, ast.Attribute) and func.attr in _WAIT_ATTRS:
        dotted = astutil.dotted_name(func) or f"<expr>.{func.attr}"
        return f"{dotted}() blocks on device completion"
    dotted = astutil.dotted_name(func)
    if dotted is not None:
        parts = dotted.split(".")
        if (
            parts[-1] in ("asarray", "array")
            and len(parts) > 1
            and parts[0] in np_names
        ):
            return (
                f"{dotted}() materializes a device array on the host"
            )
        if (
            len(parts) == 1
            and parts[0] in _CAST_BUILTINS
            and len(node.args) == 1
            and not isinstance(node.args[0], ast.Constant)
        ):
            return (
                f"{parts[0]}() on a device scalar blocks until the "
                "value is computed and fetched"
            )
    return ""


def _inside_barrier_call(node: ast.AST, parents: dict, barriers: set):
    """Is ``node`` an argument of a sanctioned barrier call?"""
    cur = parents.get(node)
    while cur is not None and not isinstance(
        cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.stmt)
    ):
        if isinstance(cur, ast.Call):
            name = astutil.call_last_name(cur)
            if name in barriers:
                return True
        cur = parents.get(cur)
    return False


def run(project) -> Iterable:
    # barrier names: config defaults + every marker-annotated def anywhere
    # in the scan set (the marker travels with the function, not the config)
    barriers = set(project.config.host_sync_barriers)
    for mod in project.modules:
        barriers.update(mod.barrier_defs)
    for mod in project.modules:
        if not mod.is_hot(project.config):
            continue
        np_names = _numpy_names(mod.tree)
        for node in mod.nodes:
            if not isinstance(node, ast.Call):
                continue
            name = astutil.call_last_name(node)
            if name in barriers:
                continue  # the sanctioned barrier itself
            reason = _sync_reason(node, np_names)
            if not reason:
                continue
            if not astutil.in_loop(node, mod.parents):
                continue
            symbol = astutil.enclosing_symbol(node, mod.parents)
            if symbol.split(".")[-1] in barriers:
                continue  # inside a barrier's own implementation
            if _inside_barrier_call(node, mod.parents, barriers):
                continue
            yield mod.finding(
                "MPT005",
                node,
                f"host sync in a hot-path loop: {reason} — batch it "
                "outside the loop or go through force_completion at a "
                "measured boundary",
            )
