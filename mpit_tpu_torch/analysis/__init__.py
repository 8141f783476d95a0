"""mpit_tpu_torch.analysis — distributed-correctness linter + runtime checker
of the port, standing without JAX.

Two halves, each a copy of ``mpit_tpu/analysis/`` with the package renamed:

- a static AST pass over the port (:mod:`~mpit_tpu_torch.analysis.lint`,
  rules MPT001–MPT022): collective axis names, transport-tag discipline,
  wrapped-signature drift, host syncs in hot loops, blocking I/O under
  locks, wire-format drift, protocol roles and their model check
  (:mod:`~mpit_tpu_torch.analysis.mcheck`), the concurrency model
  (:mod:`~mpit_tpu_torch.analysis.threads`), the wire payload schema
  (:mod:`~mpit_tpu_torch.analysis.schema`) and the precision flow
  (:mod:`~mpit_tpu_torch.analysis.numerics`). Scanned code is parsed,
  never imported. The protocol half is the reference's rules verbatim; the
  device-idiom rules (MPT001, MPT004, MPT005, MPT020–022) read the port's
  torch forms of the same hazards (each rule module's docstring lists its
  mapping). Journals replay against the extracted protocol in
  :mod:`~mpit_tpu_torch.analysis.conformance` (TC201–TC203);
- the opt-in runtime checker (:mod:`~mpit_tpu_torch.analysis.runtime`,
  rules RT101–RT104).

CLI: ``python -m mpit_tpu_torch.analysis [--format json|text] [--fix]
[path]`` and its subcommands ``mcheck``, ``conform``, ``threads``,
``schema``, ``numerics``, ``fuzz`` — exits 0 when the scan matches the
port's baseline (``analysis/baseline.json`` beside this file).

This ``__init__`` stays import-light (PEP 562 lazy attributes): the
transports import :mod:`~mpit_tpu_torch.analysis.runtime` on their hot
construction path.
"""

from __future__ import annotations

_LAZY = {
    "Config": ("mpit_tpu_torch.analysis.lint", "Config"),
    "run_lint": ("mpit_tpu_torch.analysis.lint", "run_lint"),
    "Finding": ("mpit_tpu_torch.analysis.findings", "Finding"),
    "load_baseline": ("mpit_tpu_torch.analysis.findings", "load_baseline"),
    "new_findings": ("mpit_tpu_torch.analysis.findings", "new_findings"),
    "write_baseline": ("mpit_tpu_torch.analysis.findings", "write_baseline"),
    "RuntimeChecker": ("mpit_tpu_torch.analysis.runtime", "RuntimeChecker"),
    "RuntimeFinding": ("mpit_tpu_torch.analysis.runtime", "RuntimeFinding"),
    "checking": ("mpit_tpu_torch.analysis.runtime", "checking"),
    "make_lock": ("mpit_tpu_torch.analysis.runtime", "make_lock"),
    "active_checker": ("mpit_tpu_torch.analysis.runtime", "active_checker"),
}

__all__ = sorted(_LAZY)


def __getattr__(name: str):
    try:
        module_name, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(module_name), attr)
