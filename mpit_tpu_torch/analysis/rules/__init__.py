"""Rule registry for the static linter.

Each rule module exposes ``run(project) -> Iterable[Finding]`` plus the
``RULES`` metadata it owns. Adding a rule = adding a module here and
registering it in ``RULE_MODULES`` (and documenting it in
``docs/ANALYSIS.md``).
"""

from __future__ import annotations

from mpit_tpu_torch.analysis.rules import (
    collectives,
    concurrency,
    fleet_check,
    host_sync,
    jit_signature,
    locks,
    metric_names,
    model_check,
    numerics_flow,
    payload_schema,
    protocol_roles,
    tags,
    wire_format,
)

RULE_MODULES = (
    collectives,
    tags,
    jit_signature,
    host_sync,
    locks,
    wire_format,
    protocol_roles,
    model_check,
    fleet_check,
    metric_names,
    concurrency,
    payload_schema,
    numerics_flow,
)

# rule id -> (title, one-line rationale); the CLI's --list-rules output and
# the docs table are generated from this single source
RULE_DOCS = {}
for _mod in RULE_MODULES:
    RULE_DOCS.update(_mod.RULES)
