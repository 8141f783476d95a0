"""Finding model + baseline bookkeeping for the distributed-correctness linter.

A finding is one rule violation at one source location. Findings are
compared against a checked-in *baseline* (accepted deviations — e.g. the
deliberate per-destination send-under-lock in the socket transport) via a
line-number-free fingerprint, so routine edits above a finding don't churn
the baseline: the fingerprint is (rule, path, enclosing symbol, normalized
source text), counted — two identical violations in one function baseline
as a count of 2.
"""

from __future__ import annotations

import dataclasses
import json
from collections import Counter
from typing import Iterable, Optional

BASELINE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str  # e.g. "MPT001"
    path: str  # posix path relative to the scan root
    line: int
    col: int
    symbol: str  # enclosing function qualname, or "<module>"
    message: str
    text: str = ""  # the flagged source line, stripped

    @property
    def fingerprint(self) -> str:
        return "|".join((self.rule, self.path, self.symbol, self.text))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"[{self.symbol}] {self.message}"
        )


def load_baseline(path) -> Counter:
    """fingerprint -> accepted count. Missing file = empty baseline."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return Counter()
    if doc.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path}: version {doc.get('version')!r} != "
            f"{BASELINE_VERSION} — regenerate with --write-baseline"
        )
    return Counter(doc.get("findings", {}))


def write_baseline(path, findings: Iterable[Finding]) -> None:
    counts = Counter(f.fingerprint for f in findings)
    doc = {
        "version": BASELINE_VERSION,
        "findings": dict(sorted(counts.items())),
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def new_findings(
    findings: Iterable[Finding], baseline: Optional[Counter]
) -> list[Finding]:
    """Findings not covered by the baseline.

    Per fingerprint, the first ``baseline[fp]`` occurrences are accepted and
    any surplus is new — so ADDING a second copy of a baselined violation
    still fails the build, while the original stays accepted."""
    if not baseline:
        return list(findings)
    seen: Counter = Counter()
    out = []
    for f in findings:
        seen[f.fingerprint] += 1
        if seen[f.fingerprint] > baseline.get(f.fingerprint, 0):
            out.append(f)
    return out
