"""Structured metrics: one JSON line per record.

Counterpart of ``mpit_tpu/utils/metrics.py``'s :class:`MetricsLogger`. The
port runs as one process, so every record carries ``process: 0``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional, TextIO


def _to_jsonable(v: Any) -> Any:
    if isinstance(v, (str, bool, int, float, type(None), list, dict)):
        return v
    if hasattr(v, "tolist"):  # numpy and torch scalars and arrays, any rank
        return v.tolist()
    try:
        return float(v)
    except (TypeError, ValueError):
        return repr(v)


class MetricsLogger:
    """JSONL metrics stream (+ optional console mirror on stderr).

    Args:
      path: JSONL file to append to; parent dirs are created. When None,
        records go only to the console mirror.
      tag: short run identifier stamped on every record (e.g. "easgd").
      echo: also print a compact human-readable line to stderr.
    """

    process = 0

    def __init__(
        self,
        path: Optional[str] = None,
        tag: str = "train",
        echo: bool = True,
    ):
        self.tag = tag
        self.echo = echo
        self._f: Optional[TextIO] = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, step: int, **metrics: Any) -> None:
        rec = {
            "ts": round(time.time(), 3),
            "tag": self.tag,
            "process": self.process,
            "step": int(step),
            **{k: _to_jsonable(v) for k, v in metrics.items()},
        }
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        if self.echo:
            body = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()
                if k not in ("ts", "tag", "process")
            )
            print(f"[{self.tag}] {body}", file=sys.stderr)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
