"""Structured metrics: one JSON line per record.

Counterpart of ``mpit_tpu/utils/metrics.py``: :class:`MetricsLogger`, whose
records carry the process index of the current world (0 outside one), and
the host-side :class:`Throughput` counter.
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
      all_processes: by default only process 0 writes (replicated metrics
        are the same in every process); True for per-process streams, each
        process then with its own ``path``.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        tag: str = "train",
        echo: bool = True,
        all_processes: bool = False,
        _stream: Optional[TextIO] = None,
    ):
        from mpit_tpu_torch.comm.topology import current_process

        self.tag = tag
        self.echo = echo
        self.process = current_process()[0]
        self._active = all_processes or self.process == 0
        self._f: Optional[TextIO] = _stream
        if path is not None and self._active and _stream is None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def log(self, step: int, **metrics: Any) -> None:
        if not self._active:
            return
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


class Throughput:
    """Rolling samples/sec counter for the step loop (host-side, cheap)."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._samples = 0

    def tick(self, samples: int) -> Optional[float]:
        """Record ``samples`` processed; returns the samples/sec so far
        (None on the first tick, which only starts the clock)."""
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return None
        self._samples += samples
        return self._samples / (now - self._t0)

    def reset(self) -> None:
        self._t0, self._samples = None, 0
