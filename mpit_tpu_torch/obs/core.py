"""Stand-in for ``mpit_tpu/obs/core.py`` until ROADMAP.md item A12.

The reference's :func:`span` opens a traced region on a transport's tracer
when the transport is obs-wrapped, and returns a shared no-op otherwise.
The port wraps no transport yet (``AsyncPSTrainer`` raises for ``obs`` and
the ``MPIT_OBS_*`` knobs), so every span here is that no-op: a context
that yields None, which is what the PS roles test before they pay for a
completion barrier.
"""

from __future__ import annotations

from typing import Any


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


def span(transport, name: str, **args: Any):
    """The no-op span: the reference's disabled path."""
    return NULL_SPAN
