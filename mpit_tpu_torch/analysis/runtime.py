"""Stand-in for ``mpit_tpu/analysis/runtime.py`` until ROADMAP.md item A12.

The reference's runtime checkers (lock order RT101, tag collisions RT102,
races RT103, numerics RT104) arm only when a test or an ``MPIT_RT_*``
knob enables one; with none armed, its factories hand out plain
``threading`` locks and its notes return at once. This module is that
disabled path and nothing else, so the port's transports and PS roles keep
their call sites where the reference has them, and A12 replaces this file
without touching them.
"""

from __future__ import annotations

import threading


def active_checker():
    """The armed checker: never one until A12 ports the checkers."""
    return None


def make_lock(name: str):
    """A plain ``threading.Lock`` (``name`` labels the lock for the
    checkers A12 brings)."""
    return threading.Lock()


def make_condition(name: str):
    """A plain ``threading.Condition``."""
    return threading.Condition()


def note(key: str, write: bool) -> None:
    """An access to a shared structure, for the race checker (RT103)."""


def note_numeric_array(site: str, arr) -> None:
    """A host-boundary array, for the numerics checker (RT104)."""


def note_residual_norm(key: str, norm: float) -> None:
    """An error-feedback residual norm, for the numerics checker (RT104)."""
