"""wire — the part of ``mpit_tpu/transport/wire.py`` the PS roles import.

The reference's wire module is the framed zero-copy codec of its socket
transport (``encode_frame``/``decode_frame``, the hello negotiation) plus
the environment knobs of the wire path. The PS roles import from it only
the quantization kernels (re-exported from :mod:`mpit_tpu_torch.quant`),
:class:`WireDecodeError` and the ``*_from_env`` helpers, which are here,
copied from ``wire.py:143-203``. The codec, the socket transport and
process mode come with ROADMAP.md item A7c, where interop over sockets
can test them; the in-process broker frames nothing.
"""

from __future__ import annotations

import os
from typing import Optional

from mpit_tpu_torch.quant import (  # noqa: F401  (re-exports: wire API surface)
    QUANT_MODES,
    QuantArray,
    dequantize,
    quantize,
)


class WireDecodeError(Exception):
    """A framed body failed its integrity checks (bad magic inside a
    declared-framed frame, header CRC mismatch, unknown type/dtype code,
    or declared-vs-actual body length disagreement). Carries the frame's
    ``src``/``tag`` when the header decoded far enough to know them, so
    the transport can still route the corruption marker to the right
    stream (None otherwise)."""

    def __init__(self, message: str, src: Optional[int] = None,
                 tag: Optional[int] = None):
        super().__init__(message)
        self.src = src
        self.tag = tag


# -- env knobs ------------------------------------------------------------


def wire_format_from_env(env=os.environ) -> str:
    """``MPIT_WIRE_FORMAT``: ``framed`` (default — the hot path) or
    ``pickle`` (the historical format; the before-side of the bench
    comparison, and a kill switch)."""
    fmt = env.get("MPIT_WIRE_FORMAT", "framed").strip().lower()
    if fmt not in ("framed", "pickle"):
        raise ValueError(
            f"MPIT_WIRE_FORMAT={fmt!r}: expected 'framed' or 'pickle'"
        )
    return fmt


def quant_mode_from_env(env=os.environ) -> str:
    """``MPIT_WIRE_QUANT``: ``off`` (default), ``bf16``, or ``int8``."""
    mode = env.get("MPIT_WIRE_QUANT", "off").strip().lower()
    if mode not in QUANT_MODES:
        raise ValueError(
            f"MPIT_WIRE_QUANT={mode!r}: expected one of {QUANT_MODES}"
        )
    return mode


def negotiate_enabled_from_env(env=os.environ) -> bool:
    """``MPIT_WIRE_NEGOTIATE=0`` disables the hello exchange entirely —
    the transport then behaves like a pickle-only peer on both sides
    (no hello sent on accept, none awaited after connect, nothing
    framed). This is the mixed-version test lever AND the emergency
    lever for a peer whose stack chokes on unexpected reverse-direction
    bytes."""
    return env.get("MPIT_WIRE_NEGOTIATE", "1").strip() != "0"


def negotiate_timeout_from_env(env=os.environ) -> float:
    """``MPIT_WIRE_NEGOTIATE_TIMEOUT_S``: how long a sender waits for
    the receiver's hello before concluding the peer is pickle-only
    (default 2s; paid once per connection, and only by mixed-version
    pairs — a framed receiver sends its hello at accept time, so the
    wait is one RTT in the common case)."""
    return float(env.get("MPIT_WIRE_NEGOTIATE_TIMEOUT_S", "2.0"))
