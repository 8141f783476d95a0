"""quant — the shared scalar quantization kernels, host (numpy) face.

Counterpart of ``mpit_tpu/quant.py:1-183``, the numpy face, copied so the
port imports nothing of the JAX package. The PS wire path
(:mod:`mpit_tpu_torch.transport.wire`) re-exports it, and the PS roles
quantize numpy buffers on the host with it when ``MPIT_WIRE_QUANT`` asks.
Codes and scales are bit for bit the reference's
(``tests/test_torch_quant.py``):

- ``bf16``: round-to-nearest-even high halves of the float32 bits —
  pure bit arithmetic, scale-free, 2x byte drop;
- ``int8``: symmetric per-block absmax scaling, codes in [-127, 127],
  ``scale = absmax / 127`` computed in float32 (a float64 division would
  double-round against the device face's f32), 4x byte drop. NaN lanes
  give code 0, ±Inf saturates to ±127, and an empty or all-zero chunk
  gets scale 1.

The reference's jnp face (``mpit_tpu/quant.py:185-272``, the quantized
collective exchange) is the torch face here: :func:`quantize_torch`,
:func:`dequantize_torch`, :func:`quantize_rows_torch` and
:func:`dequantize_rows_torch` give the numpy face's codes and scales bit
for bit on the CPU and on the card. This module imports numpy at module
scope and torch inside the torch face.
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

_F32_SIZE = 4

QUANT_MODES = ("off", "bf16", "int8")

# on-wire bytes per quantized element (raw float32 = 4)
MODE_ITEMSIZE = {"off": 4, "bf16": 2, "int8": 1}


@dataclasses.dataclass(frozen=True)
class QuantArray:
    """A quantized float32 chunk in transit.

    ``mode`` is ``"bf16"`` (``data`` = uint16 high halves) or ``"int8"``
    (``data`` = symmetric codes in [-127, 127], ``scale`` = absmax/127).
    Pickles fine, so quantized exchange also works over the inproc
    broker and with pickle-only peers — quantization is a protocol-layer
    choice, independent of the framing."""

    mode: str
    scale: float
    data: np.ndarray

    @property
    def nbytes(self) -> int:
        """On-wire payload size (the telemetry byte counters read this
        via the same ``nbytes`` duck-type as real ndarrays): quantized
        buffer plus the header-resident scale."""
        return int(self.data.nbytes) + _F32_SIZE


def _rt_numerics_checker():
    """The RT104 numerics sanitizer, IF some other code armed it.

    This module stays importable with only numpy, so it never imports the
    analysis package: ``sys.modules`` is peeked for an already-imported
    ``mpit_tpu_torch.analysis.runtime``. Until ROADMAP.md item A12 that
    module is a stand-in whose ``active_checker()`` is always None, so
    this costs one dict lookup per quantize."""
    rt = sys.modules.get("mpit_tpu_torch.analysis.runtime")
    if rt is None:
        return None
    checker = rt.active_checker()
    if checker is not None and getattr(checker, "numerics", False):
        return checker
    return None


def quantize(arr: np.ndarray, mode: str) -> QuantArray:
    """Pack a float32 array into a :class:`QuantArray` (copies — the
    quantized buffer is new; the input is never aliased)."""
    a = np.ascontiguousarray(arr, dtype=np.float32)
    if mode == "bf16":
        u = a.view(np.uint32)
        # round-to-nearest-even on the dropped mantissa half; the +
        # carries into the exponent correctly for halfway cases
        data = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)
        checker = _rt_numerics_checker()
        if checker is not None:
            checker.on_quantize("quantize", a, mode, None, data)
        return QuantArray("bf16", 1.0, data)
    if mode == "int8":
        # NaN/Inf never drive the block scale (an all-NaN chunk used to
        # poison amax and cast NaN to int8 — undefined codes); the scale
        # comes from the finite elements only, so it stays finite
        finite = np.isfinite(a)
        amax = (
            np.float32(np.max(np.where(finite, np.abs(a), np.float32(0))))
            if a.size
            else np.float32(0)
        )
        # f32 division, not float64-then-cast: the jnp path divides in
        # f32 and the two must agree to the bit (all-zero chunk: scale
        # is moot, pick 1)
        scale = amax / np.float32(127.0) if amax > 0 else np.float32(1.0)
        codes = np.clip(np.rint(a / scale), -127, 127)
        # ±Inf saturates to ±127 via the clip; NaN pins to code 0, so a
        # poisoned element dequantizes to 0 instead of garbage
        data = np.where(np.isnan(a), np.float32(0), codes).astype(np.int8)
        checker = _rt_numerics_checker()
        if checker is not None:
            checker.on_quantize("quantize", a, mode, scale, data)
        return QuantArray("int8", float(scale), data)
    raise ValueError(f"unknown quantization mode {mode!r}")


def dequantize(q: QuantArray) -> np.ndarray:
    """float32 reconstruction of a :class:`QuantArray`."""
    if q.mode == "bf16":
        data = np.ascontiguousarray(q.data, dtype=np.uint16)
        return (data.astype(np.uint32) << 16).view(np.float32)
    if q.mode == "int8":
        checker = _rt_numerics_checker()
        if checker is not None:
            checker.on_dequantize("dequantize", q.scale, q.mode)
        data = np.asarray(q.data, dtype=np.int8)
        return data.astype(np.float32) * np.float32(q.scale)
    raise ValueError(f"unknown quantization mode {q.mode!r}")


def quantize_rows(a: np.ndarray, mode: str):
    """Blockwise quantization of a 2-D float32 array, one absmax scale
    per row. Returns ``(codes (B, n), scales (B, 1))``, bit-identical to
    quantizing each row with :func:`quantize`."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    if a.ndim != 2:
        raise ValueError(f"quantize_rows wants a 2-D array, got {a.shape}")
    if mode == "bf16":
        return quantize(a, "bf16").data, np.ones(
            (a.shape[0], 1), np.float32
        )
    if mode == "int8":
        finite = np.isfinite(a)
        amax = np.max(
            np.where(finite, np.abs(a), np.float32(0)),
            axis=1,
            keepdims=True,
        ).astype(np.float32) if a.size else np.zeros(
            (a.shape[0], 1), np.float32
        )
        scales = np.where(
            amax > 0, amax / np.float32(127.0), np.float32(1.0)
        ).astype(np.float32)
        codes = np.clip(np.rint(a / scales), -127, 127)
        codes = np.where(np.isnan(a), np.float32(0), codes).astype(np.int8)
        checker = _rt_numerics_checker()
        if checker is not None:
            checker.on_quantize("quantize_rows", a, mode, scales, codes)
        return codes, scales
    raise ValueError(f"unknown quantization mode {mode!r}")


def dequantize_rows(codes: np.ndarray, scales, mode: str) -> np.ndarray:
    """float32 reconstruction of a blockwise pair (scales broadcast over
    rows; ignored for bf16)."""
    if mode == "bf16":
        return dequantize(QuantArray("bf16", 1.0, codes))
    if mode == "int8":
        checker = _rt_numerics_checker()
        if checker is not None:
            checker.on_dequantize("dequantize_rows", scales, mode)
        data = np.asarray(codes, dtype=np.int8)
        return data.astype(np.float32) * np.asarray(scales, np.float32)
    raise ValueError(f"unknown quantization mode {mode!r}")


# -- device (torch) face ---------------------------------------------------
#
# The torch twins return (codes, scales) pairs, as the reference's jnp face
# does: the collective path needs one scale per destination row of the
# reduce-scatter, which a scalar-field QuantArray cannot carry. Three rules
# keep them bit-equal to the numpy face on any device:
#
# - bf16 rounds on the float32 bit pattern in int64 (torch has no uint32
#   add or shift); the 32-bit wrap of numpy's uint32 add is a mask;
# - int8 divides ``a / scale`` in f32 by a tensor on the input's device
#   (PyTorch turns a division by a CPU scalar on CUDA into a multiply by
#   the reciprocal, which rounds differently), and clamps to ±127 before
#   the cast (a float out of int8's range casts to garbage on CUDA);
# - ``torch.round`` rounds half to even, as ``np.rint`` does. A NaN code
#   (a NaN input, or 0 / 0 where a scale underflows) becomes 0.


def _bf16_codes(a):
    """uint16 round-to-nearest-even high halves of f32 ``a``."""
    import torch

    u = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    hi = (((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFFFFFF) >> 16)
    # to int16's range first, so the narrowing cast is exact everywhere
    return (hi - ((hi >> 15) << 16)).to(torch.int16).view(torch.uint16)


def _bf16_values(codes):
    """f32 values of uint16 high halves (the low halves zero)."""
    import torch

    hi = codes.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF
    u = hi << 16
    return (u - ((u >> 31) << 32)).to(torch.int32).view(torch.float32)


def _int8_codes(a, scale):
    import torch

    q = torch.round(a / scale).clamp_(-127, 127)
    return torch.nan_to_num_(q, nan=0.0).to(torch.int8)


def _int8_scale(amax):
    import torch

    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                       torch.ones_like(amax))


def quantize_torch(x, mode: str):
    """Torch twin of :func:`quantize` (``quantize_jnp``): ``(codes,
    scale)`` for one tensor with ONE scale, a 0-d f32 tensor on its device
    (1.0 for bf16). Codes and scale are the numpy face's bit for bit."""
    import torch

    a = torch.as_tensor(x).to(torch.float32)
    if mode == "bf16":
        return _bf16_codes(a), torch.ones((), dtype=torch.float32, device=a.device)
    if mode == "int8":
        finite = torch.where(torch.isfinite(a), a.abs(), torch.zeros_like(a))
        amax = (finite.amax() if a.numel()
                else torch.zeros((), dtype=torch.float32, device=a.device))
        scale = _int8_scale(amax)
        return _int8_codes(a, scale), scale
    raise ValueError(f"unknown quantization mode {mode!r}")


def dequantize_torch(codes, scale, mode: str):
    """float32 reconstruction of a torch ``(codes, scale)`` pair."""
    import torch

    if mode == "bf16":
        return _bf16_values(codes)
    if mode == "int8":
        return codes.to(torch.float32) * torch.as_tensor(
            scale, dtype=torch.float32, device=codes.device)
    raise ValueError(f"unknown quantization mode {mode!r}")


def quantize_rows_torch(x, mode: str):
    """Torch twin of :func:`quantize_rows` (``quantize_rows_jnp``): each
    row of a 2-D tensor gets its own absmax scale. Returns ``(codes (B,
    n), scales (B, 1))``; bf16 scales are ones (carried for shape
    uniformity, never sent)."""
    import torch

    a = torch.as_tensor(x).to(torch.float32)
    if a.dim() != 2:
        raise ValueError(f"quantize_rows wants a 2-D array, got {tuple(a.shape)}")
    ones = torch.ones((a.shape[0], 1), dtype=torch.float32, device=a.device)
    if mode == "bf16":
        return _bf16_codes(a), ones
    if mode == "int8":
        if a.numel():
            finite = torch.where(torch.isfinite(a), a.abs(), torch.zeros_like(a))
            amax = finite.amax(dim=1, keepdim=True)
        else:
            amax = torch.zeros_like(ones)
        scales = _int8_scale(amax)
        return _int8_codes(a, scales), scales
    raise ValueError(f"unknown quantization mode {mode!r}")


def dequantize_rows_torch(codes, scales, mode: str):
    """float32 reconstruction of a blockwise pair (scales broadcast over
    rows; ignored for bf16)."""
    return dequantize_torch(codes, scales, mode)
