"""Fused EASGD elastic update: the CUDA kernel, its plain version, and the
wrapper that picks between them.

Counterpart of ``mpit_tpu/ops/elastic.py``. The exchange round's
elementwise math (``goptim.easgd_round``)::

    new_x = x - α (x - c)            (client move toward the center)
    new_c = c + α d                  (center move; d = Σ_w (x_w - c))

The kernel is ``csrc/elastic.cu`` (see its header for its bound and
design), built on first use by ``ops/_build.py`` and called through
``ctypes``. ``x`` is one worker's tensor (the reference's per-device shape)
or W workers stacked on a leading dim; ``c`` and ``d`` have the unstacked
shape, and ``new_c`` is written once, not W times.

``use_kernel`` has the meaning of the reference's ``use_pallas``: True
requires the kernel (and raises for a CPU tensor), False is the plain
version, None is the kernel for CUDA tensors and the plain version for CPU
tensors. There is no fallback: a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches by this wrapper; a run resets it to 0 and reads it back
# to show that its main path went through the kernel
launches = 0


def elastic_update_plain(x, center, total_diff, alpha: float):
    """The plain PyTorch version; returns ``(new_x, new_center)``."""
    return x - alpha * (x - center), center + alpha * total_diff


def _check(x: torch.Tensor, center: torch.Tensor, total_diff: torch.Tensor) -> int:
    """Validate the kernel's inputs; returns W (1 for an unstacked x)."""
    for name, t in (("x", x), ("center", center), ("total_diff", total_diff)):
        if not t.is_cuda:
            raise ValueError(f"elastic kernel: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise ValueError(f"elastic kernel: {name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"elastic kernel: {name} is not contiguous")
        if t.device != x.device:
            raise ValueError("elastic kernel: inputs are on different devices")
    if total_diff.shape != center.shape:
        raise ValueError(
            f"elastic kernel: total_diff {tuple(total_diff.shape)} != center "
            f"{tuple(center.shape)}"
        )
    if x.shape == center.shape:
        return 1
    if x.dim() == center.dim() + 1 and x.shape[1:] == center.shape:
        return x.shape[0]
    raise ValueError(
        f"elastic kernel: x {tuple(x.shape)} is neither center's shape "
        f"{tuple(center.shape)} nor W stacked copies of it"
    )


def _lib() -> ctypes.CDLL:
    from mpit_tpu_torch.ops import _build

    lib = _build.load("elastic")
    fn = lib.mpit_elastic_update
    if fn.argtypes is None:  # declare once; ctypes would pass ints as 32 bits
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def elastic_update_cuda(x, center, total_diff, alpha: float):
    """Launch the kernel on the current stream; returns ``(new_x, new_c)``
    without synchronising."""
    global launches
    w = _check(x, center, total_diff)
    fn = _lib().mpit_elastic_update
    new_x = torch.empty_like(x)
    new_c = torch.empty_like(center)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), center.data_ptr(), total_diff.data_ptr(),
            new_x.data_ptr(), new_c.data_ptr(), center.numel(), w,
            float(alpha), stream,
        )
    if err != 0:
        raise RuntimeError(f"elastic kernel launch failed: CUDA error {err}")
    launches += 1
    return new_x, new_c


def elastic_update(x, center, total_diff, alpha: float, use_kernel=None):
    """Fused elastic pair update; returns ``(new_x, new_center)``."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return elastic_update_plain(x, center, total_diff, alpha)
    return elastic_update_cuda(x, center, total_diff, alpha)
