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
:func:`elastic_update_leaves` does the same for a list of leaves (a
round's whole tree) in one launch per :data:`MAX_LEAVES` leaves.

Each function takes ``inplace``: True writes ``new_x`` over ``x`` and
``new_c`` over ``center`` and returns them (the trainers' ``donate_state``).
The kernel then gets the input pointers as its outputs, which its source
allows (see its header), and nothing is allocated; the plain version
computes as out of place, then copies. The bits are the same either way.

``use_kernel`` has the meaning of the reference's ``use_pallas``: True
requires the kernel (and raises for a CPU tensor), False is the plain
version, None is the kernel for CUDA tensors and the plain version for CPU
tensors. There is no fallback: a CUDA tensor the kernel cannot take raises.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches by the wrappers below; a run resets it to 0 and reads it
# back to show that its main path went through the kernel. A captured
# training unit (``parallel/capture.py``) adds its launches on each replay
launches = 0
# leaves per launch: the kernel's parameter table (kMaxLeaves in elastic.cu)
MAX_LEAVES = 32


def elastic_update_plain(x, center, total_diff, alpha: float, inplace: bool = False):
    """The plain PyTorch version; returns ``(new_x, new_center)``."""
    new_x, new_c = x - alpha * (x - center), center + alpha * total_diff
    if not inplace:
        return new_x, new_c
    with torch.no_grad():
        return x.copy_(new_x), center.copy_(new_c)


def _workers(x: torch.Tensor, center: torch.Tensor, total_diff: torch.Tensor) -> int:
    """W from the shapes (1 for an unstacked x); raises on shapes the
    kernel does not take."""
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


def _check(x: torch.Tensor, center: torch.Tensor, total_diff: torch.Tensor) -> int:
    """Validate the kernel's inputs; returns W (1 for an unstacked x)."""
    w = _workers(x, center, total_diff)
    for name, t in (("x", x), ("center", center), ("total_diff", total_diff)):
        if not t.is_cuda:
            raise ValueError(f"elastic kernel: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise ValueError(f"elastic kernel: {name} is {t.dtype}, not float32")
        if not t.is_contiguous():
            raise ValueError(f"elastic kernel: {name} is not contiguous")
        if t.device != x.device:
            raise ValueError("elastic kernel: inputs are on different devices")
    return w


_PTRS = ctypes.POINTER(ctypes.c_void_p)
# C entry -> its argument types (ctypes would pass ints as 32 bits)
_ARGTYPES = {
    "mpit_elastic_update": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
    "mpit_elastic_update_leaves": [_PTRS] * 5 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p],
}


def _fn(symbol: str):
    from mpit_tpu_torch.ops import _build

    fn = getattr(_build.load("elastic"), symbol)
    if fn.argtypes is None:  # declare once
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return fn


def _call(symbol: str, args, device) -> None:
    with torch.cuda.device(device):
        err = _fn(symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"elastic kernel launch failed: CUDA error {err}")


def elastic_update_cuda(x, center, total_diff, alpha: float, inplace: bool = False):
    """Launch the kernel on the current stream; returns ``(new_x, new_c)``
    without synchronising."""
    global launches
    w = _check(x, center, total_diff)
    new_x = x if inplace else torch.empty_like(x)
    new_c = center if inplace else torch.empty_like(center)
    _call("mpit_elastic_update",
          (x.data_ptr(), center.data_ptr(), total_diff.data_ptr(), new_x.data_ptr(),
           new_c.data_ptr(), center.numel(), w, float(alpha)), x.device)
    launches += 1
    return new_x, new_c


def elastic_update_leaves_cuda(xs, centers, diffs, alpha: float, inplace: bool = False):
    """Launch the kernel once per :data:`MAX_LEAVES` non-empty leaves on
    the current stream; returns ``(new_xs, new_centers)`` without
    synchronising. Every leaf is checked, and all must share one W and one
    device, before any launch."""
    global launches
    if not xs:
        return [], []
    ws = {_workers(x, c, d) for x, c, d in zip(xs, centers, diffs)}
    if len(ws) > 1:
        raise ValueError(f"elastic kernel: the leaves stack W = {sorted(ws)} workers, "
                         "not one W")
    (w,) = ws
    for x, c, d in zip(xs, centers, diffs):
        _check(x, c, d)
        if x.device != xs[0].device:
            raise ValueError("elastic kernel: leaves are on different devices")
    new_xs = xs if inplace else [torch.empty_like(x) for x in xs]
    new_cs = centers if inplace else [torch.empty_like(c) for c in centers]
    busy = sum(c.numel() > 0 for c in centers) if w > 0 else 0
    if busy:
        ptrs = [(ctypes.c_void_p * len(xs))(*(t.data_ptr() for t in ts))
                for ts in (xs, centers, diffs, new_xs, new_cs)]
        sizes = (ctypes.c_longlong * len(xs))(*(c.numel() for c in centers))
        _call("mpit_elastic_update_leaves",
              (*ptrs, sizes, len(xs), w, float(alpha)), xs[0].device)
        launches += -(-busy // MAX_LEAVES)
    return new_xs, new_cs


def elastic_update(x, center, total_diff, alpha: float, use_kernel=None,
                   inplace: bool = False):
    """Fused elastic pair update; returns ``(new_x, new_center)``."""
    if use_kernel is None:
        use_kernel = x.is_cuda
    if not use_kernel:
        return elastic_update_plain(x, center, total_diff, alpha, inplace)
    return elastic_update_cuda(x, center, total_diff, alpha, inplace)


def elastic_update_leaves(xs, centers, diffs, alpha: float, use_kernel=None,
                          inplace: bool = False):
    """:func:`elastic_update` over lists of leaves, in one launch per
    :data:`MAX_LEAVES` leaves; returns ``(new_xs, new_centers)``.
    ``use_kernel`` as in :func:`elastic_update`, None deciding by the first
    leaf."""
    xs, centers, diffs = list(xs), list(centers), list(diffs)
    if not len(xs) == len(centers) == len(diffs):
        raise ValueError(f"elastic kernel: {len(xs)} x, {len(centers)} center and "
                         f"{len(diffs)} total_diff leaves")
    if use_kernel is None:
        use_kernel = bool(xs) and xs[0].is_cuda
    if not use_kernel:
        pairs = [elastic_update_plain(x, c, d, alpha, inplace)
                 for x, c, d in zip(xs, centers, diffs)]
        return [x for x, _ in pairs], [c for _, c in pairs]
    return elastic_update_leaves_cuda(xs, centers, diffs, alpha, inplace)
