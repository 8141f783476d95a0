"""Space-to-depth convolution and the strided stem of ResNet-50 and AlexNet.

Counterpart of ``mpit_tpu/ops/stem.py``, which is plain ``jnp`` there
(no Pallas kernel), so here it is plain PyTorch. A k×k stride-s conv over a
3-channel image contracts only k·k·3 elements; the space-to-depth form
computes the same function over s×s space-to-depth input: the kernel is
zero-padded so every original tap lands on exactly one s2d tap, the conv
becomes stride 1 over s²·C channels, and the result is sliced to the
original output size.

Derivation (symmetric padding p, stride s, s | H):
  original output(i) taps rows s·i − p … s·i − p + k − 1.
  lo = ceil(p/s) s2d rows of conv padding; the kernel is zero-padded by
  t = s·lo − p on top/left (absorbing the out-of-window taps) and to a
  multiple of s on bottom/right; u = (t+k+pad)/s s2d taps per dim; conv
  padding hi = u − 1 − lo keeps one output per s2d row, and the result is
  sliced to the original output size.

Images are NCHW and kernels OIHW, the port's layouts; the s2d channel of
input channel ``ci`` at block offset (a, b) is ``(a·s + b)·C + ci``, the
reference's NHWC order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from mpit_tpu_torch.models.layers import Conv, lecun_normal_


def space_to_depth_conv(x, kernel, stride: int, padding: int, dt):
    """``conv(x, kernel, stride, padding=(p, p))`` computed s2d-style, on
    ``x`` (B, C, H, W) and ``kernel`` (O, C, k, k), in ``dt``.

    Needs spatial dims divisible by ``stride`` and ``k > 2·padding`` (true
    for every real stem)."""
    b, c, h, w = x.shape
    out_ch, kc, kh, kw = kernel.shape
    s, p = int(stride), int(padding)
    if kh != kw:
        raise ValueError(f"square kernels only, got {kh}x{kw}")
    if kc != c:
        raise ValueError(f"kernel expects {kc} channels, input has {c}")
    if h % s or w % s:
        raise ValueError(
            f"space-to-depth conv needs spatial dims divisible by "
            f"stride={s}, got {h}x{w}"
        )
    if kh <= 2 * p:
        raise ValueError(f"need kernel {kh} > 2*padding {2 * p}")
    lo = -(-p // s)
    t = s * lo - p
    taps = t + kh
    u = -(-taps // s)
    bpad = s * u - taps
    k = F.pad(kernel, (t, bpad, t, bpad))
    k = (
        k.reshape(out_ch, c, u, s, u, s)
        .permute(0, 3, 5, 1, 2, 4)
        .reshape(out_ch, s * s * c, u, u)
    )
    xs = (
        x.reshape(b, c, h // s, s, w // s, s)
        .permute(0, 3, 5, 1, 2, 4)
        .reshape(b, s * s * c, h // s, w // s)
    )
    hi = u - 1 - lo
    xs = F.pad(xs.to(dt), (lo, hi, lo, hi))
    out = F.conv2d(xs, k.to(dt))
    out_h = (h + 2 * p - kh) // s + 1
    out_w = (w + 2 * p - kw) // s + 1
    return out[:, :, :out_h, :out_w]


def add_stem(module: nn.Module, cin: int, features: int, kernel: int, stride: int,
             padding: int, stem: str, dt, device, use_bias: bool = False) -> None:
    """Register the stem's leaves on ``module`` under the reference's
    names: a ``Conv_0`` layer for ``stem="conv"``, the ``stem_kernel`` (and
    ``stem_bias``) leaves for ``stem="space_to_depth"`` (the same shapes;
    checkpoints do not interchange between stems)."""
    if stem == "conv":
        module.Conv_0 = Conv(cin, features, kernel, dt, device, stride=stride,
                             padding=padding, use_bias=use_bias)
    elif stem == "space_to_depth":
        module.stem_kernel = nn.Parameter(
            torch.zeros(features, cin, kernel, kernel, device=device))
        module.stem_bias = (nn.Parameter(torch.zeros(features, device=device))
                            if use_bias else None)
    else:
        raise ValueError(f"unknown stem {stem!r}; have: conv, space_to_depth")


def reset_stem(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise ``stem_kernel`` (lecun-normal) and ``stem_bias`` (zeros)
    where :func:`add_stem` registered them; ``Conv_0`` is a child layer
    and initialises itself."""
    if getattr(module, "stem_kernel", None) is not None:
        k = module.stem_kernel
        lecun_normal_(k, math.prod(k.shape[1:]), generator)
        if module.stem_bias is not None:
            nn.init.zeros_(module.stem_bias)


def stem_conv(module: nn.Module, x, stride: int, padding: int, stem: str, dt):
    """The one strided-stem dispatch of the stem-capable models (resnet50,
    alexnet), over the leaves :func:`add_stem` registered on ``module``."""
    if stem == "space_to_depth":
        y = space_to_depth_conv(x, module.stem_kernel, stride, padding, dt)
        if module.stem_bias is not None:
            y = y + module.stem_bias.to(dt)[:, None, None]
        return y
    if stem == "conv":
        return module.Conv_0(x)
    raise ValueError(f"unknown stem {stem!r}; have: conv, space_to_depth")
