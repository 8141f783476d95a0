"""Flax-shaped layers and the functional model interface.

Each layer holds the leaves of its ``flax.linen`` counterpart under the same
names (``Conv``/``Dense``: ``kernel``, ``bias``; ``LayerNorm``/``GroupNorm``:
``scale``, ``bias``; ``Embed``: ``embedding``; ``OptimizedLSTMCell``: the
gate layers ``ii``/``if``/``ig``/``io`` and ``hi``/``hf``/``hg``/``ho``), so a
model's parameters form the flax tree (``{"Conv_0": {"bias", "kernel"},
...}``, nested as deep as the model nests its layers). Layouts:

- ``Conv.kernel`` is OIHW, PyTorch's own, for ``F.conv2d``; flax keeps HWIO.
  Images run NCHW inside the models; the public input stays NHWC.
- ``Dense.kernel`` is ``(in, out)``, flax's own, and the layer computes
  ``x @ kernel``. So a Dense leaf is the same array in both packages.

Padding follows ``lax``: ``"SAME"`` gives ``ceil(size / stride)`` outputs
and splits the total pad with the smaller half before, so a stride-2
window over an even size pads 0 before and 1 after (PyTorch's symmetric
``padding=1`` would shift every window by one); ``"VALID"`` pads nothing;
an int pads that much on both sides.

``mpit_tpu_torch.convert`` maps the two trees. Initialisation mirrors
flax's defaults, drawn on the CPU from a ``torch.Generator``: lecun-normal
kernels (truncated at two standard deviations), orthogonal recurrent
kernels, zero biases, unit norm scales, and embeddings normal with
variance 1 / features.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's variance_scaling "truncated_normal": the stddev of a unit normal
# truncated to [-2, 2], divided out so the kernel's variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    draw = torch.empty(t.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        t.copy_(draw * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """``lax``'s ``"SAME"`` split of one spatial dim: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _pads(size: int, k: int, stride: int, padding) -> tuple[int, int]:
    if padding == "SAME":
        return same_pads(size, k, stride)
    if padding == "VALID":
        return 0, 0
    return int(padding), int(padding)


def window_out(size: int, k: int, stride: int = 1, padding="VALID") -> int:
    """Output size of a conv or pool window over one spatial dim."""
    lo, hi = _pads(size, k, stride, padding)
    return (size + lo + hi - k) // stride + 1


def _pad2d(x, k: int, stride: int, padding, value: float = 0.0):
    """``x`` (..., H, W) padded as ``padding`` says, and the symmetric pad
    left for the op itself (0 after an asymmetric ``F.pad``)."""
    (top, bottom), (left, right) = (_pads(n, k, stride, padding)
                                    for n in x.shape[-2:])
    if top == bottom == left == right:
        return x, top
    return F.pad(x, (left, right, top, bottom), value=value), 0


class Conv(nn.Module):
    """``nn.Conv(features, (k, k), strides, padding, use_bias)`` on NCHW;
    ``padding`` is ``"SAME"`` (flax's default), ``"VALID"`` or an int."""

    def __init__(self, cin: int, cout: int, k: int, dtype, device,
                 stride: int = 1, padding="SAME", use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.kernel = nn.Parameter(torch.zeros(cout, cin, k, k, device=device))
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, math.prod(self.kernel.shape[1:]), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        x, pad = _pad2d(x, self.kernel.shape[-1], self.stride, self.padding)
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x, self.kernel.to(self.dtype), bias,
                        stride=self.stride, padding=pad)


def nchw(x: torch.Tensor, dtype) -> torch.Tensor:
    """An NHWC image batch in ``dtype`` and NCHW, copied into NCHW strides:
    a permuted view can also be channels-last (one channel always is), and
    cuDNN would pick a channels-last algorithm for it here but an NCHW one
    under vmap (the collective trainers), which rounds differently."""
    return x.to(dtype).permute(0, 3, 1, 2).clone(memory_format=torch.contiguous_format)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW features flattened in flax's NHWC order, as ``Dense_0`` reads
    them."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def max_pool(x, k: int, stride: int, padding="VALID"):
    """``nn.max_pool(x, (k, k), strides=(stride, stride), padding)`` on
    NCHW; ``"SAME"`` pads with -inf, split as ``lax`` splits it."""
    x, pad = _pad2d(x, k, stride, padding, value=float("-inf"))
    return F.max_pool2d(x, k, stride, padding=pad)


class Dense(nn.Module):
    """``nn.Dense(features, use_bias)``: ``x @ kernel (+ bias)`` with
    kernel (in, out)."""

    def __init__(self, fin: int, fout: int, dtype, device, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(fin, fout, device=device))
        self.bias = (nn.Parameter(torch.zeros(fout, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        y = x @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """``nn.LayerNorm(dtype=dtype)`` over the last dim: epsilon 1e-6 (torch's
    default is 1e-5), mean and the fast variance ``E[x²] − E[x]²`` (clipped
    at 0) in float32, the affine map in float32, the result in ``dtype``."""

    def __init__(self, features: int, dtype, device, epsilon: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x - mu) * mul + self.bias).to(self.dtype)


class GroupNorm(nn.Module):
    """``nn.GroupNorm(num_groups, dtype=dtype)`` on NCHW: each group of
    ``features / num_groups`` consecutive channels normalised over its
    channels and H, W, with epsilon 1e-6 and the fast variance in float32
    as :class:`LayerNorm`, then the per-channel affine map in float32; the
    result in ``dtype``."""

    def __init__(self, features: int, dtype, device, num_groups: int = 32,
                 epsilon: float = 1e-6):
        super().__init__()
        if features % num_groups:
            raise ValueError(
                f"Number of groups ({num_groups}) does not divide the number "
                f"of channels ({features})."
            )
        self.dtype = dtype
        self.num_groups = num_groups
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    reset_parameters = LayerNorm.reset_parameters

    def forward(self, x):
        shape, g = x.shape, self.num_groups
        c = shape[1]
        x = x.float().reshape(shape[0], g, c // g, -1)
        mu = x.mean((-2, -1), keepdim=True)
        var = torch.clamp((x * x).mean((-2, -1), keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale.reshape(g, c // g, 1)
        y = (x - mu) * mul + self.bias.reshape(g, c // g, 1)
        return y.reshape(shape).to(self.dtype)


class Embed(nn.Module):
    """``nn.Embed(num, features, dtype=dtype)``: rows of ``embedding``
    (num, features), gathered and returned in ``dtype``."""

    def __init__(self, num: int, features: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(num, features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # variance_scaling(1, "fan_in", "normal", out_axis=0): fan_in = features
        draw = torch.randn(self.embedding.shape, generator=generator)
        with torch.no_grad():
            self.embedding.copy_(draw / math.sqrt(self.embedding.shape[1]))

    def forward(self, tokens):
        return F.embedding(tokens.long(), self.embedding).to(self.dtype)


class OptimizedLSTMCell(nn.Module):
    """``nn.OptimizedLSTMCell(features, dtype=dtype)`` run over a sequence,
    as ``nn.RNN`` runs it from flax's zero carry.

    Leaves: ``ii``/``if``/``ig``/``io`` with ``kernel`` (in, H) and no bias,
    ``hi``/``hf``/``hg``/``ho`` with ``kernel`` (H, H) and ``bias``; the gates
    are i, f, g, o, the forget bias is not shifted. flax casts the operands
    of both gate products to ``dtype`` and keeps the carry in float32 (its
    zero carry is float32, and the ``dtype`` gates promote against it), so
    the gate products and their sums are in ``dtype`` while ``c' = f·c +
    i·g`` and ``h' = o·tanh(c')`` are float32, and the outputs are float32.
    The input product of every step is one (B·T, in) × (in, 4H) product
    before the time loop."""

    GATES = "ifgo"

    def __init__(self, fin: int, hidden: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        for g in self.GATES:
            self.add_module("i" + g, Dense(fin, hidden, dtype, device, use_bias=False))
            self.add_module("h" + g, Dense(hidden, hidden, dtype, device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for g in self.GATES:
            getattr(self, "i" + g).reset_parameters(generator)
            recurrent = getattr(self, "h" + g)
            draw = torch.empty(recurrent.kernel.shape)
            nn.init.orthogonal_(draw, generator=generator)
            with torch.no_grad():
                recurrent.kernel.copy_(draw)
                recurrent.bias.zero_()

    def forward(self, x):
        """(B, T, in) → (B, T, H) float32."""
        return self.scan(x)[1]

    def scan(self, x, carry=None, seq_lengths=None, matmul=torch.matmul):
        """``nn.RNN(cell)(x, initial_carry=carry, return_carry=True,
        seq_lengths=seq_lengths)``: the carry ``(c, h)`` (each (B, H)
        float32; flax's zero carry when None) run over (B, T, in), returned
        with the (B, T, H) outputs. With ``seq_lengths`` (B,) the carry of
        row ``n`` stops at step ``seq_lengths[n]``, as flax's selection of
        each row's last carry gives it. ``matmul`` computes the products
        (the decode path passes :func:`matmul_rows`)."""
        dt = self.dtype
        k_in = torch.cat([getattr(self, "i" + g).kernel for g in self.GATES], -1)
        k_h = torch.cat([getattr(self, "h" + g).kernel for g in self.GATES], -1).to(dt)
        b_h = torch.cat([getattr(self, "h" + g).bias for g in self.GATES], -1).to(dt)
        gates_in = matmul(x.to(dt), k_in.to(dt))
        if carry is None:
            zero = torch.zeros(x.shape[0], k_h.shape[0], dtype=torch.float32,
                               device=x.device)
            carry = (zero, zero)
        c, h = carry
        out = []
        for t in range(x.shape[1]):
            i, f, g, o = ((matmul(h.to(dt), k_h) + b_h) + gates_in[:, t]).chunk(4, -1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            out.append(h_new)
            if seq_lengths is None:
                c, h = c_new, h_new
            else:
                live = (t < seq_lengths)[:, None]
                c, h = torch.where(live, c_new, c), torch.where(live, h_new, h)
        return (c, h), torch.stack(out, 1)


#: The row count of every decode product whose rows are tokens. cuBLAS picks
#: its kernel, and so its order of summation, by shape, and PyTorch's CPU
#: path computes one row with a matrix-vector kernel that sums in another
#: order; a row then rounds apart from itself in a batch of another size.
#: Decoding runs its rows in blocks of this many, and :func:`matmul_rows`
#: pads a product to a multiple of it, so a row's result does not depend
#: on how many rows run beside it.
ROW_BLOCK = 8


def pad_rows(x: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
    """``x`` with zero rows appended along ``dim`` up to ``n`` rows."""
    short = n - x.shape[dim]
    if short <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = short
    return torch.cat([x, x.new_zeros(shape)], dim)


def matmul_rows(a: torch.Tensor, b: torch.Tensor, matmul=torch.matmul) -> torch.Tensor:
    """``matmul(a, b)`` with the row count padded by zero rows to a
    multiple of :data:`ROW_BLOCK` and the pad rows dropped from the result.
    A caller that hands it a row count which does not depend on the batch
    (a block of :data:`ROW_BLOCK` decode rows, one row's prompt chunk) gets
    each row's result from a product of one shape, whoever calls. ``b``
    2-D: ``a`` (..., K), every leading dim one row; ``b`` batched: ``a``
    (..., M, K). ``matmul`` is ``torch.matmul`` or
    :func:`~mpit_tpu_torch.ops.products.matmul_f32`."""
    if b.dim() == 2:
        rows = a.reshape(-1, a.shape[-1])
        out = matmul_rows(rows[None], b[None], matmul)[0]
        return out.reshape(*a.shape[:-1], b.shape[-1])
    m = a.shape[-2]
    padded = -(-m // ROW_BLOCK) * ROW_BLOCK
    if padded == m:
        return matmul(a, b)
    return matmul(pad_rows(a, padded, -2), b)[..., :m, :]


def reset_children(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise each child layer in registration order."""
    for layer in module.children():
        layer.reset_parameters(generator)


def params_tree(module: nn.Module) -> dict:
    """The module's parameters as the nested flax-keyed tree (copies)."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().clone()
    return tree


def rematerialized(module: nn.Module, x: torch.Tensor, **kwargs):
    """``module(x, **kwargs)`` with its activations recomputed on the
    backward pass (``torch.utils.checkpoint``, non-reentrant), flax's
    ``nn.remat``. The tensors the module holds now are passed to the
    checkpoint explicitly: inside :meth:`Model.apply` they are the caller's
    params, swapped in only while the forward runs, and a recompute that
    read the module's attributes later would use others."""
    from torch.utils.checkpoint import checkpoint

    names, tensors = zip(*module.named_parameters())

    def run(x, *tensors):
        return torch.func.functional_call(module, dict(zip(names, tensors)), (x,),
                                          kwargs)

    return checkpoint(run, x, *tensors, use_reentrant=False)


def _flat_names(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_names(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


class Model(nn.Module):
    """A model whose parameters also travel as a flax-keyed tree.

    ``init(generator)`` draws fresh parameters and returns them as the tree
    (flax's ``model.init(rng)["params"]``); ``apply(params, x)`` runs the
    forward pass on a given tree (flax's ``model.apply``), which is what
    the trainers ``vmap`` over the stacked workers."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)

    def init(self, generator: torch.Generator) -> dict:
        self.reset_parameters(generator)
        return params_tree(self)

    def apply(self, params: dict, x: torch.Tensor, *args, **kwargs):
        """Forward pass on ``params``, a flax-keyed tree of any depth;
        further arguments go to ``forward`` (a decode model's cache)."""
        return torch.func.functional_call(self, dict(_flat_names(params)),
                                          (x, *args), kwargs)

    def clone(self, **overrides) -> "Model":
        """The model with some of its settings replaced (flax's
        ``Module.clone``): a shallow copy sharing the layers and tensors,
        for settings read by the model's own ``forward`` (a decode model's
        ``decode``, ``head``, ``head_dtype``)."""
        import copy

        new = copy.copy(self)
        for name, value in overrides.items():
            if name not in self._CLONE_FIELDS:
                raise ValueError(
                    f"{type(self).__name__}.clone cannot change {name!r}; "
                    f"have {self._CLONE_FIELDS}"
                )
            object.__setattr__(new, name, value)
        new._check_settings()
        return new

    _CLONE_FIELDS: tuple = ()

    def _check_settings(self) -> None:
        """Validate settings a clone may have changed."""
