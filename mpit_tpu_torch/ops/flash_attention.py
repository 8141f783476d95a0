"""Flash attention: CUDA kernels, their plain versions, and the
``torch.autograd.Function`` that trains through them.

Counterpart of ``mpit_tpu/ops/flash_attention.py``. The kernels are built
on first use by ``ops/_build.py`` and called through ``ctypes``:

- forward: ``(O, LSE)`` by online softmax, LSE ``+inf`` for a row no key sees;
- dQ: ``scale · Σ_j P∘(dP − dd) K_j`` with P recomputed from the LSE;
- dK/dV: ``scale · Σ_i dSᵀ Q_i`` and ``Σ_i Pᵀ dO_i``, fused.

Two families of the same three kernels (see each source's header for
its bounds and design): ``csrc/flash_attention_sm90.cu`` runs them on the
tensor cores (``wgmma``, P and dS rounded to bf16) for what
:func:`_sm90_takes` accepts: bf16, D = 64, T a multiple of 64.
``csrc/flash_attention.cu`` runs them with f32 P and f32 FMAs for
everything else (f32, other head dims, other lengths).

All three work on ``(B·H, T, D)``; :func:`flash_attention` takes the
reference's ``(B, T, H, D)``. The backward computes ``dd = rowsum(dO∘O)``
in f32 outside the kernels, as the reference does.

``use_kernel`` has the meaning of the reference's ``use_pallas``: True
requires the kernels (and raises for a CPU tensor), False is
:func:`dense_attention`, None is the kernels for CUDA tensors and their
plain versions for CPU tensors. So on the CPU the same ``autograd.Function``
runs, through the LSE-recompute backward. The reference's rule for a T
that does not tile stays: blocks clamp to T, and a block that is not a
multiple of 8 or does not divide T goes to :func:`dense_attention` (no
launch is counted). A head dim the kernels do not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from mpit_tpu_torch.ops.ring_attention import dense_attention

# kernel launches by the wrappers below; a run resets them to 0 and reads
# them back to show that its main path went through the kernels. A captured
# training unit (``parallel/capture.py``) adds its launches on each replay
launches = {"flash_forward": 0, "flash_dq": 0, "flash_dkv": 0,
            "flash_forward_sm90": 0, "flash_dq_sm90": 0, "flash_dkv_sm90": 0}

_DTYPES = (torch.float32, torch.bfloat16)


# -- plain versions (whole tensors, (BH, T, D)) -----------------------------

def _scores(q, k, causal: bool):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (q.shape[-1] ** -0.5)
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        keep = (torch.arange(t_k, device=s.device)[None, :]
                <= torch.arange(t_q, device=s.device)[:, None])
        s = torch.where(keep, s, float("-inf"))
    return s


def flash_forward_plain(q, k, v, causal: bool):
    """``(O, LSE)``; a row no key sees gets LSE ``+inf`` and an O row of 0."""
    s = _scores(q, k, causal)
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(torch.isneginf(lse), float("inf"), lse)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _probs_and_ds(q, k, v, do, lse, dd, causal):
    p = torch.exp(_scores(q, k, causal) - lse[..., None])  # lse = +inf -> 0
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    return p, p * (dp - dd[..., None])


def flash_dq_plain(q, k, v, do, lse, dd, causal: bool):
    _, ds = _probs_and_ds(q, k, v, do, lse, dd, causal)
    return (torch.matmul(ds, k.float()) * (q.shape[-1] ** -0.5)).to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, dd, causal: bool):
    p, ds = _probs_and_ds(q, k, v, do, lse, dd, causal)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * (q.shape[-1] ** -0.5)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- the kernels --------------------------------------------------------------

def _check(name: str, tensors, rows) -> tuple[int, int, int]:
    """Validate the kernel's inputs; returns (BH, T, D)."""
    q = tensors[0]
    if q.dim() != 3:
        raise ValueError(f"{name} kernel: q is {tuple(q.shape)}, not (B*H, T, D)")
    bh, t, d = q.shape
    if d % 8 != 0 or not 8 <= d <= 128:
        raise ValueError(f"{name} kernel: head dim {d} is not a multiple of 8 up to 128")
    for t_, want_shape, want_dtype in (
        [(x, q.shape, q.dtype) for x in tensors] + [(r, (bh, t), torch.float32) for r in rows]
    ):
        if not t_.is_cuda:
            raise ValueError(f"{name} kernel: an input is on {t_.device}, not CUDA")
        if t_.device != q.device:
            raise ValueError(f"{name} kernel: inputs are on different devices")
        if tuple(t_.shape) != tuple(want_shape):
            raise ValueError(f"{name} kernel: shape {tuple(t_.shape)} != {tuple(want_shape)}")
        if t_.dtype != want_dtype or want_dtype not in _DTYPES:
            raise ValueError(f"{name} kernel: dtype {t_.dtype}, need {want_dtype} "
                             "(float32 or bfloat16)")
        if not t_.is_contiguous() or t_.data_ptr() % 16:
            raise ValueError(f"{name} kernel: an input is not contiguous and 16-byte aligned")
    if bh > 65535:
        raise ValueError(f"{name} kernel: B*H = {bh} exceeds the grid's 65535")
    return bh, t, d


# C entry -> (its source in csrc/, its pointer arguments); every entry then
# takes (bh, t, d, causal, bf16) as ints and the stream
_ARGTYPES = {
    "mpit_flash_forward": ("flash_attention", 5),
    "mpit_flash_dq": ("flash_attention", 7),
    "mpit_flash_dkv": ("flash_attention", 8),
    "mpit_flash_forward_sm90": ("flash_attention_sm90", 5),
    "mpit_flash_dq_sm90": ("flash_attention_sm90", 7),
    "mpit_flash_dkv_sm90": ("flash_attention_sm90", 8),
}


def _sm90_takes(q) -> bool:
    """Whether the tensor-core kernels take ``q`` of shape (B·H, T, D):
    bf16, D = 64 and T a multiple of 64. The rule is explicit: anything
    else goes to the CUDA-core kernels, never by a caught failure."""
    return (q.dtype == torch.bfloat16 and q.dim() == 3 and q.shape[-1] == 64
            and q.shape[1] % 64 == 0)


def _fn(symbol: str):
    from mpit_tpu_torch.ops import _build

    source, pointers = _ARGTYPES[symbol]
    fn = getattr(_build.load(source), symbol)
    if fn.argtypes is None:  # declare once; ctypes would pass ints as 32 bits
        fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(counter: str, symbol: str, ptrs, bh, t, d, causal, dtype, device):
    fn = _fn(symbol)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, bh, t, d, int(causal), int(dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: CUDA error {err}")
    launches[counter] += 1


def flash_forward_cuda(q, k, v, causal: bool):
    """Launch the forward kernel; returns ``(O, LSE)`` without synchronising."""
    bh, t, d = _check("flash forward", (q, k, v), ())
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    _launch("flash_forward", "mpit_flash_forward",
            [x.data_ptr() for x in (q, k, v, o, lse)], bh, t, d, causal, q.dtype, q.device)
    return o, lse


def _check_sm90(name: str, tensors, rows) -> tuple[int, int, int]:
    bh, t, d = _check(name, tensors, rows)
    if not _sm90_takes(tensors[0]):
        raise ValueError(f"{name} kernel: takes bf16 with D = 64 and T a multiple "
                         f"of 64, not {tensors[0].dtype} with D = {d}, T = {t}")
    return bh, t, d


def flash_forward_sm90(q, k, v, causal: bool):
    """The tensor-core forward; returns ``(O, LSE)`` without synchronising."""
    bh, t, d = _check_sm90("flash forward sm90", (q, k, v), ())
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), dtype=torch.float32, device=q.device)
    _launch("flash_forward_sm90", "mpit_flash_forward_sm90",
            [x.data_ptr() for x in (q, k, v, o, lse)], bh, t, d, causal, q.dtype, q.device)
    return o, lse


def flash_dq_cuda(q, k, v, do, lse, dd, causal: bool):
    bh, t, d = _check("flash dQ", (q, k, v, do), (lse, dd))
    dq = torch.empty_like(q)
    _launch("flash_dq", "mpit_flash_dq",
            [x.data_ptr() for x in (q, k, v, do, lse, dd, dq)], bh, t, d, causal,
            q.dtype, q.device)
    return dq


def flash_dkv_cuda(q, k, v, do, lse, dd, causal: bool):
    bh, t, d = _check("flash dK/dV", (q, k, v, do), (lse, dd))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_dkv", "mpit_flash_dkv",
            [x.data_ptr() for x in (q, k, v, do, lse, dd, dk, dv)], bh, t, d, causal,
            q.dtype, q.device)
    return dk, dv


def flash_dq_sm90(q, k, v, do, lse, dd, causal: bool):
    bh, t, d = _check_sm90("flash dQ sm90", (q, k, v, do), (lse, dd))
    dq = torch.empty_like(q)
    _launch("flash_dq_sm90", "mpit_flash_dq_sm90",
            [x.data_ptr() for x in (q, k, v, do, lse, dd, dq)], bh, t, d, causal,
            q.dtype, q.device)
    return dq


def flash_dkv_sm90(q, k, v, do, lse, dd, causal: bool):
    bh, t, d = _check_sm90("flash dK/dV sm90", (q, k, v, do), (lse, dd))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_dkv_sm90", "mpit_flash_dkv_sm90",
            [x.data_ptr() for x in (q, k, v, do, lse, dd, dk, dv)], bh, t, d, causal,
            q.dtype, q.device)
    return dk, dv


# -- the autograd.Function (the reference's custom_vjp) -----------------------

class _Flash(torch.autograd.Function):
    """``(q, k, v)`` of shape ``(B·H, T, D)`` → ``(O, LSE)``; ``kernel``
    picks the CUDA kernels (the family by :func:`_sm90_takes`) or the
    plain versions in both directions."""

    @staticmethod
    def forward(q, k, v, causal, kernel):
        if not kernel:
            return flash_forward_plain(q, k, v, causal)
        fwd = flash_forward_sm90 if _sm90_takes(q) else flash_forward_cuda
        return fwd(q, k, v, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, kernel = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.kernel = causal, kernel
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashBackward.apply(q, k, v, o, lse, do, ctx.causal, ctx.kernel)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, kernel):
        """Fold the mapped dim into B·H: each slice is independent rows."""
        n = info.batch_size
        qs, ks, vs = (_fold(x, dim, n) for x, dim in zip((q, k, v), in_dims[:3]))
        o, lse = _Flash.apply(qs, ks, vs, causal, kernel)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


class _FlashBackward(torch.autograd.Function):
    """The backward pass as a function of its own, so that under
    ``torch.func.grad``/``vmap`` its forward (and so the kernels) receive
    plain tensors. Attention is differentiable once: its gradient has no
    gradient here, as in the reference's ``custom_vjp``."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, kernel):
        do = do.contiguous()
        dd = (do.float() * o.float()).sum(-1)  # D_i = Σ_d dO_id O_id, f32
        if kernel:
            sm90 = _sm90_takes(q)
            dq = (flash_dq_sm90 if sm90 else flash_dq_cuda)(q, k, v, do, lse, dd, causal)
            dkv = flash_dkv_sm90 if sm90 else flash_dkv_cuda
            dk, dv = dkv(q, k, v, do, lse, dd, causal)
        else:
            dq = flash_dq_plain(q, k, v, do, lse, dd, causal)
            dk, dv = flash_dkv_plain(q, k, v, do, lse, dd, causal)
        return dq, dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("flash attention is differentiable once")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, kernel):
        n = info.batch_size
        args = [_fold(x, dim, n) for x, dim in zip((q, k, v, o, lse, do), in_dims[:6])]
        grads = _FlashBackward.apply(*args, causal, kernel)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def _fold(x, dim, n: int):
    """A tensor mapped on ``dim`` (None: not mapped) -> its n slices
    stacked along dim 0 of one contiguous tensor."""
    x = x.unsqueeze(0).expand(n, *x.shape) if dim is None else x.movedim(dim, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:]).contiguous()


def _unfold(x, n: int):
    return x.reshape(n, -1, *x.shape[1:])


def _to2d(a):
    """(B, T, H, D) -> (B·H, T, D), the kernels' layout."""
    b, t, h, d = a.shape
    return a.transpose(1, 2).reshape(b * h, t, d).contiguous()


def flash_attention(q, k, v, causal: bool = False, block_q: int = 128,
                    block_k: int = 128, use_kernel=None):
    """Tiled exact attention, ``(B, T, H, D) -> (B, T, H, D)``, trainable
    through the kernels (or, on the CPU, their plain versions)."""
    t = q.shape[1]
    block_q, block_k = min(block_q, t), min(block_k, t)
    tiles = (t % block_q == 0 and t % block_k == 0
             and block_q % 8 == 0 and block_k % 8 == 0)
    if use_kernel is False or not tiles:
        return dense_attention(q, k, v, causal=causal)
    kernel = bool(use_kernel) or q.is_cuda
    b, _, h, d = q.shape
    o, _ = _Flash.apply(_to2d(q), _to2d(k), _to2d(v), causal, kernel)
    return o.reshape(b, h, t, d).transpose(1, 2)
