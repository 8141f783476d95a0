"""The port's flash attention against the JAX package's, on the CPU.

Inputs come from numpy with a seed and go through both packages. The JAX
side runs its Pallas kernels in interpret mode (``_flash_pallas``,
``_flash_pallas_bwd``), as ``tests/test_flash_attention.py`` does; the
port side gets CPU tensors, so it takes the kernels' plain versions, and
its ``autograd.Function`` runs the same LSE-recompute backward the kernels
run on the card. Tolerances are the reference's: 2e-5 in f32 (sums in
another order), 2e-2 for the bf16 forward and 3e-2 for bf16 gradients
(the outputs are rounded to bf16, 2^-8 relative, at other places).
"""

import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.ops.ring_attention import dense_attention as jax_dense
from mpit_tpu_torch.ops import _build
from mpit_tpu_torch.ops import flash_attention as port_fa
from mpit_tpu_torch.ops.ring_attention import dense_attention

jax_fa = importlib.import_module("mpit_tpu.ops.flash_attention")

FWD_TOL = {"f32": 2e-5, "bf16": 2e-2}
GRAD_TOL = {"f32": 2e-5, "bf16": 3e-2}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
# (t, blocks, causal, dtype): the reference's kernel cases
CASES = [
    (128, 128, True, "f32"),   # single block
    (256, 128, True, "f32"),   # multi-block + skip logic
    (256, 128, False, "f32"),  # full attention
    (128, 32, True, "f32"),    # many tiny blocks
    (256, 128, True, "bf16"),  # reduced-precision inputs
]
IDS = [f"t{t}-b{b}-{'causal' if c else 'full'}-{dt}" for t, b, c, dt in CASES]


def _qkv(t, dtype, seed, b=2, h=2, d=16):
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrs = [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]
    return ([jnp.asarray(a, jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _f32(a):
    return np.asarray(a.float().numpy() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("t,blocks,causal,dtype", CASES, ids=IDS)
def test_forward_matches_pallas_interpret(t, blocks, causal, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(t, dtype, 0)
    ref_o, ref_lse = jax_fa._flash_pallas(jq, jk, jv, causal, blocks, blocks, True)
    o, lse = port_fa.flash_forward_plain(
        port_fa._to2d(q), port_fa._to2d(k), port_fa._to2d(v), causal
    )
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    _close(o, jax_fa._to2d(ref_o).astype(jnp.float32), FWD_TOL[dtype])
    _close(lse, ref_lse, FWD_TOL[dtype])


@pytest.mark.parametrize("t,blocks,causal,dtype", CASES, ids=IDS)
def test_dq_and_dkv_match_pallas_interpret(t, blocks, causal, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(t, dtype, 1)
    (jdo, _, _), (do, _, _) = _qkv(t, dtype, 2)
    ref_o, ref_lse = jax_fa._flash_pallas(jq, jk, jv, causal, blocks, blocks, True)
    ref = jax_fa._flash_pallas_bwd(jq, jk, jv, ref_o, ref_lse, jdo, causal,
                                   blocks, blocks, True)
    q2, k2, v2, do2 = (port_fa._to2d(x) for x in (q, k, v, do))
    o2 = torch.from_numpy(np.array(jax_fa._to2d(ref_o).astype(jnp.float32))).to(q.dtype)
    lse = torch.from_numpy(np.array(ref_lse))
    dd = (do2.float() * o2.float()).sum(-1)
    dq = port_fa.flash_dq_plain(q2, k2, v2, do2, lse, dd, causal)
    dk, dv = port_fa.flash_dkv_plain(q2, k2, v2, do2, lse, dd, causal)
    for got, want in zip((dq, dk, dv), ref):
        assert got.dtype == q.dtype
        _close(got, jax_fa._to2d(want).astype(jnp.float32), GRAD_TOL[dtype])


@pytest.mark.parametrize("t,blocks,causal,dtype", CASES, ids=IDS)
def test_autograd_matches_jax_grad_of_the_kernels(t, blocks, causal, dtype):
    """Gradients through the port's autograd.Function against jax.grad of
    the reference's flash_attention(use_pallas=True) (its custom_vjp). The
    loss is O against a fixed N(0, 1) cotangent, so dO is O(1) and most
    gradient elements lie beyond the tolerance: zeros would not pass."""
    (jq, jk, jv), (q, k, v) = _qkv(t, dtype, 3)
    r = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    jr, tr = jnp.asarray(r), torch.from_numpy(r)

    def jloss(a, b, c):
        o = jax_fa.flash_attention(a, b, c, causal=causal, block_q=blocks,
                                   block_k=blocks, use_pallas=True)
        return (o.astype(jnp.float32) * jr).sum()

    def loss(a, b, c):
        o = port_fa.flash_attention(a, b, c, causal=causal, block_q=blocks,
                                    block_k=blocks)
        return (o.float() * tr).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    got = torch.func.grad(loss, argnums=(0, 1, 2))(q, k, v)
    for g, r in zip(got, ref):
        assert g.dtype == q.dtype and tuple(g.shape) == r.shape
        assert (np.abs(np.asarray(r, np.float32)) > GRAD_TOL[dtype]).mean() > 0.5
        _close(g, np.asarray(r, np.float32), GRAD_TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_attention_matches_reference(causal, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(64, dtype, 4)
    ref = jax_dense(jq, jk, jv, causal=causal)
    got = dense_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype
    _close(got, np.asarray(ref, np.float32), 1e-6 if dtype == "f32" else 2e-2)


def test_untileable_length_goes_to_dense_with_no_launch():
    (jq, jk, jv), (q, k, v) = _qkv(100, "f32", 5)
    before = dict(port_fa.launches)
    got = port_fa.flash_attention(q, k, v, causal=True, use_kernel=True)
    ref = jax_fa.flash_attention(jq, jk, jv, causal=True, use_pallas=True)
    _close(got, np.asarray(ref), 1e-6)
    torch.testing.assert_close(got, dense_attention(q, k, v, causal=True), rtol=0, atol=0)
    assert port_fa.launches == before


def test_kernel_switch_on_the_cpu():
    """None takes the plain versions for CPU tensors (no launch counted);
    False is dense attention; True requires the kernels and raises for a
    CPU tensor, before any launch."""
    _, (q, k, v) = _qkv(64, "f32", 6)
    before = dict(port_fa.launches)
    plain = port_fa.flash_attention(q, k, v, causal=True)
    dense = port_fa.flash_attention(q, k, v, causal=True, use_kernel=False)
    torch.testing.assert_close(plain, dense, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(dense, dense_attention(q, k, v, causal=True),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="not CUDA"):
        port_fa.flash_attention(q, k, v, causal=True, use_kernel=True)
    assert port_fa.launches == before


@pytest.mark.parametrize("d", [12, 136])
def test_kernel_refuses_a_head_dim_it_does_not_take(d):
    x = torch.zeros(2, 16, d)
    with pytest.raises(ValueError, match="head dim"):
        port_fa.flash_forward_cuda(x, x, x, True)


def test_vmap_of_grad_folds_into_the_batch():
    """torch.func.vmap over grad through the Function: each mapped slice
    gets the gradient it gets alone, mapped or broadcast inputs alike."""
    _, (q, k, v) = _qkv(64, "f32", 7)

    def loss(a, b, c):
        return (port_fa.flash_attention(a, b, c, causal=True) ** 2).mean()

    grad = torch.func.grad(loss, argnums=(0, 1, 2))
    mapped = torch.func.vmap(grad, in_dims=(0, None, 0))(
        torch.stack([q, 0.5 * q]), k, torch.stack([v, -v])
    )
    for i, (qi, vi) in enumerate([(q, v), (0.5 * q, -v)]):
        for g, want in zip(mapped, grad(qi, k, vi)):
            torch.testing.assert_close(g[i], want, rtol=1e-6, atol=1e-7)


def test_gradient_of_the_gradient_is_refused():
    _, (q, k, v) = _qkv(32, "f32", 8)
    q.requires_grad_()
    out = port_fa.flash_attention(q, k, v, causal=True)
    (g,) = torch.autograd.grad(out.sum(), q, create_graph=True)
    with pytest.raises(NotImplementedError, match="differentiable once"):
        g.sum().backward()


# -- the tensor-core kernels (csrc/flash_attention_sm90.cu) -------------------

def _forward_bf16_p(q, k, v, causal, block=64):
    """The sm90 forward's arithmetic in torch: f32 scores of the bf16
    inputs, online softmax over tiles of 64 keys with f32 statistics, P
    rounded to bf16 before ``P V``, f32 accumulation."""
    s_all = port_fa._scores(q, k, causal)
    bh, t, d = q.shape
    m = torch.full((bh, t), float("-inf"))
    l, acc = torch.zeros(bh, t), torch.zeros(bh, t, d)
    for k0 in range(0, t, block):
        s = s_all[:, :, k0:k0 + block]
        m_new = torch.maximum(m, s.amax(-1))
        m_ref = torch.where(torch.isneginf(m_new), 0.0, m_new)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_ref))
        p = torch.exp(s - m_ref[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(
            p.bfloat16().float(), v[:, k0:k0 + block].float())
        m = m_new
    o = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    lse = torch.where(l > 0, m + torch.log(l), float("inf"))
    return o.to(q.dtype), lse


def _dq_bf16_ds(q, k, v, do, lse, dd, causal):
    """The sm90 dQ's arithmetic in torch: P and dS in f32, dS rounded to
    bf16 before ``dS K``, f32 accumulation."""
    _, ds = port_fa._probs_and_ds(q, k, v, do, lse, dd, causal)
    dq = torch.matmul(ds.bfloat16().float(), k.float())
    return (dq * q.shape[-1] ** -0.5).to(q.dtype)


def _dkv_bf16_p_ds(q, k, v, do, lse, dd, causal):
    """The sm90 dK/dV's arithmetic in torch: P and dS in f32, rounded to
    bf16 before ``Pᵀ dO`` and ``dSᵀ Q``, f32 accumulation."""
    p, ds = port_fa._probs_and_ds(q, k, v, do, lse, dd, causal)
    dv = torch.matmul(p.bfloat16().float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.bfloat16().float().transpose(-1, -2), q.float())
    return (dk * q.shape[-1] ** -0.5).to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_p_and_ds_hold_the_reference_tolerances(causal):
    """Rounding P and dS to bf16 for their products, as the tensor-core
    kernels do, stays inside the reference's bf16 tolerances against its
    Pallas kernels (f32 P), at the kernels' head dim D = 64."""
    (jq, jk, jv), (q, k, v) = _qkv(256, "bf16", 10, b=1, h=2, d=64)
    (jdo, _, _), (do, _, _) = _qkv(256, "bf16", 11, b=1, h=2, d=64)
    ref_o, ref_lse = jax_fa._flash_pallas(jq, jk, jv, causal, 128, 128, True)
    _, ref_dk, ref_dv = jax_fa._flash_pallas_bwd(jq, jk, jv, ref_o, ref_lse, jdo, causal,
                                                 128, 128, True)
    q2, k2, v2, do2 = (port_fa._to2d(x) for x in (q, k, v, do))
    o, lse = _forward_bf16_p(q2, k2, v2, causal)
    _close(o, jax_fa._to2d(ref_o).astype(jnp.float32), FWD_TOL["bf16"])
    _close(lse, ref_lse, FWD_TOL["bf16"])
    o2 = torch.from_numpy(np.array(jax_fa._to2d(ref_o).astype(jnp.float32))).bfloat16()
    dd = (do2.float() * o2.float()).sum(-1)
    dk, dv = _dkv_bf16_p_ds(q2, k2, v2, do2, torch.from_numpy(np.array(ref_lse)), dd, causal)
    for got, want in ((dk, ref_dk), (dv, ref_dv)):
        want = np.asarray(jax_fa._to2d(want).astype(jnp.float32))
        assert (np.abs(want) > GRAD_TOL["bf16"]).mean() > 0.5
        _close(got, want, GRAD_TOL["bf16"])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_bf16_ds_dq_holds_the_reference_tolerance(causal):
    """Rounding dS to bf16 before ``dS K``, as the tensor-core dQ does,
    stays inside the reference's bf16 gradient tolerance against its Pallas
    dQ kernel (f32 dS), at D = 64. Rows no key sees (LSE +inf) give 0."""
    (jq, jk, jv), (q, k, v) = _qkv(256, "bf16", 12, b=1, h=2, d=64)
    (jdo, _, _), (do, _, _) = _qkv(256, "bf16", 13, b=1, h=2, d=64)
    ref_o, ref_lse = jax_fa._flash_pallas(jq, jk, jv, causal, 128, 128, True)
    ref_dq = jax_fa._flash_pallas_bwd(jq, jk, jv, ref_o, ref_lse, jdo, causal,
                                      128, 128, True)[0]
    q2, k2, v2, do2 = (port_fa._to2d(x) for x in (q, k, v, do))
    o2 = torch.from_numpy(np.array(jax_fa._to2d(ref_o).astype(jnp.float32))).bfloat16()
    dd = (do2.float() * o2.float()).sum(-1)
    lse = torch.from_numpy(np.array(ref_lse))
    dq = _dq_bf16_ds(q2, k2, v2, do2, lse, dd, causal)
    want = np.asarray(jax_fa._to2d(ref_dq).astype(jnp.float32))
    assert dq.dtype == torch.bfloat16
    assert (np.abs(want) > GRAD_TOL["bf16"]).mean() > 0.5
    _close(dq, want, GRAD_TOL["bf16"])
    lse[:, :3] = float("inf")
    dq = _dq_bf16_ds(q2, k2, v2, do2, lse, dd, causal)
    assert torch.isfinite(dq.float()).all() and not dq[:, :3].float().any()


@pytest.mark.parametrize("dtype,t,d,takes", [
    (torch.bfloat16, 128, 64, True),   # the path's shape class
    (torch.float32, 128, 64, False),   # f32 keeps the reference's 2e-5
    (torch.bfloat16, 128, 16, False),  # other head dims
    (torch.bfloat16, 96, 64, False),   # T not a multiple of 64
], ids=["bf16-d64", "f32", "bf16-d16", "t96"])
def test_sm90_dispatch_rule(monkeypatch, dtype, t, d, takes):
    """The rule picks the family, and the forward, dQ and dK/dV of the
    Function call the launchers it names: on CPU tensors each launcher
    refuses with its own name before any launch."""
    q = torch.zeros(2, t, d, dtype=dtype)
    assert port_fa._sm90_takes(q) is takes
    before = dict(port_fa.launches)
    family = "sm90 " if takes else ""
    with pytest.raises(ValueError, match=f"flash forward {family}kernel: .* not CUDA"):
        port_fa._Flash.forward(q, q, q, True, True)
    lse = torch.zeros(2, t)
    with pytest.raises(ValueError, match=f"flash dQ {family}kernel: .* not CUDA"):
        port_fa._FlashBackward.forward(q, q, q, q, lse, q, True, True)
    monkeypatch.setattr(port_fa, "flash_dq_sm90" if takes else "flash_dq_cuda",
                        lambda *args: None)
    with pytest.raises(ValueError, match=f"flash dK/dV {family}kernel: .* not CUDA"):
        port_fa._FlashBackward.forward(q, q, q, q, lse, q, True, True)
    assert port_fa.launches == before


def test_every_ctypes_entry_matches_a_c_entry_of_its_source():
    """Each ``_ARGTYPES`` entry names an ``extern "C"`` function of the
    source it loads, with its pointers plus 5 ints and the stream; every
    flash entry of ``csrc/`` is declared. Reads the sources only: no nvcc."""
    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            entries[name] = (src.stem, len(params.split(",")))
    for symbol, (source, pointers) in port_fa._ARGTYPES.items():
        assert entries[symbol] == (source, pointers + 6), symbol
        assert _build._target(source).name.startswith(f"{source}-")
    assert {n for n in entries if n.startswith("mpit_flash")} == set(port_fa._ARGTYPES)
