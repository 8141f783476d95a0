"""The port's quantized exchange against the reference's, on the CPU.

- ``mpit_tpu_torch.quant``'s torch face (``quantize_torch``,
  ``quantize_rows_torch`` and their inverses) against the reference's numpy
  face and jnp face: codes and scales bit for bit on random and edge inputs.
- ``quantized_allreduce`` and ``quantized_psum_scatter`` over W stacked
  workers against the reference's inside ``shard_map`` on the virtual CPU
  mesh, on the same ``(W, n)`` inputs: exact and bit for bit on the
  reference's integer-valued cases (``tests/test_quant_collectives.py``);
  on random inputs the reduced values and both residual levels bit for
  bit against the reference's algorithm on its numpy face, and within an
  ulp of the block scale against its jitted collective (see
  ``test_the_reference_jits_its_int8_scale_as_a_product``).
- The sync trainer's bucket plan against the reference's ``_BucketPlan``:
  LeNet at 64 KiB buckets, ResNet-50 and the full-width LM at the 4 MiB
  default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpit_tpu
from mpit_tpu import quant as ref_quant
from mpit_tpu.comm import collectives as ref
from mpit_tpu.parallel import sync as ref_sync
from mpit_tpu_torch import quant as port_quant
from mpit_tpu_torch.comm import collectives as port
from mpit_tpu_torch.comm.topology import finalize, init
from mpit_tpu_torch.parallel import sync as port_sync

# the quantized reduce-scatter against the reference's jitted one: the
# chunk sums of dequantized codes whose int8 scales may differ by an ulp
# (one f32 rounding per term)
REDUCED_TOL = dict(rtol=1e-6, atol=1e-6)

F32 = np.finfo(np.float32)
EDGES = np.array(
    [np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, -1.0, 0.5, 2.5, -2.5, 127.5,
     F32.max, -F32.max, 3.39617752923046e+38, F32.tiny, 1e-40, -3e-42, 1e-45],
    np.float32,
)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.str, a.shape, a.tobytes()


def _rows_cases(seed):
    """2-D float32 inputs: random rows of many magnitudes with edge values
    dropped in, the edge row itself, all-zero and all-NaN rows, an empty
    row set, and rows whose absmax is subnormal (a scale that underflows)."""
    rng = np.random.default_rng(seed)
    cases = [np.tile(EDGES, (3, 1)), np.zeros((2, 7), np.float32),
             np.full((2, 4), np.nan, np.float32), np.zeros((3, 0), np.float32),
             np.array([[1e-45, 0.0, -1e-45, 0.0]], np.float32),
             (rng.standard_normal((5, 17)) * 1e-39).astype(np.float32)]
    for _ in range(6):
        a = (rng.standard_normal((int(rng.integers(1, 6)), int(rng.integers(1, 200))))
             * np.float32(10.0) ** rng.integers(-30, 30)).astype(np.float32)
        for _ in range(int(rng.integers(0, 5))):
            a[rng.integers(0, a.shape[0]), rng.integers(0, a.shape[1])] = EDGES[
                rng.integers(len(EDGES))]
        cases.append(a)
    return cases


def _flushes(a) -> bool:
    """Whether a row's largest finite magnitude is subnormal: XLA:CPU
    flushes subnormals to zero, so there the reference's jnp face gives
    scale 1 where its numpy face (and the port, on any device) divides."""
    fin = np.where(np.isfinite(a), np.abs(a), 0)
    amax = fin.max(axis=1) if a.size else np.zeros(len(a))
    return bool(((amax > 0) & (amax < F32.tiny)).any())


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_the_torch_face_is_the_numpy_and_jnp_faces(seed, mode):
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for a in _rows_cases(seed):
            codes, scales = ref_quant.quantize_rows(a, mode)
            tc, ts = port_quant.quantize_rows_torch(torch.from_numpy(a), mode)
            assert tc.dtype == (torch.uint16 if mode == "bf16" else torch.int8)
            assert _bits(tc.numpy()) == _bits(codes)
            assert _bits(ts.numpy()) == _bits(scales)
            assert _bits(port_quant.dequantize_rows_torch(tc, ts, mode).numpy()) == _bits(
                ref_quant.dequantize_rows(codes, scales, mode))
            if a.size and not _flushes(a):
                jc, js = ref_quant.quantize_rows_jnp(a, mode)
                assert _bits(tc.numpy()) == _bits(jc) and _bits(ts.numpy()) == _bits(js)
            # the whole-array face: one scale
            q = ref_quant.quantize(a, mode)
            wc, ws = port_quant.quantize_torch(torch.from_numpy(a), mode)
            assert _bits(wc.numpy()) == _bits(q.data)
            assert ws.shape == () and np.float32(q.scale).tobytes() == ws.numpy().tobytes()
            assert _bits(port_quant.dequantize_torch(wc, ws, mode).numpy()) == _bits(
                ref_quant.dequantize(q))
            if a.size and not _flushes(a.reshape(1, -1)):
                jc, js = ref_quant.quantize_jnp(a, mode)
                assert _bits(wc.numpy()) == _bits(jc)
                assert np.asarray(js, np.float32).tobytes() == ws.numpy().tobytes()


def test_the_torch_face_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="2-D"):
        port_quant.quantize_rows_torch(torch.zeros(3), "int8")
    for fn in (port_quant.quantize_torch, port_quant.quantize_rows_torch):
        with pytest.raises(ValueError, match="mode"):
            fn(torch.zeros(2, 2), "fp4")


# -- the collectives ----------------------------------------------------------


@pytest.fixture
def world():
    """The port's world of ``w`` stacked workers on the CPU and the
    reference's mesh of ``w`` devices."""
    def make(w):
        finalize()
        mpit_tpu.finalize()
        return init(num_workers=w, device="cpu"), mpit_tpu.init(num_workers=w)

    yield make
    finalize()


def _mesh_fn(topo, fn, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=topo.mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def _ref_allreduce(topo, x, mode, mean, r, r2):
    """The reference's quantized_allreduce of (W, n) rows with residuals:
    (reduced (n,), new residual (W, n), new residual2 (W, chunk))."""

    def f(s, a, b):
        red, nr, nr2 = ref.quantized_allreduce(s[0], mode=mode, mean=mean,
                                               residual=a[0], residual2=b[0])
        return red, nr[None], nr2[None]

    spec = P("dp", None)
    return [np.asarray(v) for v in _mesh_fn(topo, f, (spec, spec, spec),
                                            (P(), spec, spec))(x, r, r2)]


# the reference's known-answer cases (tests/test_quant_collectives.py):
# (W, rows, mode, mean); every block quantizes exactly on both hops
KNOWN = {
    "int8-sum-2": (np.array([[127, 2, -4, 100, 127, 2, 64, -32],
                             [127, 4, -2, -90, 127, 2, -64, 32]], np.float32), "int8", False),
    "int8-avg-2": (np.array([[127, 2, -4, 100, 127, 2, 64, -32],
                             [127, 4, -2, -90, 127, 2, -64, 32]], np.float32), "int8", True),
    "int8-sum-4": (np.tile(np.array([127, 3, -127, 5, 127, -7, -127, 9], np.float32),
                           (4, 1)), "int8", False),
    "int8-pad-2": (np.array([[127, 2, -4, 127, 2], [127, 4, -2, 127, 2]], np.float32),
                   "int8", False),
    "bf16-sum-2": (np.array([[1, 2, 3, 4, 100, 0.5, -8, 16],
                             [5, -2, 1, 4, 28, 0.5, 8, -16]], np.float32), "bf16", False),
}


@pytest.mark.parametrize("case", sorted(KNOWN))
def test_known_answers_are_exact_and_the_reference_bits(case, world):
    x, mode, mean = KNOWN[case]
    w = len(x)
    _, topo = world(w)
    want = x.mean(axis=0) if mean else x.sum(axis=0)
    op = port.AVG if mean else port.SUM
    got = port.allreduce(torch.from_numpy(x), op, quant=mode).numpy()
    np.testing.assert_array_equal(got, want)
    ref_red, ref_r, ref_r2 = _ref_allreduce(topo, x, mode, mean, np.zeros_like(x),
                                            np.zeros((w, -(-x.shape[1] // w)), np.float32))
    red, r, r2 = port.quantized_allreduce(torch.from_numpy(x), mode=mode, mean=mean)
    assert _bits(red.numpy()) == _bits(ref_red)
    assert _bits(r.numpy()) == _bits(ref_r) and _bits(r2.numpy()) == _bits(ref_r2)


def _numpy_allreduce(x, mode, r, r2):
    """The reference's quantized allreduce (mean, residuals threaded;
    ``_quant_allreduce_leaf``) computed with its numpy face, the sums in
    source order: (reduced, new residual, new residual2)."""
    w, n = x.shape
    c = x + r
    flat = np.pad(c, ((0, 0), (0, -n % w)))
    codes, scales = ref_quant.quantize_rows(flat.reshape(w * w, -1), mode)
    sent = ref_quant.dequantize_rows(codes, scales, mode).reshape(w, -1)
    rows = sent.reshape(w, w, -1)
    red = rows[0]
    for k in range(1, w):
        red = red + rows[k]
    red = red / np.float32(w) + r2
    rcodes, rscales = ref_quant.quantize_rows(red, mode)
    new_r2 = red - ref_quant.dequantize_rows(rcodes, rscales, mode)
    out = ref_quant.dequantize_rows(rcodes, rscales, mode).reshape(-1)[:n]
    return out, c - sent[:, :n], new_r2, max(scales.max(), rscales.max())


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("w", [2, 4, 8])
def test_random_allreduce_with_residuals_is_the_reference(w, mode, world):
    """Three calls on one stream, the residuals threaded through.

    Against the reference's algorithm on its numpy face: the reduced
    values and both residual levels bit for bit. Against the reference's
    collective under ``shard_map``: bf16 bit for bit; int8 within what one
    ulp of a block scale moves. Inside ``jit`` XLA turns the reference's
    ``amax / 127`` into ``amax * fl(1/127)``, whose last bit differs from
    the division's for some ``amax`` (its numpy face, its eager jnp face
    and the port divide), and a code of at most 127 times an ulp of the
    scale is at most 2^-16 of the scale: 2^-15 of the largest scale of
    both hops bounds each value. Each call gets the same residuals on
    every side (the numpy stream's), so the bound is one call's."""
    _, topo = world(w)
    rng = np.random.default_rng(w)
    n = 61  # pads to a multiple of W
    r, r2 = np.zeros((w, n), np.float32), np.zeros((w, -(-n // w)), np.float32)
    for step in range(3):
        x = (rng.standard_normal((w, n)) * 10.0 ** rng.uniform(-3, 3, (w, 1))).astype(
            np.float32)
        red, ref_r, ref_r2 = _ref_allreduce(topo, x, mode, True, r, r2)
        got, tr, tr2 = port.quantized_allreduce(
            torch.from_numpy(x), mode=mode, mean=True, residual=torch.from_numpy(r),
            residual2=torch.from_numpy(r2))
        nred, r, r2, scale = _numpy_allreduce(x, mode, r, r2)
        assert _bits(got.numpy()) == _bits(nred), step
        assert _bits(tr.numpy()) == _bits(r), step
        assert _bits(tr2.numpy()) == _bits(r2), step
        if mode == "bf16":
            for a, b in ((got, red), (tr, ref_r), (tr2, ref_r2)):
                assert _bits(a.numpy()) == _bits(b), step
        else:
            for a, b in ((got, red), (tr, ref_r), (tr2, ref_r2)):
                np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=2.0 ** -15 * scale)


def test_the_reference_jits_its_int8_scale_as_a_product():
    """Why the int8 comparisons with the reference's collectives above
    allow an ulp of scale: under ``jit`` its scale is ``amax * fl(1/127)``,
    not the quotient its other faces (and the port) compute."""
    # absmax values whose quotient by 127 and product with fl(1/127)
    # differ in the last bit (about 1 in 20 of random values)
    a = np.array([[0.9153731465339661], [0.7683529257774353], [6.273813247680664],
                  [11.473443984985352], [18.848051071166992]], np.float32)
    jitted = np.asarray(jax.jit(lambda v: ref_quant.quantize_rows_jnp(v, "int8")[1])(a))
    want = ref_quant.quantize_rows(a, "int8")[1]
    got = port_quant.quantize_rows_torch(torch.from_numpy(a), "int8")[1].numpy()
    assert _bits(got) == _bits(want)
    np.testing.assert_array_equal(jitted, a * np.float32(1 / 127))
    assert (jitted != want).all()


def test_pytree_and_dtype_are_kept(world):
    world(2)
    tree = {"a": torch.tensor([[127, 2, -4, 127]] * 2, dtype=torch.float32),
            "b": torch.tensor([[127, 254]] * 2, dtype=torch.float32)}
    out = port.allreduce(tree, port.SUM, quant="int8")
    assert out["a"].dtype == torch.float32 and set(out) == {"a", "b"}
    for k in tree:
        np.testing.assert_array_equal(out[k].numpy(), tree[k].numpy().sum(0))
    red, res, res2 = port.quantized_allreduce(tree, mode="int8")
    assert res["a"].shape == (2, 4) and res2["a"].shape == (2, 2) and res2["b"].shape == (2, 1)


def test_bad_ops_and_modes_raise(world):
    world(2)
    x = torch.ones(2, 4)
    with pytest.raises(ValueError, match="SUM/AVG"):
        port.allreduce(x, port.MAX, quant="int8")
    with pytest.raises(ValueError, match="mode"):
        port.quantized_allreduce(x, mode="fp4")
    with pytest.raises(ValueError, match="psum_scatter mode"):
        port.quantized_psum_scatter(x, mode="fp8")
    with pytest.raises(ValueError, match="does not split"):
        port.quantized_psum_scatter(torch.ones(2, 5), mode="int8")


def test_psum_scatter_known_answer_off_mode_and_random(world):
    _, topo = world(2)
    x = KNOWN["int8-sum-2"][0]
    got = port.quantized_psum_scatter(torch.from_numpy(x), mode="int8")
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy().ravel(), x.sum(axis=0))
    x = np.stack([np.arange(8, dtype=np.float32) + 10 * i for i in range(2)])
    off = port.quantized_psum_scatter(torch.from_numpy(x), mode="off")
    np.testing.assert_allclose(off.numpy().ravel(), x.sum(axis=0))
    _, topo = world(8)
    rng = np.random.default_rng(3)
    for mode in ("int8", "bf16"):
        x = rng.standard_normal((8, 64)).astype(np.float32)
        want = np.asarray(_mesh_fn(
            topo, lambda s: ref.quantized_psum_scatter(s[0], mode=mode)[None],
            P("dp", None), P("dp", None))(x))
        got = port.quantized_psum_scatter(torch.from_numpy(x), mode=mode).numpy()
        np.testing.assert_allclose(got, want, **REDUCED_TOL)


def test_error_feedback_mean_converges_past_one_shot_error(world):
    """The reference's EF pin (tests/test_quant_collectives.py): with both
    residual levels threaded, the mean of 50 reduced outputs lands far
    inside one call's quantization error."""
    world(2)
    rng = np.random.default_rng(13)
    g = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    want = g.mean(0)
    r = r2 = None
    acc = torch.zeros_like(want)
    for _ in range(50):
        red, r, r2 = port.quantized_allreduce(g, mode="int8", mean=True,
                                              residual=r, residual2=r2)
        acc += red
    one_shot = (port.quantized_allreduce(g, mode="int8", mean=True)[0] - want).abs().mean()
    assert (acc / 50 - want).abs().mean() < one_shot / 10


# -- the bucket plan ----------------------------------------------------------


def _ref_plan(model, sample, bucket_bytes, mode, w=8):
    shapes = jax.eval_shape(lambda: model.init(jax.random.key(0), sample))["params"]
    params = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    return ref_sync._BucketPlan(params, w, bucket_bytes, mode)


def _assert_same_plan(want, params, bucket_bytes, mode, w=8):
    got = port_sync._BucketPlan(params, w, bucket_bytes, mode)
    assert got.sizes == want.sizes
    assert len(got.buckets) == len(want.buckets) > 1
    for a, b in zip(got.buckets, want.buckets):
        assert (a.lo, a.hi, a.n, a.n_pad, a.chunk, a.hop_bytes) == (
            b.lo, b.hi, b.n, b.n_pad, b.chunk, b.hop_bytes)
    assert got.wire_bytes_per_step() == want.wire_bytes_per_step()
    return got


@pytest.mark.parametrize("mode", ["off", "int8", "bf16"])
def test_bucket_plans_are_the_reference_plans(mode):
    """LeNet at 64 KiB buckets; ResNet-50 and the full-width LM at the 4
    MiB default; the wire bytes a step for each."""
    from mpit_tpu.models import LeNet as JaxLeNet
    from mpit_tpu.models.resnet import ResNet50 as JaxResNet
    from mpit_tpu.models.transformer import TransformerLM as JaxLM
    from mpit_tpu_torch.models import LeNet, TransformerLM
    from mpit_tpu_torch.models.resnet import ResNet50

    assert port_sync.DEFAULT_DP_BUCKET_BYTES == ref_sync.DEFAULT_DP_BUCKET_BYTES
    want = _ref_plan(JaxLeNet(), jnp.zeros((1, 28, 28, 1)), 64 << 10, mode)
    got = _assert_same_plan(want, LeNet(device="cpu").init(torch.Generator()), 64 << 10, mode)
    if mode == "off":
        assert got.wire_bytes_per_step() == 6861952
    big = port_sync.DEFAULT_DP_BUCKET_BYTES
    want = _ref_plan(JaxResNet(num_classes=1000), jnp.zeros((1, 224, 224, 3)), big, mode)
    _assert_same_plan(want, ResNet50(device="cpu").init(torch.Generator()), big, mode)
    want = _ref_plan(JaxLM(vocab_size=10_000, num_layers=6, d_model=768, num_heads=12,
                           max_len=512), jnp.zeros((1, 512), jnp.int32), big, mode)
    _assert_same_plan(want, TransformerLM(10_000, num_layers=6, d_model=768, num_heads=12,
                                          max_len=512, device="cpu").init(torch.Generator()),
                      big, mode)


def test_env_knobs():
    assert port_sync.dp_quant_from_env({}) == "off"
    assert port_sync.dp_quant_from_env({"MPIT_DP_QUANT": "int8"}) == "int8"
    with pytest.raises(ValueError, match="MPIT_DP_QUANT"):
        port_sync.dp_quant_from_env({"MPIT_DP_QUANT": "fp4"})
    assert port_sync.dp_bucket_bytes_from_env({}) is None
    assert port_sync.dp_bucket_bytes_from_env({"MPIT_DP_BUCKET_BYTES": "4096"}) == 4096
    with pytest.raises(ValueError, match="MPIT_DP_BUCKET_BYTES"):
        port_sync.dp_bucket_bytes_from_env({"MPIT_DP_BUCKET_BYTES": "0"})
