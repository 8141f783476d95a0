"""The port's quantization kernels (``mpit_tpu_torch.quant``, the numpy
face) against the reference's ``mpit_tpu.quant``: codes, scales and
reconstructions bit for bit, on the same seeded inputs."""

import numpy as np
import pytest

from mpit_tpu import quant as ref
from mpit_tpu.transport import wire as ref_wire
from mpit_tpu_torch import quant as port
from mpit_tpu_torch.transport import wire as port_wire

_SPECIALS = np.array(
    [0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0, 2.0 ** -149, -(2.0 ** -140),
     2.0 ** -127, 1.1754942e-38, 6.5e4, 3.0e38, -3.0e38, 3.4028235e38],
    np.float32,
)


def _bits(a):
    """The bytes of an array, so NaN lanes and -0.0 compare exactly."""
    a = np.ascontiguousarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def _arrays(seed):
    """Seeded arrays over the kernels' edge cases: NaN, ±Inf, ±0,
    subnormals, huge and tiny magnitudes, an empty chunk, all zeros, all
    NaN."""
    rng = np.random.default_rng(seed)
    out = [np.zeros(0, np.float32), np.zeros(7, np.float32),
           np.full(5, np.nan, np.float32), _SPECIALS.copy()]
    for _ in range(12):
        n = int(rng.integers(1, 300))
        a = (rng.standard_normal(n) * np.float32(10.0) ** rng.integers(-40, 38)).astype(
            np.float32)
        for _ in range(int(rng.integers(0, 6))):
            a[rng.integers(0, n)] = _SPECIALS[rng.integers(len(_SPECIALS))]
        out.append(a)
    return out


@pytest.mark.parametrize("mode", ["bf16", "int8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codes_scales_and_reconstruction_are_the_reference_bits(seed, mode):
    with np.errstate(over="ignore", invalid="ignore"):
        for a in _arrays(seed):
            want, got = ref.quantize(a, mode), port.quantize(a, mode)
            assert got.mode == want.mode and got.nbytes == want.nbytes
            assert _bits(got.data) == _bits(want.data)
            assert np.float64(got.scale).tobytes() == np.float64(want.scale).tobytes()
            assert _bits(port.dequantize(got)) == _bits(ref.dequantize(want))


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_rows_faces_are_the_reference_bits(mode):
    rng = np.random.default_rng(7)
    # a row whose absmax is subnormal gets scale 0 in both packages, and
    # its division by zero saturates the codes
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        for rows, cols in [(1, 1), (4, 33), (16, 256), (3, 0)]:
            a = (rng.standard_normal((rows, cols)) * 50).astype(np.float32)
            if a.size:
                a.flat[rng.integers(0, a.size, 3)] = _SPECIALS[[2, 3, 7]]
            codes, scales = port.quantize_rows(a, mode)
            want_codes, want_scales = ref.quantize_rows(a, mode)
            assert _bits(codes) == _bits(want_codes)
            assert _bits(scales) == _bits(want_scales)
            assert _bits(port.dequantize_rows(codes, scales, mode)) == _bits(
                ref.dequantize_rows(want_codes, want_scales, mode))
    with pytest.raises(ValueError, match="2-D"):
        port.quantize_rows(np.zeros(3, np.float32), mode)


def test_constants_and_bad_modes_match():
    assert port.QUANT_MODES == ref.QUANT_MODES
    assert port.MODE_ITEMSIZE == ref.MODE_ITEMSIZE
    for fn in (lambda q: q.quantize(np.ones(2, np.float32), "fp4"),
               lambda q: q.dequantize(q.QuantArray("fp4", 1.0, np.ones(2))),
               lambda q: q.dequantize_rows(np.ones((1, 2)), np.ones((1, 1)), "fp4")):
        with pytest.raises(ValueError, match="unknown quantization mode"):
            fn(ref)
        with pytest.raises(ValueError, match="unknown quantization mode"):
            fn(port)


@pytest.mark.parametrize("xs,mode", [([3.4028234663852886e+38], "int8"),
                                     ([3.39617752923046e+38], "bf16")],
                         ids=["f32-max-int8", "near-max-bf16"])
def test_the_property_tests_failing_inputs_fail_the_same_way(xs, mode):
    """``tests/test_numerics.py::test_quantize_roundtrip_error_bound_property``
    fails on these two inputs: at f32's largest value the int8 code 127
    times absmax/127 overflows to inf in ``dequantize``, and just below it
    bf16's round-to-nearest-even carries into the exponent, which is inf.
    The port keeps the reference's kernels, so it gives the same codes,
    scales and infinities."""
    a = np.array(xs, np.float32)
    with np.errstate(over="ignore"):
        for m in ("int8", "bf16"):
            want, got = ref.quantize(a, m), port.quantize(a, m)
            assert _bits(got.data) == _bits(want.data) and got.scale == want.scale
            assert _bits(port.dequantize(got)) == _bits(ref.dequantize(want))
        out = port.dequantize(port.quantize(a, mode))
    assert np.isfinite(a).all() and not np.isfinite(out).all()
    assert out[0] == np.inf


def test_wire_env_knobs_match(monkeypatch):
    for value in ("off", "bf16", " INT8 "):
        monkeypatch.setenv("MPIT_WIRE_QUANT", value)
        assert port_wire.quant_mode_from_env() == ref_wire.quant_mode_from_env()
    monkeypatch.setenv("MPIT_WIRE_QUANT", "fp4")
    for w in (ref_wire, port_wire):
        with pytest.raises(ValueError, match="MPIT_WIRE_QUANT"):
            w.quant_mode_from_env()
    env = {"MPIT_WIRE_FORMAT": "pickle", "MPIT_WIRE_NEGOTIATE": "0",
           "MPIT_WIRE_NEGOTIATE_TIMEOUT_S": "0.5"}
    for name in ("wire_format_from_env", "negotiate_enabled_from_env",
                 "negotiate_timeout_from_env"):
        for e in ({}, env):
            assert getattr(port_wire, name)(e) == getattr(ref_wire, name)(e)
    err = port_wire.WireDecodeError("bad crc", src=3, tag=4)
    assert (str(err), err.src, err.tag) == ("bad crc", 3, 4)
