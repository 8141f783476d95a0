"""The reference's key stream: JAX's threefry2x32 PRNG as plain tensor ops.

Serving's contract is that a request's tokens do not depend on how it was
scheduled: generated token ``j`` of a request is drawn with key ``j`` of
that request's own stream (``split(rng, max_new)``), and row ``i`` of a
batch takes ``fold_in(rng, i)``. A counter-based stream gives that on any
device and at any batch position; a ``torch.Generator`` cannot. So this
module computes what ``jax.random`` computes with the default threefry
implementation and ``jax_threefry_partitionable`` on (JAX 0.9.0):

- a key is an int64 tensor of shape ``(..., 2)`` holding the two uint32
  words of JAX's key data (``jax.random.key_data``);
- :func:`split` and :func:`random_bits` hash the 64-bit iota of the
  output shape, its high word as the first counter and its low word as
  the second; :func:`fold_in` hashes the counter pair ``(0, data)``;
- :func:`uniform` puts the top 23 of the 32 bits into the mantissa of a
  float in [1, 2); :func:`gumbel` is ``-log(-log(u))`` of a uniform on
  [tiny, 1) ("low" mode, JAX's default); :func:`categorical` is the
  argmax of the logits plus Gumbel noise.

The words are held in int64 and masked to 32 bits after each add and
shift, since ``torch.uint32`` lacks those ops on the card. Integer bits are
equal to JAX's on every device; the Gumbel noise goes through ``log``,
which may differ from XLA's float32 one by an ulp or two.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# float32's smallest normal, the lower end of the Gumbel's uniform
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x1, x2)``
    under the key words ``(k1, k2)``; all int64 holding uint32 values,
    broadcast against each other. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))``: the seed's high and
    low 32-bit words."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _iota_2x32(shape, device):
    """The high and low words of ``arange(prod(shape)).reshape(shape)``."""
    n = 1
    for s in shape:
        n *= s
    flat = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return flat >> 32, flat & _MASK


def _hash_shape(keys: torch.Tensor, shape):
    """Both output words of hashing the iota of ``shape`` under each key of
    ``keys`` (..., 2): arrays of shape ``keys.shape[:-1] + shape``."""
    hi, lo = _iota_2x32(tuple(shape), keys.device)
    lead = keys.shape[:-1]
    pad = (1,) * len(shape)
    k1 = keys[..., 0].reshape(*lead, *pad)
    k2 = keys[..., 1].reshape(*lead, *pad)
    return threefry2x32(k1, k2, hi, lo)


def split(keys: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)`` for each key of ``keys`` (..., 2):
    shape ``(..., num, 2)``."""
    b1, b2 = _hash_shape(keys, (num,))
    return torch.stack([b1, b2], -1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``; ``keys`` (..., 2) and ``data`` an
    int or an integer tensor broadcast against ``keys.shape[:-1]``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & _MASK
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(b1, b2), -1)


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` for each key: uint32 values
    in int64, shape ``keys.shape[:-1] + shape``."""
    b1, b2 = _hash_shape(keys, shape)
    return b1 ^ b2


def uniform(keys: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for each
    key."""
    bits = random_bits(keys, shape)
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mantissa.view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    # XLA fuses the scale and shift into one multiply-add with one rounding;
    # in float64 the product is exact and the sum rounds once more on the
    # way back to float32, which matches it (tests/test_torch_random.py)
    scaled = (floats.double() * float(hi - lo) + float(lo)).float()
    return torch.clamp_min(scaled, float(lo))


def gumbel(keys: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` for each key. The two
    logs are taken in float64 and the result rounded to float32, so the
    noise is within an ulp of the exact value whatever float32 ``log`` the
    device's library uses (PyTorch's CPU one was seen, now and then in a
    process, to miss by 1e-4)."""
    u = uniform(keys, shape, _TINY, 1.0).double()
    return (-torch.log(-torch.log(u))).float()


def categorical_from_gumbel(logits: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The Gumbel-max draw: ``argmax(noise + logits)`` over the last dim
    (the first maximum, as ``jnp.argmax``)."""
    return torch.argmax(noise + logits, -1)


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last dim, one key
    per row: ``keys`` (..., 2), ``logits`` (..., V) float32."""
    return categorical_from_gumbel(logits, gumbel(keys, (logits.shape[-1],)))
