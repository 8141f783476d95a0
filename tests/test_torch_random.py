"""The port's threefry key stream against ``jax.random`` (JAX 0.9.0, with
``jax_threefry_partitionable`` on), on the CPU.

Keys, splits, fold-ins, random bits and uniforms are equal bit for bit;
the Gumbel noise goes through ``log``, whose last bit may differ between
XLA and PyTorch, so it is held within 2^-21 (four float32 ulps at 1) in
absolute and relative terms; categorical draws are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu_torch import random as jrandom

SEEDS = [0, 1, 42, 2**31 - 1, 123456789, 2**40 + 17]
GUMBEL_TOL = dict(rtol=2.0**-21, atol=2.0**-21)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and small CPU ops oversubscribed across all of
    them run many times slower. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bits_uniform_equal_jax(seed):
    with jax.enable_x64(seed >= 2**31):
        k = jax.random.key(seed)
        t = jrandom.key(seed)
        np.testing.assert_array_equal(t.numpy(), _data(k))
        np.testing.assert_array_equal(jrandom.split(t, 7).numpy(),
                                      _data(jax.random.split(k, 7)))
        np.testing.assert_array_equal(jrandom.fold_in(t, 5).numpy(),
                                      _data(jax.random.fold_in(k, 5)))
        rows = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(4))
        np.testing.assert_array_equal(
            jrandom.fold_in(t[None].expand(4, 2), torch.arange(4)).numpy(), _data(rows))
        np.testing.assert_array_equal(
            jrandom.random_bits(t, (3, 5)).numpy(),
            np.asarray(jax.random.bits(k, (3, 5), jnp.uint32)).astype(np.int64))
        np.testing.assert_array_equal(jrandom.uniform(t, (1000,)).numpy(),
                                      np.asarray(jax.random.uniform(k, (1000,), jnp.float32)))
        np.testing.assert_array_equal(
            jrandom.uniform(t, (64,), -2.0, 3.0).numpy(),
            np.asarray(jax.random.uniform(k, (64,), jnp.float32, -2.0, 3.0)))


def test_batched_keys_and_nested_splits_equal_jax():
    """A stack of keys, split per key (the serving streams: ``split(rng_n,
    steps)`` for every row at once), and one split of a split."""
    k = jax.random.key(9)
    rows = jax.random.split(k, 5)
    want = jax.vmap(lambda r: jax.random.split(r, 6))(rows)
    got = jrandom.split(jrandom.split(jrandom.key(9), 5), 6)
    assert tuple(got.shape) == (5, 6, 2)
    np.testing.assert_array_equal(got.numpy(), _data(want))
    bits = jax.vmap(lambda r: jax.random.bits(r, (4,), jnp.uint32))(rows)
    np.testing.assert_array_equal(
        jrandom.random_bits(jrandom.split(jrandom.key(9), 5), (4,)).numpy(),
        np.asarray(bits).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 3, 77])
def test_gumbel_within_four_ulps_and_categorical_equal(seed):
    k = jax.random.key(seed)
    t = jrandom.key(seed)
    np.testing.assert_allclose(jrandom.gumbel(t, (10000,)).numpy(),
                               np.asarray(jax.random.gumbel(k, (10000,))), **GUMBEL_TOL)
    logits = np.random.default_rng(seed).normal(size=(64, 17)).astype(np.float32)
    keys = jax.random.split(k, 64)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    got = jrandom.categorical(jrandom.split(t, 64), torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
    masked = np.where(logits < 0.5, -np.inf, logits).astype(np.float32)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, masked))
    got = jrandom.categorical(jrandom.split(t, 64), torch.from_numpy(masked))
    np.testing.assert_array_equal(got.numpy(), want)


def test_categorical_from_given_noise_is_the_gumbel_max():
    noise = jax.random.gumbel(jax.random.key(2), (3, 11))
    logits = np.random.default_rng(2).normal(size=(3, 11)).astype(np.float32)
    got = jrandom.categorical_from_gumbel(torch.from_numpy(logits),
                                          torch.from_numpy(np.array(noise)))
    np.testing.assert_array_equal(got.numpy(), np.argmax(np.asarray(noise) + logits, -1))
