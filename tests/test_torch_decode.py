"""Decode mode of the port's transformer and LSTM LMs against flax, on the CPU.

The same params (carried across with ``convert.from_flax``) and the same
cache (``convert.cache_from_flax`` of flax's initial ``cache``
collection) go through a prefill chunk and a few one-token ticks on both
sides; logits and the whole cache tree must agree after every call, f32
within ``F32_TOL`` and bf16 within ``BF16_TOL`` of
``tests/test_torch_transformer.py``. Inputs come from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models.lstm import LSTMLM as JaxLSTM
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu_torch.convert import cache_from_flax, cache_to_flax, from_flax
from mpit_tpu_torch.models.lstm import LSTMLM
from mpit_tpu_torch.models.transformer import TransformerLM

V, L = 17, 32
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
DTYPES = [(jnp.float32, torch.float32, F32_TOL),
          (jnp.bfloat16, torch.bfloat16, BF16_TOL)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and small CPU ops oversubscribed across all of
    them run many times slower. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lm(jdt, tdt):
    jm = JaxLM(vocab_size=V, num_layers=2, d_model=32, num_heads=4, max_len=L,
               compute_dtype=jdt)
    pm = TransformerLM(V, num_layers=2, d_model=32, num_heads=4, max_len=L,
                       compute_dtype=tdt, device="cpu")
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, pm, params, from_flax(jax.tree.map(np.asarray, params), device="cpu")


def _assert_tree_close(mine, ref, tol):
    got, want = cache_to_flax(mine), jax.tree.map(np.asarray, ref)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape
        if b.dtype.kind == "i":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), **tol)


@functools.lru_cache(maxsize=None)
def _jit_apply(jdec):
    return jax.jit(lambda p, c, x, **kw: jdec.apply({"params": p, "cache": c}, x,
                                                     mutable=["cache"], **kw))


def _run_both(jdec, pdec, params, tparams, jcache, tcache, x, tol):
    out, mut = _jit_apply(jdec)(params, jcache, jnp.asarray(x))
    got, tcache = pdec.apply(tparams, torch.from_numpy(x), tcache)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(out, np.float32), **tol)
    _assert_tree_close(tcache, mut["cache"], tol)
    return mut["cache"], tcache, out, got


@pytest.mark.parametrize("dtypes", DTYPES, ids=["f32", "bf16"])
def test_transformer_prefill_and_ticks_match_flax(dtypes):
    jdt, tdt, tol = dtypes
    jm, pm, params, tparams = _lm(jdt, tdt)
    jdec, pdec = jm.clone(decode=True), pm.clone(decode=True)
    b = 3
    jcache = jax.jit(jdec.init)(jax.random.key(0), jnp.zeros((b, 1), jnp.int32))["cache"]
    tcache = cache_from_flax(jax.tree.map(np.asarray, jcache), device="cpu")
    _assert_tree_close(tcache, jcache, tol)
    _assert_tree_close(pdec.init_cache(b, device="cpu"), jcache, tol)
    rng = np.random.default_rng(1)
    chunk = rng.integers(0, V, (b, 8)).astype(np.int32)
    jcache, tcache, _, _ = _run_both(jdec, pdec, params, tparams, jcache, tcache,
                                     chunk, tol)
    for _ in range(3):
        tick = rng.integers(0, V, (b, 1)).astype(np.int32)
        jcache, tcache, _, _ = _run_both(jdec, pdec, params, tparams, jcache,
                                         tcache, tick, tol)
    assert tcache["pos_index"].tolist() == [11] * b


def test_per_row_clocks_and_clamps_match_flax():
    """Rows at other clocks, one near the end of the cache (its K/V write
    start clamps to L - T) and one past it (a server's free slot: the
    write clamps and the positional gather reads the last row)."""
    jm, pm, params, tparams = _lm(jnp.float32, torch.float32)
    jdec, pdec = jm.clone(decode=True), pm.clone(decode=True)
    rng = np.random.default_rng(2)
    jcache = jax.jit(jdec.init)(jax.random.key(0), jnp.zeros((3, 1), jnp.int32))["cache"]
    jcache = jax.tree.map(np.asarray, jcache)
    for blk in [k for k in jcache if k.startswith("Block")]:
        for leaf in ("cached_key", "cached_value"):
            jcache[blk][leaf] = rng.normal(size=jcache[blk][leaf].shape).astype(np.float32)
    clocks = np.array([4, L - 2, L + 5], np.int32)
    jcache = jax.tree_util.tree_map_with_path(
        lambda p, a: np.broadcast_to(clocks, a.shape).copy()
        if getattr(p[-1], "key", None) in ("cache_index", "pos_index") else a, jcache)
    tcache = cache_from_flax(jcache, device="cpu")
    chunk = rng.integers(0, V, (3, 4)).astype(np.int32)
    _, tcache, _, _ = _run_both(jdec, pdec, params, tparams, jcache, tcache, chunk,
                                F32_TOL)
    assert tcache["Block_0"]["cache_index"].tolist() == (clocks + 4).tolist()


def test_head_false_and_head_logits_equal_the_full_forward():
    """Within the port, the prefill's last-row projection equals the
    forward's own head bit for bit (training and decode model alike), and
    the ``head_dtype`` override is the one both read."""
    _, pm, _, tparams = _lm(jnp.bfloat16, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(3).integers(0, V, (2, 8)))
    full = pm.apply(tparams, x)
    hidden = pm.clone(head=False).apply(tparams, x)
    for pos in (0, 3, 7):
        assert torch.equal(pm.head_logits(tparams, hidden[:, pos]), full[:, pos])
    one = pm.clone(head=False).apply(tparams, x[:1])
    assert torch.equal(pm.head_logits(tparams, one[:, 7]), full[:1, 7])
    f32_head = pm.clone(head_dtype=torch.float32)
    assert not torch.equal(f32_head.apply(tparams, x), full)
    assert torch.equal(f32_head.head_logits(tparams, hidden[:, 7]),
                       f32_head.apply(tparams, x)[:, 7])
    dec = pm.clone(decode=True, head=False)
    h, _ = dec.apply(tparams, x, dec.init_cache(2, device="cpu"))
    torch.testing.assert_close(h, hidden, rtol=0, atol=0)


def test_decode_validation():
    _, pm, _, tparams = _lm(jnp.float32, torch.float32)
    dec = pm.clone(decode=True)
    with pytest.raises(ValueError, match="exceeds"):
        dec.apply(tparams, torch.zeros(1, L + 1, dtype=torch.long),
                  dec.init_cache(1, device="cpu"))
    with pytest.raises(ValueError, match="takes a cache"):
        dec.apply(tparams, torch.zeros(1, 1, dtype=torch.long))
    with pytest.raises(ValueError, match="cannot change"):
        pm.clone(num_layers=3)


def _lstm(jdt, tdt, head_dtype=(None, None)):
    jm = JaxLSTM(vocab_size=V, embed_dim=12, hidden=16, num_layers=2,
                 compute_dtype=jdt, head_dtype=head_dtype[0])
    pm = LSTMLM(vocab_size=V, embed_dim=12, hidden=16, num_layers=2,
                compute_dtype=tdt, head_dtype=head_dtype[1], device="cpu")
    params = jax.jit(jm.init)(jax.random.key(3), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, pm, params, from_flax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("dtypes", DTYPES + [
    (jnp.bfloat16, torch.bfloat16, BF16_TOL, (jnp.float32, torch.float32))],
    ids=["f32", "bf16", "bf16-f32head"])
def test_lstm_prefill_with_seq_lengths_and_ticks_match_flax(dtypes):
    jdt, tdt, tol, *hd = dtypes
    jm, pm, params, tparams = _lstm(jdt, tdt, *(hd or [(None, None)]))
    jdec, pdec = jm.clone(decode=True), pm.clone(decode=True)
    b = 3
    jcache = jax.jit(jdec.init)(jax.random.key(0), jnp.zeros((b, 1), jnp.int32))["cache"]
    tcache = cache_from_flax(jax.tree.map(np.asarray, jcache), device="cpu")
    _assert_tree_close(pdec.init_cache(b, device="cpu"), jcache, tol)
    rng = np.random.default_rng(4)
    buf = rng.integers(0, V, (b, 8)).astype(np.int32)
    lens = np.array([8, 3, 5], np.int32)
    hj, mut = _jit_apply(jdec.clone(head=False))(
        params, jcache, jnp.asarray(buf), seq_lengths=jnp.asarray(lens))
    ht, tcache = pdec.clone(head=False).apply(
        tparams, torch.from_numpy(buf), tcache, seq_lengths=torch.from_numpy(lens))
    jcache = mut["cache"]
    _assert_tree_close(tcache, jcache, tol)
    rows = np.arange(b), lens - 1
    np.testing.assert_allclose(ht.float().numpy()[rows], np.asarray(hj, np.float32)[rows],
                               **tol)
    last_j = jm.head_logits(params, hj[rows])
    last_t = pm.head_logits(tparams, ht[torch.arange(b), torch.from_numpy(lens - 1).long()])
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), **tol)
    for _ in range(3):
        tick = rng.integers(0, V, (b, 1)).astype(np.int32)
        jcache, tcache, out, got = _run_both(jdec, pdec, params, tparams, jcache,
                                             tcache, tick, tol)
    # within the port the prefill's head equals the tick's head bit for bit
    h1, _ = pdec.clone(head=False).apply(tparams, torch.from_numpy(tick), tcache)
    l1, _ = pdec.apply(tparams, torch.from_numpy(tick), tcache)
    assert torch.equal(pm.head_logits(tparams, h1[:, 0]), l1[:, 0])


def test_lstm_seq_lengths_is_decode_only():
    _, pm, _, tparams = _lstm(jnp.float32, torch.float32)
    with pytest.raises(ValueError, match="decode-mode"):
        pm.apply(tparams, torch.zeros(1, 2, dtype=torch.long),
                 seq_lengths=torch.ones(1, dtype=torch.long))
