"""Speculative decoding of the port against the JAX package's, on the CPU.

The target (vocab 17, d_model 32, 2 layers) and a random draft (1 layer,
d_model 16) carry their flax params across; the speculative tokens and the
round statistics must equal the reference's, and the tokens must equal the
target's greedy ``generate_fast`` (the exactness contract) for any draft.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models import (
    generate_speculative as j_spec,
    generate_speculative_batch as j_spec_batch,
)
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu_torch.convert import from_flax
from mpit_tpu_torch.models import (
    generate_fast,
    generate_speculative,
    generate_speculative_batch,
)
from mpit_tpu_torch.models.transformer import TransformerLM

V, L = 17, 48
CPU = dict(device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and small CPU ops oversubscribed across all of
    them run many times slower. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(layers, d, heads, seed):
    jm = JaxLM(vocab_size=V, num_layers=layers, d_model=d, num_heads=heads, max_len=L,
               compute_dtype=jnp.float32)
    pm = TransformerLM(V, num_layers=layers, d_model=d, num_heads=heads, max_len=L,
                       compute_dtype=torch.float32, device="cpu")
    params = jax.jit(jm.init)(jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, pm, params, from_flax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def models():
    return _pair(2, 32, 4, 0), _pair(1, 16, 2, 11)


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, V, n)]


@pytest.mark.parametrize("k", [1, 3, 4])
def test_speculative_equals_jax_and_target_greedy(models, k):
    (jm, pm, p, tp), (jd, pd, dp, tdp) = models
    prompt = _prompt(1, 5)
    want, want_stats = j_spec(jm, p, jd, dp, prompt, 12, k=k, return_stats=True)
    got, stats = generate_speculative(pm, tp, pd, tdp, prompt, 12, k=k,
                                      return_stats=True, **CPU)
    assert got == want
    assert stats["iterations"] == want_stats["iterations"]
    assert stats["mean_emitted"] == pytest.approx(want_stats["mean_emitted"])
    assert got == generate_fast(pm, tp, prompt, 12, **CPU)


def test_a_perfect_draft_accepts_every_proposal(models):
    (jm, pm, p, tp), _ = models
    prompt = _prompt(2, 6)
    got, stats = generate_speculative(pm, tp, pm, tp, prompt, 15, k=4,
                                      return_stats=True, **CPU)
    assert got == generate_fast(pm, tp, prompt, 15, **CPU)
    assert stats["iterations"] == 3 and stats["mean_emitted"] == 5.0


def test_speculative_batch_equals_jax_and_rows_equal_solo(models):
    (jm, pm, p, tp), (jd, pd, dp, tdp) = models
    prompts = [_prompt(3, 3), _prompt(4, 1), _prompt(5, 9)]
    want = j_spec_batch(jm, p, jd, dp, prompts, 9, k=2)
    got = generate_speculative_batch(pm, tp, pd, tdp, prompts, 9, k=2, **CPU)
    assert got == want
    for n, q in enumerate(prompts):
        assert got[n] == generate_speculative(pm, tp, pd, tdp, q, 9, k=2, **CPU)
        assert got[n] == generate_fast(pm, tp, q, 9, **CPU)


def test_eos_and_validation(models):
    (jm, pm, p, tp), (jd, pd, dp, tdp) = models
    prompt = _prompt(6, 4)
    eos = generate_fast(pm, tp, prompt, 6, **CPU)[len(prompt) + 2]
    got = generate_speculative(pm, tp, pd, tdp, prompt, 6, k=3, eos_id=eos, **CPU)
    assert got == j_spec(jm, p, jd, dp, prompt, 6, k=3, eos_id=eos)
    assert got == generate_fast(pm, tp, prompt, 6, eos_id=eos, **CPU)
    assert generate_speculative_batch(pm, tp, pd, tdp, [], 4, **CPU) == []
    with pytest.raises(ValueError, match="headroom"):
        generate_speculative(pm, tp, pd, tdp, [1] * 10, L - 12, k=3, **CPU)
    with pytest.raises(ValueError, match="k=0"):
        generate_speculative(pm, tp, pd, tdp, [1], 3, k=0, **CPU)
    other = TransformerLM(V + 1, num_layers=1, d_model=16, num_heads=2, max_len=L,
                          device="cpu")
    with pytest.raises(ValueError, match="draft vocab"):
        generate_speculative(pm, tp, other, tdp, [1], 3, **CPU)
