"""The port's decoding recipes against the JAX package's, on the CPU.

One small transformer (vocab 17, d_model 32, 2 layers, max_len 32) and one
small LSTM, their flax params carried across with ``convert.from_flax``;
the same prompts and the same keys (``jax.random.key(s)`` on one side,
``mpit_tpu_torch.random.key(s)`` on the other) go through ``generate``,
``generate_fast``, ``generate_batch``, ``beam_search`` and
``generate_rnn``. At f32 the tokens must be equal, greedy and sampled; so
must the ``_filter_logits`` masks on tied logits, and a batch row must
equal its solo call within the port.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models import (
    beam_search as j_beam,
    generate as j_generate,
    generate_batch as j_batch,
    generate_fast as j_fast,
    generate_rnn as j_rnn,
)
from mpit_tpu.models import sampling as j_sampling
from mpit_tpu.models.lstm import LSTMLM as JaxLSTM
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu_torch import random as jrandom
from mpit_tpu_torch.convert import from_flax
from mpit_tpu_torch.models import (
    RNNServer,
    Server,
    beam_search,
    generate,
    generate_batch,
    generate_fast,
    generate_rnn,
    generate_speculative,
    sampling,
)
from mpit_tpu_torch.models.lstm import LSTMLM
from mpit_tpu_torch.models.transformer import TransformerLM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, L = 17, 32
CPU = dict(device="cpu")
RULES = {
    "greedy": {},
    "top_k": dict(temperature=0.8, top_k=5),
    "top_p": dict(temperature=0.9, top_p=0.85),
    "min_p": dict(temperature=1.1, min_p=0.1),
    "all": dict(temperature=0.7, top_k=9, top_p=0.9, min_p=0.05),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and small CPU ops oversubscribed across all of
    them run many times slower. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _prompt(seed, n):
    return [int(t) for t in np.random.default_rng(seed).integers(0, V, n)]


@pytest.fixture(scope="module")
def lm():
    jm = JaxLM(vocab_size=V, num_layers=2, d_model=32, num_heads=4, max_len=L,
               compute_dtype=jnp.float32)
    pm = TransformerLM(V, num_layers=2, d_model=32, num_heads=4, max_len=L,
                       compute_dtype=torch.float32, device="cpu")
    params = jax.jit(jm.init)(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, pm, params, from_flax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def lstm():
    jm = JaxLSTM(vocab_size=V, embed_dim=12, hidden=16, num_layers=2,
                 compute_dtype=jnp.float32)
    pm = LSTMLM(vocab_size=V, embed_dim=12, hidden=16, num_layers=2,
                compute_dtype=torch.float32, device="cpu")
    params = jax.jit(jm.init)(jax.random.key(3), jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, pm, params, from_flax(jax.tree.map(np.asarray, params), device="cpu")


@pytest.mark.parametrize("rule", list(RULES))
def test_generate_fast_equals_jax(lm, rule):
    jm, pm, params, tp = lm
    prompt = _prompt(1, 5)
    want = j_fast(jm, params, prompt, 12, rng=jax.random.key(7), **RULES[rule])
    got = generate_fast(pm, tp, prompt, 12, rng=jrandom.key(7), **RULES[rule], **CPU)
    assert got == want


@pytest.mark.parametrize("rule", ["greedy", "top_k"])
def test_fixed_buffer_generate_equals_jax_past_max_len(lm, rule):
    """30 steps from a 5-token prompt slide the 32-slot window."""
    jm, pm, params, tp = lm
    prompt = _prompt(2, 5)
    want = j_generate(jm, params, prompt, 30, seed=4, **RULES[rule])
    assert generate(pm, tp, prompt, 30, seed=4, **RULES[rule], **CPU) == want
    if rule == "greedy":
        # the first tokens, before the slide, are generate_fast's
        assert want[:L] == generate_fast(pm, tp, prompt, L - 5, **CPU)


def test_fixed_buffer_generate_runs_a_flash_model_as_built(lm):
    """``generate`` keeps the caller's ``attn_impl``: a flash model (the
    kernels' plain versions on the CPU) gives the xla model's tokens."""
    _, pm, _, tp = lm
    flash = TransformerLM(V, num_layers=2, d_model=32, num_heads=4, max_len=L,
                          compute_dtype=torch.float32, attn_impl="flash", device="cpu")
    prompt = _prompt(3, 6)
    assert generate(flash, tp, prompt, 8, **CPU) == generate(pm, tp, prompt, 8, **CPU)


@pytest.mark.parametrize("rule", ["greedy", "all"])
def test_generate_batch_equals_jax_and_rows_equal_solo_calls(lm, rule):
    jm, pm, params, tp = lm
    prompts = [_prompt(4, 3), _prompt(5, 1), _prompt(6, 9)]
    want = j_batch(jm, params, prompts, 7, seed=5, **RULES[rule])
    got = generate_batch(pm, tp, prompts, 7, seed=5, **RULES[rule], **CPU)
    assert got == want
    key = jrandom.key(5)
    for n, p in enumerate(prompts):
        solo = generate_fast(pm, tp, p, 7, rng=jrandom.fold_in(key, n), **RULES[rule], **CPU)
        assert solo == got[n], n


@pytest.mark.parametrize("beam,eos", [(3, False), (4, True), (1, False)])
def test_beam_search_equals_jax(lm, beam, eos):
    jm, pm, params, tp = lm
    prompt = _prompt(7, 5)
    eos_id = None
    if eos:  # the greedy continuation's second token ends the beams' race
        eos_id = generate_fast(pm, tp, prompt, 3, **CPU)[6]
    seq, score = j_beam(jm, params, prompt, 6, beam_size=beam, eos_id=eos_id)
    got, got_score = beam_search(pm, tp, prompt, 6, beam_size=beam, eos_id=eos_id, **CPU)
    assert got == seq
    np.testing.assert_allclose(got_score, score, rtol=2e-5, atol=2e-5)
    if beam == 1:
        assert got == generate_fast(pm, tp, prompt, 6, **CPU)


def test_filter_logits_masks_on_ties_equal_jax():
    """Ties at the top-k boundary keep every tied token; top-p's descending
    order puts the higher index first among equals (the reference's
    reversed stable argsort), which decides which tied token crosses the
    mass; min-p keeps the band against the row's max."""
    rows = np.array([
        [2.0, 1.0, 2.0, 0.5, 2.0, -1.0, 1.0, 1.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [3.0, 3.0, 1.0, 1.0, 1.0, 0.0, -2.0, 3.0],
        [1.0, -np.inf, 1.0, 0.25, 0.25, 0.25, -np.inf, 0.5],
    ], np.float32)
    for top_k, top_p, min_p in [(2, None, None), (3, 0.5, None), (None, 0.4, None),
                                (None, 0.99, 0.5), (5, 0.6, 0.3), (None, None, 0.9),
                                (8, 1.0, None), (1, None, None)]:
        want = jax.vmap(lambda r: j_sampling._filter_logits(
            r, top_k, top_p, min_p))(jnp.asarray(rows))
        n = len(rows)
        got = sampling._filter_logits(
            torch.from_numpy(rows), top_k,
            None if top_p is None else sampling._col(top_p, n, "cpu"),
            None if min_p is None else sampling._col(min_p, n, "cpu"))
        np.testing.assert_array_equal(np.isneginf(got.numpy()),
                                      np.isneginf(np.asarray(want)),
                                      err_msg=str((top_k, top_p, min_p)))


@pytest.mark.parametrize("rule", ["greedy", "top_k", "top_p"])
def test_generate_rnn_equals_jax(lstm, rule):
    jm, pm, params, tp = lstm
    prompt = _prompt(8, 4)
    want = j_rnn(jm, params, prompt, 20, rng=jax.random.key(4), **RULES[rule])
    assert generate_rnn(pm, tp, prompt, 20, rng=jrandom.key(4), **RULES[rule], **CPU) == want
    prompts = [_prompt(9, 3), _prompt(10, 1), _prompt(11, 6)]
    want = j_rnn(jm, params, prompts, 9, seed=2, **RULES[rule])
    got = generate_rnn(pm, tp, prompts, 9, seed=2, **RULES[rule], **CPU)
    assert got == want
    key = jrandom.key(2)
    for n, p in enumerate(prompts):
        assert generate_rnn(pm, tp, p, 9, rng=jrandom.fold_in(key, n), **RULES[rule],
                            **CPU) == got[n]


def test_eos_truncation_and_weights_dtype(lm, lstm):
    jm, pm, params, tp = lm
    prompt = _prompt(12, 4)
    probe = generate_fast(pm, tp, prompt, 8, **CPU)
    eos = probe[len(prompt) + 2]
    got = generate_fast(pm, tp, prompt, 8, eos_id=eos, **CPU)
    assert got == j_fast(jm, params, prompt, 8, eos_id=eos)
    assert got[-1] == eos and len(got) <= len(probe)
    assert generate_batch(pm, tp, [prompt, prompt[:2]], 8, eos_id=eos, **CPU) == j_batch(
        jm, params, [prompt, prompt[:2]], 8, eos_id=eos)
    # bf16 serving weights on the f32 model: the same rounding on both sides
    assert generate_fast(pm, tp, prompt, 8, weights_dtype=torch.bfloat16, **CPU) == j_fast(
        jm, params, prompt, 8, weights_dtype=jnp.bfloat16)
    jl, pl, lp, tlp = lstm
    assert generate_rnn(pl, tlp, prompt, 8, eos_id=eos, **CPU) == j_rnn(
        jl, lp, prompt, 8, eos_id=eos)


def test_edge_cases_and_validation(lm, lstm):
    _, pm, _, tp = lm
    _, pl, _, tlp = lstm
    assert generate_batch(pm, tp, [], 5, **CPU) == []
    assert generate_fast(pm, tp, [1, 2], 0, **CPU) == [1, 2]
    assert beam_search(pm, tp, [1, 2], 0, **CPU) == ([1, 2], 0.0)
    assert generate_rnn(pl, tlp, (), 5, **CPU) == []
    with pytest.raises(ValueError, match="exceeds max_len"):
        generate_fast(pm, tp, [1] * 20, 13, **CPU)
    with pytest.raises(ValueError, match="greedy"):
        generate_fast(pm, tp, [1], 3, top_k=3, **CPU)
    with pytest.raises(ValueError, match="vocab_size"):
        generate_fast(pm, tp, [V], 3, **CPU)
    with pytest.raises(ValueError, match="top_p"):
        generate_fast(pm, tp, [1], 3, temperature=1.0, top_p=0.0, **CPU)
    with pytest.raises(ValueError, match="beam_size"):
        beam_search(pm, tp, [1], 3, beam_size=0, **CPU)
    with pytest.raises(ValueError, match="prompt of 0"):
        generate_rnn(pl, tlp, [], 3, **CPU)
    # every entry point runs on the card unless asked for the CPU; none here
    for call in (lambda: generate(pm, tp, [1], 3), lambda: generate_fast(pm, tp, [1], 3),
                 lambda: generate_batch(pm, tp, [[1]], 3),
                 lambda: beam_search(pm, tp, [1], 3), lambda: generate_rnn(pl, tlp, [1], 3),
                 lambda: generate_speculative(pm, tp, pm, tp, [1], 3),
                 lambda: Server(pm, tp), lambda: RNNServer(pl, tlp)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_the_serving_tour_runs_on_the_cpu():
    """``mpit_tpu_torch/examples/generate_text.py``: trains, decodes six
    ways and asserts the speculative and serving contracts."""
    r = subprocess.run([sys.executable, os.path.join("mpit_tpu_torch", "examples",
                                                     "generate_text.py"),
                        "--device", "cpu", "--steps", "60"],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "speculative" in r.stdout and r.stdout.count("served") == 3
