"""Deterministic, learnable synthetic datasets.

Verbatim copies of ``synthetic_image_classification`` and
``synthetic_lm_corpus`` from ``mpit_tpu/data/synthetic.py`` (the port
imports nothing of the JAX package); ``tests/test_torch_data.py`` holds
them byte-equal to the originals.

Design: each class c gets a fixed random template T_c (seeded PRNG); a sample
is ``clip(intensity * T_c + noise)``. Linearly separable enough that LeNet
reaches high accuracy in a few hundred steps, noisy enough that training
dynamics are non-trivial.
"""

from __future__ import annotations

import numpy as np


def synthetic_image_classification(
    num_train: int,
    num_test: int,
    image_shape: tuple[int, int, int],
    num_classes: int,
    seed: int = 0,
    noise: float = 0.35,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x_train, y_train, x_test, y_test); images float32 in [0, 1],
    labels int32."""
    rng = np.random.default_rng(seed)
    templates = rng.uniform(0.0, 1.0, size=(num_classes, *image_shape)).astype(
        np.float32
    )

    def make(n: int, split_seed: int):
        r = np.random.default_rng(seed + split_seed)
        y = r.integers(0, num_classes, size=n).astype(np.int32)
        intensity = r.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
        x = templates[y] * intensity + r.normal(
            0.0, noise, size=(n, *image_shape)
        ).astype(np.float32)
        return np.clip(x, 0.0, 1.0), y

    x_tr, y_tr = make(num_train, 1)
    x_te, y_te = make(num_test, 2)
    return x_tr, y_tr, x_te, y_te


def synthetic_lm_corpus(
    num_tokens: int, vocab_size: int, seed: int = 0, order: int = 2
) -> np.ndarray:
    """A synthetic token stream with learnable Markov structure.

    Tokens follow a sparse ``order``-gram chain (each context maps to a small
    set of likely successors), so an LSTM achieves materially lower perplexity
    than the uniform baseline — enough signal for PTB-config tests
    (BASELINE.json:11) without shipping the corpus.
    """
    rng = np.random.default_rng(seed)
    branch = 4
    successors = rng.integers(
        0, vocab_size, size=(vocab_size, branch)
    )  # per-context candidate sets (order-1 chain is plenty)
    tokens = np.empty(num_tokens, dtype=np.int32)
    tokens[0] = rng.integers(0, vocab_size)
    picks = rng.integers(0, branch, size=num_tokens)
    mistakes = rng.random(num_tokens) < 0.1  # 10% uniform noise
    randoms = rng.integers(0, vocab_size, size=num_tokens)
    for i in range(1, num_tokens):
        if mistakes[i]:
            tokens[i] = randoms[i]
        else:
            tokens[i] = successors[tokens[i - 1], picks[i]]
    return tokens
