"""Deterministic, learnable synthetic datasets.

A verbatim copy of ``synthetic_image_classification`` from
``mpit_tpu/data/synthetic.py`` (the port imports nothing of the JAX
package); ``tests/test_torch_data.py`` holds the two byte-equal.

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
