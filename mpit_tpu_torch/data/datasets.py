"""MNIST and PTB loaders with an on-disk fast path and a synthetic
fallback, the per-worker shard, and the global-batch iterator.

Counterpart of the MNIST and PTB parts of ``mpit_tpu/data/datasets.py``,
copied so the port imports nothing of the JAX package;
``tests/test_torch_data.py`` holds the outputs byte-equal. The CIFAR-10 and
ImageNet loaders are not ported yet.

Everything returns host arrays; moving them to the card is the trainer's
job (``data/prefetch.py``).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Iterator, Optional

import numpy as np
import torch

from mpit_tpu_torch.data.synthetic import (
    synthetic_image_classification,
    synthetic_lm_corpus,
)


def _data_dir() -> Optional[str]:
    d = os.environ.get("MPIT_DATA_DIR")
    return d if d and os.path.isdir(d) else None


def _read_idx(path: str) -> np.ndarray:
    """Parse an MNIST idx file (optionally gzipped)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find(dirname: str, stem: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(dirname, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def load_mnist(synthetic_train: int = 8192, synthetic_test: int = 2048):
    """MNIST as (x_train, y_train, x_test, y_test), images (N,28,28,1) in
    [0,1]. Falls back to learnable synthetic data when no files exist."""
    d = _data_dir()
    if d:
        paths = {
            "xtr": _find(d, "train-images-idx3-ubyte"),
            "ytr": _find(d, "train-labels-idx1-ubyte"),
            "xte": _find(d, "t10k-images-idx3-ubyte"),
            "yte": _find(d, "t10k-labels-idx1-ubyte"),
        }
        if all(paths.values()):
            x_tr = _read_idx(paths["xtr"]).astype(np.float32)[..., None] / 255.0
            y_tr = _read_idx(paths["ytr"]).astype(np.int32)
            x_te = _read_idx(paths["xte"]).astype(np.float32)[..., None] / 255.0
            y_te = _read_idx(paths["yte"]).astype(np.int32)
            return x_tr, y_tr, x_te, y_te
    return synthetic_image_classification(
        synthetic_train, synthetic_test, (28, 28, 1), 10, seed=0
    )


def load_ptb(
    synthetic_tokens: int = 200_000, vocab_size: int = 10_000
) -> tuple[np.ndarray, np.ndarray, int]:
    """PTB-shaped token streams (train, valid, vocab_size). Real PTB
    (``ptb.train.txt``/``ptb.valid.txt`` under $MPIT_DATA_DIR) when present;
    synthetic Markov corpus otherwise."""
    d = _data_dir()
    if d:
        tr = os.path.join(d, "ptb.train.txt")
        va = os.path.join(d, "ptb.valid.txt")
        if os.path.exists(tr) and os.path.exists(va):
            with open(tr) as f:
                train_words = f.read().replace("\n", " <eos> ").split()
            with open(va) as f:
                valid_words = f.read().replace("\n", " <eos> ").split()
            vocab = {w: i for i, w in enumerate(sorted(set(train_words)))}
            unk = vocab.get("<unk>", 0)
            t = np.array([vocab[w] for w in train_words], dtype=np.int32)
            v = np.array(
                [vocab.get(w, unk) for w in valid_words], dtype=np.int32
            )
            return t, v, len(vocab)
    toks = synthetic_lm_corpus(synthetic_tokens, vocab_size, seed=3)
    split = int(len(toks) * 0.9)
    return toks[:split], toks[split:], vocab_size


def shard_for_worker(x, worker: int, num_workers: int):
    """Static per-worker shard by worker id. Truncates to equal shard
    sizes: the stacked workers need identical shapes."""
    per = len(x) // num_workers
    return x[worker * per : (worker + 1) * per]


@dataclasses.dataclass
class Batches:
    """Host-side minibatch iterator producing *global* batches.

    Yields arrays with leading dim ``global_batch = per_worker_batch * W``
    (numpy arrays, or CPU tensors where ``x`` is one, as after
    ``cast_input_dtype(..., "bf16")``). Shuffles per epoch with a
    deterministic seed; the trailing remainder of each epoch is dropped."""

    x: np.ndarray
    y: np.ndarray
    global_batch: int
    seed: int = 0

    def __post_init__(self):
        if len(self.x) != len(self.y):
            raise ValueError("x and y length mismatch")
        if len(self.x) < self.global_batch:
            raise ValueError(
                f"dataset of {len(self.x)} samples cannot fill one global "
                f"batch of {self.global_batch}"
            )

    def epoch(self, epoch_index: int) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(self.seed + epoch_index)
        order = rng.permutation(len(self.x))
        n_full = len(self.x) // self.global_batch
        for b in range(n_full):
            idx = order[b * self.global_batch : (b + 1) * self.global_batch]
            yield self.x[idx], self.y[idx]

    def steps_per_epoch(self) -> int:
        return len(self.x) // self.global_batch


INPUT_DTYPES = ("float32", "bf16")


def cast_input_dtype(x: np.ndarray, dtype_name: str):
    """Cast a float input array to the staging dtype (``float32`` | ``bf16``).

    ``bf16`` returns a CPU ``torch.bfloat16`` tensor (numpy has no bf16),
    halving the host-to-card bytes; the models cast their input to bf16 on
    entry anyway, so the values they compute on are the same. Integer
    inputs pass through untouched."""
    if dtype_name not in INPUT_DTYPES:
        raise ValueError(
            f"unknown input dtype {dtype_name!r}; have {INPUT_DTYPES}"
        )
    if dtype_name == "float32" or not np.issubdtype(x.dtype, np.floating):
        return x
    return torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
