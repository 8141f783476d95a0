"""MNIST, CIFAR-10, ImageNet-like and PTB loaders with an on-disk fast
path and a synthetic fallback, the per-worker shard, and the global-batch
iterator.

Counterpart of ``mpit_tpu/data/datasets.py``, copied so the port imports
nothing of the JAX package; ``tests/test_torch_data.py`` holds the outputs
byte-equal. On-disk formats, under ``$MPIT_DATA_DIR``: MNIST's idx files;
CIFAR-10's binary batches (``data_batch_1..5.bin`` + ``test_batch.bin``, in
the directory or a ``cifar-10-batches-bin/`` subdir) or a ``cifar10.npz``
cache; an ImageNet-style class-per-directory image tree under
``imagenet/train`` (+ ``val``), decoded with PIL; PTB's text files.

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


def _read_cifar10_bin(paths: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """Parse standard CIFAR-10 binary batches (``data_batch_*.bin`` /
    ``test_batch.bin``): records of 1 label byte + 3072 pixel bytes laid
    out channel-planar (3, 32, 32). Returns (x in NHWC [0,1], y int32)."""
    record = 1 + 3 * 32 * 32
    xs, ys = [], []
    for p in paths:
        opener = gzip.open if p.endswith(".gz") else open
        with opener(p, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        if raw.size == 0 or raw.size % record != 0:
            raise ValueError(
                f"{p}: size {raw.size} is not a multiple of the "
                f"{record}-byte CIFAR-10 record"
            )
        rows = raw.reshape(-1, record)
        ys.append(rows[:, 0].astype(np.int32))
        xs.append(
            rows[:, 1:]
            .reshape(-1, 3, 32, 32)
            .transpose(0, 2, 3, 1)
            .astype(np.float32)
            / 255.0
        )
    return np.concatenate(xs), np.concatenate(ys)


def has_real_dataset(name: str) -> bool:
    """True iff the matching loader would read REAL files (not the
    synthetic fallback). The conditions here restate each loader's own
    file checks exactly — keep them in lockstep when editing a loader.
    """
    if name not in ("mnist", "cifar10", "ptb", "imagenet"):
        raise ValueError(f"unknown dataset {name!r}")
    d = _data_dir()
    if not d:
        return False
    if name == "mnist":
        return all(
            _find(d, n)
            for n in (
                "train-images-idx3-ubyte", "train-labels-idx1-ubyte",
                "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte",
            )
        )
    if name == "cifar10":
        for sub in ("", "cifar-10-batches-bin"):
            base = os.path.join(d, sub) if sub else d
            if (
                all(
                    _find(base, f"data_batch_{i}.bin")
                    for i in range(1, 6)
                )
                and _find(base, "test_batch.bin")
            ):
                return True
        return os.path.exists(os.path.join(d, "cifar10.npz"))
    if name == "ptb":
        return os.path.exists(
            os.path.join(d, "ptb.train.txt")
        ) and os.path.exists(os.path.join(d, "ptb.valid.txt"))
    train = os.path.join(d, "imagenet", "train")
    return os.path.isdir(train) and any(
        os.path.isdir(os.path.join(train, e)) for e in os.listdir(train)
    )


def load_cifar10(synthetic_train: int = 8192, synthetic_test: int = 2048):
    """CIFAR-10 as (x_train, y_train, x_test, y_test), images (N,32,32,3)
    in [0,1]. Prefers the standard binary batches (``data_batch_1..5.bin``
    + ``test_batch.bin``, optionally gzipped, under ``$MPIT_DATA_DIR``
    directly or in a ``cifar-10-batches-bin/`` subdir), then an ``.npz``
    cache, then learnable synthetic data."""
    d = _data_dir()
    if d:
        for sub in ("", "cifar-10-batches-bin"):
            base = os.path.join(d, sub) if sub else d
            train = [
                _find(base, f"data_batch_{i}.bin") for i in range(1, 6)
            ]
            test = _find(base, "test_batch.bin")
            if all(train) and test:
                x_tr, y_tr = _read_cifar10_bin(train)
                x_te, y_te = _read_cifar10_bin([test])
                return x_tr, y_tr, x_te, y_te
        p = os.path.join(d, "cifar10.npz")
        if os.path.exists(p):
            z = np.load(p)
            return (
                z["x_train"].astype(np.float32),
                z["y_train"].astype(np.int32),
                z["x_test"].astype(np.float32),
                z["y_test"].astype(np.int32),
            )
    return synthetic_image_classification(
        synthetic_train, synthetic_test, (32, 32, 3), 10, seed=1
    )


_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def _read_image_folder(
    root: str,
    image_size: int,
    limit: Optional[int] = None,
    classes: Optional[list[str]] = None,
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Decode a class-per-subdirectory image tree (the standard ImageNet
    train/val layout) into (x NHWC [0,1], y int32, class_names). Images are
    resized so the short side is ``image_size`` then center-cropped — the
    standard eval transform. ``limit`` caps total images (the loader holds
    everything in host RAM, like every loader in this module), spread as an
    even per-class cap so every class stays represented. ``classes`` pins
    the label mapping (pass the train split's list when loading val so
    labels agree across splits; unknown subdirs are an error)."""
    from PIL import Image

    subdirs = sorted(
        e for e in os.listdir(root)
        if os.path.isdir(os.path.join(root, e))
    )
    if not subdirs:
        raise ValueError(f"{root}: no class subdirectories")
    if classes is None:
        classes = subdirs
    else:
        unknown = sorted(set(subdirs) - set(classes))
        if unknown:
            raise ValueError(
                f"{root}: subdirectories {unknown} not in the training "
                f"class list — splits must share one label mapping"
            )
    label_of = {c: i for i, c in enumerate(classes)}
    per_class = (
        None if limit is None else max(1, limit // len(subdirs))
    )
    xs, ys = [], []
    for cls in subdirs:
        cdir = os.path.join(root, cls)
        taken = 0
        if limit is not None and len(xs) >= limit:
            break  # the total cap is a hard RAM bound and wins over coverage
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith(_IMAGE_EXTS):
                continue
            if per_class is not None and taken >= per_class:
                break
            if limit is not None and len(xs) >= limit:
                break
            with Image.open(os.path.join(cdir, fname)) as im:
                im = im.convert("RGB")
                w, h = im.size
                scale = image_size / min(w, h)
                im = im.resize(
                    (max(image_size, round(w * scale)),
                     max(image_size, round(h * scale)))
                )
                left = (im.size[0] - image_size) // 2
                top = (im.size[1] - image_size) // 2
                im = im.crop(
                    (left, top, left + image_size, top + image_size)
                )
                xs.append(np.asarray(im, dtype=np.float32) / 255.0)
                ys.append(label_of[cls])
            taken += 1
    if not xs:
        raise ValueError(
            f"{root}: class subdirectories contain no decodable images "
            f"(supported extensions: {', '.join(_IMAGE_EXTS)})"
        )
    return np.stack(xs), np.array(ys, dtype=np.int32), classes


def load_imagenet_like(
    synthetic_train: int = 2048,
    synthetic_test: int = 512,
    image_size: int = 224,
    num_classes: int = 1000,
):
    """ImageNet-shaped data for the AlexNet/ResNet-50 configs
    (BASELINE.json:9-10). When ``$MPIT_DATA_DIR/imagenet/train`` (+
    ``val``) holds the standard class-per-subdir image tree it is decoded
    for real (PIL; resize-short-side + center-crop; in-RAM). Per-split
    image counts are capped at what the caller asked for
    (``synthetic_train``/``synthetic_test``, i.e. the config's
    ``train_size``) unless ``$MPIT_IMAGENET_LIMIT`` overrides both caps;
    the cap is spread evenly across classes. Otherwise synthetic data of
    the right shape — the throughput benchmark only needs shape."""
    d = _data_dir()
    if d:
        train_dir = os.path.join(d, "imagenet", "train")
        val_dir = os.path.join(d, "imagenet", "val")
        if os.path.isdir(train_dir):
            env_limit = os.environ.get("MPIT_IMAGENET_LIMIT")
            tr_limit = int(env_limit) if env_limit else synthetic_train
            te_limit = int(env_limit) if env_limit else synthetic_test
            x_tr, y_tr, classes = _read_image_folder(
                train_dir, image_size, tr_limit
            )
            if len(classes) > num_classes:
                raise ValueError(
                    f"{train_dir}: {len(classes)} class subdirectories "
                    f"exceed the model head's num_classes={num_classes}; "
                    "labels would be out of range for the logits"
                )
            if os.path.isdir(val_dir):
                x_te, y_te, _ = _read_image_folder(
                    val_dir, image_size, te_limit, classes=classes
                )
            else:  # no val split: hold out a shuffled slice of train
                perm = np.random.default_rng(0).permutation(len(x_tr))
                x_tr, y_tr = x_tr[perm], y_tr[perm]
                cut = max(1, len(x_tr) // 10)
                x_te, y_te = x_tr[-cut:], y_tr[-cut:]
                x_tr, y_tr = x_tr[:-cut], y_tr[:-cut]
            return x_tr, y_tr, x_te, y_te
    return synthetic_image_classification(
        synthetic_train,
        synthetic_test,
        (image_size, image_size, 3),
        num_classes,
        seed=2,
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
