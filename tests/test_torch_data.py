"""The port's copies of the JAX package's host-side pieces — data, flat
params, config — held equal to the originals: byte for byte where the
original is exact."""

import dataclasses
import os
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from mpit_tpu.data import datasets as jax_datasets
from mpit_tpu.data import synthetic as jax_synthetic
from mpit_tpu.utils import config as jax_config
from mpit_tpu_torch.data import datasets, prefetch_to_device, synthetic
from mpit_tpu_torch.utils import config
from mpit_tpu_torch.utils.params import (
    flatten_params,
    tree_leaves,
    tree_map,
    unflatten_params,
)


def _same(a, b):
    assert type(a) is type(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("args", [
    (64, 16, (28, 28, 1), 10, 0), (40, 8, (32, 32, 3), 10, 1),
])
def test_synthetic_images_byte_equal(args):
    for a, b in zip(jax_synthetic.synthetic_image_classification(*args),
                    synthetic.synthetic_image_classification(*args)):
        _same(a, b)


@pytest.mark.parametrize("args", [(5000, 50, 0), (3000, 10_000, 3)])
def test_synthetic_lm_corpus_byte_equal(args):
    _same(jax_synthetic.synthetic_lm_corpus(*args),
          synthetic.synthetic_lm_corpus(*args))


@pytest.mark.parametrize("on_disk", [False, True], ids=["synthetic", "text-files"])
def test_load_ptb_byte_equal(tmp_path, monkeypatch, on_disk):
    if on_disk:
        (tmp_path / "ptb.train.txt").write_text(
            "the cat sat on the mat\n a dog <unk> ran\n")
        (tmp_path / "ptb.valid.txt").write_text("the bird sat\n on a cat\n")
        monkeypatch.setenv("MPIT_DATA_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("MPIT_DATA_DIR", raising=False)
    ref = jax_datasets.load_ptb(synthetic_tokens=4000, vocab_size=97)
    got = datasets.load_ptb(synthetic_tokens=4000, vocab_size=97)
    _same(ref[0], got[0])
    _same(ref[1], got[1])
    assert ref[2] == got[2] == (10 if on_disk else 97)


def test_ptb_windows_byte_equal_and_untouched_by_input_cast():
    from mpit_tpu.run import _ptb_windows as jax_windows
    from mpit_tpu_torch.run import _ptb_windows

    cfg = dataclasses.replace(config.TrainConfig().apply_preset("ptb-transformer-large"),
                              seq_len=32, train_size=40)
    jcfg = jax_config.TrainConfig.from_json(cfg.to_json())
    ref, got = jax_windows(jcfg), _ptb_windows(cfg)
    for a, b in zip(ref[:4], got[:4]):
        _same(a, b)
    assert ref[4] == got[4] == {"vocab_size": 10_000}
    assert got[0].shape == (40, 32)
    assert datasets.cast_input_dtype(got[0], "bf16") is got[0]


def _write_idx(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x0800 | arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("on_disk", [False, True], ids=["synthetic", "idx-files"])
def test_load_mnist_byte_equal(tmp_path, monkeypatch, on_disk):
    if on_disk:
        rng = np.random.default_rng(0)
        for stem, shape in (("train-images-idx3-ubyte", (12, 28, 28)),
                            ("train-labels-idx1-ubyte", (12,)),
                            ("t10k-images-idx3-ubyte", (5, 28, 28)),
                            ("t10k-labels-idx1-ubyte", (5,))):
            _write_idx(tmp_path / stem, rng.integers(0, 256, shape))
        monkeypatch.setenv("MPIT_DATA_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("MPIT_DATA_DIR", raising=False)
    ref = jax_datasets.load_mnist(synthetic_train=96, synthetic_test=32)
    got = datasets.load_mnist(synthetic_train=96, synthetic_test=32)
    for a, b in zip(ref, got):
        _same(a, b)
    assert got[0].shape[1:] == (28, 28, 1)
    assert len(got[0]) == (12 if on_disk else 96)


def _write_cifar_bin(path, rng, n, gz=False):
    """n CIFAR-10 records: 1 label byte + 3072 channel-planar pixel bytes."""
    import gzip

    rows = np.concatenate([rng.integers(0, 10, (n, 1)), rng.integers(0, 256, (n, 3072))],
                          axis=1).astype(np.uint8)
    (gzip.open if gz else open)(path, "wb").write(rows.tobytes())


@pytest.mark.parametrize("branch", ["synthetic", "bin-files", "bin-subdir-gz", "npz"])
def test_load_cifar10_byte_equal(tmp_path, monkeypatch, branch):
    rng = np.random.default_rng(1)
    if branch == "synthetic":
        monkeypatch.delenv("MPIT_DATA_DIR", raising=False)
    else:
        monkeypatch.setenv("MPIT_DATA_DIR", str(tmp_path))
    if branch.startswith("bin"):
        base = tmp_path / "cifar-10-batches-bin" if "subdir" in branch else tmp_path
        base.mkdir(exist_ok=True)
        sfx = ".gz" if "gz" in branch else ""
        for i in range(1, 6):
            _write_cifar_bin(base / f"data_batch_{i}.bin{sfx}", rng, 3, gz=bool(sfx))
        _write_cifar_bin(base / f"test_batch.bin{sfx}", rng, 4, gz=bool(sfx))
    elif branch == "npz":
        np.savez(tmp_path / "cifar10.npz",
                 x_train=rng.uniform(0, 1, (6, 32, 32, 3)), y_train=rng.integers(0, 10, 6),
                 x_test=rng.uniform(0, 1, (2, 32, 32, 3)), y_test=rng.integers(0, 10, 2))
    ref = jax_datasets.load_cifar10(synthetic_train=48, synthetic_test=16)
    got = datasets.load_cifar10(synthetic_train=48, synthetic_test=16)
    for a, b in zip(ref, got):
        _same(a, b)
    assert got[0].shape[1:] == (32, 32, 3)
    assert len(got[0]) == {"synthetic": 48, "npz": 6}.get(branch, 15)
    assert datasets.has_real_dataset("cifar10") == jax_datasets.has_real_dataset(
        "cifar10") == (branch != "synthetic")


def test_cifar10_bad_record_size_raises_as_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("MPIT_DATA_DIR", str(tmp_path))
    for i in range(1, 6):
        (tmp_path / f"data_batch_{i}.bin").write_bytes(b"\0" * 3073)
    (tmp_path / "test_batch.bin").write_bytes(b"\0" * 100)
    with pytest.raises(ValueError, match="3073-byte CIFAR-10 record"):
        datasets.load_cifar10()
    with pytest.raises(ValueError, match="3073-byte CIFAR-10 record"):
        jax_datasets.load_cifar10()


def _write_image_tree(root, rng, classes, per_class, split="train"):
    from PIL import Image

    for c in classes:
        d = root / "imagenet" / split / c
        d.mkdir(parents=True)
        for i in range(per_class):
            w, h = (int(v) for v in rng.integers(20, 40, 2))
            img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            Image.fromarray(img).save(d / f"img{i}.{'png' if i % 2 else 'bmp'}")
        (d / "notes.txt").write_text("not an image")


@pytest.mark.parametrize("branch", ["synthetic", "train-only", "train-val", "env-limit"])
def test_load_imagenet_like_byte_equal(tmp_path, monkeypatch, branch):
    rng = np.random.default_rng(2)
    if branch == "synthetic":
        monkeypatch.delenv("MPIT_DATA_DIR", raising=False)
    else:
        monkeypatch.setenv("MPIT_DATA_DIR", str(tmp_path))
        _write_image_tree(tmp_path, rng, ["n01", "n02", "n03"], 4)
        if branch == "train-val":
            _write_image_tree(tmp_path, rng, ["n01", "n03"], 2, split="val")
    if branch == "env-limit":
        monkeypatch.setenv("MPIT_IMAGENET_LIMIT", "7")
    else:
        monkeypatch.delenv("MPIT_IMAGENET_LIMIT", raising=False)
    kw = dict(synthetic_train=10, synthetic_test=6, image_size=16, num_classes=20)
    ref = jax_datasets.load_imagenet_like(**kw)
    got = datasets.load_imagenet_like(**kw)
    for a, b in zip(ref, got):
        _same(a, b)
    assert got[0].shape[1:] == (16, 16, 3)
    assert datasets.has_real_dataset("imagenet") == jax_datasets.has_real_dataset(
        "imagenet") == (branch != "synthetic")


def test_imagenet_like_refusals_match_the_reference(tmp_path, monkeypatch):
    """More classes than the head has, and a val split with a class the
    train split lacks, raise as in the reference."""
    rng = np.random.default_rng(3)
    monkeypatch.setenv("MPIT_DATA_DIR", str(tmp_path))
    monkeypatch.delenv("MPIT_IMAGENET_LIMIT", raising=False)
    _write_image_tree(tmp_path, rng, ["a", "b", "c"], 1)
    for load in (datasets.load_imagenet_like, jax_datasets.load_imagenet_like):
        with pytest.raises(ValueError, match="exceed the model head"):
            load(synthetic_train=8, image_size=8, num_classes=2)
    _write_image_tree(tmp_path, rng, ["a", "z"], 1, split="val")
    for load in (datasets.load_imagenet_like, jax_datasets.load_imagenet_like):
        with pytest.raises(ValueError, match="not in the training class list"):
            load(synthetic_train=8, image_size=8, num_classes=10)


def test_has_real_dataset_matches_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("MPIT_DATA_DIR", str(tmp_path))
    (tmp_path / "ptb.train.txt").write_text("a b\n")
    (tmp_path / "ptb.valid.txt").write_text("a\n")
    for name in ("mnist", "cifar10", "ptb", "imagenet"):
        assert datasets.has_real_dataset(name) == jax_datasets.has_real_dataset(name)
    assert datasets.has_real_dataset("ptb")
    with pytest.raises(ValueError, match="unknown dataset"):
        datasets.has_real_dataset("svhn")


def test_batches_epoch_and_shards_byte_equal():
    x, y, _, _ = synthetic.synthetic_image_classification(
        100, 4, (28, 28, 1), 10
    )
    ref = jax_datasets.Batches(x, y, global_batch=16, seed=3)
    got = datasets.Batches(x, y, global_batch=16, seed=3)
    assert got.steps_per_epoch() == ref.steps_per_epoch() == 6
    for e in (0, 1):
        pairs = list(zip(ref.epoch(e), got.epoch(e)))
        assert len(pairs) == 6
        for (rx, ry), (gx, gy) in pairs:
            _same(rx, gx)
            _same(ry, gy)
    for k in range(3):
        _same(jax_datasets.shard_for_worker(x, k, 3),
              datasets.shard_for_worker(x, k, 3))


def test_cast_input_dtype_bf16_bit_equal():
    x = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)
    ref = jax_datasets.cast_input_dtype(x, "bf16")
    got = datasets.cast_input_dtype(x, "bf16")
    assert ref.dtype == ml_dtypes.bfloat16 and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  ref.view(np.int16))
    assert datasets.cast_input_dtype(x, "float32") is x
    ints = np.arange(4, dtype=np.int32)
    assert datasets.cast_input_dtype(ints, "bf16") is ints
    with pytest.raises(ValueError):
        datasets.cast_input_dtype(x, "fp8")


def _trees():
    rng = np.random.default_rng(2)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return [
        {"Dense_1": {"kernel": f(4, 3), "bias": f(3)},
         "Conv_0": {"kernel": f(2, 2, 1, 4), "bias": f(4)}},
        (f(5), [f(2, 2), {"b": f(1), "a": f(3)}]),
        {"w": f(3), "i": np.arange(4, dtype=np.int32)},  # promotes to f32
    ]


@pytest.mark.parametrize("tree", _trees(), ids=["flax-like", "tuple-list", "mixed"])
def test_flatten_params_matches_ravel_pytree(tree):
    ref_flat, ref_unravel = ravel_pytree(jax.tree.map(jnp.asarray, tree))
    flat, spec = flatten_params(tree_map(torch.from_numpy, tree))
    assert spec.size == ref_flat.size
    assert str(flat.dtype).split(".")[-1] == str(ref_flat.dtype)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref_flat))
    back = unflatten_params(spec, flat)
    ref_back = ref_unravel(ref_flat)
    assert jax.tree.structure(tree_map(lambda t: t.numpy(), back)) == \
        jax.tree.structure(ref_back)
    for a, b in zip(jax.tree.leaves(ref_back), tree_leaves(back)):
        assert b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError):
        unflatten_params(spec, flat[:-1])


def test_presets_and_config_equal_reference():
    assert config.PRESETS == jax_config.PRESETS
    ref_fields = [(f.name, f.default, str(f.type))
                  for f in dataclasses.fields(jax_config.TrainConfig)]
    got_fields = [(f.name, f.default, str(f.type))
                  for f in dataclasses.fields(config.TrainConfig)]
    assert got_fields == ref_fields
    argv = ["--preset", "mnist-easgd", "--epochs", "1", "--tau", "2"]
    assert (config.TrainConfig.from_args(argv).to_json()
            == jax_config.TrainConfig.from_args(argv).to_json())


def test_prefetch_to_device_cpu():
    items = [(np.full((2, 3), i, np.float32), np.arange(2) + i) for i in range(5)]
    got = list(prefetch_to_device(iter(items), torch.device("cpu"), depth=2))
    assert len(got) == 5
    for (x, y), (gx, gy) in zip(items, got):
        assert isinstance(gx, torch.Tensor)
        np.testing.assert_array_equal(gx.numpy(), x)
        np.testing.assert_array_equal(gy.numpy(), y)
    with pytest.raises(ValueError):
        prefetch_to_device(iter(items), torch.device("cpu"), depth=-1)


def test_metrics_logger_jsonl(tmp_path):
    import json

    from mpit_tpu_torch.utils.metrics import MetricsLogger

    path = tmp_path / "m" / "log.jsonl"
    with MetricsLogger(path=str(path), tag="easgd", echo=False) as log:
        log.log(3, loss=torch.tensor(1.5), acc=0.25)
    (rec,) = [json.loads(line) for line in open(path)]
    assert rec["step"] == 3 and rec["loss"] == 1.5 and rec["acc"] == 0.25
    assert rec["tag"] == "easgd" and rec["process"] == 0
    assert os.path.getsize(path) > 0
