"""The port's numpy data loader against the JAX package's, on the CPU: the
same arguments give the same arrays, bit for bit."""

import gzip
import os
import pickle
import struct

import numpy as np
import pytest

from dctn_tpu.data import load_dataset as jax_load_dataset
from dctn_tpu.data import pipeline as jax_pipeline
from dctn_tpu_torch.data import io as port_io
from dctn_tpu_torch.data import load_dataset, pipeline

SIZES = (12, 4, 6)


def assert_splits_equal(got, want):
    assert got.nu == want.nu
    for g, w in zip(got, want):
        for field in ("x", "y", "indices", "unmodified_x"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize(
    "ds_type,kwargs",
    [
        ("mnist", {}),
        ("fashionmnist", {"autoscale_kernel_size": 4}),
        ("fashionmnist", {"phi_multiplier": 1.5}),
        ("cifar10_28x28_grayscale", {"autoscale_kernel_size": 3}),
        ("cifar10_32x32_grayscale", {}),
        ("cifar10_rgb", {"center_and_normalize_each_channel": True, "autoscale_kernel_size": 2}),
        ("cifar10_YCbCr", {"add_constant_channel": 0.5, "nu_per_channel": (1.1, 0.9, 1.2)}),
    ],
)
def test_synthetic_splits_match_jax(ds_type, kwargs):
    got = load_dataset(ds_type, "synthetic", synthetic_sizes=SIZES, **kwargs)
    want = jax_load_dataset(ds_type, "synthetic", synthetic_sizes=SIZES, **kwargs)
    assert_splits_equal(got, want)


@pytest.mark.parametrize("kernel_size", [2, 3, 4])
def test_calc_scaling_factor_matches_jax(kernel_size):
    x = np.random.default_rng(kernel_size).uniform(size=(2, 5, 9, 9, 3)).astype(np.float32)
    assert pipeline.calc_scaling_factor(x, kernel_size) == jax_pipeline.calc_scaling_factor(
        x, kernel_size
    )


def _write_idx(root, rng, gz):
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    for prefix, n in (("train", 14), ("t10k", 5)):
        images = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, n).astype(np.uint8)
        with opener(os.path.join(root, f"{prefix}-images-idx3-ubyte{suffix}"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, *images.shape) + images.tobytes())
        with opener(os.path.join(root, f"{prefix}-labels-idx1-ubyte{suffix}"), "wb") as f:
            f.write(struct.pack(">II", 2049, n) + labels.tobytes())


@pytest.mark.parametrize("gz", [False, True])
def test_idx_file_splits_match_jax(tmp_path, monkeypatch, gz):
    root = tmp_path / "FashionMNIST" / "raw"
    root.mkdir(parents=True)
    _write_idx(str(root), np.random.default_rng(3), gz)
    monkeypatch.setattr(pipeline, "MNISTLIKE_NUM_TRAIN_SAMPLES", 10)
    monkeypatch.setattr(jax_pipeline, "MNISTLIKE_NUM_TRAIN_SAMPLES", 10)
    got = load_dataset("fashionmnist", str(tmp_path), autoscale_kernel_size=3)
    want = jax_load_dataset("fashionmnist", str(tmp_path), autoscale_kernel_size=3)
    assert [len(s) for s in got] == [10, 4, 5]
    assert_splits_equal(got, want)


def _write_cifar(root, rng, n=6):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        batch = {
            b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8),
            b"labels": [int(v) for v in rng.integers(0, 10, n)],
        }
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump(batch, f)


@pytest.mark.parametrize("ds_type", ["cifar10_28x28_grayscale", "cifar10_rgb", "cifar10_YCbCr"])
def test_cifar_file_splits_match_jax(tmp_path, monkeypatch, ds_type):
    _write_cifar(str(tmp_path), np.random.default_rng(4))
    monkeypatch.setattr(pipeline, "CIFAR10_NUM_TRAIN_SAMPLES", 24)
    monkeypatch.setattr(jax_pipeline, "CIFAR10_NUM_TRAIN_SAMPLES", 24)
    got = load_dataset(ds_type, str(tmp_path))
    want = jax_load_dataset(ds_type, str(tmp_path))
    assert [len(s) for s in got] == [24, 6, 6]
    assert_splits_equal(got, want)


def test_bad_idx_magic_and_missing_files_are_refused(tmp_path):
    path = tmp_path / "train-images-idx3-ubyte"
    path.write_bytes(struct.pack(">IIII", 1234, 0, 28, 28))
    with pytest.raises(ValueError, match="bad IDX magic"):
        port_io.read_idx_images(str(path))
    with pytest.raises(FileNotFoundError, match="synthetic"):
        port_io.load_mnist_like(str(tmp_path / "empty"), "MNIST", train=True)


@pytest.mark.parametrize(
    "ds_type,kwargs",
    [
        ("nosuchset", {}),
        ("mnist", {"phi_multiplier": 1.0, "autoscale_kernel_size": 4}),
        ("mnist", {"add_constant_channel": 1.0}),
        ("cifar10_rgb", {"phi_multiplier": 1.0}),
    ],
)
def test_bad_options_are_refused(ds_type, kwargs):
    with pytest.raises(ValueError):
        load_dataset(ds_type, "synthetic", synthetic_sizes=SIZES, **kwargs)
