"""Raw dataset readers (port of ``dctn_tpu/data/io.py``): MNIST-family IDX
files, CIFAR-10 python batches, and the deterministic synthetic generator.

The standard on-disk formats are parsed directly (no torchvision, no
download); ``synthetic_mnist_like`` yields the same images, bit for bit, as
the JAX package's generator for the same arguments.
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
from typing import List, Optional, Tuple

import numpy as np


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def read_idx_images(path: str) -> np.ndarray:
    """Parse an IDX3 image file → (N, H, W) uint8."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad IDX magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols)


def read_idx_labels(path: str) -> np.ndarray:
    """Parse an IDX1 label file → (N,) int64."""
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad IDX magic {magic} in {path}")
        data = np.frombuffer(f.read(n), dtype=np.uint8)
    return data.astype(np.int64)


def _candidate_dirs(root: str, name: str) -> List[str]:
    return [root, os.path.join(root, name), os.path.join(root, name, "raw")]


def load_mnist_like(root: str, name: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N, H, W), labels (N,)) for MNIST / FashionMNIST from
    the standard IDX files under ``root`` (the torchvision layouts probed)."""
    prefix = "train" if train else "t10k"
    last_error: Optional[Exception] = None
    for d in _candidate_dirs(root, name):
        try:
            images = read_idx_images(os.path.join(d, f"{prefix}-images-idx3-ubyte"))
            labels = read_idx_labels(os.path.join(d, f"{prefix}-labels-idx1-ubyte"))
            return images, labels
        except FileNotFoundError as e:
            last_error = e
    raise FileNotFoundError(
        f"no {name} IDX files under {root!r} (tried {_candidate_dirs(root, name)}); "
        f"use ds_path='synthetic' for generated data"
    ) from last_error


def load_cifar10(root: str, train: bool) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 → (images uint8 (N, 32, 32, 3), labels (N,))."""
    for d in (root, os.path.join(root, "cifar-10-batches-py")):
        if os.path.exists(os.path.join(d, "data_batch_1" if train else "test_batch")):
            base = d
            break
    else:
        raise FileNotFoundError(f"no cifar-10-batches-py under {root!r}")
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    xs, ys = [], []
    for name in names:
        with open(os.path.join(base, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        xs.append(np.asarray(d[b"data"], dtype=np.uint8))
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return x, np.asarray(ys, dtype=np.int64)


def synthetic_mnist_like(
    n: int,
    height: int = 28,
    width: int = 28,
    num_classes: int = 10,
    channels: int = 0,
    seed: int = 1234,
    offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-structured images in [0, 1]: a fixed smooth
    prototype per class plus noise. ``offset`` selects a disjoint slice of
    the virtual infinite dataset, so train/val/test do not overlap.
    ``channels``: 0 → grayscale (N, H, W), else (N, H, W, channels)."""
    rng = np.random.default_rng(seed)
    shape_tail = (height, width) if channels == 0 else (height, width, channels)
    protos = rng.uniform(0.0, 1.0, size=(num_classes,) + shape_tail)
    for _ in range(2):
        protos = (
            protos
            + np.roll(protos, 1, axis=1)
            + np.roll(protos, -1, axis=1)
            + np.roll(protos, 1, axis=2)
            + np.roll(protos, -1, axis=2)
        ) / 5.0
    sample_rng = np.random.default_rng(seed + 1)
    labels = sample_rng.integers(0, num_classes, size=offset + n)[offset:]
    noise_rng = np.random.default_rng(seed + 2 + offset)
    noise = noise_rng.normal(0.0, 0.18, size=(n,) + shape_tail)
    x = protos[labels] + noise
    return np.clip(x, 0.0, 1.0).astype(np.float32), labels.astype(np.int64)
