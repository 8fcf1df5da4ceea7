"""Datasets → quantum features → ν scaling (port of ``load_dataset`` and
``calc_scaling_factor`` from ``dctn_tpu/data/pipeline.py``).

- MNIST/FashionMNIST: train = first 50k, val = last 10k of the train files,
  test = the test files; φ applied to the whole split up front.
- CIFAR-10 grayscale 28×28 / 32×32 (PIL resize + ITU-R grayscale) and
  colored rgb / YCbCr (the color values are the quantum dim, Q₀ = 3), after
  the reference's seed-0 shuffle and a 45k/5k split.
- ν autoscaling: multiply x so K×K windows of rank-one tensors have
  μ²+σ²=1, in float64 over the first 10880 train samples.
- per-channel normalization, a constant channel and per-channel ν for
  colored CIFAR.

Host-side numpy; the same arguments give the same arrays as the JAX
package. Its training ``Batcher`` is not ported: serving batches by slicing.
"""

from __future__ import annotations

import dataclasses
import logging
import random
from typing import Optional, Tuple

import numpy as np

from . import io as data_io
from .feature_maps import PhiMap, apply_feature_map, phi_cos_sin_squared_1

logger = logging.getLogger(__name__)

DATASET_TYPES = (
    "mnist",
    "fashionmnist",
    "cifar10_28x28_grayscale",
    "cifar10_32x32_grayscale",
    "cifar10_rgb",
    "cifar10_YCbCr",
)

CIFAR10_NUM_TRAIN_SAMPLES = 45000
MNISTLIKE_NUM_TRAIN_SAMPLES = 50000

# the ν-scaled FashionMNIST train split with K=4 and the default φ
FASHIONMNIST_K4_SCALED_MEAN = 0.7284077405929565
FASHIONMNIST_K4_SCALED_STD = 0.6384438872337341


@dataclasses.dataclass
class QuantumSplit:
    """One split: quantum features x (C, N, H, W, Q) float32, labels,
    indices into the original dataset, and the pre-φ images."""

    x: np.ndarray
    y: np.ndarray
    indices: np.ndarray
    unmodified_x: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.y)


@dataclasses.dataclass
class Splits:
    train: QuantumSplit
    val: QuantumSplit
    test: QuantumSplit
    nu: Optional[Tuple[float, ...]] = None  # the scaling actually applied

    def __iter__(self):
        return iter((self.train, self.val, self.test))


def calc_scaling_factor(x: np.ndarray, kernel_size: int, subset: int = 10880) -> float:
    """ν such that K×K windows of ν·x (rank-one tensors) have μ²+σ²=1.

    ``x``: (C, N, H, W, Q). Float64 throughout; windows are never densified:
    per-window sums and norms use the rank-one product identities, and the
    variance is the unbiased one over the implied dense batch.
    """
    xs = x[:, :subset].astype(np.float64)
    c, n, h, w, q = xs.shape
    hp, wp = h - kernel_size + 1, w - kernel_size + 1
    sums = np.ones((n, hp, wp))
    sqnorms = np.ones((n, hp, wp))
    nfactors = 0
    for dh in range(kernel_size):
        for dw in range(kernel_size):
            for ch in range(c):
                view = xs[ch, :, dh : dh + hp, dw : dw + wp, :]
                sums *= view.sum(axis=-1)
                sqnorms *= (view**2).sum(axis=-1)
                nfactors += 1
    nelement = n * hp * wp * float(q) ** nfactors
    total = sums.sum()
    mean = total / nelement
    divisor = nelement - 1
    var = sqnorms.sum() / divisor - 2 * total / divisor * mean + nelement / divisor * mean**2
    return float((mean**2 + var) ** (-1.0 / (2 * kernel_size**2)))


def _synthetic(sizes, seed, **kwargs):
    """Disjoint synthetic train/val/test raws and labels."""
    n_tr, n_val, n_te = sizes
    parts = [
        data_io.synthetic_mnist_like(n, seed=seed, offset=off, **kwargs)
        for n, off in ((n_tr, 0), (n_val, n_tr), (n_te, n_tr + n_val))
    ]
    raws, ys = zip(*parts)
    return raws, ys, tuple(np.arange(len(y)) for y in ys)


def _mnist_like_splits(ds_type: str, root: str, phi: PhiMap, synthetic_sizes):
    if root == "synthetic":
        raws, ys, idxs = _synthetic(synthetic_sizes, 1234 if ds_type == "mnist" else 4321)
    else:
        name = {"mnist": "MNIST", "fashionmnist": "FashionMNIST"}[ds_type]
        images, labels = data_io.load_mnist_like(root, name, train=True)
        test_images, test_labels = data_io.load_mnist_like(root, name, train=False)
        images = images.astype(np.float32) / 255.0
        n_tr = MNISTLIKE_NUM_TRAIN_SAMPLES
        raws = (images[:n_tr], images[n_tr : n_tr + 10000], test_images.astype(np.float32) / 255.0)
        ys = (labels[:n_tr], labels[n_tr : n_tr + 10000], test_labels)
        idxs = (np.arange(len(ys[0])), np.arange(n_tr, n_tr + len(ys[1])), np.arange(len(test_labels)))
    return tuple(
        QuantumSplit(apply_feature_map(r, phi), y, i, unmodified_x=r)
        for r, y, i in zip(raws, ys, idxs)
    )


def _seed0_shuffled_indices(n: int) -> list:
    """The reference's deterministic CIFAR shuffle (random.seed(0) then
    random.sample)."""
    random.seed(0)
    return random.sample(range(n), n)


def _shuffled_cifar(root: str, convert):
    """The seed-0 shuffled CIFAR-10 train set split 45k/5k, and the test
    set, each passed through ``convert``: (raws, ys, idxs)."""
    x, y = data_io.load_cifar10(root, train=True)
    xt, yt = data_io.load_cifar10(root, train=False)
    order = _seed0_shuffled_indices(len(x))
    logger.info("cifar shuffle first 10 indices: %s", order[:10])
    xc, y_sh, cut = convert(x[order]), y[order], CIFAR10_NUM_TRAIN_SAMPLES
    raws = (xc[:cut], xc[cut:], convert(xt))
    ys = (y_sh[:cut], y_sh[cut:], yt)
    idxs = (np.asarray(order[:cut]), np.asarray(order[cut:]), np.arange(len(yt)))
    return raws, ys, idxs


def _cifar_grayscale_splits(root: str, image_size: int, phi: PhiMap, synthetic_sizes):
    if root == "synthetic":
        raws, ys, idxs = _synthetic(synthetic_sizes, 77, height=image_size, width=image_size)
    else:
        from PIL import Image

        def to_gray(batch: np.ndarray) -> np.ndarray:
            out = np.empty((len(batch), image_size, image_size), np.float32)
            for i, img in enumerate(batch):
                pil = Image.fromarray(img)
                if image_size != 32:
                    pil = pil.resize((image_size, image_size), Image.BILINEAR)
                out[i] = np.asarray(pil.convert("L"), np.float32) / 255.0
            return out

        raws, ys, idxs = _shuffled_cifar(root, to_gray)
    return tuple(
        QuantumSplit(apply_feature_map(r, phi), y, i, unmodified_x=r)
        for r, y, i in zip(raws, ys, idxs)
    )


def _cifar_colored_splits(root: str, colors: str, synthetic_sizes):
    """Colored CIFAR: C = 1 image channel, the 3 color values are the
    quantum dim (Q₀ = 3), x of shape (1, N, 32, 32, 3)."""
    if root == "synthetic":
        raws, ys, idxs = _synthetic(synthetic_sizes, 99, height=32, width=32, channels=3)
    else:
        from PIL import Image

        def convert(batch: np.ndarray) -> np.ndarray:
            if colors == "rgb":
                return batch.astype(np.float32) / 255.0
            out = np.empty_like(batch, dtype=np.float32)
            for i, img in enumerate(batch):
                out[i] = np.asarray(Image.fromarray(img).convert("YCbCr"), np.float32) / 255.0
            return out

        raws, ys, idxs = _shuffled_cifar(root, convert)
    return tuple(
        QuantumSplit(r[None].astype(np.float32), y, i, unmodified_x=r)
        for r, y, i in zip(raws, ys, idxs)
    )


def load_dataset(
    ds_type: str,
    root: str,
    *,
    phi: PhiMap = phi_cos_sin_squared_1,
    phi_multiplier: Optional[float] = None,
    autoscale_kernel_size: Optional[int] = None,
    center_and_normalize_each_channel: bool = False,
    add_constant_channel: Optional[float] = None,
    nu_per_channel: Optional[Tuple[float, float, float]] = None,
    synthetic_sizes: Tuple[int, int, int] = (8192, 2048, 2048),
) -> Splits:
    """(train, val, test) QuantumSplits; ``root="synthetic"`` generates the
    data. ``phi_multiplier`` ν replaces the factor 2 of the default φ; it
    excludes ``autoscale_kernel_size`` and ``nu_per_channel``."""
    if ds_type not in DATASET_TYPES:
        raise ValueError(f"unknown ds_type {ds_type!r}; one of {DATASET_TYPES}")
    colored = ds_type in ("cifar10_rgb", "cifar10_YCbCr")
    if sum(v is not None for v in (phi_multiplier, autoscale_kernel_size, nu_per_channel)) > 1:
        raise ValueError("phi_multiplier, autoscale_kernel_size and nu_per_channel exclude each other")
    if not colored and (
        nu_per_channel is not None or center_and_normalize_each_channel
        or add_constant_channel is not None
    ):
        raise ValueError("per-channel options apply to colored CIFAR only")
    if colored and phi_multiplier is not None:
        raise ValueError("phi_multiplier does not apply to colored CIFAR")

    if phi_multiplier is not None:
        m = phi_multiplier
        phi = tuple((lambda X, f=f: f(X) * (m / 2.0)) for f in phi)

    if ds_type in ("mnist", "fashionmnist"):
        train, val, test = _mnist_like_splits(ds_type, root, phi, synthetic_sizes)
    elif ds_type in ("cifar10_28x28_grayscale", "cifar10_32x32_grayscale"):
        size = 28 if ds_type == "cifar10_28x28_grayscale" else 32
        train, val, test = _cifar_grayscale_splits(root, size, phi, synthetic_sizes)
    else:
        colors = "rgb" if ds_type == "cifar10_rgb" else "YCbCr"
        train, val, test = _cifar_colored_splits(root, colors, synthetic_sizes)

    splits = Splits(train, val, test)
    if colored:
        if center_and_normalize_each_channel:
            mu = train.x.astype(np.float64).mean(axis=(0, 1, 2, 3))
            sigma = train.x.astype(np.float64).std(axis=(0, 1, 2, 3))
            for s in splits:
                s.x = ((s.x - mu) / sigma).astype(np.float32)
        nu = nu_per_channel
        if add_constant_channel is not None:
            for s in splits:
                s.x = np.concatenate((s.x, np.full_like(s.x[..., :1], add_constant_channel)), axis=4)
            if nu is not None:
                nu = tuple(nu) + (1.0,)
        if autoscale_kernel_size is not None:
            nu = (calc_scaling_factor(train.x, autoscale_kernel_size),) * train.x.shape[-1]
        if nu is not None:
            arr = np.asarray(nu, np.float32)
            for s in splits:
                s.x = s.x * arr
            splits.nu = tuple(float(v) for v in nu)
    elif autoscale_kernel_size is not None:
        v = calc_scaling_factor(train.x, autoscale_kernel_size)
        for s in splits:
            s.x = (s.x * v).astype(np.float32)
        splits.nu = (float(v),)
        if (
            ds_type == "fashionmnist" and autoscale_kernel_size == 4
            and phi is phi_cos_sin_squared_1 and root != "synthetic"
        ):
            if not (
                np.allclose(train.x.mean(), FASHIONMNIST_K4_SCALED_MEAN, atol=1e-6)
                and np.allclose(train.x.std(), FASHIONMNIST_K4_SCALED_STD, atol=1e-6)
            ):
                raise ValueError("ν-scaled FashionMNIST statistics differ from the reference's")
    logger.info("ν applied: %s", splits.nu)
    return splits
