"""Synthetic, offline stand-ins for the paper's image datasets (port of
``repro.data.synthetic``; numpy only, so the arrays are bit for bit the
JAX package's for the same arguments).

EMNIST/KMNIST are replaced by procedurally generated class-structured image
datasets with the same tensor format (28x28 grayscale, 47/10 balanced
classes).  Each class owns a smooth random "prototype" field plus a stroke
skeleton; samples are random translations/scalings of the prototype with
additive noise — hard enough that a linear model underfits, easy enough
that the paper's small CNN separates them, which is all the FL experiments
need (they compare *relative* convergence speed of scheduling strategies,
not absolute accuracy).

The token dataset of the LM examples is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ImageDataset(NamedTuple):
    x: np.ndarray  # [N, H, W, 1] float32 in [0, 1]
    y: np.ndarray  # [N] int32
    num_classes: int


def _class_prototype(rng: np.random.Generator, size: int) -> np.ndarray:
    """Smooth random field + random stroke segments — a class 'glyph'."""
    # low-frequency random field
    freqs = rng.normal(size=(4, 4))
    yy, xx = np.mgrid[0:size, 0:size] / size * 2 * np.pi
    field = np.zeros((size, size))
    for i in range(4):
        for j in range(4):
            field += freqs[i, j] * np.sin((i + 1) * yy + (j + 1) * xx
                                          + rng.uniform(0, 2 * np.pi))
    field = (field - field.min()) / (np.ptp(field) + 1e-9)
    # stroke skeleton: 3 random line segments, thickened
    img = 0.3 * field
    for _ in range(3):
        x0, y0, x1, y1 = rng.uniform(4, size - 4, size=4)
        t = np.linspace(0, 1, 64)
        xs = (x0 + t * (x1 - x0)).astype(int)
        ys = (y0 + t * (y1 - y0)).astype(int)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                img[np.clip(ys + dy, 0, size - 1),
                    np.clip(xs + dx, 0, size - 1)] = 1.0
    return img.astype(np.float32)


def make_synthetic_image_dataset(
    num_classes: int = 47,
    samples_per_class: int = 200,
    image_size: int = 28,
    seed: int = 0,
    noise: float = 0.15,
) -> ImageDataset:
    rng = np.random.default_rng(seed)
    protos = [_class_prototype(rng, image_size) for _ in range(num_classes)]
    xs, ys = [], []
    for c, proto in enumerate(protos):
        for _ in range(samples_per_class):
            shift = rng.integers(-3, 4, size=2)
            img = np.roll(proto, shift, axis=(0, 1))
            scale = rng.uniform(0.7, 1.3)
            img = np.clip(img * scale + rng.normal(0, noise, img.shape), 0, 1)
            xs.append(img.astype(np.float32))
            ys.append(c)
    x = np.stack(xs)[..., None]
    y = np.asarray(ys, dtype=np.int32)
    perm = rng.permutation(len(y))
    return ImageDataset(x=x[perm], y=y[perm], num_classes=num_classes)


def train_test_split(ds: ImageDataset, test_fraction: float = 0.2,
                     seed: int = 0) -> tuple[ImageDataset, ImageDataset]:
    """Split one generated dataset into train/test (same class prototypes —
    the test set is 'unseen samples', matching the paper's protocol)."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(ds.y))
    cut = int(len(idx) * (1 - test_fraction))
    tr, te = idx[:cut], idx[cut:]
    return (ImageDataset(ds.x[tr], ds.y[tr], ds.num_classes),
            ImageDataset(ds.x[te], ds.y[te], ds.num_classes))
