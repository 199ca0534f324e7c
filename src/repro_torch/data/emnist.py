"""Download-free EMNIST-style dataset loader (port of ``repro.data.emnist``,
numpy only).

This loader never downloads anything.  Resolution order:

  1. a **local cache**: an ``.npz`` file with arrays ``x`` (``[N, 28, 28]``
     or ``[N, 28, 28, 1]``, uint8 or float) and ``y`` (``[N]`` integer
     labels) at ``$REPRO_EMNIST_PATH`` or ``~/.cache/repro/emnist.npz`` —
     e.g. a converted EMNIST-Balanced split dropped in by the user;
  2. a **deterministic synthetic fallback** with exactly the EMNIST tensor
     format (28x28 grayscale, float32 in [0, 1], int32 labels): the
     class-structured glyph generator of :mod:`repro_torch.data.synthetic`
     seeded off this module's namespace, so the fallback is stable across
     runs and distinct from the ``"synthetic"`` dataset.

Either way the result is an :class:`repro_torch.data.synthetic.ImageDataset`
subsampled to ``num_classes`` x ``samples_per_class`` — the same shapes,
dtypes and values as the JAX package's loader on every machine.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .synthetic import ImageDataset, make_synthetic_image_dataset

_IMAGE_SIZE = 28
_FALLBACK_SEED_OFFSET = 0xE3157  # "emnist"-namespace: differ from synthetic


def emnist_cache_path() -> str:
    """The resolved local cache location (the file need not exist)."""
    env = os.environ.get("REPRO_EMNIST_PATH")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro",
                        "emnist.npz")


def _subsample(x: np.ndarray, y: np.ndarray, num_classes: int,
               samples_per_class: int, seed: int) -> ImageDataset:
    """Deterministic class-balanced subsample in the canonical format."""
    rng = np.random.default_rng(seed)
    labels = np.unique(y)
    if len(labels) < num_classes:
        raise ValueError(
            f"cached EMNIST file has {len(labels)} classes, "
            f"{num_classes} were asked for")
    keep = rng.permutation(labels)[:num_classes]
    xs, ys = [], []
    for new_c, c in enumerate(sorted(keep)):
        idx = np.flatnonzero(y == c)
        if len(idx) < samples_per_class:
            raise ValueError(
                f"class {c} has only {len(idx)} samples, need "
                f"{samples_per_class}")
        pick = rng.permutation(idx)[:samples_per_class]
        xs.append(x[pick])
        ys.append(np.full(samples_per_class, new_c, dtype=np.int32))
    x_out = np.concatenate(xs).astype(np.float32)
    if x_out.max() > 1.5:  # uint8-scaled cache
        x_out = x_out / 255.0
    if x_out.ndim == 3:
        x_out = x_out[..., None]
    y_out = np.concatenate(ys)
    perm = rng.permutation(len(y_out))
    return ImageDataset(x=x_out[perm], y=y_out[perm],
                        num_classes=num_classes)


def load_emnist(num_classes: int = 47, samples_per_class: int = 40,
                seed: int = 0, path: Optional[str] = None) -> ImageDataset:
    """EMNIST-format dataset: local ``.npz`` cache if present, else the
    deterministic synthetic fallback (see the module docstring)."""
    path = emnist_cache_path() if path is None else path
    if os.path.exists(path):
        with np.load(path) as npz:
            x = np.asarray(npz["x"])
            y = np.asarray(npz["y"])
        if x.ndim not in (3, 4) or x.shape[1:3] != (_IMAGE_SIZE, _IMAGE_SIZE):
            raise ValueError(
                f"{path}: expected [N, 28, 28(, 1)] images, got {x.shape}")
        return _subsample(x, y, num_classes, samples_per_class, seed)
    return make_synthetic_image_dataset(
        num_classes=num_classes, samples_per_class=samples_per_class,
        image_size=_IMAGE_SIZE, seed=seed + _FALLBACK_SEED_OFFSET)
