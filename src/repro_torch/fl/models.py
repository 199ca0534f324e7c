"""Small classifiers for the FL experiments (Appendix B.1; port of
``repro.fl.models``) as ``nn.Module``s.

The paper's EMNIST/KMNIST network: two 7x7 conv layers (20, 40 channels)
with ReLU, a 2x2 max-pool and a dense softmax head.  Inputs are NHWC, as
the JAX package's (``[B, H, W, 1]``), and are cast to the parameters' type
first, so a float64 batch does not promote the model.

Parameter layouts: a dense layer keeps ``w [in, out]`` and ``b [out]``
(``h @ w + b``, the reference's layout); a conv layer keeps PyTorch's
``w [out, in, kh, kw]`` (OIHW, the reference's HWIO transposed) and
``b [out]``.  The CNN runs its convolutions in NCHW and permutes the pooled
activations back to NHWC before flattening, so the head's rows are in the
reference's (H, W, C) order and converted weights need no row permutation
(:func:`repro_torch.convert.model_params`).

Initialisation (:meth:`init_parameters`) draws from a key
(:mod:`repro_torch.core.prng`) with the reference's split structure:
He-normal weights (``N(0, 2 / fan_in)``, a float32 ``normal`` scaled in
float64, as the reference's ``normal(...) * np.sqrt(...)`` promotes) and
zero biases, as ``_dense_init`` and ``cnn_classifier.init`` do.  The
draws are JAX's for the same key; the normal is held to JAX's within a few
ulps (PyTorch's ``erfinv`` is not XLA's), and the weights are rounded to
the parameters' float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..core import prng


def _he_normal(key: torch.Tensor, shape, fan_in: int) -> torch.Tensor:
    """``normal(key, shape, float32) * sqrt(2 / fan_in)`` in float64."""
    z = prng.normal(key, shape, torch.float32)
    return z.double() * math.sqrt(2.0 / fan_in)


class Dense(nn.Module):
    """``h @ w + b`` with ``w [in, out]``."""

    def __init__(self, fan_in: int, fan_out: int, *, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(fan_in, fan_out, device=device))
        self.b = nn.Parameter(torch.zeros(fan_out, device=device))

    def init_parameters(self, key: torch.Tensor) -> None:
        """The reference's ``_dense_init``: ``w`` from the first key of a
        2-way split."""
        fan_in, fan_out = self.w.shape
        k1 = prng.split(key.to(self.w.device))[0]
        with torch.no_grad():
            self.w.copy_(_he_normal(k1, (fan_in, fan_out), fan_in))
            self.b.zero_()

    def forward(self, h):
        return h @ self.w + self.b


class Conv(nn.Module):
    """SAME-padded stride-1 convolution with ReLU, ``w`` OIHW."""

    def __init__(self, c_in: int, c_out: int, kernel: int, *, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(c_out, c_in, kernel, kernel,
                                          device=device))
        self.b = nn.Parameter(torch.zeros(c_out, device=device))

    def init_parameters(self, key: torch.Tensor) -> None:
        """``w`` drawn in the reference's HWIO shape from ``key``."""
        c_out, c_in, kh, kw = self.w.shape
        w = _he_normal(key.to(self.w.device), (kh, kw, c_in, c_out),
                       kh * kw * c_in)
        with torch.no_grad():
            self.w.copy_(w.permute(3, 2, 0, 1))
            self.b.zero_()

    def forward(self, h):  # NCHW
        # padding="same" pads (k - 1) // 2 before and the rest after, as
        # XLA's SAME does (3 on each side at k = 7)
        return F.relu(F.conv2d(h, self.w, self.b, padding="same"))


class MLPClassifier(nn.Module):
    """Dense ReLU layers and a linear head on the flattened input."""

    def __init__(self, input_dim: int, num_classes: int,
                 hidden: tuple[int, ...] = (256, 128), *, device=None):
        super().__init__()
        sizes = (input_dim,) + tuple(hidden) + (num_classes,)
        self.layers = nn.ModuleList(
            Dense(a, b, device=device) for a, b in zip(sizes[:-1], sizes[1:]))

    def init_parameters(self, key: torch.Tensor) -> None:
        """One key a layer, from a split of ``key``."""
        for layer, k in zip(self.layers, prng.split(key, len(self.layers))):
            layer.init_parameters(k)

    def forward(self, x):
        h = x.reshape(x.shape[0], -1).to(self.layers[0].w.dtype)
        for layer in self.layers[:-1]:
            h = F.relu(layer(h))
        return self.layers[-1](h)


class CNNClassifier(nn.Module):
    """The paper's EMNIST CNN (Appendix B.1): NHWC ``[B, S, S, 1]`` in,
    logits ``[B, num_classes]`` out."""

    def __init__(self, image_size: int, num_classes: int,
                 channels: tuple[int, int] = (20, 40), kernel: int = 7, *,
                 device=None):
        super().__init__()
        c1, c2 = channels
        self.conv1 = Conv(1, c1, kernel, device=device)
        self.conv2 = Conv(c1, c2, kernel, device=device)
        flat = (image_size // 2) * (image_size // 2) * c2
        self.head = Dense(flat, num_classes, device=device)

    def init_parameters(self, key: torch.Tensor) -> None:
        """``conv1``, ``conv2`` and the head from a 3-way split of
        ``key``."""
        for layer, k in zip((self.conv1, self.conv2, self.head),
                            prng.split(key, 3)):
            layer.init_parameters(k)

    def forward(self, x):
        h = x.to(self.conv1.w.dtype).permute(0, 3, 1, 2)  # NHWC -> NCHW
        h = self.conv2(self.conv1(h))
        h = F.max_pool2d(h, 2)  # VALID: odd edges are dropped, as XLA's
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # (H, W, C) rows
        return self.head(h)


def mlp_classifier(input_dim: int, num_classes: int,
                   hidden: tuple[int, ...] = (256, 128), *,
                   device="cuda") -> MLPClassifier:
    return MLPClassifier(input_dim, num_classes, hidden, device=device)


def cnn_classifier(image_size: int, num_classes: int,
                   channels: tuple[int, int] = (20, 40), kernel: int = 7, *,
                   device="cuda") -> CNNClassifier:
    """The paper's EMNIST CNN (Appendix B.1)."""
    return CNNClassifier(image_size, num_classes, channels, kernel,
                         device=device)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy; labels may be [B] (classification) or [B, S]."""
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None].long()).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
