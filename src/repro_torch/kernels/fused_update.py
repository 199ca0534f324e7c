"""The fused Generalized-AsyncSGD server update (port of
``repro.kernels.fused_update``): ``w <- w - scale * g`` fused with the
squared gradient norm, one pass over ``(w, g)``.

Replaces the Pallas TPU kernel
``repro/kernels/fused_update.py::fused_async_update_flat`` (body
``_update_kernel``) with the hand-written CUDA kernel
``csrc/fused_update.cu``: one CTA per 4096-element block and lane, 128-bit
vector loads, a warp-shuffle reduction of each block's ``sum g^2`` into a
partial, and the partials summed in block order.  It is bound by the bytes
it moves (``w`` and ``g`` read once, ``w'`` written once: 12 B a float32
parameter).  The reduction order depends on element indices only, so the
same inputs give the same bits on every run, and ``w'`` equals the plain
PyTorch ``w - scale * g`` bit for bit (no contracted multiply-adds).

Entry points:

  * :func:`fused_async_update_flat` — ``w, g`` ``[N]`` or ``[L, N]``
    (float32 or bfloat16), ``scale`` a number or ``[L]``; returns the new
    ``w`` (same shape and type) and ``sum g^2`` in float32 (``[]`` or
    ``[L]``).  Launches the CUDA kernel for CUDA tensors (or raises) and
    runs :func:`fused_async_update_flat_plain` — the same arithmetic in
    PyTorch — for CPU tensors only.  ``fused_async_update_flat.launches``
    counts kernel launches.
  * :func:`fused_async_update` — the pytree form over a dict or list of
    leaves: the new leaves and the gradient norm ``sqrt(sum g^2)``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

BLOCK = 4096  # elements per partial sum, as the TPU kernel's tile
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lanes(w, g, scale):
    """``(w [L, N], g [L, N], scale [L] float32, flat input?)``."""
    if w.shape != g.shape:
        raise ValueError(f"w {tuple(w.shape)} and g {tuple(g.shape)} differ")
    if w.dtype != g.dtype:
        raise ValueError(f"w is {w.dtype}, g is {g.dtype}")
    if w.dim() not in (1, 2):
        raise ValueError(f"expected [N] or [L, N], got {tuple(w.shape)}")
    flat = w.dim() == 1
    w2, g2 = (w[None], g[None]) if flat else (w, g)
    L = w2.shape[0]
    s = torch.as_tensor(scale, dtype=torch.float32, device=w.device)
    s = s.reshape(-1).expand(L) if s.numel() == 1 else s.reshape(L)
    return w2, g2, s, flat


def fused_async_update_flat_plain(w, g, scale):
    """The kernel's arithmetic in PyTorch: ``(w - scale * g)`` in float32
    cast to ``w``'s type, and ``sum g^2`` in float32 as per-block partials
    summed in block order — what CPU tensors run."""
    w2, g2, s, flat = _lanes(w, g, scale)
    L, N = w2.shape
    g32 = g2.to(torch.float32)
    out = (w2.to(torch.float32) - s[:, None] * g32).to(w.dtype)
    n_blocks = -(-N // BLOCK)
    sq = torch.zeros((L, n_blocks * BLOCK), dtype=torch.float32,
                     device=w.device)
    sq[:, :N] = g32 * g32
    sumsq = sq.view(L, n_blocks, BLOCK).sum(dim=2).sum(dim=1)
    return (out[0], sumsq[0]) if flat else (out, sumsq)


def _launch(w, g, scale):
    w2, g2, s, flat = _lanes(w, g, scale)
    if w2.dtype not in _DTYPES:
        raise ValueError(f"fused update: {w2.dtype} is not float32 or "
                         f"bfloat16")
    if g2.device != w2.device:
        raise ValueError("fused update: w and g on different devices")
    w2, g2, s = w2.contiguous(), g2.contiguous(), s.contiguous()
    L, N = w2.shape
    n_blocks = -(-N // BLOCK)
    out = torch.empty_like(w2)
    partial = torch.empty((L, n_blocks), dtype=torch.float32,
                          device=w2.device)
    sumsq = torch.empty(L, dtype=torch.float32, device=w2.device)
    fn = build.load("fused_update").fused_update
    if not fn.argtypes:  # the library caches its function objects
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 2
                       + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(w2.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(w2.data_ptr(), g2.data_ptr(), s.data_ptr(), out.data_ptr(),
                 partial.data_ptr(), sumsq.data_ptr(), L, N,
                 _DTYPES[w2.dtype], stream)
    build.check(err, "fused_update launch")
    build.count(fused_async_update_flat)
    return (out[0], sumsq[0]) if flat else (out, sumsq)


def fused_async_update_flat(w, g, scale):
    """``(w - scale * g, sum g^2)`` over ``[N]`` or ``[L, N]`` parameters
    (see the module docstring): the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if w.is_cuda:
        return _launch(w, g, scale)
    if w.device.type == "cpu":
        return fused_async_update_flat_plain(w, g, scale)
    raise ValueError(f"no fused update kernel for device {w.device}")


fused_async_update_flat.launches = 0


def fused_async_update(params, grads, scale):
    """Pytree form over a dict (or list) of leaves: one flat update per
    leaf; returns ``(new_params, sqrt(sum g^2))`` like the reference."""
    keys = list(params) if isinstance(params, dict) else range(len(params))
    new = {} if isinstance(params, dict) else [None] * len(params)
    total = None
    for k in keys:
        w, g = params[k], grads[k]
        nw, sq = fused_async_update_flat(w.reshape(-1), g.reshape(-1), scale)
        new[k] = nw.reshape(w.shape)
        total = sq if total is None else total + sq
    return new, torch.sqrt(total)
