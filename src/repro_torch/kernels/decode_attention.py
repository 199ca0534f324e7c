"""Decode attention for the LM's one-token step (port of
``repro.kernels.decode_attention``): one query token of each head against
a KV cache with a valid length, GQA, an online softmax in float32.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention_pallas`` (body
``_decode_kernel``) with the hand-written CUDA kernel
``csrc/decode_attention.cu``: one CTA per (batch, KV head) with the G query
heads of that KV head resident in shared memory as float32, a loop inside
it over 64-row cache tiles that stops at the last valid entry, the next K
and V tiles loaded 16 bytes a thread along D while the current one is
computed, scores, row max and row sum by warp reductions, ``p`` and the
``[G, D]`` accumulator in shared memory.  The cache is read in place
through its batch and row strides (no ``moveaxis`` or padded copy, which
would double the bytes of a memory-bound kernel).  It is bound by bytes:
the valid cache rows, read once.

The scores are ``(q.f32 * D^-1/2) . k.f32``: q upcast and then scaled, as
the TPU kernel and ``decode_attention_ref`` do.  Entries at or past
``length[b]`` are masked with ``-1e30``; the output is ``acc / max(l,
1e-30)`` in q's type, so ``length = 0`` gives 0 (the TPU kernel's value
there, a uniform mean over its padded tiles, is not kept).  A length above
S counts as S.

Entry points:

  * :func:`decode_attention` — q ``[B, 1, H, D]``, caches ``[B, S, KV,
    D]`` (float32 or bfloat16), ``length`` a Python int or an integer
    tensor ``[B]`` (or a 0-d one) on the cache's device; returns ``[B, 1,
    H, D]`` in q's type.  Launches the CUDA kernel for CUDA tensors (D = 64
    or 128, ``(H / KV) * D <= 6144``, q contiguous, each cache row's
    ``[KV, D]`` dense and 16-byte aligned; anything else raises) and runs
    :func:`decode_attention_plain` for CPU tensors only.
    ``decode_attention.launches`` counts kernel launches.
  * :func:`decode_attention_plain` — the same blocked online softmax in
    PyTorch, 64-row tiles.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NEG_INF = -1e30
BLOCK_S = 64  # cache rows per tile, as the CUDA kernel's BS
MAX_GD = 6144  # (H / KV) * D: the kernel's shared-memory accumulator
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _shapes(q, k_cache, v_cache):
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.dim() != 4:
        raise ValueError(f"expected q [B, 1, H, D], caches [B, S, KV, D]; "
                         f"got {tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    B, one, H, D = q.shape
    if one != 1:
        raise ValueError(f"decode attention takes one query token, got "
                         f"{one}")
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D):
        raise ValueError(f"caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    S, KV = k_cache.shape[1], k_cache.shape[2]
    if S < 1 or KV < 1 or H % KV:
        raise ValueError(f"{H} query heads over {KV} KV heads and {S} cache "
                         f"entries")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError(f"q, k, v types {q.dtype}, {k_cache.dtype}, "
                         f"{v_cache.dtype}")
    return B, S, H, KV, D


def _lengths(length, B: int, S: int, device):
    """``length`` as an int64 tensor ``[B]`` clamped to ``[0, S]``, and the
    number of tiles to visit (all of them for a tensor: no host sync)."""
    if isinstance(length, torch.Tensor):
        if length.dtype.is_floating_point or length.dtype == torch.bool:
            raise ValueError(f"length must be an integer, got "
                             f"{length.dtype}")
        if length.dim() > 1 or length.numel() not in (1, B):
            raise ValueError(f"length must be a scalar or [B = {B}], got "
                             f"{tuple(length.shape)}")
        lengths = length.to(device=device, dtype=torch.int64)
        return lengths.reshape(-1).expand(B).clamp(0, S), S
    n = min(max(int(length), 0), S)
    return torch.full((B,), n, dtype=torch.int64, device=device), n


def decode_attention_plain(q, k_cache, v_cache, length) -> torch.Tensor:
    """The kernel's blocked online softmax in PyTorch (see the module
    docstring): what CPU tensors run."""
    B, S, H, KV, D = _shapes(q, k_cache, v_cache)
    G = H // KV
    dev = q.device
    lengths, n = _lengths(length, B, S, dev)
    qf = q.to(torch.float32).reshape(B, KV, G, D) * D ** -0.5
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=dev)
    for s0 in range(0, n, BLOCK_S):
        kb = k_cache[:, s0:s0 + BLOCK_S].to(torch.float32)
        vb = v_cache[:, s0:s0 + BLOCK_S].to(torch.float32)
        pos = torch.arange(s0, s0 + kb.shape[1], device=dev)
        s = torch.einsum("bngd,bknd->bngk", qf, kb)
        valid = pos[None, :] < lengths[:, None]  # [B, tile]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bngk,bknd->bngd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = torch.where((lengths == 0)[:, None, None, None], 0.0, out)
    return out.reshape(B, 1, H, D).to(q.dtype)


def _launch(q, k_cache, v_cache, length):
    B, S, H, KV, D = _shapes(q, k_cache, v_cache)
    if q.dtype not in _DTYPES:
        raise ValueError(f"decode attention kernel: {q.dtype} is not "
                         f"float32 or bfloat16")
    if D not in _HEAD_DIMS:
        raise ValueError(f"decode attention kernel: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if (H // KV) * D > MAX_GD:
        raise ValueError(f"decode attention kernel: {H // KV} query heads "
                         f"per KV head x head_dim {D} > {MAX_GD}")
    if not (k_cache.device == q.device and v_cache.device == q.device):
        raise ValueError("decode attention kernel: q and the caches on "
                         "different devices")
    if not q.is_contiguous():
        raise ValueError("decode attention kernel: q must be contiguous")
    vec = 16 // q.element_size()
    for name, c in (("k", k_cache), ("v", v_cache)):
        if c.stride(3) != 1 or c.stride(2) != D:
            raise ValueError(f"decode attention kernel: each row of the "
                             f"{name} cache must be a dense [KV, D]; "
                             f"strides {c.stride()}")
        if c.data_ptr() % 16 or c.stride(0) % vec or c.stride(1) % vec:
            raise ValueError(f"decode attention kernel: the {name} cache's "
                             f"rows must be 16-byte aligned")
    if isinstance(length, torch.Tensor):
        if length.device != q.device:
            raise ValueError(f"decode attention kernel: length on "
                             f"{length.device}, the cache on {q.device}")
        lengths, _ = _lengths(length, B, S, q.device)
        lengths = lengths.to(torch.int32).contiguous()
        len_ptr, scalar = lengths.data_ptr(), 0
    else:
        len_ptr, scalar = None, min(max(int(length), 0), S)
    out = torch.empty_like(q)
    fn = build.load("decode_attention").decode_attention
    if not fn.argtypes:  # the library caches its function objects
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 4
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 out.data_ptr(), len_ptr, scalar, B, S, H, KV, D,
                 k_cache.stride(0), k_cache.stride(1), v_cache.stride(0),
                 v_cache.stride(1), D ** -0.5, _DTYPES[q.dtype], stream)
    build.check(err, "decode_attention launch")
    decode_attention.launches += 1
    return out


def decode_attention(q, k_cache, v_cache, length) -> torch.Tensor:
    """One query token per head against a KV cache, ``softmax(q k^T
    D^-1/2 + mask) v`` over the first ``length`` entries (see the module
    docstring): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return _launch(q, k_cache, v_cache, length)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length)
    raise ValueError(f"no decode attention kernel for device {q.device}")


decode_attention.launches = 0
