"""Flash attention for the LM's full-sequence forward (port of
``repro.kernels.flash_attention``): GQA, causal and sliding-window masks,
an online softmax in float32.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention_pallas`` (body
``_flash_kernel``) with the hand-written CUDA source
``csrc/flash_attention.cu``, which has one kernel per type:

  * bfloat16 (``flash_wgmma_kernel``): a persistent CTA of three
    warpgroups per SM walks the (batch x head, 128-query tile) items,
    heaviest first.  A producer thread copies an item's q and each
    128-key K/V tile by TMA into a ring of 3 shared-memory stages
    fenced by ``mbarrier`` barriers; two consumer warpgroups of 64 query
    rows compute ``q k^T`` with ``wgmma`` from shared memory, the online
    softmax in float32 on the accumulator fragment (the scale on the
    float32 scores, ``exp2`` with ``log2 e`` folded in), and ``p v`` with
    ``wgmma`` taking p rounded to bfloat16 from registers (``l`` sums the
    float32 p).  A tile's scores are issued with the previous tile's
    ``p v``, and the two warpgroups take turns on the tensor cores.  TMA
    needs q, k, v and the output 16-byte aligned.
  * float32 (``flash_kernel``): one CTA per (batch x head, 64-query tile),
    a loop over 64-key tiles, q and the K/V tiles staged in shared memory,
    a 4 x 4 register tile of scores and a 4 x D/16 tile of the accumulator
    per thread, float32 FFMA and the precise ``expf`` throughout (the
    ``2e-5`` bound rules out TF32 and bf16 tensor cores).

Head ``h`` reads KV head ``h // G`` in place (no repeated K/V).  The
function is bound by operations (a causal call at B = 2, S = 2048, H = 32,
D = 128 does 68.7 GFLOP: 0.0695 ms at the card's bf16 tensor-core peak,
against 0.025 ms for its bytes).

The masking constant is the TPU kernel's ``-1e30``, not ``-inf``: a row
that meets a fully masked tile before its first valid key gathers finite
garbage that the first valid key wipes (``exp(-1e30 - m) = 0``); with
``-inf`` it would be ``exp(-inf + inf) = NaN``.  A row with no valid key at
all comes out 0 in both versions here (the TPU kernel's value there
depends on its block size).

Entry points:

  * :func:`flash_attention` — q ``[B, Sq, H, D]``, k and v ``[B, Sk, KV,
    D]`` (float32 or bfloat16), ``causal``, ``window`` (``None`` or >= 1);
    returns ``[B, Sq, H, D]`` in q's type.  Launches the CUDA kernel of
    q's type for CUDA tensors (D = 64 or 128, contiguous, bfloat16 16-byte
    aligned; anything else raises) and runs :func:`flash_attention_plain`
    for CPU tensors only.
    ``flash_attention.launches`` counts kernel launches.
  * :func:`flash_attention_plain` — the float32 kernel's blocked online
    softmax in PyTorch: q upcast and then scaled (the TPU kernel's order),
    64-key tiles, ``-1e30`` masking, ``acc / max(l, 1e-30)``; the bfloat16
    kernel differs from it only by rounding (p in bf16 for ``p v``, the
    scale on the scores), inside the ``2e-2`` bound.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build

NEG_INF = -1e30
BLOCK_K = 64  # keys per tile, as the float32 CUDA kernel's BK
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _shapes(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected q [B, Sq, H, D], k/v [B, Sk, KV, D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    Sk, KV = k.shape[1], k.shape[2]
    if Sk < 1 or KV < 1 or H % KV:
        raise ValueError(f"{H} query heads over {KV} KV heads and {Sk} keys")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v types {q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    return B, Sq, Sk, H, KV, D


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None) -> torch.Tensor:
    """The kernel's blocked online softmax in PyTorch (see the module
    docstring): what CPU tensors run."""
    B, Sq, Sk, H, KV, D = _shapes(q, k, v, window)
    G = H // KV
    scale = D ** -0.5
    qf = (q.to(torch.float32) * scale).reshape(B, Sq, KV, G, D)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dev = q.device
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=torch.float32, device=dev)
    q_pos = torch.arange(Sq, device=dev)[:, None]
    for k0 in range(0, Sk, BLOCK_K):
        kb, vb = kf[:, k0:k0 + BLOCK_K], vf[:, k0:k0 + BLOCK_K]
        k_pos = torch.arange(k0, k0 + kb.shape[1], device=dev)[None, :]
        ok = torch.ones((Sq, kb.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            ok &= k_pos <= q_pos
        if window is not None:
            ok &= k_pos > q_pos - window
        s = torch.einsum("bqngd,bknd->bqngk", qf, kb)
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqngk,bknd->bqngd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = torch.where((m == NEG_INF)[..., None], 0.0, out)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def _launch(q, k, v, causal, window):
    B, Sq, Sk, H, KV, D = _shapes(q, k, v, window)
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash attention kernel: {q.dtype} is not float32 "
                         f"or bfloat16")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {D} not in "
                         f"{_HEAD_DIMS}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash attention kernel: q, k, v on different "
                         "devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention kernel: q, k, v must be contiguous")
    out = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and any(
            x.data_ptr() % 16 for x in (q, k, v, out)):
        raise ValueError("flash attention kernel: bfloat16 q, k, v must be "
                         "16-byte aligned (TMA)")
    fn = build.load("flash_attention").flash_attention
    if not fn.argtypes:  # the library caches its function objects
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Sk, H, KV, D, int(causal),
                 0 if window is None else int(window), D ** -0.5,
                 _DTYPES[q.dtype], stream)
    build.check(err, "flash_attention launch")
    build.count(flash_attention)
    return out


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """GQA attention ``softmax(q k^T D^-1/2 + mask) v`` (see the module
    docstring): the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return _launch(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash attention kernel for device {q.device}")


flash_attention.launches = 0
