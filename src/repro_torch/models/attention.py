"""Attention implementations (port of ``repro.models.attention``).

``flash_attention_ref`` is a chunked online-softmax attention in plain
PyTorch (a loop over KV blocks): O(S * block) memory, so long prefills run
without materialising S x S score matrices.  ``plain_attention_ref`` is the
naive O(S^2) oracle for small shapes, and ``decode_attention_ref`` the
single-token cache attention.

All take q ``[B, Sq, H, D]`` and k, v ``[B, Sk, KV, D]``, with GQA (query
head ``h = kv * G + g`` reads KV head ``kv``), causal masks and sliding
windows, and return q's type.  :func:`attention` dispatches between them
and the hand-written flash-attention kernel (``impl="kernel"``), and
:func:`decode_attention` between ``decode_attention_ref`` and the
hand-written decode-attention kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels import decode_attention as kda
from ..kernels.flash_attention import flash_attention

NEG = -1e30
IMPLS = ("ref", "plain", "kernel")


def _mask_bias(q_pos, k_pos, causal: bool, window: Optional[int]):
    """[q, k] additive bias implementing causal / sliding-window masks."""
    ok = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= k_pos[None, :] > q_pos[:, None] - window
    return torch.where(ok, 0.0, NEG)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, block_k: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """Chunked online-softmax attention; returns ``[B, Sq, H, D]``.  q is
    scaled in its own type and then upcast, as the reference does."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    # the reference's weakly typed scale takes q's type before the multiply
    scale = torch.tensor(D ** -0.5, dtype=q.dtype, device=dev)
    qf = (q * scale).to(torch.float32).reshape(B, Sq, KV, G, D)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, KV, G), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, D), dtype=torch.float32, device=dev)
    n_blocks = -(-Sk // block_k)
    pad = n_blocks * block_k - Sk
    kf = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).to(torch.float32)
    vf = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).to(torch.float32)
    for start in range(0, n_blocks * block_k, block_k):
        kb, vb = kf[:, start:start + block_k], vf[:, start:start + block_k]
        k_pos = start + torch.arange(block_k, device=dev)
        bias = _mask_bias(q_pos, k_pos, causal, window)
        bias = torch.where(k_pos[None, :] < Sk, bias, NEG)  # padding mask
        s = torch.einsum("bqngd,bknd->bqngk", qf, kb)
        s = s + bias[None, :, None, None, :]
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqngk,bknd->bqngd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, H, D).to(q.dtype)


def plain_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Naive O(S^2)-memory attention — the oracle for small shapes."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qf = q.to(torch.float32).reshape(B, Sq, KV, G, D) * D ** -0.5
    s = torch.einsum("bqngd,bknd->bqngk", qf, k.to(torch.float32))
    dev = q.device
    bias = _mask_bias(q_offset + torch.arange(Sq, device=dev),
                      torch.arange(k.shape[1], device=dev), causal, window)
    s = s + bias[None, :, None, None, :]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqngk,bknd->bqngd", p, v.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, length) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffered) KV cache:
    q ``[B, 1, H, D]``, caches ``[B, S, KV, D]``, ``length`` (a number or
    ``[B]``) the valid entries; returns ``[B, 1, H, D]``."""
    B, _, H, D = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    qf = q.to(torch.float32).reshape(B, KV, G, D) * D ** -0.5
    s = torch.einsum("bngd,bknd->bngk", qf, k_cache.to(torch.float32))
    dev = q.device
    lengths = torch.as_tensor(length, device=dev).reshape(-1, 1)
    valid = torch.arange(S, device=dev)[None, :] < lengths.expand(B, S)
    s = torch.where(valid[:, None, None, :], s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngk,bknd->bngd", p, v_cache.to(torch.float32))
    return out.reshape(B, 1, H, D).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              impl: str = "ref", q_offset: int = 0, block_k: int = 1024):
    """Dispatch between the chunked reference (``"ref"``), the naive one
    (``"plain"``) and the flash-attention kernel (``"kernel"``, the port's
    counterpart of the reference's ``"pallas"``).  The kernel route takes
    no ``block_k`` (its tiles are fixed) and raises on a nonzero
    ``q_offset``, which the reference's kernel route would drop."""
    if impl == "kernel":
        if q_offset:
            raise ValueError(f"impl='kernel' takes no q_offset (got "
                             f"{q_offset}): the kernel's queries start at "
                             f"position 0")
        return flash_attention(q, k, v, causal=causal, window=window)
    if impl == "plain":
        return plain_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset)
    if impl == "ref":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, block_k=block_k)
    raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")


def decode_attention(q, k_cache, v_cache, length, *, impl: str = "ref"):
    """Dispatch one-token cache attention: ``"kernel"`` to the
    decode-attention kernel (CUDA on the card, its plain version on the
    CPU), ``"ref"`` and ``"plain"`` to :func:`decode_attention_ref`, which
    the reference's decode always calls."""
    if impl == "kernel":
        return kda.decode_attention(q, k_cache, v_cache, length)
    if impl in ("ref", "plain"):
        return decode_attention_ref(q, k_cache, v_cache, length)
    raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
