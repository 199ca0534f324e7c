"""Decode attention for the LM's one-token step (port of
``repro.kernels.decode_attention``): one query token of each head against
a KV cache with a valid length, GQA, an online softmax in float32.

Replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py::decode_attention_pallas`` (body
``_decode_kernel``) with the hand-written CUDA kernels of
``csrc/decode_attention.cu``, one CTA per (batch, KV head) and part of the
cache, a loop inside it over 64-row cache tiles that stops at the last
valid entry.  It is bound by bytes: the valid cache rows, read once.

  * bfloat16 (``decode_mma_kernel``): a producer thread keeps a ring of
    bf16 K and V tiles in shared memory full by TMA, read in place through
    the caches' batch and row strides; consumer warps compute ``q k^T``
    and ``p v`` with ``mma.sync`` on the tensor cores (the KV head's G
    query rows padded to 16), each over its own slice of every tile's
    keys, with its own running max, sum and accumulator, merged once at
    the end.  When ``B * KV`` would leave half the SMs idle the cache is
    split: :func:`split_plan` cuts each (batch, KV head)'s tiles into
    parts over as many CTAs, each writes its float32 ``(acc, m, l)`` to a
    workspace, and ``decode_combine_kernel`` merges them in split
    order.
  * float32 (``decode_kernel``): the G query heads resident in shared
    memory as float32, the next K and V tiles loaded 16 bytes a thread
    while the current one is computed, scores and sums by warp reductions
    on the FFMA units (the ``2e-5`` bound rules out TF32).

The scores are ``(q.f32 * D^-1/2) . k.f32`` as the TPU kernel and
``decode_attention_ref`` compute them (the bf16 kernel scales the float32
product instead: a few float32 ulps).  Entries at or past ``length[b]``
are masked with ``-1e30`` and never reach the output, whatever the cache
holds there; the output is ``acc / max(l, 1e-30)`` in q's type, so
``length = 0`` gives 0 (the TPU kernel's value there, a uniform mean over
its padded tiles, is not kept).  A length above S counts as S.

Entry points:

  * :func:`decode_attention` — q ``[B, 1, H, D]``, caches ``[B, S, KV,
    D]`` (float32 or bfloat16), ``length`` a Python int or an integer
    tensor ``[B]`` (or a 0-d one) on the cache's device; returns ``[B, 1,
    H, D]`` in q's type.  Launches the CUDA kernels for CUDA tensors (D =
    64 or 128, ``(H / KV) * D <= 6144``, q contiguous, each cache row's
    ``[KV, D]`` dense and 16-byte aligned; anything else raises) and runs
    :func:`decode_attention_plain` for CPU tensors only.
    ``decode_attention.launches`` counts calls of the kernel route (one
    each), ``decode_attention.combine_launches`` the combine's launches.
  * :func:`decode_attention_plain` — the same blocked online softmax in
    PyTorch, 64-row tiles: :func:`decode_attention_partials_plain` with
    one part, then :func:`decode_attention_combine_plain`.
  * :func:`split_plan` — how many parts the bf16 kernel cuts the cache
    into, and how many tiles each part takes.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NEG_INF = -1e30
BLOCK_S = 64  # cache rows per tile, as the CUDA kernels' tiles
MAX_GD = 6144  # (H / KV) * D: the float32 kernel's shared accumulator
_HEAD_DIMS = (64, 128)
# the bf16 kernel's ring holds up to RING_BYTES of K and V tiles (2 stages
# at D = 128, 4 at D = 64), and a part of a split cache at least
# MIN_PART_TILES tiles (both chosen by timing on an H100; see PERF.md)
RING_BYTES = 64 * 1024
MIN_PART_TILES = 4


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


def split_plan(B: int, KV: int, S: int, length: int,
               sm_count: int) -> tuple[int, int]:
    """``(parts, tiles_per_part)`` for the bf16 kernel: each (batch, KV
    head)'s 64-row tiles of the first ``length`` entries (``S`` for a
    tensor of lengths, so that no host sync is needed) cut into ``parts``
    contiguous ranges of ``tiles_per_part``, one CTA each.  The cache is
    split only when ``B * KV`` CTAs would leave at least half the SMs
    idle: into as many parts as fill the SMs once, each of at least
    ``MIN_PART_TILES`` tiles (so at most one part per tile).  At one CTA
    an SM or more, a split measured slower: the combine's launch costs more
    than the shorter ranges save."""
    tiles = -(-min(max(int(length), 0), S) // BLOCK_S)
    parts = min(sm_count // (B * KV), tiles // MIN_PART_TILES)
    if parts <= 1:
        return 1, max(tiles, 1)
    per = -(-tiles // parts)
    return -(-tiles // per), per


def decode_attention_partials_plain(q, k_cache, v_cache, length,
                                    parts: int, tiles_per_part: int):
    """The split kernel's first pass in PyTorch: part ``p`` runs the online
    softmax over tiles ``[p * tiles_per_part, (p + 1) * tiles_per_part)``
    and stops, as the kernel does, at the last tile holding a valid entry
    of each batch row.  Returns float32 ``(acc [parts, B, H, D], m [parts,
    B, H], l [parts, B, H])``, the kernel's workspace layout (a part with
    no tile to visit: 0, -1e30, 0).  Cache rows at or past a length never
    reach the result: their scores are masked by a select and their values
    zeroed."""
    B, S, H, KV, D = _shapes(q, k_cache, v_cache)
    G = H // KV
    dev = q.device
    lengths, n = _lengths(length, B, S, dev)
    qf = q.to(torch.float32).reshape(B, KV, G, D) * D ** -0.5
    accs, ms, ls = [], [], []
    for p in range(parts):
        m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=dev)
        first = p * tiles_per_part * BLOCK_S
        last = min((p + 1) * tiles_per_part * BLOCK_S, n)
        for s0 in range(first, last, BLOCK_S):
            kb = k_cache[:, s0:s0 + BLOCK_S].to(torch.float32)
            vb = v_cache[:, s0:s0 + BLOCK_S].to(torch.float32)
            pos = torch.arange(s0, s0 + kb.shape[1], device=dev)
            valid = pos[None, :] < lengths[:, None]  # [B, tile]
            vb = torch.where(valid[:, :, None, None], vb, 0.0)
            s = torch.einsum("bngd,bknd->bngk", qf, kb)
            s = torch.where(valid[:, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            pr = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            visit = (s0 < lengths)[:, None, None]  # the row's tile is read
            l = torch.where(visit, l * corr + pr.sum(dim=-1), l)
            acc = torch.where(visit[..., None], acc * corr[..., None]
                              + torch.einsum("bngk,bknd->bngd", pr, vb), acc)
            m = torch.where(visit, m_new, m)
        accs.append(acc.reshape(B, H, D))
        ms.append(m.reshape(B, H))
        ls.append(l.reshape(B, H))
    return torch.stack(accs), torch.stack(ms), torch.stack(ls)


def decode_attention_combine_plain(acc, m, l, dtype) -> torch.Tensor:
    """The split kernel's second pass in PyTorch: the parts of
    :func:`decode_attention_partials_plain` merged, ``sum_p acc_p w_p /
    max(sum_p l_p w_p, 1e-30)`` with ``w_p = exp(m_p - max_p m_p)``, as
    ``[B, 1, H, D]`` in ``dtype``."""
    w = torch.exp(m - m.amax(dim=0))
    out = ((acc * w[..., None]).sum(dim=0)
           / torch.clamp_min((l * w).sum(dim=0), 1e-30)[..., None])
    return out[:, None].to(dtype)


def decode_attention_plain(q, k_cache, v_cache, length) -> torch.Tensor:
    """The kernel's blocked online softmax in PyTorch (see the module
    docstring), in one part: what CPU tensors run."""
    S = _shapes(q, k_cache, v_cache)[1]
    acc, m, l = decode_attention_partials_plain(
        q, k_cache, v_cache, length, 1, max(-(-S // BLOCK_S), 1))
    return decode_attention_combine_plain(acc, m, l, q.dtype)


_sm_counts: dict[int, int] = {}


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def _c_function(name: str, argtypes):
    fn = getattr(build.load("decode_attention"), name)
    if not fn.argtypes:  # the library caches its function objects
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_F32_ARGS = ([_P] * 5 + [_I] * 6 + [_L] * 4 + [ctypes.c_float, _P])
_BF16_ARGS = ([_P] * 6 + [_I] * 6 + [_L] * 4
              + [ctypes.c_float, _I, _I, _I, _P])
_COMBINE_ARGS = [_P, _P, _I, _I, _I, _I, _P]


def _launch(q, k_cache, v_cache, length, plan=None):
    """The CUDA route; ``plan`` overrides :func:`split_plan` (bf16)."""
    B, S, H, KV, D = _shapes(q, k_cache, v_cache)
    if q.dtype not in (torch.float32, torch.bfloat16):
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
        len_ptr, scalar, span = lengths.data_ptr(), 0, S
    else:
        len_ptr, scalar = None, min(max(int(length), 0), S)
        span = scalar
    out = torch.empty_like(q)
    strides = (k_cache.stride(0), k_cache.stride(1), v_cache.stride(0),
               v_cache.stride(1))
    ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            out.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if q.dtype == torch.float32:
            err = _c_function("decode_attention_f32", _F32_ARGS)(
                *ptrs, len_ptr, scalar, B, S, H, KV, D, *strides, D ** -0.5,
                stream)
            build.check(err, "decode_attention launch")
            build.count(decode_attention)
            return out
        parts, per = plan or split_plan(B, KV, S, span, _sm_count(q.device))
        ws = (torch.empty(parts * B * H * (D + 2), dtype=torch.float32,
                          device=q.device) if parts > 1 else None)
        stages = max(1, min(per, RING_BYTES // (2 * BLOCK_S * D * 2)))
        err = _c_function("decode_attention_bf16", _BF16_ARGS)(
            *ptrs, None if ws is None else ws.data_ptr(), len_ptr, scalar, B,
            S, H, KV, D, *strides, D ** -0.5, parts, per, stages, stream)
        build.check(err, "decode_attention launch")
        build.count(decode_attention)
        if parts > 1:
            err = _c_function("decode_attention_combine", _COMBINE_ARGS)(
                ws.data_ptr(), out.data_ptr(), parts, B, H, D, stream)
            build.check(err, "decode_attention combine launch")
            build.count(decode_attention, "combine_launches")
    return out


def decode_attention(q, k_cache, v_cache, length) -> torch.Tensor:
    """One query token per head against a KV cache, ``softmax(q k^T
    D^-1/2 + mask) v`` over the first ``length`` entries (see the module
    docstring): the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors."""
    if q.is_cuda:
        return _launch(q, k_cache, v_cache, length)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length)
    raise ValueError(f"no decode attention kernel for device {q.device}")


decode_attention.launches = 0
decode_attention.combine_launches = 0
