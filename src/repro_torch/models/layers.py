"""Shared transformer layers (port of ``repro.models.layers``): RMSNorm,
standard rotary embeddings, the SwiGLU FFN, the GQA attention block of the
full-sequence forward (train / prefill) and its one-token decode against a
KV cache.

Parameters are dicts of tensors in the reference's layout: a dense weight
is ``[in, out]`` and applied as ``x @ w``, so the JAX package's weights
carry over as a copy.  Initialisers draw from an explicit
``torch.Generator`` the reference's shapes, scales and types (a float32
normal, scaled, cast to ``param_dtype``); ``lead`` stacks them along leading
axes (the LM's groups), one slice at a time.  M-RoPE waits for the vlm
slice (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .attention import attention, decode_attention
from .config import ArchConfig


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pdtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def normal(gen: torch.Generator, lead: tuple, shape: tuple, scale: float,
           dtype: torch.dtype, device) -> torch.Tensor:
    """``lead + shape`` of ``(N(0, 1) * scale).to(dtype)``, drawn in float32
    one ``shape`` slice at a time (no float32 copy of the whole stack)."""
    out = torch.empty(tuple(lead) + tuple(shape), dtype=dtype, device=device)
    for piece in out.view(-1, *shape):
        piece.copy_(torch.randn(shape, generator=gen, dtype=torch.float32,
                                device=device) * scale)
    return out


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(dim: int, cfg: ArchConfig, lead: tuple = (),
                 device="cuda"):
    return {"scale": torch.ones(tuple(lead) + (dim,), dtype=pdtype_of(cfg),
                                device=device)}


def rmsnorm(params, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device="cuda"):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """Standard RoPE.  x: ``[B, S, H, D]``; positions: ``[S]`` or
    ``[B, S]``.  Computed in float32, cast back to x's type."""
    D = x.shape[-1]
    freqs = rope_frequencies(D, theta, x.device)  # [D/2]
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[..., None] * freqs[None, None, :]  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _no_mrope(cfg: ArchConfig):
    return NotImplementedError(
        f"{cfg.name}: M-RoPE (rope='mrope') waits for the vlm slice "
        f"(ROADMAP Queue 1 item 10)")


def positions_for(cfg: ArchConfig, batch: int, seq: int, offset: int = 0,
                  device="cuda"):
    """The position stream ``[batch, seq]`` for standard RoPE."""
    if cfg.rope == "mrope":
        raise _no_mrope(cfg)
    pos = offset + torch.arange(seq, device=device)
    return pos[None, :].expand(batch, seq)


def _rope_q_or_k(cfg: ArchConfig, x, positions):
    if cfg.rope == "standard":
        return apply_rope(x, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        raise _no_mrope(cfg)
    return x  # "none"


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU)
# ---------------------------------------------------------------------------

def init_dense_ffn(gen, cfg: ArchConfig, lead: tuple = (), device="cuda",
                   d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = pdtype_of(cfg)
    return {"w_gate": normal(gen, lead, (d, f), d ** -0.5, pd, device),
            "w_up": normal(gen, lead, (d, f), d ** -0.5, pd, device),
            "w_down": normal(gen, lead, (f, d), f ** -0.5, pd, device)}


def dense_ffn(params, x):
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

class AttnCache(NamedTuple):
    k: torch.Tensor  # [B, S_cache, KV, D]
    v: torch.Tensor  # [B, S_cache, KV, D]


def init_attention(gen, cfg: ArchConfig, lead: tuple = (), device="cuda"):
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = d ** -0.5
    pd = pdtype_of(cfg)
    params = {"wq": normal(gen, lead, (d, H * hd), s, pd, device),
              "wk": normal(gen, lead, (d, KV * hd), s, pd, device),
              "wv": normal(gen, lead, (d, KV * hd), s, pd, device),
              "wo": normal(gen, lead, (H * hd, d), (H * hd) ** -0.5, pd,
                           device)}
    if cfg.qk_norm:
        params["q_norm"] = init_rmsnorm(hd, cfg, lead, device)
        params["k_norm"] = init_rmsnorm(hd, cfg, lead, device)
    return params


def _project_qkv(params, cfg: ArchConfig, x, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ params["wq"]).reshape(B, S, H, hd)
    k = (x @ params["wk"]).reshape(B, S, KV, hd)
    v = (x @ params["wv"]).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    return _rope_q_or_k(cfg, q, positions), _rope_q_or_k(cfg, k, positions), v


def attention_block(params, cfg: ArchConfig, x, positions, *, causal=True,
                    window=None, impl="ref", return_cache=False):
    """Full-sequence attention (train / prefill): ``(y, AttnCache or
    None)``.  The window is ``window or cfg.sliding_window``, as in the
    reference: a config's sliding window is always in effect."""
    q, k, v = _project_qkv(params, cfg, x, positions)
    if cfg.repeat_kv and cfg.n_kv_heads < cfg.n_heads:
        # GQA -> MHA layout: KV head n becomes heads n*G .. n*G + G-1,
        # which the flattened (kv, g) query heads read
        G = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    out = attention(q, k, v, causal=causal,
                    window=window or cfg.sliding_window, impl=impl)
    B, S = x.shape[:2]
    y = out.reshape(B, S, -1) @ params["wo"]
    return y, (AttnCache(k=k, v=v) if return_cache else None)


def attention_decode(params, cfg: ArchConfig, x, pos: int, cache: AttnCache,
                     *, window=None, impl="ref"):
    """One-token decode against a KV cache: ``(y [B, 1, d], cache)``.

    x is ``[B, 1, d]`` at position ``pos`` (a Python int).  With a sliding
    window the cache is a ring buffer: the write slot is ``pos % S_cache``
    and every entry is valid once ``pos >= S_cache``.  Without one the
    slot is ``pos`` (clamped to the last entry, as the reference's
    ``dynamic_update_slice`` clamps) and the entries up to it are valid.
    The new K/V row is written into the caller's cache in place (the
    reference returns a new cache; a functional copy of every layer's cache
    would cost more than the step), and that cache is returned.
    """
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.hd
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions)
    S_cache = cache.k.shape[1]
    slot = pos % S_cache if window is not None else min(pos, S_cache - 1)
    cache.k[:, slot] = k_new[:, 0]
    cache.v[:, slot] = v_new[:, 0]
    out = decode_attention(q, cache.k, cache.v, min(pos + 1, S_cache),
                           impl=impl)
    y = out.reshape(B, 1, H * hd) @ params["wo"]
    return y, cache
