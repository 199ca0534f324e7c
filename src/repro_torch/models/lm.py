"""Decoder-only language model (port of ``repro.models.lm``): the
full-sequence forward (train / prefill) and the one-token decode step
against a KV cache.

A model is ``embed -> [prelude groups] -> loop over stacked groups -> norm
-> head``, where one *group* is ``cfg.block_pattern`` and the groups'
parameters are stacked along a leading axis, as in the reference; the
reference's ``scan`` over that axis is a Python loop here.  Each pattern
slot is the ``attn`` mixer with a dense FFN (or none), pre-RMSNorm
residuals.  The ``mamba``, ``mlstm`` and ``slstm`` mixers and the MoE FFN
raise ``NotImplementedError`` (ROADMAP Queue 1 item 10).  The decode cache
mirrors the parameters: ``{"prelude": [...], "groups": {"slot<i>":
AttnCache([n_groups, B, L, KV, D] each)}}``, and a decode step writes into
it in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .config import ArchConfig
from .layers import (AttnCache, attention_block, attention_decode,
                     dense_ffn, dtype_of, init_attention, init_dense_ffn,
                     init_rmsnorm, normal, pdtype_of, positions_for,
                     rmsnorm)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` on what of ``cfg`` this slice cannot
    run: another mixer than ``attn``, the MoE FFN, an audio or vlm front
    end."""
    mixers = sorted(set(cfg.block_pattern) - {"attn"})
    if mixers:
        raise NotImplementedError(
            f"{cfg.name}: the {mixers} mixers wait for ROADMAP Queue 1 item "
            f"10 (models/ssm.py)")
    if "moe" in cfg.ffns:
        raise NotImplementedError(
            f"{cfg.name}: the MoE FFN waits for ROADMAP Queue 1 item 10 "
            f"(models/moe.py)")
    if cfg.family in ("audio", "vlm") or cfg.rope == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} front end waits for ROADMAP "
            f"Queue 1 item 10")


def tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and NamedTuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack(trees: list):
    """Stack like-structured trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack(list(xs)) for xs in zip(*trees)))
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(gen, cfg: ArchConfig, slot: int, lead: tuple = (),
               device="cuda"):
    params: dict[str, Any] = {"ln1": init_rmsnorm(cfg.d_model, cfg, lead,
                                                  device),
                              "mixer_attn": init_attention(gen, cfg, lead,
                                                           device)}
    if cfg.ffns[slot] == "dense":
        params["ln2"] = init_rmsnorm(cfg.d_model, cfg, lead, device)
        params["ffn_dense"] = init_dense_ffn(gen, cfg, lead, device)
    return params


def init_group(gen, cfg: ArchConfig, lead: tuple = (), device="cuda"):
    return {f"slot{i}": init_block(gen, cfg, i, lead, device)
            for i in range(cfg.group_size)}


def init_lm(gen: torch.Generator, cfg: ArchConfig, device="cuda"):
    """The reference's parameter tree (``groups`` stacked on axis 0) with
    its shapes, scales and types, drawn from ``gen`` (a generator on
    ``device``)."""
    check_supported(cfg)
    pd = pdtype_of(cfg)
    n_pre = cfg.first_k_dense
    params = {"embed": normal(gen, (), (cfg.vocab, cfg.d_model), 0.02, pd,
                              device),
              "final_norm": init_rmsnorm(cfg.d_model, cfg, (), device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(gen, (), (cfg.d_model, cfg.vocab),
                                   cfg.d_model ** -0.5, pd, device)
    if n_pre:
        params["prelude"] = [init_group(gen, cfg, (), device)
                             for _ in range(n_pre)]
    params["groups"] = init_group(gen, cfg, (cfg.n_groups - n_pre,), device)
    return params


# ---------------------------------------------------------------------------
# block application — full sequence
# ---------------------------------------------------------------------------

def apply_block(bparams, cfg: ArchConfig, slot: int, x, positions, *,
                impl="ref", window=None, collect_cache=False):
    """Returns ``(x, aux_loss, cache_entry)``."""
    h = rmsnorm(bparams["ln1"], x)
    y, cache_entry = attention_block(
        bparams["mixer_attn"], cfg, h, positions, causal=True, window=window,
        impl=impl, return_cache=collect_cache)
    x = x + y
    if "ffn_dense" in bparams:
        x = x + dense_ffn(bparams["ffn_dense"], rmsnorm(bparams["ln2"], x))
    return x, torch.zeros((), dtype=torch.float32, device=x.device), \
        cache_entry


def apply_group(gparams, cfg: ArchConfig, x, positions, *, impl="ref",
                window=None, collect_cache=False):
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = {}
    for i in range(cfg.group_size):
        x, aux, ce = apply_block(gparams[f"slot{i}"], cfg, i, x, positions,
                                 impl=impl, window=window,
                                 collect_cache=collect_cache)
        aux_total = aux_total + aux
        if collect_cache:
            caches[f"slot{i}"] = ce
    return x, aux_total, caches


# ---------------------------------------------------------------------------
# forward — train / prefill
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor
    cache: Any = None


def embed_inputs(params, cfg: ArchConfig, tokens, image_embeds=None):
    """Token embedding in ``cfg.dtype``, with optional stubbed modality
    embeddings prepended."""
    x = params["embed"][tokens].to(dtype_of(cfg))
    if image_embeds is not None:
        x = torch.cat([image_embeds.to(dtype_of(cfg)), x], dim=1)
    return x


def lm_forward(params, cfg: ArchConfig, tokens, image_embeds=None, *,
               impl="ref", window=None, collect_cache=False,
               last_only=False) -> ForwardOut:
    """Logits ``[B, S, V]`` (or ``[B, 1, V]`` with ``last_only``) in
    float32, the auxiliary loss and, with ``collect_cache``, the KV cache
    ``{"prelude": [...], "groups": {"slot<i>": AttnCache([n_groups, B, S,
    KV, D] each)}}``."""
    check_supported(cfg)
    x = embed_inputs(params, cfg, tokens, image_embeds)
    B, S, _ = x.shape
    positions = positions_for(cfg, B, S, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    kw = dict(impl=impl, window=window, collect_cache=collect_cache)

    pre_caches = []
    for g in params.get("prelude", []):
        x, aux, c = apply_group(g, cfg, x, positions, **kw)
        aux_total = aux_total + aux
        pre_caches.append(c)

    groups = params["groups"]
    n_scan = groups["slot0"]["ln1"]["scale"].shape[0]
    caches = []
    for gi in range(n_scan):
        g = tree_map(lambda a: a[gi], groups)
        x, aux, c = apply_group(g, cfg, x, positions, **kw)
        aux_total = aux_total + aux
        caches.append(c)
    x = rmsnorm(params["final_norm"], x)
    if last_only or (collect_cache and cfg.prefill_last_only):
        x = x[:, -1:]  # prefill only needs the next-token distribution
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).to(torch.float32)
    cache = None
    if collect_cache:
        cache = {"prelude": pre_caches,
                 "groups": _stack(caches) if caches else None}
    return ForwardOut(logits=logits, aux_loss=aux_total, cache=cache)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_block_cache(cfg: ArchConfig, slot: int, batch: int, cache_len: int,
                     window: Optional[int], dtype, lead: tuple = (),
                     device="cuda") -> AttnCache:
    """The zero cache of one ``attn`` slot, ``lead + [batch, L, KV, D]``:
    ``L = min(window, cache_len)`` (a ring) with a window, else
    ``cache_len``."""
    L = min(window, cache_len) if window else cache_len
    shape = tuple(lead) + (batch, L, cfg.n_kv_heads, cfg.hd)
    return AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               window: Optional[int] = None, dtype=None, device="cuda"):
    """The zero decode cache, in ``cfg.dtype`` unless ``dtype`` is given;
    the groups' entries stacked along a leading axis, as the reference's
    (which stacks one group when there are none or one to scan)."""
    check_supported(cfg)
    dtype = dtype or dtype_of(cfg)

    def one_group(lead=()):
        return {f"slot{i}": init_block_cache(cfg, i, batch, cache_len, window,
                                             dtype, lead, device)
                for i in range(cfg.group_size)}

    n_pre = cfg.first_k_dense
    n_scan = cfg.n_groups - n_pre
    return {"prelude": [one_group() for _ in range(n_pre)],
            "groups": one_group((max(n_scan, 1),))}


def decode_block(bparams, cfg: ArchConfig, x, pos: int, cache_entry, *,
                 window=None, impl="ref"):
    """One block's decode step: returns x; ``cache_entry`` is updated in
    place."""
    h = rmsnorm(bparams["ln1"], x)
    y, _ = attention_decode(bparams["mixer_attn"], cfg, h, pos, cache_entry,
                            window=window, impl=impl)
    x = x + y
    if "ffn_dense" in bparams:
        x = x + dense_ffn(bparams["ffn_dense"], rmsnorm(bparams["ln2"], x))
    return x


def decode_group(gparams, cfg: ArchConfig, x, pos: int, gcache, *,
                 window=None, impl="ref"):
    for i in range(cfg.group_size):
        x = decode_block(gparams[f"slot{i}"], cfg, x, pos,
                         gcache[f"slot{i}"], window=window, impl=impl)
    return x


def lm_decode_step(params, cfg: ArchConfig, cache, tokens, pos, *,
                   window=None, impl="ref"):
    """One decode step.  tokens: ``[B, 1]``; pos: the position (a Python
    int, or a 0-d tensor read once on the host).  Returns ``(logits [B, 1,
    V] in float32, cache)``: the caller's cache, updated in place."""
    check_supported(cfg)
    pos = int(pos)
    x = params["embed"][tokens].to(dtype_of(cfg))
    kw = dict(window=window, impl=impl)
    for g, c in zip(params.get("prelude", []), cache["prelude"]):
        x = decode_group(g, cfg, x, pos, c, **kw)
    groups, gcache = params["groups"], cache["groups"]
    for gi in range(groups["slot0"]["ln1"]["scale"].shape[0]):
        x = decode_group(tree_map(lambda a: a[gi], groups), cfg, x, pos,
                         tree_map(lambda a: a[gi], gcache), **kw)
    x = rmsnorm(params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).to(torch.float32), cache
