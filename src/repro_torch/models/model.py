"""Model bundle (port of ``repro.models.model``): a uniform functional API
over the LM architectures this slice runs (the dense decoder-only ones).

``build_model(cfg)`` returns a :class:`ModelBundle` with:

  * ``init(generator) -> params``   (drawn on the bundle's device)
  * ``loss_fn(params, batch) -> (loss, metrics)``
  * ``prefill(params, batch) -> (logits [B, 1, V], cache)``
  * ``decode_step(params, cache, tokens [B, 1], pos) -> (logits [B, 1, V],
    cache)``  (the cache updated in place)
  * ``init_cache(batch_size, cache_len, use_window=None) -> cache``

and ``train_step`` and ``input_specs``, which raise
``NotImplementedError`` until their slice (ROADMAP Queue 1 item 10).  The
batch is ``{"tokens": [B, S], "targets": [B, S]}`` of integer tensors on
the bundle's device.  The reference's ``ParallelContext`` is not ported:
these functions run on one device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from . import lm
from .attention import IMPLS
from .config import ArchConfig


class ModelBundle(NamedTuple):
    cfg: ArchConfig
    init: Callable
    loss_fn: Callable
    train_step: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    input_specs: Callable


def _xent(logits, targets, z_loss: float):
    """Token-mean cross entropy with optional z-loss, in float32."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None])[..., 0]
    loss = (logz - gold).mean()
    if z_loss:
        loss = loss + z_loss * logz.square().mean()
    return loss


def _later(what: str, item: str) -> Callable:
    def missing(*args, **kwargs):
        raise NotImplementedError(f"{what} waits for ROADMAP Queue 1 {item}")
    return missing


def build_model(cfg: ArchConfig, *, attention_impl: str = "ref",
                window_override: Optional[int] = None,
                device="cuda") -> ModelBundle:
    """The bundle of ``cfg`` on ``device``.  ``attention_impl`` is
    ``"ref"`` (chunked PyTorch; ``decode_attention_ref`` in decode),
    ``"plain"`` or ``"kernel"`` (the flash-attention kernel in prefill and
    the decode-attention kernel in decode: CUDA on the card, their plain
    versions on the CPU); ``window_override`` replaces
    ``cfg.sliding_window`` in prefill, decode and the cache."""
    lm.check_supported(cfg)
    if attention_impl not in IMPLS:
        raise ValueError(f"unknown attention_impl {attention_impl!r}; one of "
                         f"{IMPLS}")
    window = (window_override if window_override is not None
              else cfg.sliding_window)

    def init(generator: torch.Generator):
        return lm.init_lm(generator, cfg, device)

    def loss_fn(params, batch):
        out = lm.lm_forward(params, cfg, batch["tokens"],
                            impl=attention_impl)
        loss = _xent(out.logits, batch["targets"], cfg.z_loss) + out.aux_loss
        return loss, {"loss": loss, "aux_loss": out.aux_loss}

    def prefill(params, batch):
        out = lm.lm_forward(params, cfg, batch["tokens"], impl=attention_impl,
                            window=window, collect_cache=True)
        return out.logits[:, -1:], out.cache

    def decode_step(params, cache, tokens, pos):
        return lm.lm_decode_step(params, cfg, cache, tokens, pos,
                                 window=window, impl=attention_impl)

    def init_cache(batch_size: int, cache_len: int,
                   use_window: Optional[int] = None):
        w = use_window if use_window is not None else window
        return lm.init_cache(cfg, batch_size, cache_len, window=w,
                             device=device)

    return ModelBundle(
        cfg=cfg, init=init, loss_fn=loss_fn,
        train_step=_later("train_step (optim/)", "item 10"),
        prefill=prefill,
        decode_step=decode_step, init_cache=init_cache,
        input_specs=_later("input_specs (the dry-run)", "item 10"))
