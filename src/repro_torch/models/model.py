"""Model bundle (port of ``repro.models.model``): a uniform functional API
over the LM architectures this slice runs (the dense decoder-only ones).

``build_model(cfg)`` returns a :class:`ModelBundle` with:

  * ``init(generator) -> params``   (drawn on the bundle's device)
  * ``loss_fn(params, batch) -> (loss, metrics)``
  * ``prefill(params, batch) -> (logits [B, 1, V], cache)``

and ``train_step``, ``decode_step``, ``init_cache`` and ``input_specs``,
which raise ``NotImplementedError`` until their slices (ROADMAP Queue 1
items 2 and 10).  The batch is ``{"tokens": [B, S], "targets": [B, S]}``
of integer tensors on the bundle's device.  The reference's
``ParallelContext`` is not ported: these functions run on one device.
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
    ``"ref"`` (chunked PyTorch), ``"plain"`` or ``"kernel"`` (the
    flash-attention kernel: CUDA on the card, its plain version on the
    CPU); ``window_override`` replaces ``cfg.sliding_window`` in prefill."""
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

    return ModelBundle(
        cfg=cfg, init=init, loss_fn=loss_fn,
        train_step=_later("train_step (optim/)", "item 10"),
        prefill=prefill,
        decode_step=_later("decode_step", "item 2"),
        init_cache=_later("init_cache", "item 2"),
        input_specs=_later("input_specs (the dry-run)", "item 10"))
