"""Batched decode serving (port of ``repro.launch.serve``): a batch
of prompts is stepped through ``decode_step`` one token at a time (the
reference's launcher does not call ``prefill``), then decoded greedily.

CPU-sized by default (``--preset tiny``); on the card (``--device cuda``,
the default) decode attention runs the hand-written decode kernel
(``attention_impl="kernel"``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --preset full --batch 16 --prompt-len 256 --new-tokens 64
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import numpy as np
import torch


class Generation(NamedTuple):
    tokens: torch.Tensor  # [B, N]: the greedy continuation (or ``forced``)
    prompt_logits: torch.Tensor  # [B, V]: after the prompt's last token
    step_logits: Optional[torch.Tensor]  # [B, P + N - 1, V], if kept
    prefill_s: float  # the prompt's P steps
    decode_s: float  # the N - 1 generating steps
    cache: dict  # the decode cache after the last step


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def generate(bundle, params, prompts, new_tokens: int, *, forced=None,
             keep_logits: bool = False) -> Generation:
    """Step ``prompts`` (``[B, P]`` integer tokens on the bundle's device)
    through ``bundle.decode_step`` into a cache of ``P + new_tokens``
    entries, then generate ``new_tokens`` tokens by ``argmax``.  With
    ``forced`` (``[B, new_tokens]``) those tokens are fed instead of the
    argmax (teacher forcing).  With ``keep_logits`` every step's logits are
    returned.  Each phase's time ends in a device synchronisation."""
    B, P = prompts.shape
    N = new_tokens
    if N < 1:
        raise ValueError(f"new_tokens must be >= 1, got {N}")
    if forced is not None and tuple(forced.shape) != (B, N):
        raise ValueError(f"forced tokens {tuple(forced.shape)}, expected "
                         f"{(B, N)}")
    dev = prompts.device
    cache = bundle.init_cache(B, P + N)
    kept = None

    def step(cache, toks, t):
        nonlocal kept
        logits, cache = bundle.decode_step(params, cache, toks, t)
        if keep_logits:
            if kept is None:
                kept = logits.new_empty((B, P + N - 1, logits.shape[-1]))
            kept[:, t] = logits[:, 0]
        return logits[:, -1], cache

    _sync(dev)
    t0 = time.perf_counter()
    for t in range(P):
        logits, cache = step(cache, prompts[:, t:t + 1], t)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    prompt_logits = logits

    def pick(logits, i):
        if forced is not None:
            return forced[:, i:i + 1]
        return logits.argmax(dim=-1)[:, None]

    toks = pick(logits, 0)
    out = [toks]
    t0 = time.perf_counter()
    for t in range(P, P + N - 1):
        logits, cache = step(cache, toks, t)
        toks = pick(logits, t - P + 1)
        out.append(toks)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return Generation(tokens=torch.cat(out, dim=1),
                      prompt_logits=prompt_logits,
                      step_logits=kept,
                      prefill_s=prefill_s, decode_s=decode_s, cache=cache)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config
    from ..models import build_model

    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = cfg.reduced(vocab=512, n_layers=2 * cfg.group_size)
    dev = torch.device(args.device)
    bundle = build_model(cfg, attention_impl="kernel", device=dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    B, P, N = args.batch, args.prompt_len, args.new_tokens
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)), device=dev)

    gen = generate(bundle, params, prompts, N)
    seqs = gen.tokens.cpu().numpy()
    print(f"[serve] {cfg.name}: batch={B} prompt={P} new={N}")
    print(f"  prefill {gen.prefill_s:.2f}s | decode {gen.decode_s:.2f}s "
          f"({B * (N - 1) / max(gen.decode_s, 1e-9):.1f} tok/s)")
    print(f"  sample continuation: {seqs[0, :16].tolist()}")
    return gen


if __name__ == "__main__":
    main()
