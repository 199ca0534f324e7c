"""Serving example of the PyTorch port: batched prompt stepping + greedy
decode for a dense architecture (port of ``examples/serve_decode.py``).

Uses reduced configs; decode attention runs the hand-written decode kernel
on the card (``--device cuda``, the default) and its plain PyTorch version
on the CPU.

Run:  PYTHONPATH=src python examples/serve_decode_torch.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    dev = torch.device(args.device)
    cfg = get_config(args.arch).reduced(vocab=512)
    bundle = build_model(cfg, attention_impl="kernel", device=dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    B, P, N = args.batch, args.prompt_len, args.new_tokens
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (B, P)), device=dev)

    gen = generate(bundle, params, prompts, N)
    seqs = gen.tokens.cpu().numpy()
    print(f"{cfg.name} ({cfg.family}): "
          f"{B * (N - 1) / max(gen.decode_s, 1e-9):.1f} tok/s "
          f"(reduced config, {dev.type})")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {seqs[b].tolist()}")


if __name__ == "__main__":
    main()
