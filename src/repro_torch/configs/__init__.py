"""Architecture registry of the port: ``get_config(arch_id)`` (port of
``repro.configs``).

The four dense decoder-only archs are ported; the other six raise
``NotImplementedError`` until their mixers, FFNs and front ends are
(ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen3-8b", "xlstm-350m", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
    "llama3-405b", "internlm2-1.8b", "qwen2-vl-2b", "whisper-medium",
    "granite-34b", "jamba-v0.1-52b",
]
DENSE_ARCHS = ["qwen3-8b", "llama3-405b", "internlm2-1.8b", "granite-34b"]


def get_config(arch_id: str):
    if arch_id not in ARCHS:
        raise ValueError(f"unknown arch {arch_id!r}; known: {ARCHS}")
    if arch_id not in DENSE_ARCHS:
        raise NotImplementedError(
            f"{arch_id}: only the dense archs {DENSE_ARCHS} are ported; the "
            f"rest wait for ROADMAP Queue 1 item 10 (moe, ssm, vlm, audio)")
    mod = importlib.import_module(
        f"{__name__}.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.CONFIG
