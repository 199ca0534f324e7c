"""Architecture configuration schema for the LM scaffold (port of
``repro.models.config``; data only, the port's own copy).

Every architecture is an ``ArchConfig``; repeated layer structure is grouped
into a *block pattern* (one group = ``block_pattern`` layers), so parameters
stack along a leading ``n_groups`` axis and the forward pass is a loop over
that axis.  ``reduced()`` gives the small same-family variant the CPU tests
use.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int
    num_shared: int = 0          # shared (always-on) experts
    shared_ff: int = 0           # hidden dim of the shared-expert FFN
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-4
    gather_output: bool = False  # explicit bf16 all-gather at EP exit (§Perf)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | ssm | moe | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    citation: str = ""

    # attention details
    head_dim: Optional[int] = None     # default: d_model // n_heads
    qk_norm: bool = False
    rope: str = "standard"             # standard | mrope | none
    rope_theta: float = 1e6
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # of head_dim/2
    sliding_window: Optional[int] = None  # SWA variant for long_500k (dense archs)

    # layer pattern: one group = these layers, repeated n_layers/len(pattern) times
    block_pattern: Tuple[str, ...] = ("attn",)     # attn | mamba | mlstm | slstm
    ffn_pattern: Optional[Tuple[str, ...]] = None  # dense | moe | none (per slot)
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0            # leading groups forced dense-FFN (kimi)

    # ssm details
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # frontends (stubs per spec)
    num_image_tokens: int = 0         # vlm: precomputed patch embeddings
    encoder_layers: int = 0           # audio: transformer encoder depth
    encoder_frames: int = 0           # audio: precomputed frame embeddings

    # training details
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    scan_layers: bool = True   # the reference's scan/unroll switch; the
                               # port always loops over the groups
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    z_loss: float = 1e-4
    remat: bool = True
    remat_policy: str = "full"     # full | dots (save matmul outputs)
    prefill_last_only: bool = False  # lm_head on last token only in prefill
    microbatches: int = 1          # gradient accumulation chunks per step
    seq_parallel: bool = False     # keep residual stream seq-sharded over
                                   # 'model' between blocks (SP; §Perf)
    repeat_kv: bool = False        # materialize GQA kv -> H heads so the
                                   # head dim shards over 'model' even when
                                   # n_kv_heads < model-axis size (§Perf)
    tie_embeddings: bool = False

    def __post_init__(self):
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}")
        if self.ffn_pattern is not None:
            assert len(self.ffn_pattern) == len(self.block_pattern)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def group_size(self) -> int:
        return len(self.block_pattern)

    @property
    def n_groups(self) -> int:
        return self.n_layers // self.group_size

    @property
    def ffns(self) -> Tuple[str, ...]:
        if self.ffn_pattern is not None:
            return self.ffn_pattern
        default = "moe" if self.moe is not None else "dense"
        # ssm blocks carry their own projections; no external FFN by default
        return tuple(default if b == "attn" else ("dense" if self.d_ff > 0 else "none")
                     for b in self.block_pattern)

    def reduced(self, **overrides) -> "ArchConfig":
        """A small same-family variant for CPU smoke tests (<=2 groups,
        d_model <= 512, <= 4 experts)."""
        changes = dict(
            n_layers=min(self.n_layers, 2 * self.group_size),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=64,
            mrope_sections=(8, 12, 12),  # scaled to head_dim 64
            encoder_layers=min(self.encoder_layers, 2),
            encoder_frames=min(self.encoder_frames, 32) if self.encoder_frames else 0,
            num_image_tokens=min(self.num_image_tokens, 16) if self.num_image_tokens else 0,
            dtype="float32",
            param_dtype="float32",
            mamba_d_state=8,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=2, expert_ff=128,
                num_shared=min(self.moe.num_shared, 1), shared_ff=128,
                capacity_factor=2.0)
        if self.n_kv_heads == self.n_heads:
            changes["n_kv_heads"] = changes["n_heads"]
        if self.n_kv_heads == 1:
            changes["n_kv_heads"] = 1
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
