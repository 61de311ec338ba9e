"""Configuration schema (port of ``repro/configs/base.py``): the
``ModelConfig`` and ``ShapeConfig`` fields and the ``reduced`` smoke
sizing, unchanged, so a config built here equals the reference's field
for field."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture. Layer kinds: 'attn', 'mamba', 'rwkv';
    layer_pattern is tiled to n_layers."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    n_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25

    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    mlp_activation: str = "swiglu"  # swiglu | relu2 | gelu
    layer_pattern: Tuple[str, ...] = ("attn",)

    d_state: int = 16
    d_conv: int = 4
    ssm_expand: int = 2

    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64

    frontend: str = "none"
    n_patches: int = 0

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        reps = -(-self.n_layers // len(self.layer_pattern))
        return (self.layer_pattern * reps)[: self.n_layers]

    @property
    def superlayer(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_superlayers(self) -> int:
        if self.n_layers % self.superlayer:
            raise ValueError(f"n_layers={self.n_layers} is not a multiple "
                             f"of the layer pattern ({self.superlayer})")
        return self.n_layers // self.superlayer

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, 256)

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def is_moe_layer(self, idx: int) -> bool:
        if self.n_experts == 0:
            return False
        return idx % self.moe_every == self.moe_offset


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (paired with an architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


def reduced(cfg: ModelConfig, *, layers: Optional[int] = None) -> ModelConfig:
    """Smoke-test config: same family/topology, tiny dims."""
    sl = cfg.superlayer
    n_layers = layers if layers is not None else 2 * sl
    n_layers = _round_up(n_layers, sl)
    heads = min(cfg.n_heads, 4)
    kv = max(1, min(cfg.n_kv_heads, heads))
    while heads % kv:
        kv -= 1
    hd = 16
    d_model = heads * hd * 2
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=hd,
        d_ff=4 * d_model if cfg.n_experts == 0 else 64,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        experts_per_token=(min(cfg.experts_per_token, 2)
                           if cfg.n_experts else 0),
        capacity_factor=8.0,
        sliding_window=(64 if cfg.sliding_window is not None else None),
        d_state=8,
        rwkv_head_dim=16,
        rwkv_lora_dim=8,
        n_patches=8 if cfg.n_patches else 0,
        dtype="float32",
    )
