"""Configuration schema (port of ``repro/configs/base.py``): the
``ModelConfig`` and ``ShapeConfig`` fields, the four ``SHAPES`` cells and
the ``reduced`` smoke sizing, unchanged, so a config built here equals
the reference's field for field."""

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
    def d_inner(self) -> int:  # mamba
        return self.ssm_expand * self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    def is_moe_layer(self, idx: int) -> bool:
        if self.n_experts == 0:
            return False
        return idx % self.moe_every == self.moe_offset

    def is_pure_full_attention(self) -> bool:
        """True if every token-mixing layer is unwindowed full attention
        (quadratic: the long_500k cell is skipped for it)."""
        return (all(k == "attn" for k in self.layer_kinds)
                and self.sliding_window is None)

    def param_counts(self) -> dict:
        """{"total", "active"} parameters, the reference's count (its
        approximations of the rwkv and Mamba projections included)."""
        d, hd = self.d_model, self.head_dim
        qkvo = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        mlp = (3 if self.mlp_activation == "swiglu" else 2) * d * self.d_ff
        total = active = 0
        for idx, kind in enumerate(self.layer_kinds):
            if kind == "attn":
                m = qkvo
            elif kind == "mamba":
                din, ds = self.d_inner, self.d_state
                m = (d * 2 * din + din * self.d_conv + din * (ds * 2 + 1)
                     + din + din * ds + din + din * d)
            else:  # rwkv
                m = 5 * d * d + 2 * self.rwkv_lora_dim * d \
                    + self.n_rwkv_heads * self.rwkv_head_dim
            total, active = total + m, active + m
            if self.is_moe_layer(idx):
                total += self.n_experts * mlp + d * self.n_experts
                active += self.experts_per_token * mlp + d * self.n_experts
            elif kind == "rwkv":
                cm = 2 * d * self.d_ff + d * d  # channel mix k, v, r
                total, active = total + cm, active + cm
            else:
                total, active = total + mlp, active + mlp
            total, active = total + 2 * d, active + 2 * d  # norms
        emb = self.padded_vocab * d
        head = 0 if self.tie_embeddings else self.padded_vocab * d
        return {"total": total + emb + head + d,
                "active": active + emb + head + d}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (paired with an architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")

    @property
    def tokens_per_step(self) -> int:
        """One new token a sequence for decode cells, else every token."""
        if self.is_decode:
            return self.global_batch
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}


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
