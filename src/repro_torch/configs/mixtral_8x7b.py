"""mixtral-8x7b [moe] — 8 experts top-2, GQA kv=8, sliding-window 4096.

[arXiv:2401.04088; hf mistralai/Mixtral-8x7B-v0.1]
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2, SWA.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    experts_per_token=2,
    moe_every=1,
    sliding_window=4096,
    rope_theta=1e6,
    mlp_activation="swiglu",
    layer_pattern=("attn",),
)
