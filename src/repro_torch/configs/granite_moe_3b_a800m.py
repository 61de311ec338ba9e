"""granite-moe-3b-a800m [moe] — 40 experts top-8 (the reference's count),
GQA kv=8: a group of 3 query heads, head dim 64.

[hf:ibm-granite/granite-3.0-3b-a800m-base]
32L d_model=1536 24H (GQA kv=8) d_ff=512 (per-expert) vocab=49155.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    n_experts=40,
    experts_per_token=8,
    moe_every=1,
    mlp_activation="swiglu",
    layer_pattern=("attn",),
)
