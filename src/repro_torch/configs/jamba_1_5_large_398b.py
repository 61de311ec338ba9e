"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7 interleave, MoE
16e top-2 on every other layer.

[arXiv:2403.19887 / Jamba-1.5; hf ai21labs/AI21-Jamba-1.5-Large]
72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
Superlayer = the 8-layer Jamba block (attention at in-block index 3); MoE
on odd in-block indices (every 2nd layer).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_every=2,
    moe_offset=1,
    mlp_activation="swiglu",
    layer_pattern=("mamba", "mamba", "mamba", "attn",
                   "mamba", "mamba", "mamba", "mamba"),
    d_state=16,
    d_conv=4,
    ssm_expand=2,
)
