"""internvl2-1b [vlm] — InternViT-300M + Qwen2-0.5B LM backbone.

[arXiv:2404.16821; hf OpenGVLab/InternVL2-1B]
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
Backbone only: the InternViT frontend is a stub — batches carry
precomputed patch embeddings (B, 256, d_model) before the tokens. The
image prefix attends bidirectionally: the prefix-causal attention domain
(the prefix schedule, rectangle plus triangle). A group of 7 query heads.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    rope_theta=1e6,
    mlp_activation="swiglu",
    layer_pattern=("attn",),
    frontend="vision_patches",
    n_patches=256,
)
