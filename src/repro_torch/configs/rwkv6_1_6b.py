"""rwkv6-1.6b [ssm] — Finch, data-dependent decay; attention-free.

[arXiv:2404.05892] 24L d_model=2048 d_ff=7168 vocab=65536.
n_heads is the WKV head count (d_model / rwkv_head_dim = 32 heads of 64).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    layer_pattern=("rwkv",),
    rwkv_head_dim=64,
    rwkv_lora_dim=64,
)
