"""musicgen-large [audio] — decoder-only over EnCodec tokens.

[arXiv:2306.05284; hf facebook/musicgen-large]
48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192 vocab=2048.
Backbone only: the EnCodec frontend is a stub — batches carry
precomputed frame embeddings (B, S, d_model); text conditioning omitted.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp_activation="gelu",
    layer_pattern=("attn",),
    frontend="audio_frames",
)
