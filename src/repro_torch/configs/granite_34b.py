"""granite-34b [dense] — code model, MQA (kv=1).

[arXiv:2405.04324; hf ibm-granite/granite-34b-code-base]
88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
Original is GPTBigCode (learned positions, gelu 2-matrix MLP); the
reference keeps the gelu MLP and uses RoPE (its uniform position
encoding), and so does the port. One kv head: a group of 48 query heads,
six decode head slices of 8 a kv head.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_activation="gelu",
    layer_pattern=("attn",),
)
