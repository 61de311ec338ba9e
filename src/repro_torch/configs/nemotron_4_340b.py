"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP, 256k vocab.

[arXiv:2402.16819 (Nemotron-4 15B report; 340B scales it)]
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
head_dim = 192: every attention body takes it (kernel.HEAD_DIMS), forward
and backward, so the engine and the prefill step serve it on the card and
the trainer trains it there. The reference's dry-run trains it with
Adafactor (train/optimizer.py, OptConfig(kind="adafactor")): AdamW's
moments alone would be 8 bytes a parameter. Its smoke config (head dim
16) trains on the kernels too.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp_activation="relu2",
    layer_pattern=("attn",),
)
