"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP, 256k vocab.

[arXiv:2402.16819 (Nemotron-4 15B report; 340B scales it)]
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
head_dim = 192: the forward attention bodies take it, so the engine and
the prefill step serve it on the card; the backward kernels take 16-128,
so the trainer refuses it there (models/transformer.check_kernel_head_dim,
ROADMAP A.1e). Its smoke config (head dim 16) trains on the kernels.
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
