"""Model layers, the dense, RWKV-6 and Mamba/MoE layers (ports of
``repro/models``)."""
