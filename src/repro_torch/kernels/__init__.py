"""Kernel families of the port (``tri_attn``) and their CUDA build."""
