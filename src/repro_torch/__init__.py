"""PyTorch / CUDA port of the triangular-domain serving system.

The package mirrors ``src/repro`` path for path (``core/mapping.py``,
``kernels/tri_attn/ops.py``, ``serve/engine.py``, ...) so each module's
reference counterpart is found at the same relative path. It imports
``torch`` and numpy only: never ``jax`` and never the JAX package.

Entry points (``Engine``, ``init_params``, the attention ops) run on the
CUDA card unless the caller passes ``device="cpu"``; the default raises
when no card is present instead of running on the CPU.
"""
