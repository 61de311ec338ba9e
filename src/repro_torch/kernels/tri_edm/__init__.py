"""The paper's Euclidean distance map: CUDA wrappers and plain PyTorch
versions (kernel.py), the public op (ops.py), oracle and the packed
layout (ref.py)."""
