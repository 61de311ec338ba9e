"""The 3-body triplet reduction over the tetrahedron: CUDA wrappers and
plain PyTorch versions (kernel.py), the public op (ops.py), oracle and
the multiplicity weights (ref.py)."""
