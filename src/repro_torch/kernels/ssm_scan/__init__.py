"""The Mamba-1 selective scan: the CUDA wrapper and its plain version
(kernel.py), the public op (ops.py) and the sequential oracle (ref.py)."""
