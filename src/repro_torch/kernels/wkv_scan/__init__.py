"""The RWKV-6 WKV recurrence: the CUDA wrapper and its plain version
(kernel.py), the public op (ops.py) and the sequential oracle (ref.py)."""
