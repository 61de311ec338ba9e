"""Triangular-domain attention: schedules and CUDA wrappers (kernel.py),
plain PyTorch versions (scan_impl.py), public ops (ops.py), oracle
(ref.py)."""
