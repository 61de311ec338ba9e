"""Public fused selective-scan op (port of
``repro/kernels/ssm_scan/ops.py``).

impl names:
  'cuda'  — the kernel (``kernel.selective_scan``); CUDA tensors only, it
            raises on CPU tensors;
  'torch' — its plain version (``kernel.selective_scan_torch``), launch
            recorded;
  'ref'   — the sequential oracle (ref.py), f32 output, nothing recorded.

The model (models/mamba.py) sends every scan region through impl 'cuda'
on the card, single-token decode steps included; on the CPU it keeps the
reference's chunked associative-scan formulation.
"""

from __future__ import annotations

from repro_torch import device as DEV
from repro_torch.kernels.ssm_scan import kernel as K
from repro_torch.kernels.ssm_scan import ref as R

IMPLS = ("cuda", "torch", "ref")


def selective_scan(x, dt, A, Bt, Ct, h0=None, *, impl: str = "cuda",
                   block_d: int = 256, block_l: int = 128, state_out=None):
    """Returns (y (B, L, D), h_L (B, D, N) f32); see the kernel for
    ``state_out``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known {IMPLS}")
    if impl == "cuda":
        if not DEV.kernel_device(x):
            raise ValueError(f"selective_scan: impl='cuda' needs CUDA "
                             f"tensors, got {x.device}; pass impl='torch' "
                             "for the plain PyTorch version")
        return K.selective_scan(x, dt, A, Bt, Ct, h0, block_d=block_d,
                                block_l=block_l, state_out=state_out)
    if impl == "torch":
        return K.selective_scan_torch(x, dt, A, Bt, Ct, h0, block_d=block_d,
                                      block_l=block_l, state_out=state_out)
    y, h = R.selective_scan_ref(x, dt, A, Bt, Ct, h0)
    if state_out is not None:
        h = state_out.copy_(h)
    return y, h
