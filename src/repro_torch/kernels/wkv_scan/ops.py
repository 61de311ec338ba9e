"""Public fused WKV6 op (port of ``repro/kernels/wkv_scan/ops.py``).

impl names:
  'cuda'  — the kernel (``kernel.wkv``); CUDA tensors only, it raises on
            CPU tensors;
  'torch' — its plain version (``kernel.wkv_torch``), launch recorded;
  'ref'   — the sequential oracle (ref.py), f32 output, nothing recorded.

The model (models/rwkv6.py) sends every WKV region through impl 'cuda'
on the card, single-token decode steps included; on the CPU it keeps the
reference's chunked formulation.
"""

from __future__ import annotations

from repro_torch import device as DEV
from repro_torch.kernels.wkv_scan import kernel as K
from repro_torch.kernels.wkv_scan import ref as R

IMPLS = ("cuda", "torch", "ref")


def wkv(r, k, v, lw, u, s0=None, *, impl: str = "cuda", block_l: int = 64,
        state_out=None):
    """Returns (out (B, L, H, hd), s_L (B, H, hd, hd) f32); see the
    kernel for ``state_out``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known {IMPLS}")
    if impl == "cuda":
        if not DEV.kernel_device(r):
            raise ValueError(f"wkv: impl='cuda' needs CUDA tensors, got "
                             f"{r.device}; pass impl='torch' for the plain "
                             "PyTorch version")
        return K.wkv(r, k, v, lw, u, s0, block_l=block_l,
                     state_out=state_out)
    if impl == "torch":
        return K.wkv_torch(r, k, v, lw, u, s0, block_l=block_l,
                           state_out=state_out)
    out, s = R.wkv_ref(r, k, v, lw, u, s0)
    if state_out is not None:
        s = state_out.copy_(s)
    return out, s
