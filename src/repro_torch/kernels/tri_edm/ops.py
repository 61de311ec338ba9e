"""Public EDM op: the paper's Euclidean distance map (port of
``repro/kernels/tri_edm/ops.py``).

impl names:
  'cuda'     — the LTM kernel (``kernel.edm_ltm``), packed (tri(n), b, b)
               output; CUDA tensors only, it raises on CPU tensors;
  'torch'    — the plain LTM version (the reference's 'scan');
  'bb'       — the BB kernel (``kernel.edm_bb``), full (N, N) output with
               zeros above the diagonal tiles; CUDA tensors only;
  'bb_torch' — the plain BB version;
  'ref'      — the full-matrix oracle (ref.py).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.tri_edm import kernel as K
from repro_torch.kernels.tri_edm import ref as R

IMPLS = ("cuda", "torch", "bb", "bb_torch", "ref")

pack_tri = R.pack_tri
unpack_tri = R.unpack_tri


def edm(x: torch.Tensor, block: int = 128, *, squared: bool = False,
        impl: str = "cuda") -> torch.Tensor:
    """x: (N, d) features -> EDM (f32): packed (tri(n), block, block) for
    'cuda' / 'torch', full (N, N) for 'bb' / 'bb_torch' / 'ref'."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known {IMPLS}")
    if impl in ("cuda", "bb") and not x.is_cuda:
        raise ValueError(
            f"edm: impl={impl!r} needs CUDA tensors, got {x.device}; pass "
            f"impl={'torch' if impl == 'cuda' else 'bb_torch'!r} for the "
            "plain PyTorch version")
    if impl == "cuda":
        return K.edm_ltm(x, block, squared=squared)
    if impl == "torch":
        return K.edm_ltm_torch(x, block, squared=squared)
    if impl == "bb":
        return K.edm_bb(x, block, squared=squared)
    if impl == "bb_torch":
        return K.edm_bb_torch(x, block, squared=squared)
    return R.edm_full(x, squared=squared)
