"""Public 3-body op: the packed triplet reduction over the tetrahedron
(port of ``repro/kernels/tri_3body/ops.py``).

impl names:
  'cuda'      — the tet kernel (``kernel.three_body_tet``), packed
                (tet(n), 1) output; CUDA tensors only, it raises on CPU
                tensors;
  'torch'     — the plain tet version (the reference's 'scan');
  'bb3'       — the BB-3D kernel (``kernel.three_body_bb3``), (n, n, n)
                output with zeros outside the simplex; CUDA tensors only;
  'bb3_torch' — the plain BB-3D version (the reference's 'bb3_scan',
                in the cube layout);
  'ref'       — the Gram-matrix oracle (ref.py).

strict=True (every impl) keeps only point triples a > b > c over global
indices, inside the kernel, so each unordered triple of distinct points
counts once and the strict total is the plain sum of the packed values.
"""

from __future__ import annotations

import torch

from repro_torch import device as DEV
from repro_torch.kernels.tri_3body import kernel as K
from repro_torch.kernels.tri_3body import ref as R

IMPLS = ("cuda", "torch", "bb3", "bb3_torch", "ref")


def three_body(x: torch.Tensor, block: int = 128, *, impl: str = "cuda",
               strict: bool = False) -> torch.Tensor:
    """x: (N, d) points -> per-tile-triple reductions (f32): packed
    (tet(n), 1) for 'cuda' / 'torch' / 'ref', the (n, n, n) cube for
    'bb3' / 'bb3_torch'."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known {IMPLS}")
    if x.shape[0] % block:
        raise ValueError(f"n_rows={x.shape[0]} must be a multiple of "
                         f"block={block}")
    if impl in ("cuda", "bb3") and not DEV.kernel_device(x):
        raise ValueError(
            f"three_body: impl={impl!r} needs CUDA tensors, got {x.device}; "
            f"pass impl={'torch' if impl == 'cuda' else 'bb3_torch'!r} for "
            "the plain PyTorch version")
    if impl == "cuda":
        return K.three_body_tet(x, block, strict=strict)
    if impl == "torch":
        return K.three_body_tet_torch(x, block, strict=strict)
    if impl == "bb3":
        return K.three_body_bb3(x, block, strict=strict)
    if impl == "bb3_torch":
        return K.three_body_bb3_torch(x, block, strict=strict)
    return R.three_body_packed_ref(x, block, strict=strict)


def three_body_total(x: torch.Tensor, block: int = 128, *,
                     impl: str = "cuda", strict: bool = False) -> torch.Tensor:
    """Total triplet interaction from the packed unique-tile launch (f32
    scalar): with ``strict`` the plain sum of the packed values (each
    distinct unordered triple once), else the multiplicity-weighted total
    over all ordered point triples. The BB-3D cube is gathered down to
    the packed order first."""
    n = x.shape[0] // block
    out = three_body(x, block, impl=impl, strict=strict)
    coords = R.tet_coords(n, x.device)
    if impl in ("bb3", "bb3_torch"):
        out = out[coords[:, 0], coords[:, 1], coords[:, 2]][:, None]
    if strict:
        return out[:, 0].sum()
    return R.combine_packed(out, n, coords)
