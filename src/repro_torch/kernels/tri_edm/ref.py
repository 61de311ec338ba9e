"""Oracle of the Euclidean distance map and the block-packed layout.

Port of ``repro/kernels/tri_edm/ref.py``. ``pack_tri`` / ``unpack_tri``
index all tiles at once through the tensor ``ltm_map``, so they run on
the card at the sizes its users run (N = 65,536 at block 64 is 524,800
tiles), where the reference loops over lambda on the host.
"""

from __future__ import annotations

import torch

from repro_torch.core import mapping as M


def edm_full(x: torch.Tensor, *, squared: bool = False) -> torch.Tensor:
    """x: (N, d) -> (N, N) pairwise Euclidean distances (f32), exact zero
    self-distance."""
    x = x.float()
    sq = (x * x).sum(dim=-1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)
    d2.fill_diagonal_(0.0)
    return d2 if squared else torch.sqrt(d2)


def tile_coords(n: int, device=None):
    """(i, j) of every lambda in [0, tri(n)) as int64 tensors."""
    if M.tri(n) - 1 > M.LTM_TRACED_MAX_LAM:
        raise ValueError(f"tri({n}) tiles exceed the certified ltm_map "
                         f"int32 envelope (max lam {M.LTM_TRACED_MAX_LAM})")
    i, j = M.ltm_map(torch.arange(M.tri(n), dtype=torch.int32,
                                  device=device))
    return i.long(), j.long()


def pack_tri(full: torch.Tensor, block: int) -> torch.Tensor:
    """(N, N) -> block-packed lower triangle (tri(n), block, block): tile
    lambda holds full[i*b:(i+1)*b, j*b:(j+1)*b] with (i, j) = g(lambda),
    about half the memory of the full matrix."""
    n = full.shape[0] // block
    i, j = tile_coords(n, full.device)
    return full.reshape(n, block, n, block).permute(0, 2, 1, 3)[i, j]


def unpack_tri(packed: torch.Tensor, n_rows: int, *,
               symmetric: bool = True) -> torch.Tensor:
    """(tri(n), b, b) -> (N, N); the upper triangle mirrored if
    ``symmetric``, else zero."""
    t, b, _ = packed.shape
    n = n_rows // b
    if M.tri(n) != t:
        raise ValueError(f"{t} packed tiles do not cover {n_rows} rows in "
                         f"blocks of {b}")
    i, j = tile_coords(n, packed.device)
    full = torch.zeros((n, n, b, b), dtype=packed.dtype,
                       device=packed.device)
    full[i, j] = packed
    if symmetric:
        off = i != j
        full[j[off], i[off]] = packed[off].transpose(-1, -2)
    return full.permute(0, 2, 1, 3).reshape(n_rows, n_rows)


def edm_packed_ref(x: torch.Tensor, block: int, *, squared: bool = False):
    """Oracle for the packed kernels: pack_tri(edm_full(x))."""
    return pack_tri(edm_full(x, squared=squared), block)
