"""Oracle of the 3-body triplet reduction over the tetrahedron.

Port of ``repro/kernels/tri_3body/ref.py``. For every unique tile triple
(i, j, k), k <= j <= i, of an n-tile axis the workload reduces

    s(I, J, K) = sum_{a in I, b in J, c in K} G[a,b] G[b,c] G[a,c],

G = X X^T. The summand is symmetric under any permutation of (a, b, c),
so the total over all ordered point triples is the packed values
weighted by the multiset permutation count (6, 3 or 1): tet(n) tiles
instead of the bounding box's n^3 lose nothing. ``tet_coords`` indexes
all tiles at once through the tensor ``tet_map``, where the reference
loops over lambda on the host.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core import mapping as M

# tiles an oracle or plain version computes at once (bounds temporaries)
CHUNK_ELEMS = 1 << 26


@contextlib.contextmanager
def full_f32():
    """float32 matrix products without TF32 on the card (the default, set
    here so a caller's setting cannot turn the yardstick into TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def gram(x: torch.Tensor) -> torch.Tensor:
    """x: (N, d) -> (N, N) Gram matrix in f32."""
    x = x.float()
    with full_f32():
        return x @ x.T


def tile_mult(i: int, j: int, k: int) -> int:
    """Permutation multiplicity of the multiset {i, j, k}."""
    if i == j == k:
        return 1
    if i == j or j == k or i == k:
        return 3
    return 6


def tet_coords(n: int, device=None) -> torch.Tensor:
    """(tet(n), 3) int64 table of tet_map(lambda) for every lambda."""
    if M.tet(n) - 1 > M.TET_TRACED_MAX_LAM:
        raise ValueError(f"tet({n}) tiles exceed the certified tet_map "
                         f"int32 envelope (max lam {M.TET_TRACED_MAX_LAM})")
    i, j, k = M.tet_map(torch.arange(M.tet(n), dtype=torch.int32,
                                     device=device))
    return torch.stack([i, j, k], dim=1).long()


def strict_masks(i, j, k, block: int):
    """(a > b, b > c) masks over global point indices of the tiles
    (i[t], j[t], k[t]): (T, b, b) bool each, all-ones off the diagonal."""
    ar = torch.arange(block, device=i.device)
    row = ar[None, :, None]
    col = ar[None, None, :]
    m_ab = (i[:, None, None] * block + row) > (j[:, None, None] * block + col)
    m_bc = (j[:, None, None] * block + row) > (k[:, None, None] * block + col)
    return m_ab, m_bc


def three_body_packed_ref(x: torch.Tensor, block: int,
                          strict: bool = False) -> torch.Tensor:
    """Oracle: (N, d) -> (tet(n), 1) f32, each tile's sum taken from the
    tiles of the full Gram matrix (strict masks A to a > b, B to b > c)."""
    n = x.shape[0] // block
    g4 = gram(x).reshape(n, block, n, block)
    coords = tet_coords(n, x.device)
    out = torch.empty((M.tet(n), 1), dtype=torch.float32, device=x.device)
    step = max(1, CHUNK_ELEMS // (block * block))
    with full_f32():
        for t0 in range(0, M.tet(n), step):
            i, j, k = coords[t0:t0 + step].unbind(1)
            a, b, c = g4[i, :, j], g4[j, :, k], g4[i, :, k]
            if strict:
                m_ab, m_bc = strict_masks(i, j, k, block)
                a = torch.where(m_ab, a, 0.0)
                b = torch.where(m_bc, b, 0.0)
            out[t0:t0 + step, 0] = ((a @ b) * c).sum(dim=(1, 2))
    return out


def three_body_total_ref(x: torch.Tensor) -> torch.Tensor:
    """Dense oracle of the total over all ordered point triples."""
    g = gram(x)
    with full_f32():
        return torch.einsum("ab,bc,ac->", g, g, g)


def three_body_total_strict_ref(x: torch.Tensor) -> torch.Tensor:
    """Dense oracle counting each unordered distinct-point triple once:
    sum over a > b > c of G[a,b] G[b,c] G[a,c]."""
    g = gram(x)
    a = torch.tril(g, diagonal=-1)  # a > b
    with full_f32():
        return ((a @ a) * g).sum()


def combine_packed(packed: torch.Tensor, n: int,
                   coords: torch.Tensor | None = None) -> torch.Tensor:
    """(tet(n), 1) packed values -> multiplicity-weighted total (f32)."""
    if coords is None:
        coords = tet_coords(n, packed.device)
    i, j, k = coords.unbind(1)
    equal = (i == j).long() + (j == k).long()  # k <= j <= i: 0, 1 or 2
    mult = torch.tensor([6.0, 3.0, 1.0], device=packed.device)[equal]
    return torch.sum(mult * packed[:, 0])
