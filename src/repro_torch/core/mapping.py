"""Block-mapping functions for triangular domains: the paper's g(lambda).

Port of ``repro/core/mapping.py`` for the maps the serving and training
paths use: ``ltm_map`` (row-major lower triangle, diagonal included),
``band_map`` (sliding-window trapezoid) and ``prefix_full_map`` (causal
triangle plus a bidirectional prefix rectangle), the row-major inverses,
and the column-major family the attention backward's dk/dv walks
(``cm_map``, ``band_cm_map``, ``prefix_cm_map``), and the tetrahedral
map of the 3-body workload (``tet_map``: lambda -> (i, j, k) over
k <= j <= i < n, with its inverse and the BB-3D decode and guard). Each
works on host ints (exact, python ``math.isqrt``) and on int32 torch
tensors (float32 sqrt or cube root plus overflow-clamped integer probes,
the same repair as the reference). The CUDA kernels carry the same
arithmetic as ``__device__`` functions in ``csrc/packing.cuh``. The
paper's strictly-lower map (``ltm_map_nodiag``) and its competitor
strategies (UTM, RB) also take tensors, for ``core/schedule.py``'s
``index_map``; REC, the bounding box and the block counts of
``core/analysis.py`` are host integer forms only.

The envelope constants are DECLARED here and CERTIFIED by
``analysis/envelope.py``, which derives each one from this module's own
arithmetic (torch ``sqrt`` / ``pow`` in float32) and the device's
(``sqrtf`` / ``cbrtf``): the torch and device forms are exact for
``lam <= LTM_TRACED_MAX_LAM`` (2-D) and ``lam <= TET_TRACED_MAX_LAM``
(3-D).
"""

from __future__ import annotations

import math

import numpy as np
import torch

INT32_MAX = 2**31 - 1
# floor(sqrt(INT32_MAX)): probes clamp here so (r+1)^2 cannot wrap.
ISQRT_MAX_R = 46340
# correction probes in each direction after the float32 sqrt candidate
ISQRT_PROBES = 1
# _isqrt_tensor(x) == floor(sqrt(x)) for every 0 <= x <= ISQRT_TRACED_MAX_X
ISQRT_TRACED_MAX_X = INT32_MAX
# ltm_map computes 8*lam + 1 in int32, which caps lam here.
LTM_TRACED_MAX_LAM = (INT32_MAX - 1) // 8  # 268,435,455
LTM_TRACED_MAX_I = 23169  # row of LTM_TRACED_MAX_LAM
# 3-D row finder: the float32 cube-root candidate lies within [-1, +2] of
# the true plane, so two probes each way repair it.
TET_PROBES_UP = 2
TET_PROBES_DOWN = 2
# Largest argument whose int32 tet() intermediate tri(i) * (i + 2) fits
# (2,145,507,000 < 2^31); probes clamp here, so the tensor and device maps
# are exact for planes i <= TET_TRACED_EXACT_PLANES.
TET_TRACED_MAX_I = 1624
TET_TRACED_EXACT_PLANES = TET_TRACED_MAX_I - 1  # 1623


def _is_host(x) -> bool:
    return isinstance(x, (int, np.integer))


def tri(n):
    """T(n) = n(n+1)/2 (host ints or tensors)."""
    return (n * (n + 1)) // 2


def _isqrt_tensor(x: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(x)) for non-negative int32 tensors: a correctly rounded
    float32 sqrt candidate, then ISQRT_PROBES clamped probes each way."""
    r = torch.floor(torch.sqrt(x.to(torch.float32))).to(x.dtype)
    r = torch.clamp(r, max=ISQRT_MAX_R)
    for _ in range(ISQRT_PROBES):
        up = torch.clamp(r + 1, max=ISQRT_MAX_R)
        r = torch.where((up * up <= x) & (up == r + 1), r + 1, r)
    for _ in range(ISQRT_PROBES):
        r = torch.where(r * r > x, r - 1, r)
    return r


def isqrt(x):
    """Exact floor-sqrt: host ints use math.isqrt, tensors the repair."""
    if _is_host(x):
        return math.isqrt(int(x))
    return _isqrt_tensor(x)


def _as_index(lam: torch.Tensor) -> torch.Tensor:
    return lam if lam.dtype in (torch.int32, torch.int64) \
        else lam.to(torch.int32)


def ltm_map(lam):
    """g(lambda) -> (i, j): i = floor((isqrt(8 lam + 1) - 1) / 2),
    j = lam - tri(i)."""
    if _is_host(lam):
        i = (math.isqrt(8 * int(lam) + 1) - 1) // 2
        return i, int(lam) - tri(i)
    lam = _as_index(lam)
    i = (isqrt(8 * lam + 1) - 1) // 2
    return i, lam - tri(i)


def ltm_map_nodiag(lam):
    """The paper's eq. (10), the strictly-lower triangle: i =
    floor((isqrt(8 lam + 1) + 1) / 2), j = lam - tri(i - 1), so j < i."""
    if _is_host(lam):
        i = (math.isqrt(8 * int(lam) + 1) + 1) // 2
        return i, int(lam) - tri(i - 1)
    lam = _as_index(lam)
    i = (isqrt(8 * lam + 1) + 1) // 2
    return i, lam - tri(i - 1)


def band_blocks(n: int, w: int) -> int:
    """Blocks of the banded lower triangle of width w tiles."""
    w = min(w, n)
    return tri(w - 1) + (n - (w - 1)) * w


def band_map(lam, w):
    """lambda -> (i, j) for the banded lower triangle, row-major: the
    triangular head reuses g(lambda), the parallelogram tail is div/mod."""
    head = tri(w - 1)
    if _is_host(lam) and _is_host(w):
        lam = int(lam)
        if lam < head:
            return ltm_map(lam)
        r, c = divmod(lam - head, w)
        i = (w - 1) + r
        return i, i - (w - 1) + c
    i_t, j_t = ltm_map(lam)
    q = (lam - head) // w
    c = (lam - head) - q * w
    i_b = (w - 1) + q
    j_b = i_b - (w - 1) + c
    in_head = lam < head
    return torch.where(in_head, i_t, i_b), torch.where(in_head, j_t, j_b)


def prefix_full_blocks(n: int, p: int) -> int:
    p = min(p, n)
    return tri(n) + tri(p - 1)


def prefix_full_map(lam, n, p):
    """Row-major enumeration of {(i, j): j <= i or j < p}: rows below p
    are p wide (flat head of p*p tiles), later rows i+1 wide."""
    head = p * p
    if _is_host(lam) and _is_host(p):
        lam = int(lam)
        if lam < head:
            return lam // p, lam % p
        rem = lam - head
        i = (math.isqrt(8 * (rem + tri(p)) + 1) - 1) // 2
        return i, rem + tri(p) - tri(i)
    in_head = lam < head
    i_h, j_h = lam // p, lam % p
    rem = lam - head + tri(p)
    i_t = (isqrt(rem * 8 + 1) - 1) // 2
    j_t = rem - tri(i_t)
    return torch.where(in_head, i_h, i_t), torch.where(in_head, j_h, j_t)


def ltm_inverse(i, j):
    """(i, j) -> lambda of the row-major lower-triangle enumeration."""
    return tri(i) + j


def band_inverse(i, j, w):
    """(i, j) -> lambda of ``band_map`` (host ints)."""
    if i < w - 1:
        return ltm_inverse(i, j)
    return tri(w - 1) + (i - (w - 1)) * w + (j - (i - (w - 1)))


# ---------------------------------------------------------------------------
# The tetrahedron {(i, j, k): 0 <= k <= j <= i < n}, plane-major: plane i
# holds lambdas [tet(i), tet(i + 1)), its (j, k) triangle in g(mu) order,
# so lam = tet(i) + tri(j) + k.
# ---------------------------------------------------------------------------


def tet(i):
    """T3(i) = i(i+1)(i+2)/6 as (tri(i) * (i + 2)) // 3: both divisions
    exact, the int32 intermediate below 2^31 for i <= TET_TRACED_MAX_I."""
    return (tri(i) * (i + 2)) // 3


TET_TRACED_MAX_LAM = tet(TET_TRACED_MAX_I) - 1  # 715,168,999


def tet_blocks(n: int) -> int:
    """Blocks the tetrahedral map launches: the domain."""
    return tet(n)


def bb3_blocks(n: int) -> int:
    """Blocks the 3-D bounding box launches: the n^3 cube."""
    return n * n * n


def wasted_blocks_bb3(n: int) -> int:
    """BB-3D waste n^3 - tet(n), about 5/6 of its launch."""
    return n * n * n - tet(n)


def _tet_row_tensor(lam: torch.Tensor) -> torch.Tensor:
    """Largest i with tet(i) <= lam for int32 tensors: floor of the
    float32 cube root of 6 lam (torch.pow: torch has no cbrt), then
    TET_PROBES_UP / TET_PROBES_DOWN probes clamped at TET_TRACED_MAX_I."""
    probe = lambda x: tet(torch.clamp(x, max=TET_TRACED_MAX_I))
    c = torch.floor(torch.pow(6.0 * lam.to(torch.float32), 1.0 / 3.0)) \
        .to(lam.dtype)
    for _ in range(TET_PROBES_UP):
        c = torch.where(probe(c + 1) <= lam, c + 1, c)
    for _ in range(TET_PROBES_DOWN):
        c = torch.where(probe(c) > lam, c - 1, c)
    return torch.clamp(c, max=TET_TRACED_EXACT_PLANES)


def tet_map(lam):
    """lambda -> (i, j, k), k <= j <= i: the plane by an integer-corrected
    cube root, (j, k) = g(lam - tet(i)). Host ints are exact unboundedly;
    int32 tensors for lam <= TET_TRACED_MAX_LAM."""
    if _is_host(lam):
        lam = int(lam)
        i = round((6 * lam) ** (1.0 / 3.0))
        while tet(i + 1) <= lam:
            i += 1
        while i > 0 and tet(i) > lam:
            i -= 1
        j, k = ltm_map(lam - tet(i))
        return i, j, k
    lam = _as_index(lam)
    i = _tet_row_tensor(lam)
    j, k = ltm_map(lam - tet(i))
    return i, j, k


def tet_inverse(i, j, k):
    """(i, j, k) -> lambda of ``tet_map``."""
    return tet(i) + tri(j) + k


def bb3_map(lam, n):
    """BB-3D: row-major index over the n^3 cube -> (i, j, k)."""
    return lam // (n * n), (lam // n) % n, lam % n


def bb3_active(i, j, k):
    """Whether a BB-3D block lies in the tetrahedron (host or tensor)."""
    if _is_host(i):
        return k <= j <= i
    return (k <= j) & (j <= i)


# ---------------------------------------------------------------------------
# Column-major maps: the dk/dv backward visits each key column's tiles
# contiguously, so its accumulators are reset and emitted once per column.
# ---------------------------------------------------------------------------


def cm_map(lam, n):
    """Column-major lower triangle (diagonal included): column j holds rows
    [j, n). off(j) = j(2n+1-j)/2; j = floor((2n+1 - isqrt((2n+1)^2 -
    8 lam)) / 2) with one correction each way; i = j + lam - off(j)."""
    off = lambda j: (j * (2 * n + 1 - j)) // 2
    if _is_host(lam) and _is_host(n):
        lam = int(lam)
        j = (2 * n + 1 - math.isqrt((2 * n + 1) ** 2 - 8 * lam)) // 2
        while off(j + 1) <= lam:
            j += 1
        while off(j) > lam:
            j -= 1
        return j + lam - off(j), j
    lam = _as_index(lam)
    j = (2 * n + 1 - isqrt((2 * n + 1) ** 2 - 8 * lam)) // 2
    j = torch.where(off(j + 1) <= lam, j + 1, j)
    j = torch.where(off(j) > lam, j - 1, j)
    return j + lam - off(j), j


def cm_inverse(i, j, n):
    """(i, j) -> lambda of ``cm_map``."""
    return (j * (2 * n + 1 - j)) // 2 + (i - j)


def band_cm_map(lam, n, w):
    """Column-major banded lower triangle: column j holds rows
    [j, min(j + w, n)). The full columns j <= n - w form a flat head of w
    rows each; the shrinking tail is a reversed triangle mapped through
    ``ltm_map`` on the mirrored index."""
    if _is_host(lam) and _is_host(n) and _is_host(w):
        lam, w = int(lam), min(int(w), int(n))
        head_cols = n - w + 1
        if lam < head_cols * w:
            j, r = divmod(lam, w)
            return j + r, j
        a, b = ltm_map(tri(w - 1) - 1 - (lam - head_cols * w))
        j = head_cols + (w - 2) - a
        return j + a - b, j
    lam = _as_index(lam)
    w = torch.minimum(torch.as_tensor(w), torch.as_tensor(n))
    head_cols = n - w + 1
    head = head_cols * w
    j_h = lam // w
    i_h = j_h + (lam - j_h * w)
    a, b = ltm_map(torch.clamp(tri(w - 1) - 1 - (lam - head), min=0))
    j_t = head_cols + (w - 2) - a
    i_t = j_t + a - b
    in_head = lam < head
    return torch.where(in_head, i_h, i_t), torch.where(in_head, j_h, j_t)


def prefix_cm_map(lam, n, p):
    """Column-major prefix-causal domain: columns j < p hold all n rows,
    columns j >= p hold rows [j, n) (``cm_map`` on the shifted
    triangle)."""
    head = p * n
    if _is_host(lam) and _is_host(n) and _is_host(p):
        lam = int(lam)
        if lam < head:
            return lam % n, lam // n
        i, j = cm_map(lam - head, n - p)
        return i + p, j + p
    lam = _as_index(lam)
    i_t, j_t = cm_map(torch.clamp(lam - head, min=0), n - p)
    in_head = lam < head
    return (torch.where(in_head, lam % n, i_t + p),
            torch.where(in_head, lam // n, j_t + p))


# ---------------------------------------------------------------------------
# Block counts and the paper's competitor strategies (host ints): what
# ``core/analysis.strategy_stats`` counts. No kernel of the port walks them.
# ---------------------------------------------------------------------------


def tri_blocks(n: int) -> int:
    """Blocks LTM launches for an n-block-per-side domain."""
    return tri(n)


def bb_blocks(n: int) -> int:
    """Blocks the bounding-box strategy launches."""
    return n * n


def wasted_blocks_bb(n: int) -> int:
    """BB wastes the n(n-1)/2 strictly-upper blocks."""
    return (n * (n - 1)) // 2


def wasted_blocks_ltm(n: int) -> int:
    """LTM wastes only the upper halves inside the n diagonal blocks:
    O(n), reported as n to stay integer (the paper's O(n) claim)."""
    return n


def utm_map(k, n: int):
    """UTM (Avril et al.): thread index k -> 0-based (a, b), b > a, in the
    strictly-upper triangle of n x n, by an exact integer sqrt and the
    two repairs of the original's float form (one each way on tensors)."""
    if not _is_host(k):
        k = _as_index(k)
        s = isqrt(4 * n * n - 4 * n - 8 * k + 1)
        a = (2 * n + 1 - s) // 2
        lo = lambda a: ((a - 1) * (2 * n - a)) // 2  # first k of row a
        a = torch.where(lo(a) > k, a - 1, a)
        a = torch.where(lo(a + 1) <= k, a + 1, a)
        return a - 1, k - lo(a) + a
    k = int(k)
    s = math.isqrt(4 * n * n - 4 * n - 8 * k + 1)
    a = int(math.floor((-(2 * n + 1) + s) / -2.0))
    while (a - 1) * (2 * n - a) // 2 > k:
        a -= 1
    while a * (2 * n - a - 1) // 2 <= k:
        a += 1
    b = (a + 1) + k - (a - 1) * (2 * n - a) // 2
    return a - 1, b - 1


def utm_inverse(a: int, b: int, n: int) -> int:
    """0-based (a, b), b > a -> k of ``utm_map``."""
    a1, b1 = a + 1, b + 1
    return (a1 - 1) * (2 * n - a1) // 2 + (b1 - a1 - 1)


def rb_grid_shape(n: int):
    """RB (Jung et al.) folds the triangle into ceil(n/2) rows by n + 1
    columns, which covers both parities."""
    return ((n + 1) // 2, n + 1)


def rb_map(x, y, n: int):
    """Folded-rectangle cell (column x in [0, n], row y in [0, H)) ->
    lower-triangle (i, j), H = ceil(n/2): cells with x > y are the
    complete columns j < H, the others the residual triangle folded in."""
    h = (n + 1) // 2
    if _is_host(x):
        return (x - 1, y) if x > y else (h + y, h + x)
    below = x > y
    return torch.where(below, x - 1, h + y), torch.where(below, y, h + x)


def rb_valid(x, y, n: int):
    """Whether a rectangle cell maps inside the triangle (the odd-n edge
    is filtered at run time)."""
    i, j = rb_map(x, y, n)
    if _is_host(x):
        return 0 <= j <= i < n
    return (j >= 0) & (j <= i) & (i < n)


def rec_levels(n: int, m: int) -> int:
    """k of n = m * 2**k (REC, Ries et al.); raises otherwise."""
    if not (m >= 1 and n >= m and n % m == 0):
        raise ValueError(f"REC needs n = m*2^k with m >= 1, got n={n} m={m}")
    q = n // m
    if q & (q - 1):
        raise ValueError(f"REC needs n = m*2^k, got n={n} m={m} (n/m={q} "
                         "is not a power of 2)")
    return q.bit_length() - 1


def rec_schedule(n: int, m: int):
    """REC passes [(edge_blocks, origins, is_diag)]: pass 0 covers the n/m
    diagonal sub-triangles with m x m squares (upper halves masked), level
    l in [1, k] launches 2**(k-l) squares of edge m*2**(l-1) fully inside
    the domain."""
    k = rec_levels(n, m)
    passes = [(m, [(d * m, d * m) for d in range(n // m)], True)]
    for lvl in range(1, k + 1):
        edge = m * (1 << (lvl - 1))
        step = 2 * edge
        passes.append((edge, [(s * step + edge, s * step)
                              for s in range(n // step)], False))
    return passes


def rec_total_blocks(n: int, m: int) -> int:
    """Tiles REC launches (diagonal squares count fully)."""
    return sum(len(origins) * edge * edge
               for edge, origins, _ in rec_schedule(n, m))


def rec_useful_blocks(n: int, m: int) -> int:
    return tri(n)


def bb_map(x: int, y: int):
    """BB: identity, (i, j) = (row y, column x)."""
    return y, x


def bb_active(x: int, y: int) -> bool:
    """The paper's optimized BB guard: block (x, y) works iff y >= x."""
    return y >= x
