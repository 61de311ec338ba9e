"""Block-mapping functions for triangular domains: the paper's g(lambda).

Port of ``repro/core/mapping.py`` for the maps the serving path uses:
``ltm_map`` (row-major lower triangle, diagonal included), ``band_map``
(sliding-window trapezoid) and ``prefix_full_map`` (causal triangle plus a
bidirectional prefix rectangle). Each works on host ints (exact, python
``math.isqrt``) and on int32 torch tensors (float32 sqrt plus overflow-
clamped integer probes, the same repair as the reference). The CUDA
kernels carry the same arithmetic as ``__device__`` functions in
``csrc/packing.cuh``.

The envelope constants are copies of the reference's declared values:
the torch and device forms are exact for ``lam <= LTM_TRACED_MAX_LAM``.
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
# ltm_map computes 8*lam + 1 in int32, which caps lam here.
LTM_TRACED_MAX_LAM = (INT32_MAX - 1) // 8  # 268,435,455
LTM_TRACED_MAX_I = 23169  # row of LTM_TRACED_MAX_LAM


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
