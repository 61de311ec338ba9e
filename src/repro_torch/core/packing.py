"""Table-parameterized member maps of a packed (concatenated) schedule.

Port of the traced primitives of ``repro/core/packing.py``. A packed
launch concatenates R members (ltm, band and prefix domains) into one
1-D grid; every member is normalized into (n, w, p) integers so ONE
closed form covers all kinds (band family when p == 0, prefix family
otherwise) and a member is found by a fixed-trip-count binary search
over the cumulative ``starts`` table. ``starts`` and the parameters may be
int32 tensors or anything indexable by a tensor.

The CUDA kernels carry the same functions as ``__device__`` helpers in
``csrc/packing.cuh``.
"""

from __future__ import annotations

import torch

from repro_torch.core import mapping as M


def _maximum(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a = a if isinstance(a, torch.Tensor) else torch.as_tensor(a)
        b = b if isinstance(b, torch.Tensor) else torch.as_tensor(b)
        return torch.maximum(a, b)
    return max(a, b)


def request_from_starts(lam, starts, num_requests: int):
    """Largest r with starts[r] <= lam: ceil(log2 R) branch-free probes.
    ``starts`` must be ascending with starts[0] == 0."""
    lam = torch.as_tensor(lam)
    lo = torch.zeros_like(lam, dtype=torch.int32)
    hi = torch.full_like(lam, num_requests - 1, dtype=torch.int32)
    for _ in range((num_requests - 1).bit_length()):
        mid = (lo + hi + 1) // 2
        take = starts[mid.long()] <= lam
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid - 1)
    return lo


def member_map_params(local, n_r, w_r, p_r):
    """Member-local lambda -> (i, j) from normalized (n, w, p): both
    closed forms are evaluated and selected (p_r clamped to >= 1 for the
    prefix evaluation so its flat-head division is defined)."""
    bi, bj = M.band_map(local, w_r)
    pi, pj = M.prefix_full_map(local, n_r, _maximum(p_r, 1))
    is_p = torch.as_tensor(p_r) > 0
    return torch.where(is_p, pi, bi), torch.where(is_p, pj, bj)


def member_cm_map_params(local, n_r, w_r, p_r):
    """COLUMN-major member-local lambda -> (i, j) from normalized (n, w,
    p): the order the dk/dv walk takes (band_cm_map when p == 0,
    prefix_cm_map otherwise). Host ints take the one closed form their
    family needs; tensors evaluate both and select (p_r clamped to >= 1
    for the prefix evaluation, as in ``member_map_params``)."""
    if not any(isinstance(x, torch.Tensor) for x in (local, n_r, w_r, p_r)):
        if p_r > 0:
            return M.prefix_cm_map(local, n_r, p_r)
        return M.band_cm_map(local, n_r, w_r)
    bi, bj = M.band_cm_map(local, n_r, w_r)
    pi, pj = M.prefix_cm_map(local, n_r, _maximum(p_r, 1))
    is_p = torch.as_tensor(p_r) > 0
    return torch.where(is_p, pi, bi), torch.where(is_p, pj, bj)


def first_col_params(i, w_r):
    """First j of row i (band left edge; 0 for unbanded rows): the
    kernels' accumulator-reset column."""
    return _maximum(0, i - w_r + 1)


def last_col_params(i, p_r):
    """Last j of row i (prefix rows are at least p wide): the kernels'
    emit column."""
    return _maximum(i, p_r - 1)


def cm_first_row_params(j, p_r):
    """First i of column j (prefix columns < p span every row; i == j
    otherwise): the dk/dv accumulator-reset row."""
    if isinstance(j, torch.Tensor) or isinstance(p_r, torch.Tensor):
        j = torch.as_tensor(j)
        return torch.where(j < p_r, torch.zeros_like(j), j)
    return 0 if j < p_r else j


def cm_last_row_params(j, n_r, w_r):
    """Last i of column j (band columns end w - 1 rows below the
    diagonal; unbanded members have w == n, so n - 1): the dk/dv emit
    row."""
    if isinstance(j, torch.Tensor) or isinstance(n_r, torch.Tensor):
        return torch.minimum(torch.as_tensor(j + w_r - 1),
                             torch.as_tensor(n_r - 1))
    return min(j + w_r - 1, n_r - 1)


def segment_origin_params(i, w_r, p_r):
    """Member-local lambda of the first tile of row i (both families)."""
    i, w_r, p_r = (torch.as_tensor(x) for x in (i, w_r, p_r))
    band = torch.where(i < w_r - 1, M.tri(torch.minimum(i, w_r - 1)),
                       M.tri(w_r - 1) + (i - (w_r - 1)) * w_r)
    pre = torch.where(i < p_r, i * p_r, p_r * p_r + M.tri(i) - M.tri(p_r))
    return torch.where(p_r > 0, pre, band)
