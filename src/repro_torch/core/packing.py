"""PackedSchedule: one 1-D grid over the concatenation of simplex
domains, and its table-parameterized member maps (port of
``repro/core/packing.py``).

A packed launch concatenates R members (ltm, band, prefix and decode-row
domains) into one 1-D grid of exactly sum_r num_blocks_r steps. Every
member is normalized into (n, w, p) integers so ONE closed form covers
all kinds (band family when p == 0, prefix family otherwise), and a
member is found by a fixed-trip-count binary search over the cumulative
``starts`` table (``offsets``). ``starts`` and the parameters may be int32
tensors or anything indexable by a tensor.

  TriangularSchedule(n)     -> band family, w = n
  BandSchedule(n, w)        -> band family, w = min(w, n)
  PrefixSchedule(n, p > 0)  -> prefix family; p = 0 is the band family
  RowSchedule(n)            -> prefix family, p = n (a member of n lambdas
                               never leaves the flat head's row 0)

``PackedSchedule.offsets`` / ``row_offsets`` are the tables the attention
kernels' ``PackedTriSched.table()`` rows 0 and 1 carry. The CUDA kernels
carry the member maps as ``__device__`` helpers in ``csrc/packing.cuh``.
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.core import mapping as M
from repro_torch.core.schedule import (BandSchedule, BlockSchedule,
                                       PrefixSchedule, RowSchedule,
                                       TriangularSchedule)

# Member kinds the one parametric map covers.
SUPPORTED_MEMBERS = (TriangularSchedule, BandSchedule, PrefixSchedule,
                     RowSchedule)


def _member_params(m: BlockSchedule) -> Tuple[int, int, int]:
    """A member's (n, w, p): w the band width in tiles (n for full
    triangles), p the prefix width in tiles (0 selects the band family)."""
    if isinstance(m, RowSchedule):
        return m.n, m.n, m.n
    if isinstance(m, BandSchedule):
        return m.n, min(m.w, m.n), 0
    if isinstance(m, PrefixSchedule):
        return m.n, m.n, min(m.p, m.n)
    if isinstance(m, TriangularSchedule):
        if not m.include_diagonal:
            raise ValueError(
                "PackedSchedule members must include the diagonal "
                "(attention tiles always have a causal diagonal)")
        return m.n, m.n, 0
    raise TypeError(
        f"unsupported member schedule {type(m).__name__}; supported: "
        + ", ".join(t.__name__ for t in SUPPORTED_MEMBERS))


def _member_inverse(m: BlockSchedule, i: int, j: int) -> int:
    """(i, j) -> member-local lambda (host ints)."""
    n, w, p = _member_params(m)
    if p:  # prefix family: rows < p are p wide, then the triangular tail
        return i * p + j if i < p else p * p + M.tri(i) - M.tri(p) + j
    if i < w - 1:
        return M.tri(i) + j
    return M.tri(w - 1) + (i - (w - 1)) * w + (j - (i - (w - 1)))


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


@dataclasses.dataclass(frozen=True)
class PackedSchedule(BlockSchedule):
    """Rank-2 member schedules concatenated into one 1-D grid. ``n`` is
    the packed tile-axis size (the summed member n); index_map returns
    (request, i, j) with (i, j) member-local."""

    members: Tuple[BlockSchedule, ...] = ()

    rank = 3  # (request, i, j)

    def __post_init__(self):
        if not self.members:
            raise ValueError("PackedSchedule needs at least one member")
        for m in self.members:
            _member_params(m)  # raises on unsupported kinds
        total_rows = sum(m.n for m in self.members)
        if self.n != total_rows:
            raise ValueError(
                f"n={self.n} must equal the summed member rows {total_rows}")

    @classmethod
    def from_members(cls, members) -> "PackedSchedule":
        members = tuple(members)
        return cls(n=sum(m.n for m in members), members=members)

    @classmethod
    def decode_round(cls, kv_tiles) -> "PackedSchedule":
        """One packed decode round: member r is the RowSchedule over live
        slot r's kv_tiles[r] tiles, sum_r kv_tiles_r steps in all."""
        return cls.from_members(RowSchedule(n=int(t)) for t in kv_tiles)

    @classmethod
    def mixed_step(cls, prefill_members, kv_tiles) -> "PackedSchedule":
        """One fused continuous-batching step: the admitted prompts'
        (triangular / band / prefix) members first, the live decode slots'
        row members after, in one grid of sum_r prefill_blocks_r +
        sum_s kv_tiles_s steps (the "mixed" registry kind)."""
        prefill_members = tuple(prefill_members)
        if any(isinstance(m, RowSchedule) for m in prefill_members):
            raise ValueError(
                "mixed_step prefill members must be triangular/band/"
                "prefix (row members are the decode half)")
        decode = tuple(RowSchedule(n=int(t)) for t in kv_tiles)
        if not prefill_members and not decode:
            raise ValueError("mixed_step needs at least one member")
        return cls.from_members(prefill_members + decode)

    # -- static tables -------------------------------------------------------
    @property
    def num_requests(self) -> int:
        return len(self.members)

    @functools.cached_property
    def offsets(self) -> Tuple[int, ...]:
        """Cumulative block offsets, length R + 1: member r owns lambdas
        [offsets[r], offsets[r + 1])."""
        offs = [0]
        for m in self.members:
            offs.append(offs[-1] + m.num_blocks)
        return tuple(offs)

    @functools.cached_property
    def row_offsets(self) -> Tuple[int, ...]:
        """Cumulative tile-row offsets, length R + 1: member r's row i is
        packed row row_offsets[r] + i."""
        offs = [0]
        for m in self.members:
            offs.append(offs[-1] + m.n)
        return tuple(offs)

    def _tables(self, device=None):
        """(starts, n, w, p) int32 tensors indexed by request."""
        prm = [_member_params(m) for m in self.members]
        as_t = lambda v: torch.as_tensor(v, dtype=torch.int32, device=device)
        return (as_t(self.offsets[:-1]), as_t([q[0] for q in prm]),
                as_t([q[1] for q in prm]), as_t([q[2] for q in prm]))

    # -- interface -----------------------------------------------------------
    @property
    def num_blocks(self) -> int:
        return self.offsets[-1]

    @property
    def domain_blocks(self) -> int:
        return sum(m.domain_blocks for m in self.members)

    def host_request(self, lam: int) -> int:
        """Largest r with offsets[r] <= lam (host ints)."""
        return bisect.bisect_right(self.offsets, int(lam)) - 1

    def _locate(self, lam):
        """(request, member-local i and j, start, w, p) of int32 tensor
        lambdas; the request by the O(log R) search over ``offsets``."""
        lam = torch.as_tensor(lam)
        starts, n_t, w_t, p_t = self._tables(lam.device)
        r = request_from_starts(lam, starts, self.num_requests).long()
        i, j = member_map_params(lam - starts[r], n_t[r], w_t[r], p_t[r])
        return r, i, j, starts[r], w_t[r], p_t[r]

    def index_map(self, lam):
        """lambda -> (request, i, j), (i, j) member-local."""
        r, i, j = self._locate(lam)[:3]
        return r.to(torch.int32), i, j

    def host_map(self, lam: int) -> Tuple[int, int, int]:
        r = self.host_request(int(lam))
        i, j = self.members[r].host_map(int(lam) - self.offsets[r])
        return r, i, j

    def pack_lambda(self, r: int, i: int, j: int) -> int:
        """(request, i, j) -> packed lambda (the host inverse)."""
        return self.offsets[r] + _member_inverse(self.members[r], i, j)

    def host_first_col(self, r: int, i: int) -> int:
        return max(0, i - _member_params(self.members[r])[1] + 1)

    def host_last_col(self, r: int, i: int) -> int:
        return max(i, _member_params(self.members[r])[2] - 1)

    # -- segments: one row of one member -------------------------------------
    def seg_start(self, lam):
        if M._is_host(lam):
            r, i, j = self.host_map(lam)
            return j == self.host_first_col(r, i)
        lam = torch.as_tensor(lam)
        _, i, _, start, w, p = self._locate(lam)
        return lam == start + segment_origin_params(i, w, p)

    def seg_end(self, lam):
        if M._is_host(lam):
            r, i, j = self.host_map(lam)
            return j == self.host_last_col(r, i)
        lam = torch.as_tensor(lam)
        _, i, _, start, w, p = self._locate(lam)
        return lam == start + segment_origin_params(i + 1, w, p) - 1


def padded_bb_blocks(members) -> int:
    """Blocks a pad-to-max bounding-box launch issues for the same batch:
    R * n_max^2."""
    members = tuple(members)
    n_max = max(m.n for m in members)
    return len(members) * n_max * n_max
