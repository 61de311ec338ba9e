"""BlockSchedule: the space-of-computation abstraction (port of
``repro/core/schedule.py``).

A BlockSchedule says how a 1-D launch grid covers a tile domain of
``rank`` dimensions (2 for triangles, 3 for tetrahedra), the paper's
g(lambda) made a family. Every schedule exposes

  * ``num_blocks``     the grid size a launch issues;
  * ``index_map(lam)`` lambda -> tile coordinates (a rank-tuple), on int32
                       tensors of any device (the port's tensor maps of
                       ``core/mapping.py``, the same arithmetic the CUDA
                       kernels carry in ``csrc/packing.cuh``);
  * ``host_map(lam)``  the same on python ints, exact unboundedly;
  * ``domain_blocks``  the number of useful tiles;
  * ``seg_start(lam)`` / ``seg_end(lam)``: whether lam is the first / last
                       tile of its segment, the run sharing the outermost
                       coordinate (a row in 2-D, a plane in 3-D), where a
                       kernel resets and emits its accumulators. Both take
                       host ints or tensors.

Segment bookkeeping goes through ``segment_origin(i)`` (the lambda of
the first tile of outer coordinate i) for every kind that enumerates
segment-contiguously.

Schedules: TriangularSchedule (the paper's LTM), TetrahedralSchedule
(the 3-D simplex k <= j <= i), DenseSchedule and Dense3DSchedule (the
bounding-box baselines), BandSchedule (sliding window), PrefixSchedule
(prefix-causal), RowSchedule (one decode row over n KV tiles), the
competitors UTMSchedule (Avril), RBSchedule (Jung's fold) and
RECSchedule (Ries, multi-pass, host only), and PackedSchedule
(``core/packing.py``: ragged concatenations, the "packed" and "mixed"
kinds of ``make_schedule``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from repro_torch.core import mapping as M


@dataclasses.dataclass(frozen=True)
class BlockSchedule:
    """Base of every schedule over n tiles per side."""

    n: int  # tiles per side of the (square / cubic) bounding box

    rank = 2  # coordinates index_map returns

    @property
    def num_blocks(self) -> int:
        raise NotImplementedError

    @property
    def domain_blocks(self) -> int:
        raise NotImplementedError

    def index_map(self, lam):
        raise NotImplementedError

    def host_map(self, lam: int) -> Tuple[int, ...]:
        raise NotImplementedError

    def segment_origin(self, i):
        """lambda of the first tile whose outermost coordinate is i."""
        raise NotImplementedError

    def _outer(self, lam):
        return self.host_map(lam)[0] if M._is_host(lam) \
            else self.index_map(lam)[0]

    def seg_start(self, lam):
        return lam == self.segment_origin(self._outer(lam))

    def seg_end(self, lam):
        return lam == self.segment_origin(self._outer(lam) + 1) - 1

    def enumerate_host(self) -> List[Tuple[int, ...]]:
        return [self.host_map(lam) for lam in range(self.num_blocks)]


@dataclasses.dataclass(frozen=True)
class TriangularSchedule(BlockSchedule):
    """The paper's LTM: a 1-D grid of T(n) tiles, g(lambda)."""

    include_diagonal: bool = True

    @property
    def num_blocks(self) -> int:
        return M.tri(self.n) if self.include_diagonal else M.tri(self.n - 1)

    @property
    def domain_blocks(self) -> int:
        return self.num_blocks

    def index_map(self, lam):
        if self.num_blocks - 1 > M.LTM_TRACED_MAX_LAM:
            raise ValueError(
                f"n={self.n} launches {self.num_blocks} blocks, past the "
                f"ltm_map int32 envelope (max lam {M.LTM_TRACED_MAX_LAM})")
        return M.ltm_map(lam) if self.include_diagonal \
            else M.ltm_map_nodiag(lam)

    def host_map(self, lam: int):
        return M.ltm_map(int(lam)) if self.include_diagonal \
            else M.ltm_map_nodiag(int(lam))

    def segment_origin(self, i):
        return M.tri(i) if self.include_diagonal else M.tri(i - 1)


@dataclasses.dataclass(frozen=True)
class TetrahedralSchedule(BlockSchedule):
    """The 3-D simplex {(i, j, k): k <= j <= i < n}: a 1-D grid of tet(n)
    tiles, lambda -> (i, j, k) by the integer-corrected cube root; planes
    are contiguous."""

    rank = 3

    @property
    def num_blocks(self) -> int:
        return M.tet(self.n)

    @property
    def domain_blocks(self) -> int:
        return self.num_blocks

    def index_map(self, lam):
        if self.num_blocks - 1 > M.TET_TRACED_MAX_LAM:
            raise ValueError(
                f"n={self.n} launches {self.num_blocks} blocks, past the "
                f"tet_map int32 envelope (max lam {M.TET_TRACED_MAX_LAM})")
        return M.tet_map(lam)

    def host_map(self, lam: int):
        return M.tet_map(int(lam))

    def segment_origin(self, i):
        return M.tet(i)


@dataclasses.dataclass(frozen=True)
class Dense3DSchedule(BlockSchedule):
    """BB-3D baseline: the n^3 cube row-major; tiles outside the simplex
    k <= j <= i are dead work (``active`` guards them)."""

    rank = 3
    causal: bool = True  # guard to the simplex; False = the full cube

    @property
    def num_blocks(self) -> int:
        return self.n ** 3

    @property
    def domain_blocks(self) -> int:
        return M.tet(self.n) if self.causal else self.n ** 3

    def index_map(self, lam):
        return M.bb3_map(lam, self.n)

    def host_map(self, lam: int):
        return M.bb3_map(int(lam), self.n)

    def active(self, lam):
        i, j, k = self.index_map(lam)
        if not self.causal:
            return True if M._is_host(i) else torch.ones_like(i, dtype=bool)
        return M.bb3_active(i, j, k)

    def segment_origin(self, i):
        return i * self.n * self.n


@dataclasses.dataclass(frozen=True)
class DenseSchedule(BlockSchedule):
    """BB baseline: n * n tiles row-major; with ``causal`` the upper tiles
    are inactive (the paper's optimized BB block filter)."""

    causal: bool = True

    @property
    def num_blocks(self) -> int:
        return self.n * self.n

    @property
    def domain_blocks(self) -> int:
        return M.tri(self.n) if self.causal else self.n * self.n

    def index_map(self, lam):
        return lam // self.n, lam % self.n

    def host_map(self, lam: int):
        return int(lam) // self.n, int(lam) % self.n

    def active(self, lam):
        i, j = self.index_map(lam)
        return (j <= i) if self.causal else (j == j)

    def segment_origin(self, i):
        return i * self.n


@dataclasses.dataclass(frozen=True)
class BandSchedule(BlockSchedule):
    """Sliding-window causal band: row i keeps j in [max(0, i-w+1), i]; a
    triangular head and a div/mod parallelogram tail, zero waste."""

    w: int = 1  # band width in tiles (>= 1); w >= n is the triangle

    @property
    def num_blocks(self) -> int:
        return M.band_blocks(self.n, min(self.w, self.n))

    @property
    def domain_blocks(self) -> int:
        return self.num_blocks

    def index_map(self, lam):
        return M.band_map(lam, min(self.w, self.n))

    def host_map(self, lam: int):
        return M.band_map(int(lam), min(self.w, self.n))

    def segment_origin(self, i):
        w = min(self.w, self.n)
        flat = M.tri(w - 1) + (i - (w - 1)) * w
        if M._is_host(i):
            return M.tri(i) if i < w - 1 else flat
        return torch.where(i < w - 1, M.tri(i), flat)


@dataclasses.dataclass(frozen=True)
class RowSchedule(BlockSchedule):
    """One query row over n KV tiles, the 1 x n rectangle {(0, j)}: the
    decode-round member (``n`` is the row length, not a square side)."""

    @property
    def num_blocks(self) -> int:
        return self.n

    @property
    def domain_blocks(self) -> int:
        return self.n

    def index_map(self, lam):
        return lam * 0, lam

    def host_map(self, lam: int):
        return 0, int(lam)

    def segment_origin(self, i):
        return i * self.n  # row 0 at 0; the sentinel row 1 at n


@dataclasses.dataclass(frozen=True)
class PrefixSchedule(BlockSchedule):
    """Prefix-causal: the causal triangle plus a bidirectional prefix
    rectangle, {(i, j): j <= i or j < p}; rows are max(i + 1, p) wide."""

    p: int = 0  # prefix width in tiles

    @property
    def num_blocks(self) -> int:
        return M.prefix_full_blocks(self.n, self.p)

    @property
    def domain_blocks(self) -> int:
        return self.num_blocks

    def index_map(self, lam):
        return M.prefix_full_map(lam, self.n, min(self.p, self.n))

    def host_map(self, lam: int):
        return M.prefix_full_map(int(lam), self.n, min(self.p, self.n))

    def segment_origin(self, i):
        p = min(self.p, self.n)
        tail = p * p + M.tri(i) - M.tri(p)
        if M._is_host(i):
            return i * p if i < p else tail
        return torch.where(i < p, i * p, tail)


@dataclasses.dataclass(frozen=True)
class UTMSchedule(BlockSchedule):
    """Avril et al.'s upper-triangular map at block level (competitor):
    lambda walks the strictly-upper triangle, transposed to the lower; the
    diagonal is a tail segment of its own."""

    @property
    def num_blocks(self) -> int:
        return M.tri(self.n)

    @property
    def domain_blocks(self) -> int:
        return M.tri(self.n)

    def index_map(self, lam):
        strict = M.tri(self.n - 1)
        in_tail = lam >= strict
        a, b = M.utm_map(torch.clamp(lam, max=strict - 1), self.n)
        d = lam - strict
        return torch.where(in_tail, d, b), torch.where(in_tail, d, a)

    def host_map(self, lam: int):
        strict = M.tri(self.n - 1)
        if lam >= strict:
            d = lam - strict
            return d, d
        a, b = M.utm_map(int(lam), self.n)
        return b, a  # transposed upper -> lower


@dataclasses.dataclass(frozen=True)
class RBSchedule(BlockSchedule):
    """Jung's rectangular fold at block level (competitor): the folded
    ceil(n/2) x (n + 1) rectangle; odd n leaves O(n) invalid cells."""

    @property
    def grid_shape(self) -> Tuple[int, int]:
        return M.rb_grid_shape(self.n)

    @property
    def num_blocks(self) -> int:
        h, w = self.grid_shape
        return h * w

    @property
    def domain_blocks(self) -> int:
        return M.tri(self.n)

    def index_map(self, lam):
        w = self.grid_shape[1]
        return M.rb_map(lam % w, lam // w, self.n)

    def host_map(self, lam: int):
        w = self.grid_shape[1]
        return M.rb_map(int(lam) % w, int(lam) // w, self.n)

    def active(self, lam):
        w = self.grid_shape[1]
        return M.rb_valid(lam % w, lam // w, self.n)

    def host_active(self, lam: int) -> bool:
        w = self.grid_shape[1]
        return bool(M.rb_valid(int(lam) % w, int(lam) // w, self.n))


@dataclasses.dataclass(frozen=True)
class RECSchedule(BlockSchedule):
    """Ries's recursive partition (competitor): k + 1 passes of dense
    square grids, host only (no one-grid index_map)."""

    m: int = 1  # base tile multiple; n = m * 2**k

    def passes(self):
        return M.rec_schedule(self.n, self.m)

    @property
    def num_blocks(self) -> int:
        return M.rec_total_blocks(self.n, self.m)

    @property
    def domain_blocks(self) -> int:
        return M.tri(self.n)

    def enumerate_host(self):
        """Useful tiles only (diagonal squares keep their lower halves)."""
        out = []
        for edge, origins, is_diag in self.passes():
            for oi, oj in origins:
                for a in range(edge):
                    for b in range(a + 1 if is_diag else edge):
                        out.append((oi + a, oj + b))
        return out

    def host_map(self, lam: int):
        return self.enumerate_host()[lam]


_KINDS = {
    "ltm": TriangularSchedule,
    "triangular": TriangularSchedule,
    "tet": TetrahedralSchedule,
    "tetrahedral": TetrahedralSchedule,
    "bb": DenseSchedule,
    "dense": DenseSchedule,
    "bb3": Dense3DSchedule,
    "dense3d": Dense3DSchedule,
    "band": BandSchedule,
    "prefix": PrefixSchedule,
    "row": RowSchedule,
    "utm": UTMSchedule,
    "rb": RBSchedule,
    "rec": RECSchedule,
}


def make_schedule(kind: str, n: int, **kw) -> BlockSchedule:
    """The schedule registry: ``kind`` (or an alias) at n tiles a side.
    "packed" takes ``members`` (rank-2 schedules), "mixed" takes
    ``prefill_members`` and ``kv_tiles``; both derive n (pass 0 or the
    summed member rows)."""
    if kind == "packed":
        from repro_torch.core.packing import PackedSchedule

        members = tuple(kw.pop("members"))
        total = sum(m.n for m in members)
        if n not in (0, total):
            raise ValueError(f"packed n must be 0 or {total}, got {n}")
        return PackedSchedule(n=total, members=members, **kw)
    if kind == "mixed":
        from repro_torch.core.packing import PackedSchedule

        sched = PackedSchedule.mixed_step(kw.pop("prefill_members", ()),
                                          kw.pop("kv_tiles", ()))
        if kw:
            raise TypeError(f"unexpected mixed kwargs: {sorted(kw)}")
        if n not in (0, sched.n):
            raise ValueError(f"mixed n must be 0 or {sched.n}, got {n}")
        return sched
    return _KINDS[kind](n=n, **kw)
