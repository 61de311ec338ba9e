"""Contract declarations for every registered schedule kind (port of
``repro/analysis/contracts.py``, over ``repro_torch.core.schedule``).

A ScheduleContract is the DECLARED side of the block-space checker: an
independent closed-form description of what a schedule promises — how many
blocks it launches, what domain those blocks cover, how the launch range
partitions into segments (rows in 2D, planes in 3D), and the inverse map
that witnesses uniqueness. The formulas here are written out literally
(``n * (n + 1) // 2`` rather than ``schedule.num_blocks``) precisely so
they are NOT the implementation under test: the verifier
(repro_torch.analysis.verifier) proves the schedule and its contract agree via
closed-form counting plus boundary probing, which scales to n ~ 10^4
where the registry fuzz tests' exhaustive enumeration is impossible.

Bijectivity classes
-------------------
  BIJECTION  num_blocks == domain_blocks; host_map is a bijection from
             [0, num_blocks) onto the domain (zero interior waste — the
             paper's g(lambda) property).
  COVER      num_blocks >= domain_blocks; an ``active`` predicate selects
             the useful launches, and host_map restricted to active
             lambdas is a bijection onto the domain (BB / BB-3D / RB).
  MULTIPASS  several dense launches whose useful cells partition the
             domain (REC); verified by pass-level counting + containment.

Adding a schedule kind
----------------------
Declare a ScheduleContract with independent closed forms and register it
in ``schedule_contracts()``; the verifier picks it up automatically and
``python -m repro_torch.analysis.lint`` will fail if the registry grows a kind
with no contract.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, Optional, Tuple

from repro_torch.core import schedule as S

BIJECTION = "bijection"
COVER = "cover"
MULTIPASS = "multipass"


@dataclasses.dataclass(frozen=True)
class CheckResult:
    """One verified (or violated) obligation, across all three passes."""

    pass_name: str  # envelope | contracts | launch | obs | resilience
    rule: str       # e.g. 'contract.ltm[n=10000].counting'
    ok: bool
    detail: str = ""

    def as_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Segment:
    """One contiguous lambda-run sharing the outermost coordinate.

    ``first``/``last`` are the closed-form expected coordinates of the
    segment's first and last launch — the boundary cells where off-by-one
    errors in sqrt/cbrt-seeded maps live.
    """

    origin: int
    width: int
    first: Tuple[int, ...]
    last: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Case:
    """One (n, params) instantiation a contract is verified at."""

    label: str
    n: int
    kw: Tuple[Tuple[str, object], ...] = ()
    exhaustive: bool = False  # full enumeration cross-check (small n only)
    traced: bool = True       # vectorized traced-vs-host at boundary probes

    @property
    def kwargs(self):
        return dict(self.kw)


@dataclasses.dataclass(frozen=True)
class ScheduleContract:
    kind: str
    bijectivity: str
    rank: int
    make: Callable[[Case], S.BlockSchedule]
    launched: Callable[[Case], int]
    domain: Callable[[Case], int]
    segments: Callable[[Case], Iterable[Segment]]
    in_domain: Callable[[Tuple[int, ...], Case], bool]
    # (coords, case) -> lam; the uniqueness witness. COVER contracts invert
    # active cells back to their launch index; None only for MULTIPASS.
    inverse: Optional[Callable[[Tuple[int, ...], Case], int]]
    cases: Tuple[Case, ...]
    # COVER only: closed-form count of active launches inside a segment,
    # and the declared active predicate at a launch offset within it.
    seg_active_count: Optional[Callable[[int, Segment, Case], int]] = None
    active_at: Optional[Callable[[int, Segment, Case], bool]] = None


def _tri(n):
    return n * (n + 1) // 2


def _tet(n):
    return n * (n + 1) * (n + 2) // 6


_SMALL = (1, 2, 3, 5, 8, 33, 64)
_LARGE = (257, 1024, 10000)


def _cases(kw=(), small=_SMALL, large=_LARGE, traced_max=None):
    out = []
    for n in small:
        out.append(Case(label=f"n={n}", n=n, kw=kw, exhaustive=True))
    for n in large:
        traced = traced_max is None or n <= traced_max
        out.append(Case(label=f"n={n}", n=n, kw=kw, traced=traced))
    return tuple(out)


# ---------------------------------------------------------------------------
# Per-kind contracts
# ---------------------------------------------------------------------------


def _ltm_contract() -> ScheduleContract:
    def segments(case):
        for i in range(case.n):
            yield Segment(_tri(i), i + 1, (i, 0), (i, i))

    return ScheduleContract(
        kind="ltm", bijectivity=BIJECTION, rank=2,
        make=lambda c: S.make_schedule("ltm", c.n),
        launched=lambda c: _tri(c.n),
        domain=lambda c: _tri(c.n),
        segments=segments,
        in_domain=lambda ij, c: 0 <= ij[1] <= ij[0] < c.n,
        inverse=lambda ij, c: _tri(ij[0]) + ij[1],
        cases=_cases(),
    )


def _tet_contract() -> ScheduleContract:
    def segments(case):
        for i in range(case.n):
            yield Segment(_tet(i), _tri(i + 1), (i, 0, 0), (i, i, i))

    return ScheduleContract(
        kind="tet", bijectivity=BIJECTION, rank=3,
        make=lambda c: S.make_schedule("tet", c.n),
        launched=lambda c: _tet(c.n),
        domain=lambda c: _tet(c.n),
        segments=segments,
        in_domain=lambda ijk, c: 0 <= ijk[2] <= ijk[1] <= ijk[0] < c.n,
        inverse=lambda ijk, c: _tet(ijk[0]) + _tri(ijk[1]) + ijk[2],
        # traced envelope: planes i <= TET_TRACED_EXACT_PLANES (1624 is the
        # largest n whose every plane stays exact; checked there on purpose)
        cases=_cases(large=(257, 1624, 10000), traced_max=1624),
    )


def _bb_contract() -> ScheduleContract:
    def segments(case):
        n = case.n
        for i in range(n):
            yield Segment(i * n, n, (i, 0), (i, n - 1))

    return ScheduleContract(
        kind="bb", bijectivity=COVER, rank=2,
        make=lambda c: S.make_schedule("bb", c.n),
        launched=lambda c: c.n * c.n,
        domain=lambda c: _tri(c.n),
        segments=segments,
        in_domain=lambda ij, c: 0 <= ij[1] <= ij[0] < c.n,
        inverse=lambda ij, c: ij[0] * c.n + ij[1],
        seg_active_count=lambda si, seg, c: si + 1,  # row i: j <= i
        active_at=lambda off, seg, c: off <= seg.first[0],
        cases=_cases(),
    )


def _bb3_contract() -> ScheduleContract:
    def segments(case):
        n = case.n
        for i in range(n):
            yield Segment(i * n * n, n * n, (i, 0, 0), (i, n - 1, n - 1))

    def active_at(off, seg, case):
        j, k = off // case.n, off % case.n
        return k <= j <= seg.first[0]

    return ScheduleContract(
        kind="bb3", bijectivity=COVER, rank=3,
        make=lambda c: S.make_schedule("bb3", c.n),
        launched=lambda c: c.n ** 3,
        domain=lambda c: _tet(c.n),
        segments=segments,
        in_domain=lambda ijk, c: 0 <= ijk[2] <= ijk[1] <= ijk[0] < c.n,
        inverse=lambda ijk, c: (ijk[0] * c.n + ijk[1]) * c.n + ijk[2],
        seg_active_count=lambda si, seg, c: _tri(si + 1),  # plane simplex
        active_at=active_at,
        # n^3 lambdas exceed int32 beyond n = 1290 — traced probes stop there
        cases=_cases(small=(1, 2, 3, 5, 8, 33), large=(257, 1290, 10000),
                     traced_max=1290),
    )


def _band_contract() -> ScheduleContract:
    def eff_w(case):
        return min(case.kwargs["w"], case.n)

    def segments(case):
        w = eff_w(case)
        for i in range(case.n):
            if i < w - 1:
                yield Segment(_tri(i), i + 1, (i, 0), (i, i))
            else:
                origin = _tri(w - 1) + (i - (w - 1)) * w
                yield Segment(origin, w, (i, i - w + 1), (i, i))

    def inverse(ij, case):
        i, j = ij
        w = eff_w(case)
        if i < w - 1:
            return _tri(i) + j
        return _tri(w - 1) + (i - (w - 1)) * w + (j - (i - (w - 1)))

    return ScheduleContract(
        kind="band", bijectivity=BIJECTION, rank=2,
        make=lambda c: S.make_schedule("band", c.n, **c.kwargs),
        launched=lambda c: _tri(eff_w(c) - 1)
        + (c.n - (eff_w(c) - 1)) * eff_w(c),
        domain=lambda c: _tri(eff_w(c) - 1)
        + (c.n - (eff_w(c) - 1)) * eff_w(c),
        segments=segments,
        in_domain=lambda ij, c: 0 <= ij[1] <= ij[0] < c.n
        and ij[0] - ij[1] < eff_w(c),
        inverse=inverse,
        cases=tuple(case for w in (1, 3, 16)
                    for case in _cases(kw=(("w", w),))),
    )


def _prefix_contract() -> ScheduleContract:
    def eff_p(case):
        return min(case.kwargs["p"], case.n)

    def segments(case):
        p = eff_p(case)
        for i in range(case.n):
            if i < p:
                yield Segment(i * p, p, (i, 0), (i, p - 1))
            else:
                origin = p * p + _tri(i) - _tri(p)
                yield Segment(origin, i + 1, (i, 0), (i, i))

    def inverse(ij, case):
        i, j = ij
        p = eff_p(case)
        if i < p:
            return i * p + j
        return p * p + _tri(i) - _tri(p) + j

    return ScheduleContract(
        kind="prefix", bijectivity=BIJECTION, rank=2,
        make=lambda c: S.make_schedule("prefix", c.n, **c.kwargs),
        launched=lambda c: _tri(c.n) + _tri(eff_p(c) - 1),
        domain=lambda c: _tri(c.n) + _tri(eff_p(c) - 1),
        segments=segments,
        in_domain=lambda ij, c: 0 <= ij[0] < c.n and 0 <= ij[1] < c.n
        and (ij[1] <= ij[0] or ij[1] < eff_p(c)),
        inverse=inverse,
        cases=tuple(case for p in (1, 2, 7)
                    for case in _cases(kw=(("p", p),))),
    )


def _row_contract() -> ScheduleContract:
    return ScheduleContract(
        kind="row", bijectivity=BIJECTION, rank=2,
        make=lambda c: S.make_schedule("row", c.n),
        launched=lambda c: c.n,
        domain=lambda c: c.n,
        segments=lambda c: [Segment(0, c.n, (0, 0), (0, c.n - 1))],
        in_domain=lambda ij, c: ij[0] == 0 and 0 <= ij[1] < c.n,
        inverse=lambda ij, c: ij[1],
        cases=_cases(),
    )


def _utm_contract() -> ScheduleContract:
    # Strictly-lower cells come from the transposed Avril upper-tri map
    # (upper row a, 1-based, holds k in [lo(a), lo(a) + n - a)); the
    # diagonal is the dedicated tail segment.
    def segments(case):
        n = case.n
        for a in range(1, n):
            origin = (a - 1) * (2 * n - a) // 2
            yield Segment(origin, n - a, (a, a - 1), (n - 1, a - 1))
        yield Segment(_tri(n - 1), n, (0, 0), (n - 1, n - 1))

    def inverse(ij, case):
        i, j = ij
        n = case.n
        if i == j:
            return _tri(n - 1) + i
        a, b = j + 1, i + 1  # transpose back to 1-based upper coords
        return (a - 1) * (2 * n - a) // 2 + (b - a - 1)

    return ScheduleContract(
        kind="utm", bijectivity=BIJECTION, rank=2,
        make=lambda c: S.make_schedule("utm", c.n),
        launched=lambda c: _tri(c.n),
        domain=lambda c: _tri(c.n),
        segments=segments,
        in_domain=lambda ij, c: 0 <= ij[1] <= ij[0] < c.n,
        inverse=inverse,
        cases=_cases(),
    )


def _rb_contract() -> ScheduleContract:
    # Folded rectangle H x (n+1), H = ceil(n/2). Cell (x=col, y=row):
    #   x >  y: below-fold image (x-1, y)      -- j = y < H
    #   x <= y: folded-in image (H+y, H+x)     -- j = H+x >= H
    # The two image families are disjoint in j, and each is injective in
    # (x, y), so active cells map 1:1 — the inverse below reconstructs the
    # rectangle cell from the image's j-family.
    def H(case):
        return (case.n + 1) // 2

    def segments(case):
        n, h = case.n, H(case)
        w = n + 1
        for y in range(h):
            # first launch of the row is cell x=0 (folded-in image),
            # last is x=n (below-fold image (n-1, y))
            yield Segment(y * w, w, (h + y, h), (n - 1, y))

    def active_at(off, seg, case):
        n, h = case.n, H(case)
        y = seg.origin // (n + 1)
        x = off
        if x > y:
            i, j = x - 1, y
        else:
            i, j = h + y, h + x
        return 0 <= j <= i < n

    def seg_active_count(si, seg, case):
        n, h = case.n, H(case)
        y = si
        below = n - y                      # x in [y+1, n] -> (x-1, y)
        above = (y + 1) if h + y < n else 0  # x in [0, y] -> (h+y, h+x)
        return below + above

    def inverse(ij, case):
        i, j = ij
        n, h = case.n, H(case)
        if j < h:  # below-fold family
            x, y = i + 1, j
        else:      # folded-in family
            x, y = j - h, i - h
        return y * (n + 1) + x

    return ScheduleContract(
        kind="rb", bijectivity=COVER, rank=2,
        make=lambda c: S.make_schedule("rb", c.n),
        launched=lambda c: ((c.n + 1) // 2) * (c.n + 1),
        domain=lambda c: _tri(c.n),
        segments=segments,
        in_domain=lambda ij, c: 0 <= ij[1] <= ij[0] < c.n,
        inverse=inverse,
        seg_active_count=seg_active_count,
        active_at=active_at,
        # both parities at every scale (the odd-n fold leaves O(n) waste)
        cases=_cases(small=(1, 2, 3, 5, 8, 33, 64),
                     large=(257, 1024, 9999, 10000)),
    )


def _packed_recipe(total_rows: int):
    """Deterministic mixed-member recipe summing ~total_rows tile rows,
    cycling all four supported member kinds."""
    sizes = [3, 1, 4, 2, 7, 5]
    kinds = ["ltm", "band", "prefix", "row"]
    members, rows, k = [], 0, 0
    while rows < total_rows:
        n = min(sizes[k % len(sizes)] * (1 + k // len(sizes)),
                total_rows - rows) or 1
        kind = kinds[k % len(kinds)]
        if kind == "ltm":
            members.append(S.TriangularSchedule(n=n))
        elif kind == "band":
            members.append(S.BandSchedule(n=n, w=max(1, n // 2)))
        elif kind == "prefix":
            members.append(S.PrefixSchedule(n=n, p=max(1, n // 3)))
        else:
            members.append(S.RowSchedule(n=n))
        rows += n
        k += 1
    return tuple(members)


@functools.lru_cache(maxsize=None)
def _member_forms(m):
    """(launched, segments-as-(origin, width, first_j, last_j, i)) closed
    forms for one packed member, independent of the member's own code.
    Members are frozen dataclasses, so memoizing on them is sound — the
    10^4-row packed case probes every member thousands of times."""
    if isinstance(m, S.RowSchedule):
        return m.n, [(0, m.n, 0, m.n - 1, 0)]
    if isinstance(m, S.BandSchedule):
        w = min(m.w, m.n)
        segs = []
        for i in range(m.n):
            if i < w - 1:
                segs.append((_tri(i), i + 1, 0, i, i))
            else:
                segs.append((_tri(w - 1) + (i - (w - 1)) * w, w,
                             i - w + 1, i, i))
        return _tri(w - 1) + (m.n - (w - 1)) * w, segs
    if isinstance(m, S.PrefixSchedule):
        p = min(m.p, m.n)
        segs = []
        for i in range(m.n):
            if i < p:
                segs.append((i * p, p, 0, p - 1, i))
            else:
                segs.append((p * p + _tri(i) - _tri(p), i + 1, 0, i, i))
        return _tri(m.n) + _tri(p - 1), segs
    # TriangularSchedule
    return _tri(m.n), [(_tri(i), i + 1, 0, i, i) for i in range(m.n)]


def _packed_contract() -> ScheduleContract:
    recipes = {
        "small": _packed_recipe(13),
        "mixed": _packed_recipe(120),
        "n=10000": _packed_recipe(10000),
    }

    def members(case):
        return recipes[case.label]

    def make(case):
        return S.make_schedule("packed", 0, members=members(case))

    def launched(case):
        return sum(_member_forms(m)[0] for m in members(case))

    def segments(case):
        base = 0
        for r, m in enumerate(members(case)):
            total, segs = _member_forms(m)
            for origin, width, fj, lj, i in segs:
                yield Segment(base + origin, width, (r, i, fj), (r, i, lj))
            base += total

    @functools.lru_cache(maxsize=None)
    def bases(label):
        ms = recipes[label]
        out, cur = [], 0
        for m in ms:
            out.append(cur)
            cur += _member_forms(m)[0]
        return tuple(out)

    def in_domain(rij, case):
        r, i, j = rij
        ms = members(case)
        if not (0 <= r < len(ms)) or not (0 <= i < ms[r].n):
            return False
        _, segs = _member_forms(ms[r])
        _, _, fj, lj, _ = segs[i]
        return fj <= j <= lj

    def inverse(rij, case):
        r, i, j = rij
        ms = members(case)
        origin, _, fj, _, _ = _member_forms(ms[r])[1][i]
        return bases(case.label)[r] + origin + (j - fj)

    return ScheduleContract(
        kind="packed", bijectivity=BIJECTION, rank=3,
        make=make, launched=launched, domain=launched,
        segments=segments, in_domain=in_domain, inverse=inverse,
        cases=(
            Case(label="small", n=13, exhaustive=True),
            Case(label="mixed", n=120, exhaustive=True),
            Case(label="n=10000", n=10000),
        ),
    )


def _mixed_recipe(total_rows: int):
    """Deterministic continuous-batching recipe: ~2/3 of the tile rows go
    to prefill members cycling ltm/band/prefix (never row), the remainder
    to decode kv_tiles — the fused-step shape the engine launches."""
    sizes = [3, 1, 4, 2, 7, 5]
    kinds = ["ltm", "band", "prefix"]
    pre_rows = max(1, (2 * total_rows) // 3)
    prefill, rows, k = [], 0, 0
    while rows < pre_rows:
        n = min(sizes[k % len(sizes)] * (1 + k // len(sizes)),
                pre_rows - rows) or 1
        kind = kinds[k % len(kinds)]
        if kind == "ltm":
            prefill.append(S.TriangularSchedule(n=n))
        elif kind == "band":
            prefill.append(S.BandSchedule(n=n, w=max(1, n // 2)))
        else:
            prefill.append(S.PrefixSchedule(n=n, p=max(1, n // 3)))
        rows += n
        k += 1
    kv_tiles, rem, k = [], total_rows - rows, 0
    while rem > 0:
        t = min(sizes[k % len(sizes)], rem)
        kv_tiles.append(t)
        rem -= t
        k += 1
    return tuple(prefill), tuple(kv_tiles)


def _mixed_contract() -> ScheduleContract:
    """Fused-step schedule kind: same member machinery as "packed" (the
    mixed schedule IS a PackedSchedule), but the membership is the
    continuous-batching shape — prefill members followed by decode row
    members — declared as its own kind so the fused launch cannot ship
    uncontracted."""
    recipes = {label: _mixed_recipe(rows)
               for label, rows in (("small", 9), ("mixed", 120),
                                   ("n=10000", 10000))}

    @functools.lru_cache(maxsize=None)
    def _members(label):
        prefill, kv_tiles = recipes[label]
        return prefill + tuple(S.RowSchedule(n=t) for t in kv_tiles)

    def members(case):
        return _members(case.label)

    def make(case):
        prefill, kv_tiles = recipes[case.label]
        return S.make_schedule("mixed", 0, prefill_members=prefill,
                               kv_tiles=kv_tiles)

    def launched(case):
        return sum(_member_forms(m)[0] for m in members(case))

    def segments(case):
        base = 0
        for r, m in enumerate(members(case)):
            total, segs = _member_forms(m)
            for origin, width, fj, lj, i in segs:
                yield Segment(base + origin, width, (r, i, fj), (r, i, lj))
            base += total

    @functools.lru_cache(maxsize=None)
    def bases(label):
        ms = _members(label)
        out, cur = [], 0
        for m in ms:
            out.append(cur)
            cur += _member_forms(m)[0]
        return tuple(out)

    def in_domain(rij, case):
        r, i, j = rij
        ms = members(case)
        if not (0 <= r < len(ms)) or not (0 <= i < ms[r].n):
            return False
        _, segs = _member_forms(ms[r])
        _, _, fj, lj, _ = segs[i]
        return fj <= j <= lj

    def inverse(rij, case):
        r, i, j = rij
        ms = members(case)
        origin, _, fj, _, _ = _member_forms(ms[r])[1][i]
        return bases(case.label)[r] + origin + (j - fj)

    return ScheduleContract(
        kind="mixed", bijectivity=BIJECTION, rank=3,
        make=make, launched=launched, domain=launched,
        segments=segments, in_domain=in_domain, inverse=inverse,
        cases=(
            Case(label="small", n=9, exhaustive=True),
            Case(label="mixed", n=120, exhaustive=True),
            Case(label="n=10000", n=10000),
        ),
    )


def _rec_contract() -> ScheduleContract:
    # MULTIPASS: verified by the dedicated engine in verifier.py
    # (pass-level counting + origin-square containment + small-n bitmap).
    cases = []
    for m in (1, 4):
        for k in (0, 1, 3, 6):
            n = m * (1 << k)
            cases.append(Case(label=f"n={n},m={m}", n=n, kw=(("m", m),),
                              exhaustive=n <= 128, traced=False))
        big = m * (1 << 13)  # 8192 / 32768-capped below
        if big <= 10000:
            cases.append(Case(label=f"n={big},m={m}", n=big,
                              kw=(("m", m),), traced=False))
    return ScheduleContract(
        kind="rec", bijectivity=MULTIPASS, rank=2,
        make=lambda c: S.make_schedule("rec", c.n, **c.kwargs),
        launched=lambda c: sum(
            e * e * len(o)
            for e, o, _ in S.make_schedule("rec", c.n,
                                           **c.kwargs).passes()),
        domain=lambda c: _tri(c.n),
        segments=lambda c: [],
        in_domain=lambda ij, c: 0 <= ij[1] <= ij[0] < c.n,
        inverse=None,
        cases=tuple(cases),
    )


def schedule_contracts() -> Dict[str, ScheduleContract]:
    """kind -> contract, for every registered make_schedule kind.

    Aliases in the registry (triangular/dense/...) share the canonical
    kind's contract; the verifier checks the registry and this table stay
    in sync so a new kind cannot land without declaring a contract.
    """
    contracts = [
        _ltm_contract(), _tet_contract(), _bb_contract(), _bb3_contract(),
        _band_contract(), _prefix_contract(), _row_contract(),
        _utm_contract(), _rb_contract(), _rec_contract(),
        _packed_contract(), _mixed_contract(),
    ]
    return {c.kind: c for c in contracts}


# Registry aliases -> canonical contract kind (must mirror make_schedule).
KIND_ALIASES = {
    "triangular": "ltm",
    "tetrahedral": "tet",
    "dense": "bb",
    "dense3d": "bb3",
}

# Every kind make_schedule accepts (the verifier cross-checks this list
# against the registry by construction attempts).
REGISTERED_KINDS = ("ltm", "triangular", "tet", "tetrahedral", "bb",
                    "dense", "bb3", "dense3d", "band", "prefix", "row",
                    "utm", "rb", "rec", "packed", "mixed")
