"""repro_torch core maps and packing primitives == the JAX reference.

Exhaustive over every lambda of the n = 1..64 tile domains (ltm, several
band widths, several prefix widths), row-major and column-major, at the
top of the int32 envelope (LTM_TRACED_MAX_LAM), and for the packed member
search, the column-major member map and row and column bounds.
Exact equality: these are integer maps. Each family's lambdas of all
sizes are concatenated (with per-element parameters) so the reference
runs one eager call per op.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mapping as JM
from repro.core import packing as JPK
from repro_torch.core import mapping as M
from repro_torch.core import packing as PK

torch.set_num_threads(2)

NS = range(1, 65)


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int32))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _members(family):
    """(n, w, p) normalized member params exercised for each n."""
    out = []
    for n in NS:
        if family == "ltm":
            out.append((n, n, 0))
        elif family == "band":
            out += [(n, w, 0) for w in sorted({1, 2, max(1, n // 3), n})]
        else:
            out += [(n, n, p) for p in sorted({1, max(1, n // 2), n})]
    return out


def _steps(n, w, p):
    return M.band_blocks(n, w) if p == 0 else M.prefix_full_blocks(n, p)


def _flat(members):
    """Concatenated member-local lambdas with per-element (n, w, p)."""
    cols = [[], [], [], []]
    for n, w, p in members:
        k = _steps(n, w, p)
        for c, v in zip(cols, (np.arange(k), [n] * k, [w] * k, [p] * k)):
            c.append(np.asarray(v, np.int32))
    return [np.concatenate(c) for c in cols]


def test_envelope_constants_match():
    assert M.LTM_TRACED_MAX_LAM == JM.LTM_TRACED_MAX_LAM
    assert M.ISQRT_MAX_R == JM.ISQRT_MAX_R
    assert M.LTM_TRACED_MAX_I == JM.LTM_TRACED_MAX_I
    assert M.ltm_map(M.LTM_TRACED_MAX_LAM)[0] == M.LTM_TRACED_MAX_I
    for n in NS:
        for w in (1, max(1, n // 3), n):
            assert M.band_blocks(n, w) == JM.band_blocks(n, w)
            assert M.prefix_full_blocks(n, w) == JM.prefix_full_blocks(n, w)


@pytest.mark.parametrize("family", ["ltm", "band", "prefix"])
def test_maps_exhaustive_n_1_to_64(family):
    lam, n, w, p = _flat(_members(family))
    if family == "ltm":
        got, want = M.ltm_map(_t(lam)), JM.ltm_map(jnp.asarray(lam))
        host = [M.ltm_map(int(l)) for l in lam]
    elif family == "band":
        got = M.band_map(_t(lam), _t(w))
        want = JM.band_map(jnp.asarray(lam), jnp.asarray(w))
        host = [M.band_map(int(a), int(b)) for a, b in zip(lam, w)]
    else:
        got = M.prefix_full_map(_t(lam), _t(n), _t(p))
        want = JM.prefix_full_map(jnp.asarray(lam), jnp.asarray(n),
                                  jnp.asarray(p))
        host = [M.prefix_full_map(int(a), int(b), int(c))
                for a, b, c in zip(lam, n, p)]
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    _eq(np.asarray(host).T, np.stack([np.asarray(got[0]),
                                      np.asarray(got[1])]))


def test_ltm_map_at_envelope_top():
    top = M.LTM_TRACED_MAX_LAM
    lam = np.arange(top - 20000, top + 1, dtype=np.int32)
    got = M.ltm_map(_t(lam))
    want = JM.ltm_map(jnp.asarray(lam))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert (int(got[0][-1]), int(got[1][-1])) == JM.ltm_map(top)
    isq = np.array([0, 1, 2, 3, 4, 2**31 - 1, 46340**2, 46340**2 - 1,
                    2_147_395_599, 2_147_395_600], np.int64).astype(np.int32)
    _eq(M.isqrt(_t(isq)), JM.isqrt(jnp.asarray(isq)))


def test_member_map_params_and_row_bounds():
    members = _members("ltm") + _members("band") + _members("prefix")
    local, n, w, p = _flat(members)
    got = PK.member_map_params(_t(local), _t(n), _t(w), _t(p))
    want = JPK.member_map_params(*(jnp.asarray(x) for x in (local, n, w, p)))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    i = np.asarray(got[0])
    _eq(PK.first_col_params(_t(i), _t(w)),
        JPK.first_col_params(jnp.asarray(i), jnp.asarray(w)))
    _eq(PK.last_col_params(_t(i), _t(p)),
        JPK.last_col_params(jnp.asarray(i), jnp.asarray(p)))
    _eq(PK.segment_origin_params(_t(i), _t(w), _t(p)),
        JPK.segment_origin_params(jnp.asarray(i), jnp.asarray(w),
                                  jnp.asarray(p)))
    # each row's tiles run first_col..last_col from its segment origin
    j = np.asarray(got[1])
    first = np.asarray(PK.first_col_params(_t(i), _t(w)))
    origin = np.asarray(PK.segment_origin_params(_t(i), _t(w), _t(p)))
    _eq(local - origin, j - first)


def test_request_from_starts():
    rng = np.random.default_rng(0)
    for r in (1, 2, 3, 7, 8, 9, 33):
        sizes = rng.integers(1, 40, size=r)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int32)
        lam = np.arange(int(sizes.sum()), dtype=np.int32)
        _eq(PK.request_from_starts(_t(lam), _t(starts), r),
            JPK.request_from_starts(jnp.asarray(lam), jnp.asarray(starts),
                                    r))


def _cm_domain(n, w, p):
    """Column-major order of {(i, j): j <= i, i - j < w} or j < p."""
    cells = [(i, j) for i in range(n) for j in range(n)
             if (j <= i and i - j < w) or j < p]
    return sorted(cells, key=lambda c: (c[1], c[0]))


@pytest.mark.parametrize("family", ["ltm", "band", "prefix"])
def test_cm_maps_exhaustive_n_1_to_64(family):
    """cm_map / band_cm_map / prefix_cm_map: tensor form == the JAX map ==
    the host form, a bijection onto the domain in column-major order
    (each column's rows contiguous and ascending), and cm_inverse undoes
    cm_map."""
    lam, n, w, p = _flat(_members(family))
    if family == "ltm":
        got = M.cm_map(_t(lam), _t(n))
        want = JM.cm_map(jnp.asarray(lam), jnp.asarray(n))
        host = [M.cm_map(int(a), int(b)) for a, b in zip(lam, n)]
        _eq(M.cm_inverse(got[0], got[1], _t(n)), lam)
    elif family == "band":
        got = M.band_cm_map(_t(lam), _t(n), _t(w))
        want = JM.band_cm_map(jnp.asarray(lam), jnp.asarray(n),
                              jnp.asarray(w))
        host = [M.band_cm_map(int(a), int(b), int(c))
                for a, b, c in zip(lam, n, w)]
    else:
        got = M.prefix_cm_map(_t(lam), _t(n), _t(p))
        want = JM.prefix_cm_map(jnp.asarray(lam), jnp.asarray(n),
                                jnp.asarray(p))
        host = [M.prefix_cm_map(int(a), int(b), int(c))
                for a, b, c in zip(lam, n, p)]
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    _eq(np.asarray(host).T, np.stack([np.asarray(got[0]),
                                      np.asarray(got[1])]))
    i, j = np.asarray(got[0]), np.asarray(got[1])
    start = 0
    for nn, ww, pp in _members(family):
        k = _steps(nn, ww, pp)
        cells = list(zip(i[start:start + k].tolist(),
                         j[start:start + k].tolist()))
        assert cells == _cm_domain(nn, ww if family == "band" else nn, pp)
        start += k


def test_row_major_inverses_and_column_bounds():
    for n in NS:
        for w in sorted({1, 2, max(1, n // 3), n}):
            for lam in range(M.band_blocks(n, w)):
                i, j = M.band_map(lam, w)
                assert M.band_inverse(i, j, w) == lam
                assert JM.band_inverse(i, j, w) == lam
        for lam in range(M.tri(n)):
            assert M.ltm_inverse(*M.ltm_map(lam)) == lam
    j = np.arange(64, dtype=np.int32)
    for n, w, p in ((64, 64, 0), (64, 5, 0), (64, 64, 9)):
        _eq(PK.cm_first_row_params(_t(j), p),
            JPK.cm_first_row_params(jnp.asarray(j), p))
        _eq(PK.cm_last_row_params(_t(j), n, w),
            JPK.cm_last_row_params(jnp.asarray(j), n, w))
        assert [PK.cm_first_row_params(int(x), p) for x in j] == \
            np.asarray(JPK.cm_first_row_params(jnp.asarray(j), p)).tolist()
        assert [PK.cm_last_row_params(int(x), n, w) for x in j] == \
            np.asarray(JPK.cm_last_row_params(jnp.asarray(j), n,
                                              w)).tolist()


def test_member_cm_map_params_host_and_tensor():
    """member_cm_map_params (the packed dk/dv walk's column-major member
    map) == the reference's for every lambda of every ltm, band and
    prefix member with n = 1..16, as tensors and as host ints; each
    member's lambdas visit its domain column by column, every column's
    rows running cm_first_row..cm_last_row."""
    members = [m for fam in ("ltm", "band", "prefix") for m in _members(fam)
               if m[0] <= 16]
    local, n, w, p = _flat(members)
    got = PK.member_cm_map_params(_t(local), _t(n), _t(w), _t(p))
    want = JPK.member_cm_map_params(*(jnp.asarray(x)
                                      for x in (local, n, w, p)))
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    host = [PK.member_cm_map_params(int(a), int(b), int(c), int(d))
            for a, b, c, d in zip(local, n, w, p)]
    _eq(np.asarray(host).T, np.stack([np.asarray(got[0]),
                                      np.asarray(got[1])]))
    i, j = np.asarray(got[0]), np.asarray(got[1])
    start = 0
    for nn, ww, pp in members:
        k = _steps(nn, ww, pp)
        cells = list(zip(i[start:start + k].tolist(),
                         j[start:start + k].tolist()))
        assert cells == _cm_domain(nn, ww, pp), (nn, ww, pp)
        for col in range(nn):
            rows = [a for a, b in cells if b == col]
            assert rows == list(range(PK.cm_first_row_params(col, pp),
                                      PK.cm_last_row_params(col, nn, ww)
                                      + 1)), (nn, ww, pp, col)
        start += k
