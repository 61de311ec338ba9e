"""repro_torch's tetrahedral maps == the JAX reference.

Host ints and int32 tensors: ``tet_map`` against ``repro.core.mapping``
exhaustively for n <= 64 (with the ``tet_inverse`` round trip), the
tensor form equal to the host form at tet(i) + {-2..+2} for every plane
up to TET_TRACED_MAX_I and at TET_TRACED_MAX_LAM (where the cube-root
repair earns its keep), the reference's traced form on the same lambdas,
the envelope constants, the block counts and the BB-3D decode and guard.
The property test takes no fixture (real hypothesis refuses a
function-scoped fixture under @given).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import mapping as JM
from repro_torch.core import mapping as M

torch.set_num_threads(2)


def _host_table(lams):
    return np.asarray([M.tet_map(int(lam)) for lam in lams], np.int64)


def test_envelope_constants_match_reference():
    for name in ("TET_PROBES_UP", "TET_PROBES_DOWN", "TET_TRACED_MAX_I",
                 "TET_TRACED_EXACT_PLANES", "TET_TRACED_MAX_LAM"):
        assert getattr(M, name) == getattr(JM, name), name
    assert M.TET_TRACED_MAX_LAM == 715_168_999
    # the int32 intermediate of tet() at the clamp fits below 2^31
    assert M.tri(M.TET_TRACED_MAX_I) * (M.TET_TRACED_MAX_I + 2) < 2 ** 31


def test_tet_counts_match_reference():
    for n in range(200):
        for fn in ("tet", "tet_blocks", "bb3_blocks", "wasted_blocks_bb3"):
            assert getattr(M, fn)(n) == getattr(JM, fn)(n), (fn, n)
        assert M.bb3_blocks(n) - M.wasted_blocks_bb3(n) == M.tet_blocks(n)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 17, 64])
def test_tet_map_exhaustive_against_reference(n):
    lams = np.arange(M.tet(n))
    host = _host_table(lams)
    want = np.asarray([JM.tet_map(int(lam)) for lam in lams], np.int64)
    np.testing.assert_array_equal(host, want)
    i, j, k = M.tet_map(torch.as_tensor(lams, dtype=torch.int32))
    np.testing.assert_array_equal(torch.stack([i, j, k], 1).numpy(), host)
    assert all(0 <= c <= b <= a < n for a, b, c in host)
    assert [M.tet_inverse(*map(int, t)) for t in host] == list(lams)
    assert len({tuple(t) for t in host}) == M.tet(n)


def _edge_lams():
    edges = set()
    for i in range(1, M.TET_TRACED_MAX_I + 1):
        t = M.tet(i)
        edges.update(x for x in range(t - 2, t + 3)
                     if 0 <= x <= M.TET_TRACED_MAX_LAM)
    edges.add(M.TET_TRACED_MAX_LAM)
    return np.asarray(sorted(edges), np.int64)


def test_tensor_equals_host_at_every_plane_boundary():
    lams = _edge_lams()
    assert lams[-1] == M.TET_TRACED_MAX_LAM and len(lams) > 5 * 1620
    i, j, k = M.tet_map(torch.as_tensor(lams, dtype=torch.int32))
    got = torch.stack([i, j, k], 1).numpy()
    np.testing.assert_array_equal(got, _host_table(lams))
    # the reference's traced map agrees on the same lambdas
    it, jt, kt = jax.jit(jax.vmap(JM.tet_map))(jnp.asarray(lams, jnp.int32))
    np.testing.assert_array_equal(
        got, np.stack([np.asarray(it), np.asarray(jt), np.asarray(kt)], 1))
    assert tuple(got[-1]) == (M.TET_TRACED_EXACT_PLANES,) * 3


@given(st.integers(min_value=0, max_value=M.TET_TRACED_MAX_LAM))
@settings(max_examples=200, deadline=None)
def test_tensor_equals_host_inside_the_envelope(lam):
    i, j, k = M.tet_map(torch.tensor([lam], dtype=torch.int32))
    assert (int(i), int(j), int(k)) == M.tet_map(lam) == JM.tet_map(lam)


@given(st.integers(min_value=0, max_value=2 ** 52))
@settings(max_examples=200, deadline=None)
def test_host_round_trip_large(lam):
    i, j, k = M.tet_map(lam)
    assert 0 <= k <= j <= i
    assert M.tet_inverse(i, j, k) == lam
    assert (i, j, k) == JM.tet_map(lam)


@pytest.mark.parametrize("n", [1, 2, 5, 12])
def test_bb3_map_and_guard_match_reference(n):
    lams = np.arange(n ** 3)
    got = M.bb3_map(torch.as_tensor(lams), n)
    want = JM.bb3_map(jnp.asarray(lams), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    active = M.bb3_active(*got)
    np.testing.assert_array_equal(active.numpy(),
                                  np.asarray(JM.bb3_active(*want)))
    assert int(active.sum()) == M.tet(n) == n ** 3 - M.wasted_blocks_bb3(n)
    for lam in range(n ** 3):
        cell = M.bb3_map(lam, n)
        assert cell == tuple(JM.bb3_map(lam, n))
        assert M.bb3_active(*cell) == JM.bb3_active(*cell)
