"""repro_torch's 3-body workload == the JAX package.

The same numpy points go through the reference's 3-body op (its Pallas
tet and BB-3D kernels in interpret mode, its scans and its oracle) and
through the port's plain versions, ``three_body(impl="torch")`` and
``three_body(impl="bb3_torch")`` (what the kernel wrappers run on CPU
tensors), and its oracle ``impl="ref"``, at (16, 8), (32, 8) and (48, 16)
rows x block, d in {1, 3, 8}, strict and not, under tests/oracles.py's
``3body`` / ``3body_total`` tolerances; the independent float64 oracle
holds both. Also held to the reference: the totals against the dense
einsum, bf16 input, the ref helpers, the dummy kernel's plain version,
and the launch counters and ``kernel_summary`` of the same calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.core import mapping as JM
from repro.kernels.tri_3body import kernel as JK
from repro.kernels.tri_3body import ops as JOPS
from repro.kernels.tri_3body import ref as JREF
from repro.obs import launch as JOBS
from repro.obs import metrics as JMET
from repro_torch.core import mapping as M
from repro_torch.kernels.tri_3body import kernel as K
from repro_torch.kernels.tri_3body import ops as OPS
from repro_torch.kernels.tri_3body import ref as REF
from repro_torch.obs import launch as OBS
from repro_torch.obs import metrics as MET

torch.set_num_threads(2)

SHAPES = [(16, 8), (32, 8), (48, 16)]


def _points(n_rows, d, seed=0):
    rng = np.random.default_rng(seed + 7 * n_rows + d)
    return rng.standard_normal((n_rows, d)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _simplex(n):
    return np.asarray([JM.tet_map(lam) for lam in range(JM.tet(n))])


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("d", [1, 3, 8])
@pytest.mark.parametrize("n_rows,block", SHAPES)
@pytest.mark.parametrize("ref_impl", ["pallas", "scan", "ref"])
def test_packed_matches_reference(ref_impl, n_rows, block, d, strict):
    x = _points(n_rows, d)
    want = _np(JOPS.three_body(jnp.asarray(x), block, impl=ref_impl,
                               strict=strict))
    oracle = O.three_body_packed_oracle(x, block, strict=strict)
    n = n_rows // block
    for impl in ("torch", "ref"):
        got = OPS.three_body(torch.as_tensor(x), block, impl=impl,
                             strict=strict)
        assert got.dtype == torch.float32 and \
            tuple(got.shape) == (M.tet(n), 1)
        O.assert_close(_np(got), want, "3body", err_msg=impl)
        O.assert_close(_np(got), oracle, "3body", err_msg=impl)
    # the kernel wrapper on a CPU tensor runs the same plain version
    assert torch.equal(K.three_body_tet(torch.as_tensor(x), block,
                                        strict=strict),
                       OPS.three_body(torch.as_tensor(x), block,
                                      impl="torch", strict=strict))


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("n_rows,block", SHAPES)
@pytest.mark.parametrize("ref_impl", ["bb3", "bb3_scan"])
def test_bb3_matches_reference(ref_impl, n_rows, block, strict):
    x = _points(n_rows, 3, seed=1)
    n = n_rows // block
    want = _np(JOPS.three_body(jnp.asarray(x), block, impl=ref_impl,
                               strict=strict)).reshape(n, n, n)
    got = OPS.three_body(torch.as_tensor(x), block, impl="bb3_torch",
                         strict=strict)
    assert tuple(got.shape) == (n, n, n) and got.dtype == torch.float32
    O.assert_close(_np(got), want, "3body")
    i, j, k = _simplex(n).T
    dead = np.ones((n, n, n), bool)
    dead[i, j, k] = False
    assert (_np(got)[dead] == 0).all() and (want[dead] == 0).all()
    # the simplex cells are the packed tet values, bit for bit
    packed = OPS.three_body(torch.as_tensor(x), block, impl="torch",
                            strict=strict)
    assert torch.equal(got[i, j, k], packed[:, 0])
    assert torch.equal(K.three_body_bb3(torch.as_tensor(x), block,
                                        strict=strict), got)


PORT_OF = {"pallas": "torch", "scan": "torch", "ref": "ref",
           "bb3": "bb3_torch", "bb3_scan": "bb3_torch"}


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("ref_impl", ["scan", "ref", "bb3_scan"])
def test_total_matches_reference_and_dense_einsum(ref_impl, strict):
    """tet(n) unique tiles + multiset weights == all ordered triples;
    strict: the plain sum == each distinct unordered triple once."""
    x = _points(24, 3, seed=3)
    got = OPS.three_body_total(torch.as_tensor(x), 8, impl=PORT_OF[ref_impl],
                               strict=strict)
    assert got.dtype == torch.float32 and got.ndim == 0
    want = float(JOPS.three_body_total(jnp.asarray(x), 8, impl=ref_impl,
                                       strict=strict))
    O.assert_close(float(got), want, "3body_total")
    O.assert_close(float(got), O.three_body_total_oracle(x, strict=strict),
                   "3body_total")


@pytest.mark.parametrize("ref_impl", ["scan", "pallas"])
def test_bf16_input_matches_reference(ref_impl):
    """bf16 points: both cast the same bf16 values to f32, so the f32
    tolerance holds."""
    x = _points(32, 4, seed=2)
    want = JOPS.three_body(jnp.asarray(x, jnp.bfloat16), 8, impl=ref_impl)
    got = OPS.three_body(torch.as_tensor(x).to(torch.bfloat16), 8,
                         impl="torch")
    assert got.dtype == torch.float32
    O.assert_close(_np(got), _np(want), "3body")
    cube = OPS.three_body(torch.as_tensor(x).to(torch.bfloat16), 8,
                          impl="bb3_torch")
    i, j, k = _simplex(4).T
    assert torch.equal(cube[i, j, k], got[:, 0])


def test_ref_helpers_match_reference():
    x = _points(24, 3, seed=21)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    O.assert_close(_np(REF.gram(xt)), _np(JREF.gram(xj)), "3body")
    for fn in ("three_body_total_ref", "three_body_total_strict_ref"):
        O.assert_close(float(getattr(REF, fn)(xt)),
                       float(getattr(JREF, fn)(xj)), "3body_total")
    for n in (1, 2, 3, 7, 12):
        coords = REF.tet_coords(n)
        np.testing.assert_array_equal(coords.numpy(), JREF.tet_coords(n))
        assert coords.dtype == torch.int64
        mults = [REF.tile_mult(*map(int, c)) for c in coords]
        assert mults == [JREF.tile_mult(*c) for c in JREF.tet_coords(n)]
        assert sum(mults) == n ** 3
    packed = OPS.three_body(xt, 8, impl="torch")
    O.assert_close(float(REF.combine_packed(packed, 3)),
                   float(JREF.combine_packed(jnp.asarray(_np(packed)), 3)),
                   "3body_total")


def test_strict_changes_only_diagonal_tiles():
    x = torch.as_tensor(_points(32, 4, seed=12))
    loose = OPS.three_body(x, 8, impl="torch")
    strict = OPS.three_body(x, 8, impl="torch", strict=True)
    for lam, (i, j, k) in enumerate(REF.tet_coords(4).tolist()):
        if i > j > k:
            assert loose[lam, 0] == strict[lam, 0], (i, j, k)
        else:
            assert loose[lam, 0] != strict[lam, 0], (i, j, k)


def test_dummy_tet_matches_reference():
    n = 6
    want = np.asarray(JK.dummy_tet(n))
    for got in (K.dummy_tet_torch(n), K.dummy_tet(n, device="cpu")):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_envelope_and_input_checks():
    big = M.TET_TRACED_MAX_I + 1  # tet(big) - 1 > TET_TRACED_MAX_LAM
    with pytest.raises(ValueError, match="envelope"):
        K.dummy_tet_torch(big)
    with pytest.raises(ValueError, match="envelope"):
        K.three_body_tet_torch(torch.zeros((big * 8, 1)), 8)
    with pytest.raises(ValueError, match="multiple of block"):
        OPS.three_body(torch.zeros((30, 2)), 8, impl="torch")
    with pytest.raises(ValueError, match="unknown impl"):
        OPS.three_body(torch.zeros((32, 2)), 8, impl="scan")
    for impl in ("cuda", "bb3"):
        with pytest.raises(ValueError, match=f"impl='{impl}' needs CUDA"):
            OPS.three_body(torch.zeros((32, 2)), 8, impl=impl)
    # the kernels' supported tiles: shared memory 3 b d + 2 b^2 + 8 floats
    assert K.smem_bytes(128, 65) <= K.SMEM_LIMIT < K.smem_bytes(128, 66)
    assert K.smem_bytes(64, 259) <= K.SMEM_LIMIT < K.smem_bytes(64, 260)


@pytest.mark.parametrize("ref_impl", ["pallas", "scan", "bb3", "bb3_scan"])
def test_counters_and_summary_match_reference(ref_impl):
    """At n = 4 (32 rows, block 8): tri_3body.tet launches tet(4) = 20
    tiles against a bound of 64, tri_3body.bb3 all 64 with 20 in the
    domain (kind "bb3"); the dummy kernel tet(6). Every counter and
    kernel_summary field but the impl label agrees."""
    x = _points(32, 2, seed=4)
    jreg, treg = JMET.Registry("jax"), MET.Registry("torch")
    with JMET.scope(jreg):
        JOPS.three_body(jnp.asarray(x), 8, impl=ref_impl)
        JK.dummy_tet(6)
    with MET.scope(treg):
        OPS.three_body(torch.as_tensor(x), 8, impl=PORT_OF[ref_impl])
        K.dummy_tet(6, device="cpu")
    want, got = JOBS.kernel_summary(jreg), OBS.kernel_summary(treg)
    name = "tri_3body.bb3" if ref_impl.startswith("bb3") \
        else "tri_3body.tet"
    assert sorted(got) == sorted(want) == sorted([name,
                                                  "tri_3body.dummy_tet"])
    assert (got[name]["tiles_launched"], got[name]["tiles_domain"],
            got[name]["tiles_bb"]) == \
        ((64, 20, 64) if name == "tri_3body.bb3" else (20, 20, 64))
    assert got["tri_3body.dummy_tet"]["tiles_launched"] == M.tet(6)
    ref_label = "scan" if ref_impl.endswith("scan") else "pallas"
    if ref_label == "pallas":  # the Pallas launch takes x three times
        want[name]["bytes_moved"] //= 3
    assert got[name]["bytes_moved"] == x.nbytes
    assert want[name].pop("impls") == [ref_label]
    assert want["tri_3body.dummy_tet"].pop("impls") == ["pallas"]
    for kname in got:
        assert got[kname].pop("impls") == ["torch"]
        assert got[kname] == want[kname], kname


def test_kernel_metas_match_reference():
    """The CUDA wrappers' launch geometry is the reference's Pallas one,
    kind "bb3" on the BB-3D grid included."""
    for n, block in ((4, 8), (7, 64), (1, 128)):
        pairs = [
            (K.tet_meta("cuda", n, block),
             JOBS.meta_exact("tri_3body.tet", "tri_3body", impl="pallas",
                             kind="tet", steps=JM.tet(n),
                             block_shape=(block, block, block),
                             bb_bound=n ** 3)),
            (K.bb3_meta("cuda", n, block),
             JOBS.meta_dense("tri_3body.bb3", "tri_3body", impl="pallas",
                             grid=(n, n, n),
                             block_shape=(block, block, block),
                             tiles_domain=JM.tet(n), kind="bb3")),
            (K.dummy_meta("cuda", n),
             JOBS.meta_exact("tri_3body.dummy_tet", "tri_3body",
                             impl="pallas", kind="tet", steps=JM.tet(n),
                             block_shape=(1, 1), bb_bound=n ** 3))]
        for got, want in pairs:
            assert (got.name, got.kind, got.grid, got.block_shape,
                    got.tiles_launched, got.tiles_domain, got.tiles_bb,
                    got.tiles_wasted, got.cells) == \
                (want.name, want.kind, want.grid, want.block_shape,
                 want.tiles_launched, want.tiles_domain, want.tiles_bb,
                 want.tiles_wasted, want.cells)
