"""repro_torch's EDM and the paper's accounting == the JAX package.

The same numpy points go through the reference's EDM (its Pallas LTM and
BB kernels in interpret mode, and its scans) and through the port's
plain versions, ``edm(impl="torch")`` and ``edm(impl="bb_torch")``, what
the kernel wrappers run on CPU tensors, at the EDM tolerances of
tests/oracles.py; the independent float64 oracle holds both. Also held
to the reference: ``pack_tri`` / ``unpack_tri``, the dummy kernel's plain
version, the host strategy maps, ``strategy_stats`` /
``improvement_factor`` / ``flops_saved_fraction``, and the launch
counters and ``kernel_summary`` of the same calls.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.core import analysis as JAN
from repro.core import mapping as JM
from repro.kernels.tri_edm import kernel as JK
from repro.kernels.tri_edm import ops as JOPS
from repro.kernels.tri_edm import ref as JREF
from repro.obs import launch as JOBS
from repro.obs import metrics as JMET
from repro_torch.core import analysis as AN
from repro_torch.core import mapping as M
from repro_torch.kernels.tri_edm import kernel as K
from repro_torch.kernels.tri_edm import ops as OPS
from repro_torch.kernels.tri_edm import ref as REF
from repro_torch.obs import launch as OBS
from repro_torch.obs import metrics as MET

torch.set_num_threads(2)

SHAPES = [(32, 8), (64, 16), (96, 32)]


def _points(n_rows, d, seed=0):
    rng = np.random.default_rng(seed + 7 * n_rows + d)
    return rng.standard_normal((n_rows, d)).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _full_from_tiles(tiles, n_rows):
    """(n * n, b, b) row-major tiles (the reference's bb_scan) -> (N, N)."""
    b = tiles.shape[-1]
    n = n_rows // b
    return tiles.reshape(n, n, b, b).transpose(0, 2, 1, 3).reshape(
        n_rows, n_rows)


def _upper_tiles_zero(full, block):
    n = full.shape[0] // block
    tiles = full.reshape(n, block, n, block).transpose(0, 2, 1, 3)
    return all((tiles[i, i + 1:] == 0).all() for i in range(n))


@pytest.mark.parametrize("ref_impl", ["pallas", "scan"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("n_rows,block", SHAPES)
def test_edm_torch_matches_reference_ltm(ref_impl, d, n_rows, block):
    x = _points(n_rows, d)
    want = _np(JOPS.edm(jnp.asarray(x), block, impl=ref_impl))
    got = OPS.edm(torch.as_tensor(x), block, impl="torch")
    assert got.dtype == torch.float32 and \
        tuple(got.shape) == (M.tri(n_rows // block), block, block)
    O.assert_close(_np(got), want, "edm")
    O.assert_close(_np(got), O.edm_packed_oracle(x, block), "edm")
    # the kernel wrapper on a CPU tensor runs the same plain version
    assert torch.equal(K.edm_ltm(torch.as_tensor(x), block), got)
    diag = [M.tri(i) + i for i in range(n_rows // block)]
    assert (np.diagonal(_np(got)[diag], axis1=1, axis2=2) == 0).all()


@pytest.mark.parametrize("ref_impl", ["bb", "bb_scan"])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("n_rows,block", SHAPES)
def test_edm_bb_torch_matches_reference(ref_impl, d, n_rows, block):
    x = _points(n_rows, d, seed=1)
    want = _np(JOPS.edm(jnp.asarray(x), block, impl=ref_impl))
    if ref_impl == "bb_scan":
        want = _full_from_tiles(want, n_rows)
    got = _np(OPS.edm(torch.as_tensor(x), block, impl="bb_torch"))
    assert got.shape == (n_rows, n_rows)
    O.assert_close(got, want, "edm")
    assert _upper_tiles_zero(got, block) and (np.diagonal(got) == 0).all()
    oracle = O.edm_full_oracle(x)
    lower = ~np.triu(np.ones((n_rows // block,) * 2, bool), 1)
    lower = np.kron(lower, np.ones((block, block), bool))
    O.assert_close(got[lower], oracle[lower], "edm")
    # the BB lower tiles are the LTM tiles, bit for bit
    packed = OPS.edm(torch.as_tensor(x), block, impl="torch")
    assert torch.equal(OPS.pack_tri(torch.as_tensor(got), block), packed)


@pytest.mark.parametrize("impl,ref_impl", [("torch", "pallas"),
                                           ("bb_torch", "bb")])
def test_edm_bf16_matches_reference(impl, ref_impl):
    x = _points(32, 4, seed=2)
    want = JOPS.edm(jnp.asarray(x, jnp.bfloat16), 8, impl=ref_impl)
    got = OPS.edm(torch.as_tensor(x).to(torch.bfloat16), 8, impl=impl)
    assert got.dtype == torch.float32
    O.assert_close(_np(got), _np(want), "edm", jnp.bfloat16)


@pytest.mark.parametrize("impl,ref_impl", [("torch", "scan"),
                                           ("torch", "pallas"),
                                           ("bb_torch", "bb")])
def test_edm_squared_matches_reference(impl, ref_impl):
    x = _points(32, 4, seed=3)
    want = _np(JOPS.edm(jnp.asarray(x), 8, impl=ref_impl, squared=True))
    got = _np(OPS.edm(torch.as_tensor(x), 8, impl=impl, squared=True))
    O.assert_close(got, want, "edm_sq")
    oracle = O.edm_packed_oracle(x, 8, squared=True) if impl == "torch" \
        else None
    if oracle is not None:
        O.assert_close(got, oracle, "edm_sq")


def test_edm_ref_impl_matches_reference_and_oracle():
    x = _points(48, 3, seed=9)
    got = _np(OPS.edm(torch.as_tensor(x), 16, impl="ref"))
    O.assert_close(got, _np(JOPS.edm(jnp.asarray(x), 16, impl="ref")), "edm")
    O.assert_close(got, O.edm_full_oracle(x), "edm")
    O.assert_close(_np(REF.edm_packed_ref(torch.as_tensor(x), 16)),
                   _np(JREF.edm_packed_ref(jnp.asarray(x), 16)), "edm")


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("n_rows,block", [(48, 16), (64, 8), (32, 32)])
def test_pack_unpack_match_reference(n_rows, block, symmetric):
    rng = np.random.default_rng(n_rows + block)
    full = rng.standard_normal((n_rows, n_rows)).astype(np.float32)
    packed = REF.pack_tri(torch.as_tensor(full), block)
    want = np.asarray(JREF.pack_tri(jnp.asarray(full), block))
    np.testing.assert_array_equal(packed.numpy(), want)
    got = REF.unpack_tri(packed, n_rows, symmetric=symmetric)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JREF.unpack_tri(want, n_rows,
                                                symmetric=symmetric)))
    assert OPS.pack_tri is REF.pack_tri and OPS.unpack_tri is REF.unpack_tri


def test_dummy_ltm_matches_reference():
    n = 8
    want = np.asarray(JK.dummy_ltm(n))
    for got in (K.dummy_ltm_torch(n), K.dummy_ltm(n, device="cpu")):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_envelope_and_input_checks():
    big = M.LTM_TRACED_MAX_I + 1  # tri(big) - 1 > LTM_TRACED_MAX_LAM
    with pytest.raises(ValueError, match="envelope"):
        K.dummy_ltm_torch(big)
    with pytest.raises(ValueError, match="envelope"):
        K.edm_ltm_torch(torch.zeros((big * 8, 1)), 8)
    with pytest.raises(ValueError, match="multiple of block"):
        OPS.edm(torch.zeros((30, 2)), 8, impl="torch")
    with pytest.raises(ValueError, match="unknown impl"):
        OPS.edm(torch.zeros((32, 2)), 8, impl="scan")


# ---------------------------------------------------------------------------
# The paper's accounting: host strategy maps and core/analysis
# ---------------------------------------------------------------------------


def test_block_counts_match_reference():
    for n in range(1, 65):
        for fn in ("tri_blocks", "bb_blocks", "wasted_blocks_bb",
                   "wasted_blocks_ltm"):
            assert getattr(M, fn)(n) == getattr(JM, fn)(n), (fn, n)


def test_utm_maps_match_reference():
    for n in range(2, 25):
        for k in range(M.tri(n - 1)):
            got = M.utm_map(k, n)
            assert got == tuple(int(v) for v in JM.utm_map(k, n)), (n, k)
            assert M.utm_inverse(*got, n) == JM.utm_inverse(*got, n) == k


def test_rb_maps_match_reference():
    for n in range(1, 25):
        h, w = M.rb_grid_shape(n)
        assert (h, w) == JM.rb_grid_shape(n)
        for y in range(h):
            for x in range(w):
                assert M.rb_map(x, y, n) == tuple(JM.rb_map(x, y, n))
                assert M.rb_valid(x, y, n) == bool(JM.rb_valid(x, y, n))


def test_rec_and_bb_maps_match_reference():
    for m in (1, 2, 3):
        for k in range(5):
            n = m * 2 ** k
            assert M.rec_levels(n, m) == JM.rec_levels(n, m)
            assert M.rec_schedule(n, m) == JM.rec_schedule(n, m)
            assert M.rec_total_blocks(n, m) == JM.rec_total_blocks(n, m)
            assert M.rec_useful_blocks(n, m) == JM.rec_useful_blocks(n, m)
    with pytest.raises(ValueError):
        M.rec_levels(6, 4)
    for x in range(6):
        for y in range(6):
            assert M.bb_map(x, y) == JM.bb_map(x, y)
            assert M.bb_active(x, y) == JM.bb_active(x, y)


@pytest.mark.parametrize("band_w,rec_m", [(None, 1), (3, 1), (None, 2),
                                          (5, 4)])
def test_strategy_stats_match_reference(band_w, rec_m):
    for n in range(1, 65):
        got = {k: dataclasses.asdict(v)
               for k, v in AN.strategy_stats(n, band_w, rec_m).items()}
        want = {k: dataclasses.asdict(v)
                for k, v in JAN.strategy_stats(n, band_w, rec_m).items()}
        assert got == want, n


def test_improvement_model_matches_reference():
    for n in range(1, 65):
        for k_cost in (1.0, 1.74):
            assert AN.improvement_factor(n, k_cost) == \
                JAN.improvement_factor(n, k_cost)
        for band_w in (None, 2, 7):
            assert AN.flops_saved_fraction(n, band_w) == \
                JAN.flops_saved_fraction(n, band_w)


# ---------------------------------------------------------------------------
# Launch counters and kernel_summary
# ---------------------------------------------------------------------------

PORT_IMPL = {"pallas": "torch", "scan": "torch", "bb": "bb_torch",
             "bb_scan": "bb_torch"}


@pytest.mark.parametrize("ref_impl", ["pallas", "scan", "bb", "bb_scan"])
def test_counters_and_summary_match_reference(ref_impl):
    """At n = 4 (64 rows, block 16): tri_edm.ltm launches 10 tiles and
    tri_edm.bb 16, as in BENCH_trajectory.json; the dummy kernel tri(8).
    Every counter and kernel_summary field but the impl label agrees."""
    x = _points(64, 2, seed=4)
    jreg, treg = JMET.Registry("jax"), MET.Registry("torch")
    with JMET.scope(jreg):
        JOPS.edm(jnp.asarray(x), 16, impl=ref_impl)
        JK.dummy_ltm(8)
    with MET.scope(treg):
        OPS.edm(torch.as_tensor(x), 16, impl=PORT_IMPL[ref_impl])
        K.dummy_ltm(8, device="cpu")
    want, got = JOBS.kernel_summary(jreg), OBS.kernel_summary(treg)
    name = "tri_edm.bb" if ref_impl.startswith("bb") else "tri_edm.ltm"
    assert sorted(got) == sorted(want) == sorted([name, "tri_edm.dummy_ltm"])
    assert got[name]["tiles_launched"] == (16 if name == "tri_edm.bb"
                                           else 10)
    assert got["tri_edm.dummy_ltm"]["tiles_launched"] == M.tri(8)
    ref_label = "scan" if ref_impl.endswith("scan") else "pallas"
    if ref_label == "pallas":  # the Pallas launch takes x twice (x_i, x_j)
        want[name]["bytes_moved"] //= 2
    assert got[name]["bytes_moved"] == x.nbytes
    assert want[name].pop("impls") == [ref_label]
    assert want["tri_edm.dummy_ltm"].pop("impls") == ["pallas"]
    for kname in got:
        assert got[kname].pop("impls") == ["torch"]
        assert got[kname] == want[kname], kname


def test_kernel_metas_match_reference():
    """The CUDA wrappers' launch geometry is the reference's Pallas one."""
    for n, block in ((4, 16), (7, 8), (1, 128)):
        pairs = [
            (K.ltm_meta("cuda", n, block),
             JOBS.meta_exact("tri_edm.ltm", "tri_edm", impl="pallas",
                             kind="ltm", steps=JM.tri(n),
                             block_shape=(block, block), bb_bound=n * n)),
            (K.bb_meta("cuda", n, block),
             JOBS.meta_dense("tri_edm.bb", "tri_edm", impl="pallas",
                             grid=(n, n), block_shape=(block, block),
                             tiles_domain=JM.tri(n))),
            (K.dummy_meta("cuda", n),
             JOBS.meta_exact("tri_edm.dummy_ltm", "tri_edm", impl="pallas",
                             kind="ltm", steps=JM.tri(n), block_shape=(1, 1),
                             bb_bound=n * n))]
        for got, want in pairs:
            assert (got.name, got.kind, got.grid, got.block_shape,
                    got.tiles_launched, got.tiles_domain, got.tiles_bb,
                    got.tiles_wasted, got.cells) == \
                (want.name, want.kind, want.grid, want.block_shape,
                 want.tiles_launched, want.tiles_domain, want.tiles_bb,
                 want.tiles_wasted, want.cells)
