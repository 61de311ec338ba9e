"""repro_torch.core.schedule == the reference's schedule registry.

For every ``make_schedule`` kind and alias ("packed" and "mixed"
included), on the CPU:

* num_blocks, domain_blocks, host_map, seg_start and seg_end equal the
  reference's for every lambda, at n = 1..64 for the 2-D kinds (every
  valid n for REC) and at the reference's host cap (n <= 13, the first
  six of HOST_NS) for the tet and bb3 host maps;
* the tensor index_map (int32, the maps the kernels carry) equals the
  reference's jnp index_map on the same lambdas for n in HOST_NS, and
  seg_start / seg_end on tensors equal them on host ints;
* PackedSchedule's offsets and row_offsets equal the member tables the
  attention kernels take (PackedTriSched.table() rows 0 and 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as JP
from repro.core import schedule as JS
from repro_torch.core import packing as P
from repro_torch.core import schedule as S
from repro_torch.kernels.tri_attn import ops as OPS

torch.set_num_threads(2)

N_MAX = 64
HOST_NS = (1, 2, 3, 5, 8, 13, 21, 34, 55, 64)
KINDS = ("ltm", "triangular", "tet", "tetrahedral", "bb", "dense", "bb3",
         "dense3d", "band", "prefix", "row", "utm", "rb", "rec", "packed",
         "mixed")
THREE_D = ("tet", "tetrahedral", "bb3", "dense3d")
# kinds with a segment_origin (the others raise, in both packages)
SEGMENTED = ("ltm", "triangular", "tet", "tetrahedral", "bb", "dense",
             "bb3", "dense3d", "band", "prefix", "row", "packed", "mixed")


def _members(mod, total_rows):
    """The mixed ltm / band / prefix / row members of ~total_rows tile
    rows, as ``mod``'s schedules (the contracts' recipe)."""
    sizes, kinds = [3, 1, 4, 2, 7, 5], ["ltm", "band", "prefix", "row"]
    out, rows, k = [], 0, 0
    while rows < total_rows:
        n = min(sizes[k % 6] * (1 + k // 6), total_rows - rows) or 1
        kind = kinds[k % 4]
        out.append(mod.TriangularSchedule(n=n) if kind == "ltm" else
                   mod.BandSchedule(n=n, w=max(1, n // 2)) if kind == "band"
                   else mod.PrefixSchedule(n=n, p=max(1, n // 3))
                   if kind == "prefix" else mod.RowSchedule(n=n))
        rows += n
        k += 1
    return tuple(out)


def _pair(kind, n, **kw):
    """(port, reference) schedules of one kind at n."""
    if kind == "packed":
        return (S.make_schedule(kind, 0, members=_members(S, n)),
                JS.make_schedule(kind, 0, members=_members(JS, n)))
    if kind == "mixed":
        pre = lambda mod: tuple(m for m in _members(mod, n)
                                if not isinstance(m, mod.RowSchedule))
        tiles = (n % 5 + 1, 2, n % 3 + 1)
        return (S.make_schedule(kind, 0, prefill_members=pre(S),
                                kv_tiles=tiles),
                JS.make_schedule(kind, 0, prefill_members=pre(JS),
                                 kv_tiles=tiles))
    return S.make_schedule(kind, n, **kw), JS.make_schedule(kind, n, **kw)


def _cases(kind):
    """(n, kwargs) the sweep covers for ``kind``."""
    if kind == "rec":
        return [(m * 2 ** k, {"m": m}) for m in (1, 3) for k in range(7)
                if m * 2 ** k <= N_MAX]
    if kind == "band":
        return [(n, {"w": w}) for n in range(1, N_MAX + 1) for w in (1, 3)]
    if kind == "prefix":
        return [(n, {"p": p}) for n in range(1, N_MAX + 1) for p in (1, 4)]
    return [(n, {}) for n in range(1, N_MAX + 1)]


def _jnp_cols(coords):
    return np.stack([np.asarray(c).astype(np.int64) for c in coords], 1)


@pytest.mark.parametrize("kind", KINDS)
def test_counts_host_map_and_segments_match_reference(kind):
    for n, kw in _cases(kind):
        mine, ref = _pair(kind, n, **kw)
        ctx = f"{kind} n={n} {kw}"
        assert (mine.num_blocks, mine.domain_blocks, mine.rank) == \
            (ref.num_blocks, ref.domain_blocks, ref.rank), ctx
        if kind in THREE_D and n not in HOST_NS[:6]:
            continue
        lams = range(mine.num_blocks)
        if kind == "rec":
            assert mine.enumerate_host() == ref.enumerate_host(), ctx
            continue
        assert [mine.host_map(l) for l in lams] == \
            [tuple(int(c) for c in ref.host_map(l)) for l in lams], ctx
        if kind in ("rb",):
            assert [mine.host_active(l) for l in lams] == \
                [ref.host_active(l) for l in lams], ctx
        if kind not in SEGMENTED:
            continue
        if kind in ("packed", "mixed"):
            want_s = [ref.host_seg_start(l) for l in lams]
            want_e = [ref.host_seg_end(l) for l in lams]
        else:
            want_s = [bool(ref.seg_start(l)) for l in lams]
            want_e = [bool(ref.seg_end(l)) for l in lams]
        assert [bool(mine.seg_start(l)) for l in lams] == want_s, ctx
        assert [bool(mine.seg_end(l)) for l in lams] == want_e, ctx
        t = torch.arange(mine.num_blocks, dtype=torch.int32)
        assert mine.seg_start(t).tolist() == want_s, ctx
        assert mine.seg_end(t).tolist() == want_e, ctx


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "rec"])
def test_tensor_index_map_matches_reference_jnp(kind):
    kw = {"w": 3} if kind == "band" else {"p": 4} if kind == "prefix" \
        else {}
    pairs = [_pair(kind, n, **kw) for n in HOST_NS]
    # one lambda length for every n (eager jnp compiles each op once a
    # shape); each schedule is read on its own num_blocks
    width = max(mine.num_blocks for mine, _ in pairs)
    lam = np.arange(width, dtype=np.int32)
    for n, (mine, ref) in zip(HOST_NS, pairs):
        nb = mine.num_blocks
        got = mine.index_map(torch.as_tensor(lam[:nb]))
        assert all(c.dtype == torch.int32 for c in got), kind
        want = _jnp_cols(ref.index_map(jnp.asarray(lam)))[:nb]
        np.testing.assert_array_equal(
            np.stack([c.numpy().astype(np.int64) for c in got], 1), want,
            err_msg=f"{kind} n={n}")
        if kind in ("bb", "dense", "bb3", "dense3d", "rb"):
            np.testing.assert_array_equal(
                mine.active(torch.as_tensor(lam[:nb])).numpy(),
                np.asarray(ref.active(jnp.asarray(lam)))[:nb],
                err_msg=f"{kind} n={n}")
        if kind in SEGMENTED and kind not in ("packed", "mixed"):
            for fn in ("seg_start", "seg_end"):
                np.testing.assert_array_equal(
                    getattr(mine, fn)(torch.as_tensor(lam[:nb])).numpy(),
                    np.asarray(getattr(ref, fn)(jnp.asarray(lam)))[:nb],
                    err_msg=f"{kind}.{fn} n={n}")


@pytest.mark.parametrize("lens,window,prefix", [
    ([32, 16, 48], [None, 24, None], [0, 0, 16]),
    ([64], None, 0),
    ([16, 16, 16, 16], 20, 0),
    ([48, 32, 80], None, [40, 3, 0]),
])
def test_packed_offsets_equal_the_kernel_tables(lens, window, prefix):
    psched = OPS.make_packed_sched(lens, block=16, window=window,
                                   prefix=prefix)
    members = []
    for m in psched.members:
        members.append(S.BandSchedule(n=m.n, w=m.w_b) if m.kind == "band"
                       else S.PrefixSchedule(n=m.n, p=m.p_b)
                       if m.kind == "prefix" else S.TriangularSchedule(n=m.n))
    sched = S.make_schedule("packed", 0, members=members)
    tbl = psched.table()
    assert tuple(tbl[0]) == sched.offsets[:-1]
    assert tuple(tbl[1]) == sched.row_offsets[:-1]
    assert sched.num_blocks == psched.steps
    assert sched.row_offsets[-1] == psched.total_tiles
    # the member parameters the kernels read (rows 2-4) are _member_params
    assert [tuple(c) for c in tbl[2:5].T] == \
        [P._member_params(m) for m in members]


def test_packed_inverse_and_padded_bb_match_reference():
    for total in (1, 7, 30):
        mine, ref = _pair("packed", total)
        for lam in range(mine.num_blocks):
            r, i, j = mine.host_map(lam)
            assert mine.pack_lambda(r, i, j) == lam
            assert P._member_inverse(mine.members[r], i, j) == \
                JP._member_inverse(ref.members[r], i, j)
        assert P.padded_bb_blocks(mine.members) == \
            JP.padded_bb_blocks(ref.members)


def test_registry_refusals_match_reference():
    for mod in (S, JS):
        with pytest.raises(ValueError):
            mod.make_schedule("packed", 5,
                              members=(mod.TriangularSchedule(n=2),))
        with pytest.raises(ValueError):
            mod.make_schedule("mixed", 0, prefill_members=(
                mod.RowSchedule(n=2),), kv_tiles=(1,))
        with pytest.raises(KeyError):
            mod.make_schedule("hexagonal", 4)
    with pytest.raises(ValueError, match="diagonal"):
        S.make_schedule("packed", 0, members=(
            S.TriangularSchedule(n=3, include_diagonal=False),))
