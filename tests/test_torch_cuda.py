"""CUDA kernels of repro_torch held against their plain PyTorch versions.

These tests need an NVIDIA card (sm_90a) and nvcc: they carry the ``cuda``
marker and skip where torch.cuda.is_available() is false. On the card
run them with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest`` because the shared conftest imports JAX, which the card's
machine does not have). Inputs come from a numpy seed; tolerances are the
repo's attention policy (tests/oracles.py): f32 2e-5, bf16 2e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import mapping as M
from repro_torch.core import packing as PK
from repro_torch.kernels import build as BUILD
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    BUILD.build_all()
    return torch.device("cuda")


def _close(got, want, dtype, msg=""):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), err_msg=msg,
                               **TOL[dtype])


def _rand(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                           device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blk,d,h,hkv", [(16, 16, 4, 4), (16, 32, 4, 2),
                                         (32, 64, 8, 2), (64, 128, 32, 4),
                                         (128, 128, 8, 1)])
def test_packed_fwd_matches_plain(dev, dtype, blk, d, h, hkv):
    rng = np.random.default_rng(blk + d + h)
    lens = [5 * blk, 2 * blk, 3 * blk, blk]
    psched = OPS.make_packed_sched(lens, block=blk,
                                   window=[None, None, blk + 3, None],
                                   prefix=[0, blk + 1, 0, 0])
    s = psched.s_total
    q = _rand(rng, (1, h, s, d), dtype, dev)
    k = _rand(rng, (1, hkv, s, d), dtype, dev)
    v = _rand(rng, (1, hkv, s, d), dtype, dev)
    before = K.packed_fwd.launches
    out, lse = K.packed_fwd(q, k, v, psched)
    torch.cuda.synchronize()
    assert K.packed_fwd.launches == before + 1
    want_out, want_lse = K.packed_fwd(q.cpu(), k.cpu(), v.cpu(), psched)
    _close(out, want_out, dtype, "out")
    _close(lse, want_lse, torch.float32 if dtype == torch.float32
           else torch.bfloat16, "lse")


@pytest.mark.parametrize("q_dtype,c_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
# (128, 128) with an f32 cache takes the single-buffered path (two tiles
# of K and V would exceed shared memory)
@pytest.mark.parametrize("blk,d,h,hkv", [(16, 16, 4, 2), (32, 32, 8, 2),
                                         (64, 128, 32, 4), (128, 64, 8, 1),
                                         (128, 128, 8, 2)])
def test_packed_decode_matches_plain(dev, q_dtype, c_dtype, blk, d, h, hkv):
    rng = np.random.default_rng(7)
    b, s_cache = 5, 8 * blk
    kv_lens, slots = [8 * blk, 3, 2 * blk + 5, blk], [0, 2, 3, 4]
    window = [None, None, blk + 2, None]  # slot 3 band-limited, kv_first > 0
    tbl_np, needed = OPS.make_decode_table(kv_lens, slots, blk=blk,
                                           n_members=b + 2, n_slots=b,
                                           s_cache=s_cache, window=window)
    tbl = torch.as_tensor(tbl_np, device=dev)
    q = _rand(rng, (b, h, d), q_dtype, dev)
    kc = _rand(rng, (b, s_cache, hkv, d), c_dtype, dev)
    vc = _rand(rng, (b, s_cache, hkv, d), c_dtype, dev)
    spec = OPS.DecodeRoundSpec(n_members=b + 2, capacity=needed + 3,
                               blk=blk, impl="cuda", tiles=needed)
    got = OPS.packed_decode_attention(q, kc, vc, tbl, spec)
    torch.cuda.synchronize()
    want = OPS.packed_decode_attention(
        q, kc, vc, tbl, OPS.DecodeRoundSpec(b + 2, needed + 3, blk, "torch",
                                            needed))
    _close(got, want, q_dtype if q_dtype == torch.bfloat16
           else c_dtype)
    assert torch.count_nonzero(got[1]) == 0  # retired slot: zeros


def test_decode_empty_columns_do_not_touch_slot_zero(dev):
    """Empty member columns carry slot 0: the kernel must not write slot
    0's output row for them (nor may the pad member write anything)."""
    blk, d, h, hkv, b = 16, 16, 4, 2, 3
    rng = np.random.default_rng(3)
    tbl_np, needed = OPS.make_decode_table([17], [0], blk=blk, n_members=6,
                                           n_slots=b)
    tbl = torch.as_tensor(tbl_np, device=dev)
    q = _rand(rng, (b, h, d), torch.float32, dev)
    kc = _rand(rng, (b, 4 * blk, hkv, d), torch.float32, dev)
    vc = _rand(rng, (b, 4 * blk, hkv, d), torch.float32, dev)
    full = K.packed_decode_fwd(q, kc, vc, tbl, capacity=8, blk=blk,
                               tiles=needed)
    want = OPS.packed_decode_attention(
        q, kc, vc, tbl, OPS.DecodeRoundSpec(6, 8, blk, "ref", needed))
    _close(full[0], want[0], torch.float32)


def test_device_member_map_equals_torch(dev):
    for n in range(1, 65):
        for w, p in [(n, 0), (max(1, n // 3), 0), (n, max(1, n // 2))]:
            steps = M.band_blocks(n, w) if p == 0 \
                else M.prefix_full_blocks(n, p)
            lam = torch.arange(steps, dtype=torch.int32)
            wi, wj = PK.member_map_params(lam, n, w, p)
            gi, gj = K.member_map_device(lam.to(dev), n, w, p)
            assert torch.equal(gi.cpu(), wi.to(torch.int32)), (n, w, p)
            assert torch.equal(gj.cpu(), wj.to(torch.int32)), (n, w, p)
    top = M.LTM_TRACED_MAX_LAM
    lam = torch.arange(top - 4096, top + 1, dtype=torch.int32)
    n = M.LTM_TRACED_MAX_I + 2  # band head tri(n - 1) covers lam <= top
    wi, wj = PK.member_map_params(lam, n, n, 0)
    gi, gj = K.member_map_device(lam.to(dev), n, n, 0)
    assert torch.equal(gi.cpu(), wi) and torch.equal(gj.cpu(), wj)
    assert int(gi[-1]) == M.LTM_TRACED_MAX_I


@pytest.mark.parametrize("kernel", ["packed_fwd", "packed_decode_fwd"])
def test_engine_raises_when_a_kernel_fails(dev, monkeypatch, kernel):
    """A kernel that raises on the card stops the engine: no rung falls
    back to the plain version, nothing is degraded or retried."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Engine, EngineStepError

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device=dev)
    eng = Engine(params, cfg, slots=2, max_len=64, device=dev)
    rng = np.random.default_rng(1)
    for uid, s in enumerate((20, 7, 33)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=s), max_new=3,
                   uid=uid)
    monkeypatch.setattr(K, kernel, boom)
    with pytest.raises(EngineStepError, match="kernel launch failed"):
        eng.run()
    st = eng.stats
    assert st["launches_degraded_total"] == st["requests_retried_total"] \
        == st["decode_lockstep_launches"] == 0


def _fused_case(rng, dev, *, blk, d, g, hkv, q_dtype, c_dtype, b=5,
                kv_lens=None, slots=None, window=None, n_members=None):
    """A fused round: four prefill members (ltm, band, prefix, ltm) and
    the given live decode slots over an S_cache = 4 * blk cache."""
    h, s_cache = g * hkv, 4 * blk
    psched = OPS.make_packed_sched(
        [3 * blk, 2 * blk, blk, blk], block=blk,
        window=[None, blk + 3, None, None], prefix=[0, 0, blk // 2 + 1, 0])
    kv_lens = [4 * blk, 3, 2 * blk + 5] if kv_lens is None else kv_lens
    slots = [0, 2, 3] if slots is None else slots
    n_members = n_members or len(psched.members) + b + 1
    tbl_np, needed = OPS.make_fused_table(
        psched, kv_lens, slots, blk=blk, n_members=n_members, n_slots=b,
        s_cache=s_cache, window=window)
    s = psched.s_total
    ins = (_rand(rng, (1, h, s, d), q_dtype, dev),
           _rand(rng, (1, hkv, s, d), q_dtype, dev),
           _rand(rng, (1, hkv, s, d), q_dtype, dev),
           _rand(rng, (b, h, d), q_dtype, dev),
           _rand(rng, (b, s_cache, hkv, d), c_dtype, dev),
           _rand(rng, (b, s_cache, hkv, d), c_dtype, dev),
           torch.as_tensor(tbl_np, device=dev))
    spec = OPS.FusedStepSpec(n_members=n_members, capacity=needed + 3,
                             blk=blk, impl="cuda", tiles=needed)
    return psched, ins, spec


@pytest.mark.parametrize("q_dtype,c_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("g,hkv", [(1, 2), (8, 1)])
@pytest.mark.parametrize("blk", [16, 64, 128])
@pytest.mark.parametrize("d", [64, 128])
def test_fused_step_matches_plain(dev, d, blk, g, hkv, q_dtype, c_dtype):
    rng = np.random.default_rng(blk + d + g)
    psched, ins, spec = _fused_case(rng, dev, blk=blk, d=d, g=g, hkv=hkv,
                                    q_dtype=q_dtype, c_dtype=c_dtype,
                                    window=[None, None, blk + 2])
    before = K.fused_step_fwd.launches
    got_p, got_d = OPS.fused_step_attention(*ins, psched, spec)
    torch.cuda.synchronize()
    assert K.fused_step_fwd.launches == before + 1
    want_p, want_d = OPS.fused_step_attention(
        *ins, psched, dataclasses.replace(spec, impl="torch"))
    tol = torch.bfloat16 if torch.bfloat16 in (q_dtype, c_dtype) \
        else torch.float32
    _close(got_p, want_p, q_dtype, "pack half")
    _close(got_d, want_d, tol, "decode half")
    for retired in (1, 4):  # no live decode member: zeros
        assert torch.count_nonzero(got_d[retired]) == 0


def test_fused_step_without_live_slots_writes_no_decode_row(dev,
                                                           monkeypatch):
    """The first admit round of every run has only empty and pad decode
    columns: the launch runs the prefill half and leaves o_dec as it
    found it (here: filled with 7 where the wrapper allocates it)."""
    blk, d = 16, 64
    rng = np.random.default_rng(11)
    psched, ins, spec = _fused_case(rng, dev, blk=blk, d=d, g=2, hkv=2,
                                    q_dtype=torch.float32,
                                    c_dtype=torch.float32, kv_lens=[],
                                    slots=[])
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: empty(*a, **k).fill_(7.0))
    o_pack, o_dec = K.fused_step_fwd(*ins, psched=psched,
                                     capacity=spec.capacity,
                                     tiles=spec.tiles)
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert bool((o_dec == 7.0).all())
    want, _ = K.packed_fwd(*ins[:3], psched)
    assert torch.equal(o_pack, want)


def test_fused_step_empty_columns_do_not_touch_slot_zero(dev):
    """Unused decode columns carry slot 0 and the pad member slot B: only
    the live member may write slot 0's row."""
    blk, d = 16, 64
    rng = np.random.default_rng(12)
    psched, ins, spec = _fused_case(rng, dev, blk=blk, d=d, g=2, hkv=2,
                                    q_dtype=torch.float32,
                                    c_dtype=torch.float32, b=3,
                                    kv_lens=[17], slots=[0], n_members=10)
    _, o_dec = K.fused_step_fwd(*ins, psched=psched, capacity=spec.capacity,
                                tiles=spec.tiles)
    _, want = OPS.fused_step_attention(
        *ins, psched, dataclasses.replace(spec, impl="ref"))
    _close(o_dec[0], want[0], torch.float32)


@pytest.mark.parametrize("q_dtype,c_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32)])
def test_fused_halves_equal_the_split_kernels(dev, q_dtype, c_dtype):
    """The prefill half runs packed_fwd's body at its thread count: bitwise
    equal. The decode half runs packed_decode's body at 256 threads
    against 512: equal within the tolerance."""
    blk, d, g, hkv, b = 64, 128, 8, 2, 5
    rng = np.random.default_rng(13)
    kv_lens, slots = [4 * blk, 3, 2 * blk + 5], [0, 2, 3]
    psched, ins, spec = _fused_case(rng, dev, blk=blk, d=d, g=g, hkv=hkv,
                                    q_dtype=q_dtype, c_dtype=c_dtype,
                                    kv_lens=kv_lens, slots=slots)
    o_pack, o_dec = K.fused_step_fwd(*ins, psched=psched,
                                     capacity=spec.capacity,
                                     tiles=spec.tiles)
    split_pack, _ = K.packed_fwd(*ins[:3], psched)
    assert torch.equal(o_pack, split_pack)
    dtbl, dneeded = OPS.make_decode_table(kv_lens, slots, blk=blk,
                                          n_members=b + 1, n_slots=b,
                                          s_cache=4 * blk)
    split_dec = K.packed_decode_fwd(
        ins[3], ins[4], ins[5], torch.as_tensor(dtbl, device=dev),
        capacity=dneeded, blk=blk, tiles=dneeded)
    torch.cuda.synchronize()
    _close(o_dec[slots], split_dec[slots], q_dtype)


def test_fused_engine_raises_when_the_fused_kernel_fails(dev, monkeypatch):
    """A failing fused kernel stops the fused engine: no fused -> split
    rung, no plain version, nothing degraded or retried."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Engine, EngineStepError

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device=dev)
    eng = Engine(params, cfg, slots=2, max_len=64, step_mode="fused",
                 device=dev)
    rng = np.random.default_rng(1)
    for uid, s in enumerate((20, 7, 33)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=s), max_new=3,
                   uid=uid)
    monkeypatch.setattr(K, "fused_step_fwd", boom)
    with pytest.raises(EngineStepError, match="kernel launch failed") as info:
        eng.run()
    assert info.value.phase == "fused"
    st = eng.stats
    assert st["launches_degraded_total"] == st["requests_retried_total"] \
        == st["fused_fallbacks"] == st["prefill_launches"] == 0
    assert sorted(r.uid for r in eng.queue) == [0, 1, 2]


# ---------------------------------------------------------------------------
# Training path: tri_attn.fwd (csrc/tri_fwd.cu) and tri_attn.bwd dq, dk/dv
# (csrc/tri_bwd.cu). Grads are held at the attn_grad tolerance of
# tests/oracles.py in float32 (the kernels sum in another order than the
# plain version), at the bf16 attention tolerance in bfloat16.
# ---------------------------------------------------------------------------

GRAD_TOL = {torch.float32: dict(atol=2e-4, rtol=2e-3),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}
TRI_KINDS = {"ltm": lambda blk: (None, 0), "band": lambda blk: (blk + 5, 0),
             "prefix": lambda blk: (None, blk + 3)}


def _tri_case(dev, kind, blk, d, g, hkv, dtype, n=5, b=2):
    rng = np.random.default_rng(blk + d + g + hkv + n)
    h, s = g * hkv, n * blk
    window, prefix = TRI_KINDS[kind](blk)
    sched = OPS.make_sched(s, block=blk, window=window, prefix=prefix)
    q, k, v, do = (_rand(rng, shape, dtype, dev) for shape in
                   ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d),
                    (b, h, s, d)))
    return sched, q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hkv", [(1, 2), (2, 2), (8, 1)])
@pytest.mark.parametrize("blk,d", [(16, 64), (64, 128)])
@pytest.mark.parametrize("kind", ["ltm", "band", "prefix"])
def test_tri_fwd_and_bwd_match_plain(dev, kind, blk, d, g, hkv, dtype):
    from repro_torch.kernels.tri_attn import scan_impl as SC

    sched, q, k, v, do = _tri_case(dev, kind, blk, d, g, hkv, dtype)
    scale = d ** -0.5
    before = (K.fwd.launches, K.bwd_dq.launches, K.bwd_dkv.launches)
    out, lse = K.fwd(q, k, v, sched)
    dq, dk, dv = K.bwd(q, k, v, out, lse, do, sched)
    torch.cuda.synchronize()
    assert (K.fwd.launches, K.bwd_dq.launches, K.bwd_dkv.launches) == \
        tuple(x + 1 for x in before)
    want_out, want_lse = SC.fwd_torch(q, k, v, sched, scale)
    _close(out, want_out, dtype, "out")
    _close(lse, want_lse, dtype, "lse")
    want = SC.bwd_torch(q, k, v, out, lse, do, sched, scale)
    delta = (do.float() * out.float()).sum(dim=-1)
    assert torch.equal(K.bwd_dq(q, k, v, do, lse, delta, sched), dq)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), err_msg=name,
                                   **GRAD_TOL[dtype])


def test_tri_bwd_is_deterministic(dev):
    """No atomics: the same inputs give bitwise-equal grads."""
    sched, q, k, v, do = _tri_case(dev, "ltm", 64, 128, 8, 1,
                                   torch.bfloat16)
    out, lse = K.fwd(q, k, v, sched)
    first = K.bwd(q, k, v, out, lse, do, sched)
    again = K.bwd(q, k, v, out, lse, do, sched)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("kind", ["ltm", "band", "prefix"])
def test_triangular_attention_cuda_grads_match_ref(dev, kind):
    """Autograd through impl='cuda' (the kernels' custom backward) against
    autograd through the port's full-matrix oracle."""
    blk, d = 16, 32
    sched, q, k, v, do = _tri_case(dev, kind, blk, d, 2, 2, torch.float32)
    window, prefix = TRI_KINDS[kind](blk)
    grads = {}
    for impl in ("cuda", "ref"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = OPS.triangular_attention(*leaves, window=window, prefix=prefix,
                                       impl=impl, block=blk)
        out.backward(do)
        grads[impl] = (out.detach(),) + tuple(x.grad for x in leaves)
    _close(grads["cuda"][0], grads["ref"][0], torch.float32, "out")
    for got, want, name in zip(grads["cuda"][1:], grads["ref"][1:], "qkv"):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   err_msg=f"d{name}",
                                   **GRAD_TOL[torch.float32])


@pytest.mark.parametrize("fn", ["tri_fwd_launch", "tri_bwd_dq_launch",
                                "tri_bwd_dkv_launch"])
def test_tri_failing_launch_raises(dev, monkeypatch, fn):
    """A launch CUDA refuses (non-zero cudaGetLastError) raises and
    is not counted; nothing falls back to the plain version."""
    sched, q, k, v, do = _tri_case(dev, "ltm", 16, 32, 2, 2, torch.float32)
    out, lse = K.fwd(q, k, v, sched)
    lib = BUILD.load("tri_fwd" if fn == "tri_fwd_launch" else "tri_bwd")
    monkeypatch.setattr(lib, fn, lambda *a: 9)
    before = (K.fwd.launches, K.bwd_dq.launches, K.bwd_dkv.launches)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        if fn == "tri_fwd_launch":
            K.fwd(q, k, v, sched)
        else:
            K.bwd(q, k, v, out, lse, do, sched)
    after = (K.fwd.launches, K.bwd_dq.launches, K.bwd_dkv.launches)
    if fn == "tri_bwd_dkv_launch":  # dq launched before dk/dv failed
        assert after == (before[0], before[1] + 1, before[2])
    else:
        assert after == before


# ---------------------------------------------------------------------------
# Packed document training: tri_attn.packed_bwd dq and dk/dv
# (csrc/packed_bwd.cu) on a mixed member zoo (ltm, prefix, band, short
# ltm in one launch), at the tolerances of the training kernels above.
# ---------------------------------------------------------------------------

PACKED_D = {16: 64, 32: 64, 64: 128, 128: 128}


def _packed_case(dev, blk, g, hkv, dtype, b=2):
    rng = np.random.default_rng(blk + g + hkv)
    d, h = PACKED_D[blk], g * hkv
    psched = OPS.make_packed_sched([5 * blk, 2 * blk, 3 * blk, blk],
                                   block=blk,
                                   window=[None, None, blk + 3, None],
                                   prefix=[0, blk + 1, 0, 0])
    s = psched.s_total
    q, k, v, do = (_rand(rng, shape, dtype, dev) for shape in
                   ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d),
                    (b, h, s, d)))
    return psched, q, k, v, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hkv", [(1, 2), (2, 2), (8, 1)])
@pytest.mark.parametrize("blk", [16, 32, 64, 128])
def test_packed_bwd_matches_plain(dev, blk, g, hkv, dtype):
    from repro_torch.kernels.tri_attn import scan_impl as SC

    psched, q, k, v, do = _packed_case(dev, blk, g, hkv, dtype)
    scale = q.shape[-1] ** -0.5
    out, lse = K.packed_fwd(q, k, v, psched)
    before = (K.packed_bwd_dq.launches, K.packed_bwd_dkv.launches)
    dq, dk, dv = K.packed_bwd(q, k, v, out, lse, do, psched)
    torch.cuda.synchronize()
    assert (K.packed_bwd_dq.launches, K.packed_bwd_dkv.launches) == \
        (before[0] + 1, before[1] + 1)
    want = SC.packed_bwd_torch(q, k, v, out, lse, do, psched, scale)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), err_msg=name,
                                   **GRAD_TOL[dtype])


def test_packed_bwd_is_deterministic(dev):
    """No atomics: the same inputs give bitwise-equal grads."""
    psched, q, k, v, do = _packed_case(dev, 64, 8, 1, torch.bfloat16)
    out, lse = K.packed_fwd(q, k, v, psched)
    first = K.packed_bwd(q, k, v, out, lse, do, psched)
    again = K.packed_bwd(q, k, v, out, lse, do, psched)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_packed_attention_cuda_grads_match_ref(dev):
    """Autograd through packed_prefill_attention(impl='cuda') (forward,
    dq and dk/dv kernels, three launches) against autograd through the
    port's full-matrix oracle."""
    psched, q, k, v, do = _packed_case(dev, 16, 2, 2, torch.float32)
    grads = {}
    for impl in ("cuda", "ref"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = {n: f.launches for n, f in K.WRAPPERS.items()}
        out = OPS.packed_prefill_attention(*leaves, psched, impl=impl)
        out.backward(do)
        moved = {n: f.launches - before[n] for n, f in K.WRAPPERS.items()
                 if f.launches != before[n]}
        assert moved == ({"tri_attn.packed_fwd": 1,
                          "tri_attn.packed_bwd_dq": 1,
                          "tri_attn.packed_bwd_dkv": 1}
                         if impl == "cuda" else {}), moved
        grads[impl] = (out.detach(),) + tuple(x.grad for x in leaves)
    _close(grads["cuda"][0], grads["ref"][0], torch.float32, "out")
    for got, want, name in zip(grads["cuda"][1:], grads["ref"][1:], "qkv"):
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   err_msg=f"d{name}",
                                   **GRAD_TOL[torch.float32])


@pytest.mark.parametrize("fn", ["packed_bwd_dq_launch",
                                "packed_bwd_dkv_launch"])
def test_packed_bwd_failing_launch_raises(dev, monkeypatch, fn):
    """A launch CUDA refuses raises and is not counted; nothing falls back
    to the plain version."""
    psched, q, k, v, do = _packed_case(dev, 16, 2, 2, torch.float32)
    out, lse = K.packed_fwd(q, k, v, psched)
    monkeypatch.setattr(BUILD.load("packed_bwd"), fn, lambda *a: 9)
    before = (K.packed_bwd_dq.launches, K.packed_bwd_dkv.launches)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        K.packed_bwd(q, k, v, out, lse, do, psched)
    after = (K.packed_bwd_dq.launches, K.packed_bwd_dkv.launches)
    if fn == "packed_bwd_dkv_launch":  # dq launched before dk/dv failed
        assert after == (before[0] + 1, before[1])
    else:
        assert after == before


def test_packed_training_step_on_the_card(dev):
    """Smoke-size float32 packed training: kernels and plain versions give
    the same losses over 2 steps, and the step launches the packed
    kernels only."""
    import copy

    from repro_torch.configs import registry as REG
    from repro_torch.train import data as DATA
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    cfg = REG.smoke_config("yi-9b")
    docs = DATA.PackedDocsLM(cfg, (41, 7, 23, 3), block=16, seed=0,
                             device=dev)
    psched = OPS.make_packed_sched(docs.member_lens, block=16)
    opt = OPT.OptConfig()
    base = TS.init_state(cfg, opt, seed=0, device=dev)
    losses = {}
    for impl in ("cuda", "torch"):
        step = TS.make_train_step(cfg, opt, attn_impl=impl, block=16,
                                  packed=psched)
        state = copy.deepcopy(base)
        before = {n: f.launches for n, f in K.WRAPPERS.items()}
        losses[impl] = []
        for i in range(2):
            state, m = step(state, docs.batch(i))
            losses[impl].append(float(m["loss"]))
        moved = {n: f.launches - before[n] for n, f in K.WRAPPERS.items()
                 if f.launches != before[n]}
        layers = cfg.n_layers
        assert moved == ({"tri_attn.packed_fwd": 4 * layers,
                          "tri_attn.packed_bwd_dq": 2 * layers,
                          "tri_attn.packed_bwd_dkv": 2 * layers}
                         if impl == "cuda" else {}), moved
    np.testing.assert_allclose(losses["cuda"], losses["torch"], rtol=1e-5)


# ---------------------------------------------------------------------------
# The paper's experiment: tri_edm.edm_ltm, edm_bb and dummy_ltm
# (csrc/tri_edm.cu) and tri_attn.fwd_bb (csrc/fwd_bb.cu), against their
# plain versions. EDM tolerances are tests/oracles.py's edm policy (f32
# atol 2e-3 rtol 1e-4, bf16 5e-2, squared 1e-5); the diagonal
# self-distances and BB's upper tiles must be exact zeros.
# ---------------------------------------------------------------------------

EDM_TOL = {(torch.float32, False): dict(atol=2e-3, rtol=1e-4),
           (torch.float32, True): dict(atol=1e-5, rtol=1e-5),
           (torch.bfloat16, False): dict(atol=5e-2, rtol=5e-2)}


def _points(dev, n_rows, d, dtype, seed=0):
    rng = np.random.default_rng(seed + n_rows + d)
    return _rand(rng, (n_rows, d), dtype, dev)


def _diag_zero(packed, n):
    """The self-distances of the diagonal tiles of a packed EDM."""
    lam = torch.tensor([M.tri(i) + i for i in range(n)], device=packed.device)
    return torch.diagonal(packed[lam], dim1=-2, dim2=-1)


@pytest.mark.parametrize("dtype,squared", [(torch.float32, False),
                                           (torch.float32, True),
                                           (torch.bfloat16, False)])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
def test_edm_ltm_matches_plain(dev, block, d, dtype, squared):
    from repro_torch.kernels.tri_edm import kernel as EK

    n = 6
    x = _points(dev, n * block, d, dtype)
    before = EK.edm_ltm.launches
    got = EK.edm_ltm(x, block, squared=squared)
    torch.cuda.synchronize()
    assert EK.edm_ltm.launches == before + 1
    want = EK.edm_ltm_torch(x, block, squared=squared)
    assert got.shape == want.shape == (M.tri(n), block, block)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **EDM_TOL[(dtype, squared)])
    assert torch.count_nonzero(_diag_zero(got, n)) == 0


@pytest.mark.parametrize("dtype,squared", [(torch.float32, False),
                                           (torch.float32, True),
                                           (torch.bfloat16, False)])
@pytest.mark.parametrize("d", [1, 3, 16])
@pytest.mark.parametrize("block", [8, 16, 32, 64, 128])
def test_edm_bb_matches_plain(dev, block, d, dtype, squared):
    from repro_torch.kernels.tri_edm import kernel as EK
    from repro_torch.kernels.tri_edm import ref as ER

    n = 5
    x = _points(dev, n * block, d, dtype, seed=1)
    before = EK.edm_bb.launches
    got = EK.edm_bb(x, block, squared=squared)
    torch.cuda.synchronize()
    assert EK.edm_bb.launches == before + 1
    want = EK.edm_bb_torch(x, block, squared=squared)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **EDM_TOL[(dtype, squared)])
    tiles = got.reshape(n, block, n, block).permute(0, 2, 1, 3)
    for i in range(n):
        assert torch.count_nonzero(tiles[i, i + 1:]) == 0
        assert torch.count_nonzero(torch.diagonal(tiles[i, i])) == 0
    # the BB lower tiles are the LTM kernel's tiles, bit for bit
    assert torch.equal(EK.edm_ltm(x, block, squared=squared),
                       tiles[ER.tile_coords(n, dev)])


@pytest.mark.parametrize("n", [1, 2, 8, 300, 2000])
def test_dummy_ltm_matches_plain(dev, n):
    from repro_torch.kernels.tri_edm import kernel as EK

    before = EK.dummy_ltm.launches
    got = EK.dummy_ltm(n, device=dev)
    torch.cuda.synchronize()
    assert EK.dummy_ltm.launches == before + 1
    assert got.shape == (M.tri(n), 1) and got.dtype == torch.float32
    assert torch.equal(got, EK.dummy_ltm_torch(n, dev))


def test_edm_op_on_the_card(dev):
    """ops.edm through every impl on one input: cuda == torch and bb ==
    bb_torch within tolerance, packed LTM == pack_tri of BB's lower
    tiles, and the oracle agrees."""
    from repro_torch.kernels.tri_edm import ops as EOPS

    x = _points(dev, 256, 3, torch.float32, seed=2)
    packed = EOPS.edm(x, 32, impl="cuda")
    full = EOPS.edm(x, 32, impl="bb")
    np.testing.assert_allclose(packed.cpu().numpy(),
                               EOPS.edm(x, 32, impl="torch").cpu().numpy(),
                               **EDM_TOL[(torch.float32, False)])
    assert torch.equal(packed, EOPS.pack_tri(full, 32))
    np.testing.assert_allclose(
        EOPS.unpack_tri(packed, 256).cpu().numpy(),
        EOPS.edm(x, 32, impl="ref").cpu().numpy(),
        **EDM_TOL[(torch.float32, False)])


BB_KINDS = {"ltm": lambda blk: None, "band": lambda blk: blk + 5,
            "band_short": lambda blk: 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hkv", [(1, 2), (2, 2), (8, 1)])
@pytest.mark.parametrize("blk,d", [(16, 64), (32, 64), (64, 128),
                                   (128, 128)])
@pytest.mark.parametrize("kind", ["ltm", "band", "band_short"])
def test_fwd_bb_matches_plain_and_tri_fwd(dev, kind, blk, d, g, hkv, dtype):
    from repro_torch.kernels.tri_attn import scan_impl as SC

    n, b = 5, 2
    rng = np.random.default_rng(blk + d + g + hkv)
    h, s = g * hkv, n * blk
    sched = OPS.make_sched(s, block=blk, window=BB_KINDS[kind](blk))
    q, k, v = (_rand(rng, shape, dtype, dev) for shape in
               ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    before = K.fwd_bb.launches
    out, lse = K.fwd_bb(q, k, v, sched)
    torch.cuda.synchronize()
    assert K.fwd_bb.launches == before + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    for want_out, want_lse in (SC.fwd_bb_torch(q, k, v, sched, d ** -0.5),
                               K.fwd(q, k, v, sched)):
        _close(out, want_out, dtype, "out")
        _close(lse, want_lse, dtype, "lse")


def test_fwd_bb_is_deterministic_and_counted(dev):
    """Which block merges a row varies between runs, what it computes does
    not: two runs are bitwise equal. One launch, counted as the
    reference's n x n grid of each (batch, head)."""
    from repro_torch.obs import launch as OBS
    from repro_torch.obs import metrics as MET

    b, h, hkv, n, blk, d = 1, 8, 2, 16, 64, 128
    rng = np.random.default_rng(5)
    sched = OPS.make_sched(n * blk, block=blk)
    q, k, v = (_rand(rng, shape, torch.bfloat16, dev) for shape in
               ((b, h, n * blk, d), (b, hkv, n * blk, d),
                (b, hkv, n * blk, d)))
    reg = MET.Registry("fwd_bb")
    with MET.scope(reg):
        first = K.fwd_bb(q, k, v, sched)
        again = K.fwd_bb(q, k, v, sched)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    summ = OBS.kernel_summary(reg)["tri_attn.fwd_bb"]
    assert (summ["launches"], summ["tiles_launched"], summ["tiles_domain"],
            summ["tiles_bb"], summ["impls"]) == \
        (2, 2 * n * n * b * h, 2 * M.tri(n) * b * h, 2 * n * n * b * h,
         ["cuda"])
    out = OPS.triangular_attention(q, k, v, impl="bb", block=blk)
    assert torch.equal(out, first[0])


@pytest.mark.parametrize("fn", ["edm_ltm_launch", "edm_bb_launch",
                                "dummy_ltm_launch", "fwd_bb_launch"])
def test_paper_failing_launch_raises(dev, monkeypatch, fn):
    """A launch CUDA refuses raises and is not counted."""
    from repro_torch.kernels.tri_edm import kernel as EK

    lib = BUILD.load("fwd_bb" if fn == "fwd_bb_launch" else "tri_edm")
    monkeypatch.setattr(lib, fn, lambda *a: 9)
    x = _points(dev, 64, 3, torch.float32)
    sched = OPS.make_sched(64, block=16)
    q = _rand(np.random.default_rng(0), (1, 2, 64, 64), torch.float32, dev)
    call, wrapper = {
        "edm_ltm_launch": (lambda: EK.edm_ltm(x, 16), EK.edm_ltm),
        "edm_bb_launch": (lambda: EK.edm_bb(x, 16), EK.edm_bb),
        "dummy_ltm_launch": (lambda: EK.dummy_ltm(4, device=dev),
                             EK.dummy_ltm),
        "fwd_bb_launch": (lambda: K.fwd_bb(q, q, q, sched), K.fwd_bb)}[fn]
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="cudaError 9"):
        call()
    assert wrapper.launches == before


@pytest.mark.parametrize("impl", ["cuda", "bb"])
def test_edm_kernel_impls_refuse_cpu_tensors(impl):
    """The kernel impls never run the plain version for a CPU tensor."""
    from repro_torch.kernels.tri_edm import ops as EOPS

    x = torch.zeros((32, 3))
    with pytest.raises(ValueError, match=f"impl='{impl}' needs CUDA"):
        EOPS.edm(x, 8, impl=impl)
