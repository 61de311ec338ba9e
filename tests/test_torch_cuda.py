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


# D 192 (nemotron-4) at g 1 and 12 at every edge: wgmma m64n192k16 at 64
# and 128 (one K/V stage at 128), mma.sync at 16 and 32
D192_PACKED = [(blk, 192, h, hkv) for blk in (16, 32, 64, 128)
               for h, hkv in ((2, 2), (12, 1))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("blk,d,h,hkv", [(16, 16, 4, 4), (16, 32, 4, 2),
                                         (32, 64, 8, 2), (64, 128, 32, 4),
                                         (128, 128, 8, 1)] + D192_PACKED)
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


def _packed_fwd_case(dev, blk, d, g, hkv):
    rng = np.random.default_rng(blk + d + g)
    psched = OPS.make_packed_sched([5 * blk, 2 * blk, 3 * blk, blk],
                                   block=blk,
                                   window=[None, None, blk + 3, 3],
                                   prefix=[0, blk + 1, 0, 0])
    s = psched.s_total
    return psched, [_rand(rng, shape, torch.bfloat16, dev) for shape in
                    ((1, g * hkv, s, d), (1, hkv, s, d), (1, hkv, s, d))]


@pytest.mark.parametrize("blk,d", [(64, 128), (128, 64), (128, 128),
                                   (64, 192), (128, 192)])
def test_packed_fwd_is_deterministic(dev, blk, d):
    """One block per accumulator owner on the bf16 wgmma body, no atomics:
    two runs are bitwise equal, and finite."""
    psched, (q, k, v) = _packed_fwd_case(dev, blk, d, 8, 1)
    first = K.packed_fwd(q, k, v, psched)
    again = K.packed_fwd(q, k, v, psched)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(bool(torch.isfinite(x.float()).all()) for x in first)


def _misaligned(x):
    """x's values in a contiguous tensor 2 bytes off a 16-byte boundary."""
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype,
                          device=x.device)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    return shifted


@pytest.mark.parametrize("blk", [16, 64])  # mma.sync (cp.async) and wgmma
@pytest.mark.parametrize("arg", range(3))
def test_packed_fwd_misaligned_bf16_raises(dev, blk, arg):
    """The bf16 tensor-core body copies q, k, v 16 bytes at a time (TMA or
    cp.async): a contiguous operand 2 bytes off a 16-byte boundary is
    refused with cudaErrorMisalignedAddress and not counted; nothing falls
    back to the CUDA-core body."""
    psched, ops = _packed_fwd_case(dev, blk, 64, 2, 2)
    ops[arg] = _misaligned(ops[arg])
    before = K.packed_fwd.launches
    with pytest.raises(RuntimeError, match="cudaError 716"):
        K.packed_fwd(*ops, psched)
    assert K.packed_fwd.launches == before


@pytest.mark.parametrize("q_dtype,c_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)])
# (64, 64, 16, 1): g = 16 query heads a kv head, two head slices of 8; at
# D 192 no thread count in use divides the 48 (f32) or 24 (bf16) columns
@pytest.mark.parametrize("blk,d,h,hkv", [(16, 16, 4, 2), (32, 32, 8, 2),
                                         (64, 128, 32, 4), (128, 64, 8, 1),
                                         (128, 128, 8, 2), (64, 64, 16, 1)]
                         + D192_PACKED)
def test_packed_decode_matches_plain(dev, q_dtype, c_dtype, blk, d, h, hkv):
    """Members across the chunk edges at every blk: a whole cache, one
    chunk exactly and one token past it, a band-limited slot whose
    kv_first is not tile-aligned and whose tiles span two chunks, short
    slots of one chunk."""
    rng = np.random.default_rng(7)
    ch = K.DECODE_CHUNK
    b, s_cache = 7, max(8 * blk, 4 * ch)
    kv_lens = [s_cache, 3, 2 * ch + 5, blk, ch, ch + 1]
    slots = [0, 2, 3, 4, 5, 6]
    # slot 3 band-limited: kv_first = ch + 2 > 0, not on a tile edge
    window = [None, None, ch + 3, None, None, None]
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


def _decode_case(rng, dev, kv_lens, slots, *, blk=64, d=128, h=32, hkv=4,
                 b=6, s_cache=1024, q_dtype=torch.bfloat16,
                 c_dtype=torch.float32, q=None, caches=None):
    """One decode round's inputs and its table (b + 1 columns); the
    queries and caches drawn from rng unless given."""
    tbl_np, needed = OPS.make_decode_table(kv_lens, slots, blk=blk,
                                           n_members=b + 1, n_slots=b,
                                           s_cache=s_cache)
    q = _rand(rng, (b, h, d), q_dtype, dev) if q is None else q
    kc, vc = caches if caches is not None else (
        _rand(rng, (b, s_cache, hkv, d), c_dtype, dev),
        _rand(rng, (b, s_cache, hkv, d), c_dtype, dev))
    return q, kc, vc, torch.as_tensor(tbl_np, device=dev), needed


def _decode_plain(q, kc, vc, tbl, blk, needed):
    from repro_torch.kernels.tri_attn import scan_impl as SC

    return SC.packed_decode_torch(q, kc, vc, tbl, capacity=needed, blk=blk,
                                  tiles=needed, scale=q.shape[-1] ** -0.5)


def test_packed_decode_is_deterministic_and_leaves_no_count(dev):
    """Two runs on the same inputs give the same bits, whichever block
    merges; three launches back to back on other tables (other chunk
    counts a member) each match the plain version, which a counter left
    nonzero by a merge would break."""
    rng = np.random.default_rng(21)
    blk = 64
    q, kc, vc, tbl, needed = _decode_case(rng, dev, [1000, 37, 900, 300],
                                          [0, 1, 2, 3])
    kw = dict(capacity=needed, blk=blk, tiles=needed)
    first = K.packed_decode_fwd(q, kc, vc, tbl, **kw)
    again = K.packed_decode_fwd(q, kc, vc, tbl, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first[:4], again[:4])
    for kv_lens, slots in (([1024, 129], [2, 5]), ([128, 600, 7], [0, 3, 4]),
                           ([513, 1000, 64, 255, 256], [1, 2, 3, 4, 5])):
        q, kc, vc, tbl, needed = _decode_case(rng, dev, kv_lens, slots)
        got = K.packed_decode_fwd(q, kc, vc, tbl, capacity=needed, blk=blk,
                                  tiles=needed)
        want = _decode_plain(q, kc, vc, tbl, blk, needed)
        _close(got[slots], want[slots], torch.bfloat16, str(kv_lens))


@pytest.mark.parametrize("blk", [16, 64, 128])
def test_packed_decode_slot_is_the_same_in_any_round(dev, blk):
    """A slot's chunking reads its own table column alone: its output is
    bitwise the same alone and among a full round, at another table
    width and column position."""
    rng = np.random.default_rng(22)
    q, kc, vc, tbl, needed = _decode_case(
        rng, dev, [1000, 37, 900, 300, 1024, 129], list(range(6)), blk=blk)
    full = K.packed_decode_fwd(q, kc, vc, tbl, capacity=needed, blk=blk,
                               tiles=needed)
    for slot, kv_len in ((0, 1000), (2, 900), (5, 129)):
        _, _, _, alone_tbl, alone_needed = _decode_case(
            rng, dev, [kv_len], [slot], blk=blk, q=q, caches=(kc, vc))
        alone = K.packed_decode_fwd(q, kc, vc, alone_tbl,
                                    capacity=alone_needed, blk=blk,
                                    tiles=alone_needed)
        torch.cuda.synchronize()
        assert torch.equal(alone[slot], full[slot]), (blk, slot)


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
    eng = Engine(params, cfg, slots=2, max_len=64, decode_mode="packed",
                 device=dev)
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


def test_auto_engine_raises_when_a_packed_round_fails(dev, monkeypatch):
    """The default engine ("auto") on the card: the first round its cost
    rule sends packed fails in packed_decode_fwd, and run() raises
    EngineStepError; no lockstep rung re-runs the round, nothing is
    degraded or retried."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Engine, EngineStepError

    modes = []
    picked = Engine._round_mode

    def spy(self, tiles):
        modes.append(picked(self, tiles))
        return modes[-1]

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device=dev)
    eng = Engine(params, cfg, slots=4, max_len=128, device=dev)
    assert eng.decode_mode == "auto"
    rng = np.random.default_rng(2)
    # tiles [1, 1, 1, 5] at blk 16: 2.3 * 8 < 4 * 5, so the rule goes packed
    for uid, s in enumerate((3, 3, 3, 70)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=s), max_new=4,
                   uid=uid)
    monkeypatch.setattr(Engine, "_round_mode", spy)
    monkeypatch.setattr(K, "packed_decode_fwd", boom)
    with pytest.raises(EngineStepError, match="kernel launch failed") as info:
        eng.run()
    assert info.value.phase == "decode" and modes[-1] == "packed"
    st = eng.stats
    assert st["decode_packed_launches"] == 0
    assert st["decode_lockstep_launches"] == modes.count("lockstep")
    assert st["launches_degraded_total"] == st["requests_retried_total"] \
        == 0


def test_auto_engine_matches_the_packed_engine(dev):
    """decode_mode="auto" (the default) on the kernels: the rounds its cost
    rule sends packed run packed_decode_fwd once a layer, the others the
    full-cache einsum (no decode kernel), and the greedy tokens equal the
    packed engine's."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Engine

    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, cfg.vocab_size, size=s)
               for s in (6, 60, 8, 6, 44, 10, 14, 4)]
    out, stats, launches = {}, {}, {}
    for mode in ("packed", "auto"):
        eng = Engine(params, cfg, slots=4, max_len=128, prefill_block=16,
                     decode_block=16, decode_mode=mode, device=dev)
        for uid, p in enumerate(prompts):
            eng.submit(p, max_new=6, uid=uid)
        before = K.packed_decode_fwd.launches
        out[mode] = eng.run()
        launches[mode] = K.packed_decode_fwd.launches - before
        stats[mode] = eng.stats
    st = stats["auto"]
    assert out["auto"] == out["packed"]
    assert st["decode_packed_launches"] > 0 and \
        st["decode_lockstep_launches"] > 0
    assert st["decode_packed_launches"] + st["decode_lockstep_launches"] \
        == st["decode_rounds"]
    for mode in out:
        assert launches[mode] == \
            cfg.n_layers * stats[mode]["decode_packed_launches"], mode
    assert stats["packed"]["decode_lockstep_launches"] == 0


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
@pytest.mark.parametrize("g,hkv", [(1, 2), (8, 1), (12, 1)])
# bf16 q: the decode half at the prefill body's 2 blk threads, 32 to 256
@pytest.mark.parametrize("blk", [16, 32, 64, 128])
@pytest.mark.parametrize("d", [64, 128, 192])
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
    """The prefill half runs packed_fwd's body at packed_fwd's thread count
    (2 blk on the bf16 tensor-core body, 256 on the f32 CUDA-core body):
    bitwise equal. The decode half runs packed_decode's body, in the same
    chunks, at that count against 256: each output element by the same
    operations, so bitwise equal too."""
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
    assert torch.equal(o_dec[slots], split_dec[slots])


@pytest.mark.parametrize("blk", [16, 64])
@pytest.mark.parametrize("arg", range(3))
def test_fused_step_misaligned_bf16_raises(dev, blk, arg):
    """A bf16 pack's q, k or v 2 bytes off a 16-byte boundary is refused
    by the fused launch (cudaErrorMisalignedAddress), not counted; nothing
    falls back to the CUDA-core prefill."""
    rng = np.random.default_rng(14)
    psched, ins, spec = _fused_case(rng, dev, blk=blk, d=64, g=2, hkv=2,
                                    q_dtype=torch.bfloat16,
                                    c_dtype=torch.float32)
    ins = list(ins)
    ins[arg] = _misaligned(ins[arg])
    before = K.fused_step_fwd.launches
    with pytest.raises(RuntimeError, match="cudaError 716"):
        K.fused_step_fwd(*ins, psched=psched, capacity=spec.capacity,
                         tiles=spec.tiles)
    assert K.fused_step_fwd.launches == before


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
             "prefix": lambda blk: (None, blk + 3),
             "band_short": lambda blk: (3, 0)}
# (blk, D), each head dim at some edge. bf16 forward (tri_fwd.cu): the
# mma.sync body at blk 16 and 32, the wgmma body at 64 and 128; bf16
# backward (tri_bwd.cu): the CUDA-core body at blk 16 and 32, the wgmma
# body at 64 and 128 (64 x 64 sub-tiles, dk/dv folded); f32 in both
# directions: the CUDA-core body (kernel.tile_body)
TRI_GEOMS = [(16, 64), (16, 32), (32, 16), (32, 128), (64, 128), (64, 32),
             (128, 16), (128, 64), (32, 192), (64, 192)]


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
@pytest.mark.parametrize("blk,d", TRI_GEOMS)
@pytest.mark.parametrize("kind", ["ltm", "band", "prefix", "band_short"])
# the dk/dv fold pairs column j with n - 1 - j: n 5 leaves the middle
# column alone, n 6 pairs every column
@pytest.mark.parametrize("n", [5, 6])
def test_tri_fwd_and_bwd_match_plain(dev, kind, blk, d, g, hkv, dtype, n):
    from repro_torch.kernels.tri_attn import scan_impl as SC

    sched, q, k, v, do = _tri_case(dev, kind, blk, d, g, hkv, dtype, n=n)
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


@pytest.mark.parametrize("kind,blk,d", [("ltm", 64, 128),
                                        ("band_short", 128, 64),
                                        ("prefix", 32, 128)])
def test_tri_fwd_is_deterministic(dev, kind, blk, d):
    """One block per accumulator owner, no atomics: two runs of the bf16
    forward are bitwise equal, and finite."""
    sched, q, k, v, _ = _tri_case(dev, kind, blk, d, 8, 1, torch.bfloat16)
    first = K.fwd(q, k, v, sched)
    again = K.fwd(q, k, v, sched)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(bool(torch.isfinite(x.float()).all()) for x in first)


@pytest.mark.parametrize("kind,blk,d", [("ltm", 64, 128),
                                        ("band_short", 64, 128),
                                        ("ltm", 128, 64),
                                        ("band_short", 128, 128),
                                        ("ltm", 64, 192),
                                        ("band_short", 128, 192)])
def test_tri_bwd_is_deterministic(dev, kind, blk, d):
    """No atomics: the same inputs give bitwise-equal grads, and finite."""
    sched, q, k, v, do = _tri_case(dev, kind, blk, d, 8, 1, torch.bfloat16)
    out, lse = K.fwd(q, k, v, sched)
    first = K.bwd(q, k, v, out, lse, do, sched)
    again = K.bwd(q, k, v, out, lse, do, sched)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(bool(torch.isfinite(x.float()).all()) for x in first)


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


@pytest.mark.parametrize("arg", range(4))
def test_tri_bwd_misaligned_bf16_raises(dev, arg):
    """The bf16 wgmma backward reads q, k, v, do by TMA: a contiguous
    operand 2 bytes off a 16-byte boundary is refused with
    cudaErrorMisalignedAddress, counted by neither wrapper, as tri_fwd
    refuses one; nothing falls back."""
    sched, q, k, v, do = _tri_case(dev, "ltm", 64, 64, 2, 2, torch.bfloat16)
    out, lse = K.fwd(q, k, v, sched)
    delta = (do.float() * out.float()).sum(dim=-1)
    ops = [q, k, v, do]
    shifted = torch.empty(ops[arg].numel() + 1, dtype=torch.bfloat16,
                          device=dev)[1:].view(ops[arg].shape)
    shifted.copy_(ops[arg])
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    ops[arg] = shifted
    code = 716  # cudaErrorMisalignedAddress
    before = (K.bwd_dq.launches, K.bwd_dkv.launches)
    with pytest.raises(RuntimeError, match=f"cudaError {code}"):
        K.bwd_dq(*ops, lse, delta, sched)
    with pytest.raises(RuntimeError, match=f"cudaError {code}"):
        K.bwd_dkv(*ops, lse, delta, sched)
    assert (K.bwd_dq.launches, K.bwd_dkv.launches) == before


# ---------------------------------------------------------------------------
# Packed document training: tri_attn.packed_bwd dq and dk/dv
# (csrc/packed_bwd.cu) on a mixed member zoo (ltm, prefix, band, short
# ltm in one launch), at the tolerances of the training kernels above:
# bf16 at blk 64 and 128 on the wgmma body of tri_bwd (each member's
# columns folded), float32 and bf16 at 16 and 32 on the CUDA cores.
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


@pytest.mark.parametrize("blk", [64, 128])  # the bf16 wgmma body
def test_packed_bwd_is_deterministic(dev, blk):
    """No atomics: the same inputs give bitwise-equal grads, and finite."""
    psched, q, k, v, do = _packed_case(dev, blk, 8, 1, torch.bfloat16)
    out, lse = K.packed_fwd(q, k, v, psched)
    first = K.packed_bwd(q, k, v, out, lse, do, psched)
    again = K.packed_bwd(q, k, v, out, lse, do, psched)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(bool(torch.isfinite(x.float()).all()) for x in first)


@pytest.mark.parametrize("g,hkv", [(1, 2), (8, 1)])
def test_packed_bwd_long_member_matches_plain(dev, g, hkv):
    """A member of 24 tiles at blk 64 (the largest of the packed train
    phase) beside short ltm, band and prefix members: the wgmma body's
    longest dq rows and dk/dv pairs, at the bf16 grad tolerance."""
    from repro_torch.kernels.tri_attn import scan_impl as SC

    blk, d, h = 64, 128, g * hkv
    rng = np.random.default_rng(24 + g)
    psched = OPS.make_packed_sched([24 * blk, 3 * blk, 2 * blk, blk],
                                   block=blk, window=[None, blk + 3, None, 3],
                                   prefix=[0, 0, blk + 1, 0])
    s = psched.s_total
    q, k, v, do = (_rand(rng, shape, torch.bfloat16, dev) for shape in
                   ((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d),
                    (1, h, s, d)))
    out, lse = K.packed_fwd(q, k, v, psched)
    got = K.packed_bwd(q, k, v, out, lse, do, psched)
    want = SC.packed_bwd_torch(q, k, v, out, lse, do, psched, d ** -0.5)
    for x, ref, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(x.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), err_msg=name,
                                   **GRAD_TOL[torch.bfloat16])


@pytest.mark.parametrize("arg", range(4))
def test_packed_bwd_misaligned_bf16_raises(dev, arg):
    """The bf16 wgmma packed backward reads q, k, v, do by TMA: a
    contiguous operand 2 bytes off a 16-byte boundary is refused with
    cudaErrorMisalignedAddress, counted by neither wrapper; nothing falls
    back."""
    psched, q, k, v, do = _packed_case(dev, 64, 2, 2, torch.bfloat16)
    out, lse = K.packed_fwd(q, k, v, psched)
    delta = (do.float() * out.float()).sum(dim=-1)
    ops = [q, k, v, do]
    shifted = torch.empty(ops[arg].numel() + 1, dtype=torch.bfloat16,
                          device=dev)[1:].view(ops[arg].shape)
    shifted.copy_(ops[arg])
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    ops[arg] = shifted
    code = 716  # cudaErrorMisalignedAddress
    before = (K.packed_bwd_dq.launches, K.packed_bwd_dkv.launches)
    with pytest.raises(RuntimeError, match=f"cudaError {code}"):
        K.packed_bwd_dq(*ops, lse, delta, psched)
    with pytest.raises(RuntimeError, match=f"cudaError {code}"):
        K.packed_bwd_dkv(*ops, lse, delta, psched)
    assert (K.packed_bwd_dq.launches, K.packed_bwd_dkv.launches) == before


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
@pytest.mark.parametrize("g,hkv", [(1, 2), (2, 2), (8, 1), (12, 1)])
@pytest.mark.parametrize("blk,d", [(16, 64), (32, 64), (64, 128),
                                   (128, 128), (16, 192), (32, 192),
                                   (64, 192), (128, 192)])
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


# ---------------------------------------------------------------------------
# The 3-body workload: tri_3body.three_body_tet, three_body_bb3 and
# dummy_tet (csrc/tri_3body.cu) against their plain versions. A tile's
# sum may differ from the plain version's by rounding only: at most
# 2 (b + d) float32 units (2^-24) of its sum(|(A B) * C|).
# ---------------------------------------------------------------------------

U32 = 2.0 ** -24
TB_CASES = [(64, 1), (64, 3), (64, 259), (128, 3), (128, 64), (128, 65)]


def _tet_check(x, block, strict, got):
    """Every tile of a packed kernel output against the plain version."""
    from repro_torch.kernels.tri_3body import kernel as TK
    from repro_torch.kernels.tri_3body import ref as TR

    n = x.shape[0] // block
    coords = TR.tet_coords(n, x.device)
    want, scale = TK.triplet_tiles(x, block, *coords.unbind(1),
                                   strict=strict, with_abs=True)
    bound = 2 * (block + x.shape[1]) * U32 * scale
    assert got.shape == (M.tet(n), 1) and got.dtype == torch.float32
    assert bool(((got[:, 0] - want).abs() <= bound).all())
    return coords


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("block,d", TB_CASES)
def test_three_body_tet_matches_plain(dev, block, d, strict, dtype):
    from repro_torch.kernels.tri_3body import kernel as TK

    x = _points(dev, 5 * block, d, dtype, seed=3)
    before = TK.three_body_tet.launches
    got = TK.three_body_tet(x, block, strict=strict)
    torch.cuda.synchronize()
    assert TK.three_body_tet.launches == before + 1
    _tet_check(x, block, strict, got)
    assert torch.equal(TK.three_body_tet(x, block, strict=strict), got)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("block,d", TB_CASES)
def test_three_body_bb3_equals_tet(dev, block, d, strict):
    """The simplex cells are the tet kernel's bits; the rest exact 0."""
    from repro_torch.kernels.tri_3body import kernel as TK

    n = 6
    x = _points(dev, n * block, d, torch.float32, seed=4)
    before = TK.three_body_bb3.launches
    cube = TK.three_body_bb3(x, block, strict=strict)
    torch.cuda.synchronize()
    assert TK.three_body_bb3.launches == before + 1
    assert cube.shape == (n, n, n)
    packed = TK.three_body_tet(x, block, strict=strict)
    coords = _tet_check(x, block, strict, packed)
    i, j, k = coords.unbind(1)
    assert torch.equal(cube[i, j, k], packed[:, 0])
    dead = torch.ones_like(cube, dtype=torch.bool)
    dead[i, j, k] = False
    assert int(torch.count_nonzero(cube[dead])) == 0
    assert torch.equal(TK.three_body_bb3_torch(x, block, strict=strict)
                       [dead], cube[dead])


@pytest.mark.parametrize("n", [1, 2, 8, 100, 500])
def test_dummy_tet_matches_plain(dev, n):
    from repro_torch.kernels.tri_3body import kernel as TK

    before = TK.dummy_tet.launches
    got = TK.dummy_tet(n, device=dev)
    torch.cuda.synchronize()
    assert TK.dummy_tet.launches == before + 1
    assert got.shape == (M.tet(n), 1) and got.dtype == torch.float32
    assert torch.equal(got, TK.dummy_tet_torch(n, dev))


def _tet64(i):
    return i * (i + 1) * (i + 2) // 6


def test_device_tet_map_over_the_envelope(dev):
    """All 715,169,000 lambdas of the certified envelope through the
    device tet_map (dummy_tet at n = 1624), against the exact int64
    closed form: float64 cube root corrected both ways, then g(mu)."""
    from repro_torch.kernels.tri_3body import kernel as TK

    n = M.TET_TRACED_MAX_I
    out = TK.dummy_tet(n, device=dev)
    t, step = M.tet(n), 1 << 26
    for t0 in range(0, t, step):
        lam = torch.arange(t0, min(t, t0 + step), dtype=torch.int64,
                           device=dev)
        i = torch.pow((6 * lam).double(), 1.0 / 3.0).floor().long()
        i = torch.where(_tet64(i + 1) <= lam, i + 1, i)
        i = torch.where(_tet64(i) > lam, i - 1, i)
        mu = lam - _tet64(i)
        j = torch.sqrt((8 * mu + 1).double()).floor().long()
        j = torch.where(j * j > 8 * mu + 1, j - 1, j)
        j = (j - 1) // 2
        assert torch.equal(out[t0:t0 + step, 0],
                           (i + j + mu - j * (j + 1) // 2).float()), t0


def test_three_body_op_on_the_card(dev):
    """ops.three_body through every impl on one input, and the totals
    against float64 dense oracles, within 1e-5 of the sum of the absolute
    summands."""
    from repro_torch.kernels.tri_3body import ops as TOPS
    from repro_torch.kernels.tri_3body import ref as TR

    x = _points(dev, 384, 3, torch.float32, seed=5)
    packed = TOPS.three_body(x, 64, impl="cuda")
    cube = TOPS.three_body(x, 64, impl="bb3")
    i, j, k = TR.tet_coords(6, dev).unbind(1)
    assert torch.equal(cube[i, j, k], packed[:, 0])
    for impl in ("torch", "ref"):
        np.testing.assert_allclose(
            packed.cpu().numpy(),
            TOPS.three_body(x, 64, impl=impl).cpu().numpy(),
            atol=2e-4, rtol=2e-5)
    g = x.double() @ x.double().T
    low = torch.tril(g, diagonal=-1)
    oracles = {False: (torch.einsum("ab,bc,ac->", g, g, g),
                       ((g.abs() @ g.abs()) * g.abs()).sum()),
               True: (((low @ low) * g).sum(),
                      ((low.abs() @ low.abs()) * g.abs()).sum())}
    for strict, (want, scale) in oracles.items():
        for impl in ("cuda", "bb3"):
            got = float(TOPS.three_body_total(x, 64, impl=impl,
                                              strict=strict))
            assert abs(got - float(want)) <= 1e-5 * float(scale), \
                (impl, strict)


@pytest.mark.parametrize("fn", ["three_body_tet_launch",
                                "three_body_bb3_launch", "dummy_tet_launch"])
def test_three_body_failing_launch_raises(dev, monkeypatch, fn):
    """A launch CUDA refuses raises and is not counted."""
    from repro_torch.kernels.tri_3body import kernel as TK

    monkeypatch.setattr(BUILD.load("tri_3body"), fn, lambda *a: 9)
    x = _points(dev, 128, 3, torch.float32)
    call, wrapper = {
        "three_body_tet_launch": (lambda: TK.three_body_tet(x, 64),
                                  TK.three_body_tet),
        "three_body_bb3_launch": (lambda: TK.three_body_bb3(x, 64),
                                  TK.three_body_bb3),
        "dummy_tet_launch": (lambda: TK.dummy_tet(4, device=dev),
                             TK.dummy_tet)}[fn]
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="cudaError 9"):
        call()
    assert wrapper.launches == before


def test_three_body_kernels_refuse_unsupported_input(dev):
    from repro_torch.kernels.tri_3body import kernel as TK

    for x, block in ((_points(dev, 128, 3, torch.float32), 32),
                     (_points(dev, 256, 66, torch.float32), 128),
                     (_points(dev, 128, 260, torch.float32), 64),
                     (_points(dev, 128, 3, torch.float16), 64)):
        for fn in (TK.three_body_tet, TK.three_body_bb3):
            with pytest.raises(ValueError):
                fn(x, block)


# ---------------------------------------------------------------------------
# A prefix at least as long as its sequence: the attention kernels walk no
# key tile past the member and agree with the plain versions and the
# oracle (every key visible).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefix", [64, 100])
def test_dense_prefix_past_length_kernels(dev, prefix):
    rng = np.random.default_rng(prefix)
    q, k, v = (_rand(rng, shape, torch.float32, dev) for shape in
               ((1, 4, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16)))
    do = _rand(rng, (1, 4, 64, 16), torch.float32, dev)
    res = {}
    for impl in ("cuda", "torch", "ref"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = OPS.triangular_attention(*leaves, prefix=prefix, impl=impl,
                                       block=16)
        out.backward(do)
        res[impl] = (out.detach(),) + tuple(x.grad for x in leaves)
    for want in (res["torch"], res["ref"]):
        _close(res["cuda"][0], want[0], torch.float32, "out")
        for got, w in zip(res["cuda"][1:], want[1:]):
            np.testing.assert_allclose(got.cpu().numpy(), w.cpu().numpy(),
                                       **GRAD_TOL[torch.float32])


def test_packed_prefix_past_member_kernels(dev):
    rng = np.random.default_rng(48)
    psched = OPS.make_packed_sched([32, 64], block=16, prefix=[48, 0])
    q, k, v = (_rand(rng, shape, torch.float32, dev) for shape in
               ((1, 4, 96, 16), (1, 2, 96, 16), (1, 2, 96, 16)))
    do = _rand(rng, (1, 4, 96, 16), torch.float32, dev)
    res = {}
    for impl in ("cuda", "torch", "ref"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = OPS.packed_prefill_attention(*leaves, psched, impl=impl)
        out.backward(do)
        res[impl] = (out.detach(),) + tuple(x.grad for x in leaves)
    for want in (res["torch"], res["ref"]):
        _close(res["cuda"][0], want[0], torch.float32, "out")
        for got, w in zip(res["cuda"][1:], want[1:]):
            np.testing.assert_allclose(got.cpu().numpy(), w.cpu().numpy(),
                                       **GRAD_TOL[torch.float32])


# ---------------------------------------------------------------------------
# The RWKV-6 WKV recurrence: wkv_scan.wkv (csrc/wkv_scan.cu) against its
# plain version (ref.py) on the same inputs; f32 within 1e-4 (the two
# sum the hd-long dot products in other orders over up to 100 steps),
# bf16 outputs within a bf16 rounding.
# ---------------------------------------------------------------------------

WKV_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _wkv_case(dev, b, l, h, hd, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed + l + hd)
    f = lambda *s: torch.as_tensor(
        (0.5 * rng.standard_normal(s)).astype(np.float32), device=dev)
    r, k, v = f(b, l, h, hd), f(b, l, h, hd), f(b, l, h, hd)
    lw = -torch.exp(f(b, l, h, hd))
    return ([t.to(dtype) for t in (r, k, v, lw)] + [f(h, hd)],
            f(b, h, hd, hd))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,hd,block_l", [(1, 8, 1, 8, 64),
                                              (2, 64, 4, 64, 64),
                                              (2, 37, 3, 16, 64),
                                              (3, 100, 8, 32, 64),
                                              (2, 96, 2, 64, 16)])
def test_wkv_matches_plain(dev, b, l, h, hd, block_l, dtype):
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR

    xs, s0 = _wkv_case(dev, b, l, h, hd, dtype)
    before = WK.wkv.launches
    out, s_l = WK.wkv(*xs, s0, block_l=block_l)
    torch.cuda.synchronize()
    assert WK.wkv.launches == before + 1
    assert out.dtype == dtype and s_l.dtype == torch.float32
    want_o, want_s = WR.wkv_ref(*xs, s0)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want_o.to(dtype).float().cpu().numpy(),
                               **WKV_TOL[dtype])
    np.testing.assert_allclose(s_l.cpu().numpy(), want_s.cpu().numpy(),
                               **WKV_TOL[torch.float32])


def test_wkv_aliased_decode_state_and_chaining(dev):
    """L = 1 steps with s0 and s_L the same cache tensor, chained over 16
    steps, equal one launch over the 16 (and the plain version)."""
    from repro_torch.kernels.wkv_scan import kernel as WK

    (r, k, v, lw, u), s0 = _wkv_case(dev, 4, 16, 8, 64, seed=1)
    whole_o, whole_s = WK.wkv(r, k, v, lw, u, s0)
    cache = s0.clone()
    outs = []
    for t in range(16):
        o, s = WK.wkv(r[:, t:t + 1].contiguous(), k[:, t:t + 1].contiguous(),
                      v[:, t:t + 1].contiguous(),
                      lw[:, t:t + 1].contiguous(), u, cache,
                      state_out=cache)
        assert s is cache
        outs.append(o)
    torch.cuda.synchronize()
    tol = WKV_TOL[torch.float32]
    np.testing.assert_allclose(torch.cat(outs, 1).cpu().numpy(),
                               whole_o.cpu().numpy(), **tol)
    np.testing.assert_allclose(cache.cpu().numpy(), whole_s.cpu().numpy(),
                               **tol)
    plain_o, plain_s = WK.wkv_torch(r, k, v, lw, u, s0)
    np.testing.assert_allclose(whole_s.cpu().numpy(), plain_s.cpu().numpy(),
                               **tol)


def test_wkv_refuses_instead_of_falling_back(dev, monkeypatch):
    """hd > 64, mixed dtypes and inputs that need a gradient raise before
    a launch; a launch CUDA refuses raises and is not counted."""
    from repro_torch.kernels.wkv_scan import kernel as WK

    before = WK.wkv.launches
    (r, k, v, lw, u), _ = _wkv_case(dev, 1, 4, 1, 128)
    with pytest.raises(ValueError, match="head size 128"):
        WK.wkv(r, k, v, lw, u)
    (r, k, v, lw, u), _ = _wkv_case(dev, 1, 4, 2, 16)
    with pytest.raises(ValueError, match="one dtype"):
        WK.wkv(r.bfloat16(), k, v, lw, u)
    with pytest.raises(ValueError, match="no backward"):
        WK.wkv(r.requires_grad_(), k, v, lw, u)
    lib = BUILD.load("wkv_scan")
    monkeypatch.setattr(lib, "wkv_launch", lambda *a: 9)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        WK.wkv(r.detach(), k, v, lw, u)
    assert WK.wkv.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 63, 64, 65, 127, 2048])
def test_wkv_chunks_match_plain(dev, l, dtype):
    """The chunked walk (WKV_CHUNK = 64 steps a block, chained in the
    launch) at L = 1, C - 1, C, C + 1, 127 and 2048 against the plain
    version, f32 held to 1e-4 of the output's scale (chip_smoke.py's
    WKV_REL: the chunks' sums round otherwise than the walk)."""
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.kernels.wkv_scan import ref as WR

    assert WK.WKV_CHUNK == 64
    xs, s0 = _wkv_case(dev, 2, l, 3, 64, dtype, seed=5)
    out, s_l = WK.wkv(*xs, s0)
    torch.cuda.synchronize()
    want_o, want_s = WR.wkv_ref(*xs, s0)
    scale = float(want_o.abs().max())
    tol = (dict(atol=1e-4 * scale, rtol=1e-4) if dtype == torch.float32
           else WKV_TOL[dtype])
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               want_o.to(dtype).float().cpu().numpy(), **tol)
    np.testing.assert_allclose(
        s_l.cpu().numpy(), want_s.cpu().numpy(), rtol=1e-4,
        atol=1e-4 * float(want_s.abs().max()))


def test_wkv_is_deterministic_and_leaves_no_count(dev):
    """Two launches of a many-chunk call give the same bits, and every
    counter (the ticket and each stream's published chunks) is 0 after
    each; a many-chunk call between two one-chunk calls changes neither."""
    from repro_torch.kernels.build import arrival_counters
    from repro_torch.kernels.wkv_scan import kernel as WK

    xs, s0 = _wkv_case(dev, 4, 2048, 32, 64, seed=6)
    first = WK.wkv(*xs, s0)
    counters = arrival_counters(xs[0], 1 + 4 * 32)
    torch.cuda.synchronize()
    assert int(counters.abs().sum()) == 0
    for _ in range(2):
        again = WK.wkv(*xs, s0)
        torch.cuda.synchronize()
        assert int(counters.abs().sum()) == 0
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    one = [t[:, :1].contiguous() for t in xs[:4]] + [xs[4]]
    assert all(torch.equal(a, b) for a, b in
               zip(WK.wkv(*one, s0), WK.wkv(*one, s0)))


@pytest.mark.parametrize("hd", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_one_chunk_is_the_sequential_walk(dev, hd, dtype):
    """A call of L <= WKV_CHUNK is the sequential walk: bitwise equal to
    L one-step calls on an aliased cache (each the walk's one step), in
    outputs and state."""
    from repro_torch.kernels.wkv_scan import kernel as WK

    (r, k, v, lw, u), s0 = _wkv_case(dev, 2, WK.WKV_CHUNK, 3, hd, dtype,
                                     seed=7)
    whole_o, whole_s = WK.wkv(r, k, v, lw, u, s0)
    cache = s0.clone()
    outs = []
    for t in range(WK.WKV_CHUNK):
        step = [x[:, t:t + 1].contiguous() for x in (r, k, v, lw)]
        o, _ = WK.wkv(*step, u, cache, state_out=cache)
        outs.append(o)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, 1), whole_o)
    assert torch.equal(cache, whole_s)


def test_rwkv_serving_on_the_card(dev):
    """Smoke-size float32 rwkv6 on the card: the engine (2 slots, 5
    requests: reused slots, a 1-token prompt) through the WKV kernel
    emits the tokens of a batch-1 generate on the card, and of the
    engine on the plain versions; every launch is the kernel's."""
    from repro_torch.configs import registry as REG
    from repro_torch.kernels.wkv_scan import kernel as WK
    from repro_torch.models import model as MD
    from repro_torch.serve import decode as D
    from repro_torch.serve.engine import Engine
    from repro_torch.train import train_step as TS

    cfg = REG.smoke_config("rwkv6-1.6b")
    params = MD.init_params(cfg, seed=3, device=dev)
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5], [4, 4, 2],
               [7]]

    def engine(impl, device):
        p = params if device == dev else _to(params, device)
        eng = Engine(p, cfg, slots=2, max_len=48, prefill_impl=impl,
                     decode_impl=impl, device=device)
        for uid, pr in enumerate(prompts):
            eng.submit(np.asarray(pr, np.int32), max_new=6, uid=uid)
        return eng.run()

    before = WK.wkv.launches
    got = engine("cuda", dev)
    assert WK.wkv.launches > before
    assert got == engine("torch", "cpu")
    prefill = TS.make_prefill_step(cfg, cache_dtype=torch.float32)
    for uid, pr in enumerate(prompts):
        toks = torch.as_tensor([pr], device=dev)
        if len(pr) > 1:
            _, cache = prefill(params, {"tokens": toks[:, :-1]})
        else:
            cache = MD.init_cache(cfg, 1, 48, torch.float32, dev)
        out, _, _ = D.generate(params, cfg, cache, toks[:, -1:],
                               len(pr) - 1, 6)
        assert out[0].tolist() == got[uid], uid


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


SSM_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
           torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}


def _ssm_case(dev, b, l, d, n, dtype=torch.float32, seed=0):
    """x, dt, A, Bt, Ct (the reference test's distributions) and h0."""
    rng = np.random.default_rng(seed + 7 * l + d + n)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                                   device=dev)
    x, bt, ct, h0 = f(b, l, d), f(b, l, n), f(b, l, n), f(b, d, n)
    dt = torch.nn.functional.softplus(f(b, l, d) - 1)
    a = -torch.exp(0.3 * f(d, n))
    return [x.to(dtype), dt.to(dtype), a, bt.to(dtype), ct.to(dtype)], h0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,n", [(1, 8, 16, 4), (2, 32, 64, 16),
                                     (2, 128, 256, 16), (1, 64, 128, 8),
                                     (3, 16, 32, 32), (2, 37, 200, 8),
                                     (4, 1, 16384, 16), (1, 300, 130, 4)])
def test_ssm_matches_plain(dev, b, l, d, n, dtype):
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.ssm_scan import ref as SR

    xs, h0 = _ssm_case(dev, b, l, d, n, dtype)
    before = SK.selective_scan.launches
    y, h_l = SK.selective_scan(*xs, h0)
    torch.cuda.synchronize()
    assert SK.selective_scan.launches == before + 1
    assert y.dtype == dtype and h_l.dtype == torch.float32
    want_y, want_h = SR.selective_scan_ref(*xs, h0)
    np.testing.assert_allclose(y.float().cpu().numpy(),
                               want_y.to(dtype).float().cpu().numpy(),
                               **SSM_TOL[dtype])
    np.testing.assert_allclose(h_l.cpu().numpy(), want_h.cpu().numpy(),
                               **SSM_TOL[torch.float32])


def test_ssm_aliased_decode_state_and_chaining(dev):
    """L = 1 steps with h0 and h_L the same cache tensor, chained over 16
    steps, equal one launch over the 16 (and the plain version)."""
    from repro_torch.kernels.ssm_scan import kernel as SK

    (x, dt, a, bt, ct), h0 = _ssm_case(dev, 4, 16, 1024, 16, seed=1)
    whole_y, whole_h = SK.selective_scan(x, dt, a, bt, ct, h0)
    cache = h0.clone()
    outs = []
    step = lambda t, i: t[:, i:i + 1].contiguous()
    for i in range(16):
        y, h = SK.selective_scan(step(x, i), step(dt, i), a, step(bt, i),
                                 step(ct, i), cache, state_out=cache)
        assert h is cache
        outs.append(y)
    torch.cuda.synchronize()
    tol = SSM_TOL[torch.float32]
    np.testing.assert_allclose(torch.cat(outs, 1).cpu().numpy(),
                               whole_y.cpu().numpy(), **tol)
    np.testing.assert_allclose(cache.cpu().numpy(), whole_h.cpu().numpy(),
                               **tol)
    _, plain_h = SK.selective_scan_torch(x, dt, a, bt, ct, h0)
    np.testing.assert_allclose(whole_h.cpu().numpy(), plain_h.cpu().numpy(),
                               **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,n", [(1, 8, 16, 4), (3, 16, 32, 32),
                                     (2, 128, 256, 16), (1, 300, 130, 4),
                                     (4, 2048, 1024, 16)])
def test_ssm_is_deterministic(dev, b, l, d, n, dtype):
    """Two launches give the same bits at the reference test's shapes, a
    D that is no whole number of blocks (threads past D only stage), and
    a long L (many staged chunks)."""
    from repro_torch.kernels.ssm_scan import kernel as SK

    xs, h0 = _ssm_case(dev, b, l, d, n, dtype, seed=2)
    first = SK.selective_scan(*xs, h0)
    again = SK.selective_scan(*xs, h0)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_ssm_refuses_instead_of_falling_back(dev, monkeypatch):
    """N 64, mixed dtypes and inputs that need a gradient raise before a
    launch; a launch CUDA refuses raises and is not counted."""
    from repro_torch.kernels.ssm_scan import kernel as SK

    before = SK.selective_scan.launches
    xs, _ = _ssm_case(dev, 1, 4, 32, 64)
    with pytest.raises(ValueError, match="state size 64"):
        SK.selective_scan(*xs)
    (x, dt, a, bt, ct), _ = _ssm_case(dev, 1, 4, 32, 16)
    with pytest.raises(ValueError, match="one dtype"):
        SK.selective_scan(x.bfloat16(), dt, a, bt, ct)
    with pytest.raises(ValueError, match="no backward"):
        SK.selective_scan(x.clone().requires_grad_(), dt, a, bt, ct)
    lib = BUILD.load("ssm_scan")
    monkeypatch.setattr(lib, "ssm_scan_launch", lambda *args: 9)
    with pytest.raises(RuntimeError, match="cudaError 9"):
        SK.selective_scan(x, dt, a, bt, ct)
    assert SK.selective_scan.launches == before


@pytest.mark.parametrize("s", [37, 2047])
def test_attention_pads_a_ragged_sequence_on_the_kernel_path(dev, s):
    """A sequence no kernel tile divides (a 2047-token prompt) goes
    through tri_attn.fwd padded at its causal tail; its rows equal the
    oracle's (impl "ref": the plain path would halve its tile to 1)."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import layers as L
    from repro_torch.models import model as MD

    cfg = dataclasses.replace(REG.smoke_config("yi-9b"), n_layers=1)
    params = MD.init_params(cfg, seed=5, device=dev)
    mixer = params["layers"]["l0"]["mixer"]
    mixer = {k: v[0] for k, v in mixer.items()}
    x = torch.as_tensor(np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32), device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    before = K.fwd.launches
    got = L.attention(mixer, x, cfg, positions=pos, attn_impl="cuda")
    assert K.fwd.launches == before + 1
    want = L.attention(mixer, x, cfg, positions=pos, attn_impl="ref")
    for g, w in zip(got, want):
        _close(g, w, torch.float32)


def test_jamba_serving_on_the_card(dev):
    """Smoke-size float32 jamba on the card: the engine (2 slots, 5
    requests: reused slots, a 1-token prompt) through the selective-scan
    kernel emits the tokens of the engine on the plain versions (CPU) and
    of a batch-1 generate on the card."""
    from repro_torch.configs import registry as REG
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.models import model as MD
    from repro_torch.serve import decode as D
    from repro_torch.serve.engine import Engine
    from repro_torch.train import train_step as TS

    cfg = REG.smoke_config("jamba-1.5-large-398b")
    params = MD.init_params(cfg, seed=3, device=dev)
    prompts = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5], [4, 4, 2],
               [7]]

    def engine(impl, device):
        p = params if device == dev else _to(params, device)
        eng = Engine(p, cfg, slots=2, max_len=48, prefill_impl=impl,
                     decode_impl=impl, device=device)
        for uid, pr in enumerate(prompts):
            eng.submit(np.asarray(pr, np.int32), max_new=6, uid=uid)
        return eng.run()

    before = SK.selective_scan.launches
    got = engine("cuda", dev)
    assert SK.selective_scan.launches > before
    assert got == engine("torch", "cpu")
    prefill = TS.make_prefill_step(cfg, cache_dtype=torch.float32,
                                   max_len=48)
    for uid, pr in enumerate(prompts):
        toks = torch.as_tensor([pr], device=dev)
        if len(pr) > 1:
            _, cache = prefill(params, {"tokens": toks[:, :-1]})
        else:
            cache = MD.init_cache(cfg, 1, 48, torch.float32, dev)
        out, _, _ = D.generate(params, cfg, cache, toks[:, -1:],
                               len(pr) - 1, 6)
        assert out[0].tolist() == got[uid], uid


# ---------------------------------------------------------------------------
# Query groups that are not a power of two (the new architectures: g 3
# granite-moe, 7 internvl2, 12 nemotron, 48 granite-34b) through the
# serving and training kernels: the decode body's head slices (the last of
# a kv head holding min(8, g - h0) heads) and the dk/dv sum over the group,
# bf16 at D 64 and 128 and float32, against the plain versions.
# ---------------------------------------------------------------------------

ODD_GROUPS = [(3, 2), (7, 2), (12, 1), (48, 1)]  # (g, Hkv)
ODD_CASES = [(torch.bfloat16, 64), (torch.bfloat16, 128),
             (torch.float32, 64)]


# bf16 dk and dv sum g heads' terms, each with its own bf16 rounding of P
# and dS (ROADMAP C). On these tests' inputs the kernels' dk/dv read at
# most 0.572 x GRAD_TOL at g 12 and 1.154 x at g 48 (max |err| / (atol +
# rtol |want|); tri_bwd's equal to a plain emulation's of that rounding;
# scripts/group_grad_error.py, H100 80GB HBM3): g 48 gets GRAD_TOL x
# 1.75, 1.5 x headroom over that reading
GROUP_GRAD_SCALE = {48: 1.75}


def _group_grad_tol(name, dtype, g):
    """GRAD_TOL, scaled for bf16 dk and dv by GROUP_GRAD_SCALE."""
    tol = dict(GRAD_TOL[dtype])
    if dtype == torch.bfloat16 and name in ("dk", "dv"):
        tol = {k: v * GROUP_GRAD_SCALE.get(g, 1.0) for k, v in tol.items()}
    return tol


@pytest.mark.parametrize("dtype,d", ODD_CASES)
@pytest.mark.parametrize("g,hkv", ODD_GROUPS)
def test_odd_groups_packed_decode_matches_plain(dev, g, hkv, dtype, d):
    rng = np.random.default_rng(g + d)
    ch, blk, b = K.DECODE_CHUNK, 64, 5
    kv_lens, slots = [4 * ch, 3, 2 * ch + 5, blk], [0, 2, 3, 4]
    q, kc, vc, tbl, needed = _decode_case(
        rng, dev, kv_lens, slots, blk=blk, d=d, h=g * hkv, hkv=hkv, b=b,
        s_cache=4 * ch, q_dtype=dtype, c_dtype=torch.float32)
    spec = OPS.DecodeRoundSpec(b + 1, needed, blk, "cuda", needed)
    before = K.packed_decode_fwd.launches
    got = OPS.packed_decode_attention(q, kc, vc, tbl, spec)
    torch.cuda.synchronize()
    assert K.packed_decode_fwd.launches == before + 1
    assert K.decode_grid(needed, b + 1, blk, hkv, g)[1] == \
        hkv * -(-g // K.DECODE_HEADS)
    want = OPS.packed_decode_attention(q, kc, vc, tbl, dataclasses.replace(
        spec, impl="torch"))
    _close(got, want, dtype, f"g {g}")
    assert torch.count_nonzero(got[1]) == 0  # retired slot


@pytest.mark.parametrize("dtype,d", ODD_CASES)
@pytest.mark.parametrize("g,hkv", ODD_GROUPS)
def test_odd_groups_fused_step_matches_plain(dev, g, hkv, dtype, d):
    rng = np.random.default_rng(g + d + 1)
    psched, ins, spec = _fused_case(rng, dev, blk=64, d=d, g=g, hkv=hkv,
                                    q_dtype=dtype, c_dtype=torch.float32)
    before = K.fused_step_fwd.launches
    got_p, got_d = OPS.fused_step_attention(*ins, psched, spec)
    torch.cuda.synchronize()
    assert K.fused_step_fwd.launches == before + 1
    want_p, want_d = OPS.fused_step_attention(
        *ins, psched, dataclasses.replace(spec, impl="torch"))
    _close(got_p, want_p, dtype, f"pack half g {g}")
    _close(got_d, want_d, dtype, f"decode half g {g}")


@pytest.mark.parametrize("dtype,d", ODD_CASES)
@pytest.mark.parametrize("g,hkv", ODD_GROUPS)
def test_odd_groups_packed_fwd_and_bwd_match_plain(dev, g, hkv, dtype, d):
    """packed_fwd, then the packed dq and dk/dv (dk/dv summed over the g
    query heads of each kv head in the kernel)."""
    from repro_torch.kernels.tri_attn import scan_impl as SC

    rng = np.random.default_rng(g + d + 2)
    blk, h = 64, g * hkv
    psched = OPS.make_packed_sched([3 * blk, 2 * blk, blk], block=blk,
                                   window=[None, blk + 3, None],
                                   prefix=[0, 0, blk // 2 + 1])
    s = psched.s_total
    q, k, v, do = (_rand(rng, shape, dtype, dev) for shape in
                   ((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d),
                    (1, h, s, d)))
    scale = d ** -0.5
    out, lse = K.packed_fwd(q, k, v, psched)
    want_out, want_lse = SC.packed_fwd_torch(q, k, v, psched, scale)
    _close(out, want_out, dtype, "out")
    _close(lse, want_lse, dtype, "lse")
    dq, dk, dv = K.packed_bwd(q, k, v, out, lse, do, psched)
    torch.cuda.synchronize()
    want = SC.packed_bwd_torch(q, k, v, out, lse, do, psched, scale)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   err_msg=f"{name} g {g}",
                                   **_group_grad_tol(name, dtype, g))


@pytest.mark.parametrize("dtype,d", ODD_CASES)
@pytest.mark.parametrize("g,hkv", ODD_GROUPS)
@pytest.mark.parametrize("kind", ["ltm", "prefix"])
def test_odd_groups_tri_fwd_and_bwd_match_plain(dev, kind, g, hkv, dtype,
                                                d):
    """tri_fwd and tri_bwd at blk 64 (bf16: the wgmma bodies, dk/dv
    summed over the group in one f32 accumulator)."""
    from repro_torch.kernels.tri_attn import scan_impl as SC

    sched, q, k, v, do = _tri_case(dev, kind, 64, d, g, hkv, dtype, n=5,
                                   b=1)
    scale = d ** -0.5
    out, lse = K.fwd(q, k, v, sched)
    want_out, want_lse = SC.fwd_torch(q, k, v, sched, scale)
    _close(out, want_out, dtype, "out")
    _close(lse, want_lse, dtype, "lse")
    dq, dk, dv = K.bwd(q, k, v, out, lse, do, sched)
    torch.cuda.synchronize()
    want = SC.bwd_torch(q, k, v, out, lse, do, sched, scale)
    for got, ref, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.float().cpu().numpy(),
                                   err_msg=f"{name} g {g}",
                                   **_group_grad_tol(name, dtype, g))


@pytest.mark.parametrize("d", [64, 192])
@pytest.mark.parametrize("blk", [16, 64])
def test_decode_capacity_padding_is_inert(dev, blk, d):
    """The split decode round on the card: three capacity buckets give
    the same bits (the grid walks the live tiles, not the capacity), and
    the plain version's within the tolerance."""
    rng = np.random.default_rng(blk)
    b, s_cache = 3, 8 * blk
    q, kc, vc, tbl, needed = _decode_case(
        rng, dev, [2 * blk + 1, 8 * blk - 2], [0, 2], blk=blk, d=d, h=8,
        hkv=2, b=b, s_cache=s_cache, q_dtype=torch.float32)
    runs = [OPS.packed_decode_attention(
        q, kc, vc, tbl, OPS.DecodeRoundSpec(b + 1, capacity, blk, "cuda",
                                            needed))
        for capacity in (needed, needed + 5, 4 * needed)]
    for run in runs[1:]:
        assert torch.equal(run, runs[0])
    want = OPS.packed_decode_attention(
        q, kc, vc, tbl, OPS.DecodeRoundSpec(b + 1, needed, blk, "torch",
                                            needed))
    _close(runs[0], want, torch.float32)
    assert torch.count_nonzero(runs[0][1]) == 0


# ---------------------------------------------------------------------------
# Head dim 192 (nemotron-4-340b), beside the D 192 cases of the packed_fwd,
# packed_decode, fused, fwd_bb, tri_fwd / tri_bwd tests above: tri_fwd
# (bf16: mma.sync at blk 16 and 32, wgmma at 64 and 128, one K/V stage at
# 128; f32: the CUDA-core body) at g 1 and nemotron's 12, the decode body's
# PV items over 48 f32 or 24 bf16 columns, which no thread count in use
# divides, and the backward: tri_bwd and packed_bwd dq and dk/dv (bf16:
# the CUDA-core body at blk 16 and 32, wgmma m64n192k16 at 64 and 128;
# f32: the CUDA-core body, whose dq takes its keys 16 at a time at blk
# 128) at g 1 and 12 against the plain versions at GRAD_TOL, bitwise
# repeats, autograd through both ops and an Adafactor step on the card
# against the CPU's.
# ---------------------------------------------------------------------------

D192_GROUPS = [(1, 2), (12, 1)]  # (g, Hkv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hkv", D192_GROUPS)
@pytest.mark.parametrize("blk", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["ltm", "prefix", "band_short"])
def test_d192_tri_fwd_matches_plain(dev, kind, blk, g, hkv, dtype):
    from repro_torch.kernels.tri_attn import scan_impl as SC

    sched, q, k, v, do = _tri_case(dev, kind, blk, 192, g, hkv, dtype, n=4,
                                   b=1)
    before = K.fwd.launches
    out, lse = K.fwd(q, k, v, sched)
    again = K.fwd(q, k, v, sched)
    torch.cuda.synchronize()
    assert K.fwd.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip((out, lse), again))
    want_out, want_lse = SC.fwd_torch(q, k, v, sched, 192 ** -0.5)
    _close(out, want_out, dtype, "out")
    _close(lse, want_lse, dtype, "lse")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hkv", D192_GROUPS)
@pytest.mark.parametrize("blk", [16, 32, 64, 128])
@pytest.mark.parametrize("kind", ["ltm", "prefix", "band_short"])
def test_d192_tri_bwd_matches_plain(dev, kind, blk, g, hkv, dtype):
    """tri_bwd dq and dk/dv at D 192 against the plain versions on the
    kernels' own forward (out, lse), each launched once, twice bitwise."""
    from repro_torch.kernels.tri_attn import scan_impl as SC

    sched, q, k, v, do = _tri_case(dev, kind, blk, 192, g, hkv, dtype, n=4,
                                   b=1)
    out, lse = K.fwd(q, k, v, sched)
    before = (K.bwd_dq.launches, K.bwd_dkv.launches)
    got = K.bwd(q, k, v, out, lse, do, sched)
    again = K.bwd(q, k, v, out, lse, do, sched)
    torch.cuda.synchronize()
    assert (K.bwd_dq.launches, K.bwd_dkv.launches) == \
        (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = SC.bwd_torch(q, k, v, out, lse, do, sched, 192 ** -0.5)
    for x, ref, name in zip(got, want, ("dq", "dk", "dv")):
        assert x.dtype == ref.dtype and x.shape == ref.shape, name
        np.testing.assert_allclose(x.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), err_msg=name,
                                   **_group_grad_tol(name, dtype, g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hkv", D192_GROUPS)
@pytest.mark.parametrize("blk", [16, 32, 64, 128])
def test_d192_packed_bwd_matches_plain(dev, blk, g, hkv, dtype):
    """packed_bwd dq and dk/dv at D 192 on the mixed member zoo (ltm,
    prefix, band, 3-token band) against the plain versions, twice
    bitwise."""
    from repro_torch.kernels.tri_attn import scan_impl as SC

    psched, (q, k, v) = _packed_fwd_case(dev, blk, 192, g, hkv)
    if dtype == torch.float32:
        q, k, v = (x.float() for x in (q, k, v))
    do = _rand(np.random.default_rng(blk + g), q.shape, dtype, dev)
    out, lse = K.packed_fwd(q, k, v, psched)
    before = (K.packed_bwd_dq.launches, K.packed_bwd_dkv.launches)
    got = K.packed_bwd(q, k, v, out, lse, do, psched)
    again = K.packed_bwd(q, k, v, out, lse, do, psched)
    torch.cuda.synchronize()
    assert (K.packed_bwd_dq.launches, K.packed_bwd_dkv.launches) == \
        (before[0] + 2, before[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(bool(torch.isfinite(x.float()).all()) for x in got)
    want = SC.packed_bwd_torch(q, k, v, out, lse, do, psched, 192 ** -0.5)
    for x, ref, name in zip(got, want, ("dq", "dk", "dv")):
        assert x.dtype == ref.dtype and x.shape == ref.shape, name
        np.testing.assert_allclose(x.float().cpu().numpy(),
                                   ref.float().cpu().numpy(), err_msg=name,
                                   **_group_grad_tol(name, dtype, g))


D192_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16)]  # (q, cache)


@pytest.mark.parametrize("q_dtype,c_dtype", D192_DTYPES)
@pytest.mark.parametrize("blk", [16, 32, 64, 128])
def test_d192_decode_bits_at_any_thread_count_and_in_any_round(
        dev, blk, q_dtype, c_dtype):
    """At D 192 no thread count in use divides the decode body's 48 (f32)
    or 24 (bf16) columns, so a thread's PV items lie on several columns;
    each output element is still computed by the same operations, a key
    at a time in key order, and a member's chunks merged in chunk order:
    the fused kernel's decode half at 2 blk threads (bf16 q) or 256 and
    packed_decode at 256 give the same bits, for members of one chunk
    (acc / l written directly) and of several, and a slot alone gives the
    bits it gives among the round."""
    g, hkv, b = 12, 1, 5
    rng = np.random.default_rng(blk + 192)
    s_cache = 4 * blk
    kv_lens, slots = [4 * blk, 3, 2 * blk + 5], [0, 2, 3]
    psched, ins, spec = _fused_case(rng, dev, blk=blk, d=192, g=g, hkv=hkv,
                                    q_dtype=q_dtype, c_dtype=c_dtype,
                                    kv_lens=kv_lens, slots=slots)
    _, o_dec = K.fused_step_fwd(*ins, psched=psched, capacity=spec.capacity,
                                tiles=spec.tiles)
    q, kc, vc = ins[3:6]
    _, _, _, tbl, needed = _decode_case(rng, dev, kv_lens, slots, blk=blk,
                                        d=192, b=b, s_cache=s_cache, q=q,
                                        caches=(kc, vc))
    split = K.packed_decode_fwd(q, kc, vc, tbl, capacity=needed, blk=blk,
                                tiles=needed)
    torch.cuda.synchronize()
    assert torch.equal(o_dec[slots], split[slots])
    chunks = [-(-min(n, s_cache) // K.DECODE_CHUNK) for n in kv_lens]
    assert 1 in chunks and (blk < 64 or max(chunks) > 1), chunks
    for slot, kv_len in zip(slots, kv_lens):
        _, _, _, alone_tbl, alone_needed = _decode_case(
            rng, dev, [kv_len], [slot], blk=blk, d=192, b=b,
            s_cache=s_cache, q=q, caches=(kc, vc))
        alone = K.packed_decode_fwd(q, kc, vc, alone_tbl,
                                    capacity=alone_needed, blk=blk,
                                    tiles=alone_needed)
        torch.cuda.synchronize()
        assert torch.equal(alone[slot], split[slot]), (blk, slot)


def _launch_counts():
    return {name: fn.launches for name, fn in K.WRAPPERS.items()}


@pytest.mark.parametrize("op", ["triangular_attention",
                                "packed_prefill_attention"])
def test_d192_autograd_runs_the_backward_kernels(dev, op):
    """triangular_attention and packed_prefill_attention differentiate a
    bf16 D 192 operand on the kernels: forward, dq and dk/dv launched
    once each, the grads within the bf16 grad policy of autograd through
    the port's full-matrix oracle (impl 'ref') in float32."""
    rng = np.random.default_rng(0)
    q, do = (_rand(rng, (1, 12, 256, 192), torch.bfloat16, dev)
             for _ in range(2))
    k, v = (_rand(rng, (1, 1, 256, 192), torch.bfloat16, dev)
            for _ in range(2))
    psched = OPS.make_packed_sched([128, 64, 64], block=64)
    grads = {}
    for impl in ("cuda", "ref"):
        dt = torch.bfloat16 if impl == "cuda" else torch.float32
        leaves = [x.to(dt).clone().requires_grad_() for x in (q, k, v)]
        before = _launch_counts()
        if op == "triangular_attention":
            out = OPS.triangular_attention(*leaves, impl=impl, block=64)
        else:
            out = OPS.packed_prefill_attention(*leaves, psched, impl=impl)
        out.backward(do.to(dt))
        moved = {n: c - before[n] for n, c in _launch_counts().items()
                 if c != before[n]}
        prefix = "tri_attn." + ("" if op == "triangular_attention"
                                else "packed_")
        assert moved == ({prefix + "fwd": 1, prefix + "bwd_dq": 1,
                          prefix + "bwd_dkv": 1} if impl == "cuda" else {}), \
            moved
        grads[impl] = [x.grad for x in leaves]
    for got, want, name in zip(grads["cuda"], grads["ref"], "qkv"):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   err_msg=f"d{name}",
                                   **_group_grad_tol(f"d{name}",
                                                     torch.bfloat16, 12))


def test_adafactor_step_on_the_card_matches_the_cpu(dev, monkeypatch):
    """One Adafactor step of a tree with a stacked (L, d) norm, stacked
    matrices (grads per layer, as the trainer hands them), a 1-D leaf and
    a leaf split into row chunks, on the card and on the CPU from the
    same numpy draws: the f32 tolerance (the card's sums run in another
    order); two runs on the card bitwise equal."""
    from repro_torch.train import optimizer as OPT

    rng = np.random.default_rng(1)
    shapes = {"embed": (300, 48), "final_norm": (48,), "norm1": (3, 48),
              "wq": (3, 48, 40)}
    draws = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(2)]
    opt = OPT.OptConfig(kind="adafactor", lr=1e-2, warmup_steps=1)
    monkeypatch.setattr(OPT, "CHUNK", 48 * 7)
    runs = []
    for where in ("cpu", dev, dev):
        p = {k: torch.tensor(x, device=where) for k, x in draws[0].items()}
        g = {k: torch.tensor(x, device=where) for k, x in draws[1].items()}
        params = {"embed": p["embed"], "final_norm": p["final_norm"],
                  "layers": {k: p[k] for k in ("norm1", "wq")}}
        grads = {"embed": g["embed"], "final_norm": g["final_norm"],
                 "layers": {k: list(g[k]) for k in ("norm1", "wq")}}
        state = OPT.init_opt_state(params, opt)
        OPT.apply_updates(opt, params, grads, state, 0)
        runs.append([p[k] for k in shapes] + [
            x for key in ("vr", "vc") for x in
            (state[key]["embed"], state[key]["final_norm"],
             state[key]["layers"]["norm1"], state[key]["layers"]["wq"])])
    for a, b, c in zip(*runs):
        assert torch.equal(b, c)
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=1e-6,
                                   rtol=1e-5)


def test_compressed_code_and_step_on_the_card_match_the_cpu(dev,
                                                            monkeypatch):
    """The int8 error-feedback code (parallel/compression.py) of a tree
    with stacked leaves handed per layer, on the card and on the CPU from
    the same numpy draws, in one chunk and in chunks of 7 elements:
    bitwise (a max, an IEEE division, round half to even). Then one
    compressed train step of the smoke yi-9b in float32, on the kernels
    and on the CPU's plain versions from one state: loss and grad norm at
    the f32 policy; each new error within 2e-4 x 127 scales (the f32 grad
    policy's absolute part at the leaf's largest target) of the CPU's or
    exactly one step off (a target within f32 noise of a half step rounds
    either way), at most 1% of a leaf's elements so; every other param at
    the f32 policy."""
    import torch_dp_worker as W
    from repro_torch.configs import registry as REG
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.parallel import compression as C
    from repro_torch.train import data as DATA
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    rng = np.random.default_rng(4)
    draws = {k: rng.standard_normal(s).astype(np.float32) * m for k, s, m in
             (("embed", (300, 48), 1.0), ("wq", (3, 48, 40), 10.0),
              ("norm1", (3, 48), 0.1))}
    errs = {k: rng.standard_normal(x.shape).astype(np.float32) * 1e-2
            for k, x in draws.items()}
    for chunk in (OPT.CHUNK, 7):
        monkeypatch.setattr(OPT, "CHUNK", chunk)
        runs = []
        for where in ("cpu", dev):
            g = {"embed": torch.tensor(draws["embed"], device=where),
                 "layers": {k: list(torch.tensor(draws[k], device=where))
                            for k in ("wq", "norm1")}}
            e = {"embed": torch.tensor(errs["embed"], device=where),
                 "layers": {k: torch.tensor(errs[k], device=where)
                            for k in ("wq", "norm1")}}
            mean, e = C.compressed_psum(g, e)
            runs.append([mean["embed"], torch.stack(mean["layers"]["wq"]),
                         torch.stack(mean["layers"]["norm1"]), e["embed"],
                         e["layers"]["wq"], e["layers"]["norm1"]])
        for a, b in zip(*runs):
            assert torch.equal(a, b.cpu())
    monkeypatch.undo()

    cfg = REG.smoke_config("yi-9b")
    opt = OPT.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    out = {}
    for where, impl in (("cpu", "torch"), (dev, "cuda")):
        state = TS.init_state(cfg, opt, seed=0, device="cpu",
                              compression=True)
        state = TS.TrainState(
            params=_to(state.params, where),
            opt_state=_to(state.opt_state, where), step=0,
            err_state=_to(state.err_state, where))
        scales = {}
        step = TS.make_train_step(
            cfg, opt, attn_impl=impl, block=16,
            compressed_allreduce=W.noting_scales(
                C.make_compressed_allreduce(), scales))
        batch = DATA.SyntheticLM(cfg, ShapeConfig("t", 64, 2, "train"),
                                 device=where).batch(0)
        state, m = step(state, batch)
        out[impl] = (state, m, scales)
    (cs, cm, sc), (gs, gm, _) = out["torch"], out["cuda"]
    np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(gm["grad_norm"]),
                               float(cm["grad_norm"]), rtol=1e-4)
    for key, want in _flat_leaves(cs.err_state).items():
        got = _flat_leaves(gs.err_state)[key]
        steps = (got.cpu() - want).abs() / float(sc[key])
        off = steps > 2e-4 * 127
        assert float(off.float().mean()) <= 1e-2, key
        assert torch.all((steps[off] - 1).abs() <= 2e-4 * 127), key
        p_got = _flat_leaves(gs.params)[key].cpu()
        p_want = _flat_leaves(cs.params)[key]
        np.testing.assert_allclose(p_got[~off].numpy(), p_want[~off].numpy(),
                                   atol=2e-5, rtol=2e-4, err_msg=key)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _flat_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat_leaves(v, key) if isinstance(v, dict)
                   else {key: v})
    return out


# ---------------------------------------------------------------------------
# The dry-run's meta branches and reckoning against the card
# ---------------------------------------------------------------------------

import torch_wrapper_cases as WC  # noqa: E402


@pytest.mark.parametrize("name", WC.NAMES)
def test_meta_branch_matches_the_kernels_outputs(dev, name):
    """Each wrapper's meta branch returns the shapes and dtypes its
    kernel returns (the attention wrappers in bf16), and launches
    nothing."""
    attn = name.startswith("tri_attn.")
    dtype = torch.bfloat16 if attn else torch.float32
    before = {n: f.launches for n, f in WC.WRAPPERS.items()}
    meta = WC.call(name, "meta", dtype)
    assert {n: f.launches for n, f in WC.WRAPPERS.items()} == before
    got = WC.call(name, dev, dtype)
    torch.cuda.synchronize()
    assert WC.WRAPPERS[name].launches == before[name] + 1
    assert [(tuple(t.shape), t.dtype) for t in meta] == \
        [(tuple(t.shape), t.dtype) for t in got]
    assert all(t.is_meta for t in meta)


@pytest.fixture(scope="module")
def cut_step_reading(dev, tmp_path_factory):
    """yi-9b at full width cut to 2 layers, seq 1024, batch 1, AdamW:
    ``python -m repro_torch.roofline.attribution`` in a fresh process (a
    window late in a process drops launches): 2 timed steps, their peak,
    the dry-run's count of the same cell, one attributed window."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    out = tmp_path_factory.mktemp("roofline") / "reading.json"
    src = Path(__file__).resolve().parents[1] / "src"
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.roofline.attribution", "--arch",
         "yi-9b", "--n-layers", "2", "--seq", "1024", "--batch", "1",
         "--steps", "2", "--json", str(out)], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(src)), timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(out.read_text())


def test_reckoned_peak_of_a_cut_train_step(cut_step_reading):
    """The dry-run's peak of the cut step within 10% of the card's
    max_memory_allocated over its steps, its split summing to it."""
    mem = cut_step_reading["reckoned"]["memory"]
    peak = mem["peak_bytes_per_device"]
    assert sum(mem["peak_split"].values()) == peak
    assert abs(peak / cut_step_reading["peak_bytes"] - 1) <= 0.10, \
        (peak, cut_step_reading["peak_bytes"])


def test_attribution_window_holds_the_wrappers_counts(cut_step_reading):
    """The window's region launches equal the wrappers' .launches over the
    step (2 layers: fwd 4 with the remat recompute, dq 2, dk/dv 2), and
    every kernel falls in a group."""
    att = cut_step_reading["attribution"]
    held = {n: c for n, c in att["launches_held"].items() if c}
    assert held == {"tri_attn.fwd": 4, "tri_attn.bwd_dq": 2,
                    "tri_attn.bwd_dkv": 2}
    for name, count in held.items():
        assert att["groups"][name]["launches"] == count
    assert "gemm" in att["groups"] and "elementwise" in att["groups"]
    assert abs(sum(g["share"] for g in att["groups"].values()) - 1) < 1e-9


@pytest.mark.parametrize("arch,wrapper", [
    ("rwkv6-1.6b", "wkv_scan"), ("jamba-1.5-large-398b", "ssm_scan")])
def test_recurrent_training_on_the_card_refuses_the_scan_kernels(dev, arch,
                                                                 wrapper):
    """A smoke-size rwkv6 or jamba train step on the card: with the scans
    on the kernels (no backward) the step raises; with scan_impl "torch"
    it trains through the plain chunked scans, and the scan kernel is
    launched no time."""
    import importlib

    from repro_torch.configs import registry as REG
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import data as DATA
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    cfg = REG.smoke_config(arch)
    opt = OPT.OptConfig()
    batch = DATA.SyntheticLM(cfg, ShapeConfig("t", 32, 2, "train"), seed=0,
                             device=dev).batch(0)
    kern = importlib.import_module(f"repro_torch.kernels.{wrapper}.kernel")
    for f in kern.WRAPPERS.values():
        f.launches = 0
    state = TS.init_state(cfg, opt, seed=0, device=dev)
    step = TS.make_train_step(cfg, opt, attn_impl="cuda", block=16)
    with pytest.raises(ValueError, match="backward"):
        step(state, batch)
    state = TS.init_state(cfg, opt, seed=0, device=dev)
    step = TS.make_train_step(cfg, opt, attn_impl="cuda", block=16,
                              scan_impl="torch")
    _, met = step(state, batch)
    assert np.isfinite(float(met["loss"]))
    assert all(f.launches == 0 for f in kern.WRAPPERS.values())
