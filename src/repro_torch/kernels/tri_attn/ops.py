"""Public attention ops (port of ``repro/kernels/tri_attn/ops.py``).

``triangular_attention`` + ``make_sched``: one request's causal, banded or
prefix-causal attention (the models' training path), differentiable: the
forward saves (q, k, v, out, lse) and the backward runs the dq and dk/dv
launches.
``packed_prefill_attention`` + ``make_packed_sched``: R requests (or
documents) of mixed lengths concatenated along S, attended
block-diagonally in ONE launch, differentiable: the backward runs one
packed dq and one packed dk/dv launch (packed document training).
``packed_decode_attention`` + ``make_decode_table`` + ``DecodeRoundSpec``:
one mixed-position decode round per launch, each live slot attending only
its own valid KV prefix.
``fused_step_attention`` + ``make_fused_table`` + ``FusedStepSpec``: one
continuous-batching engine step per launch, the round's admitted prompts
(packed prefill members) and its live decode slots from one (8, R) table.

impl names:
  'cuda'  — the hand-written kernel (kernel.py -> csrc/); CUDA tensors
            only, it raises on CPU tensors rather than running anything
            else;
  'torch' — the plain PyTorch version (scan_impl.py), the counterpart of
            the reference's 'scan', on any device;
  'bb', 'bb_torch' — ``triangular_attention`` only: the paper's
            bounding-box baseline (``kernel.fwd_bb``, CUDA tensors only) and
            its plain version, forward only;
  'ref'   — the masked full-matrix oracle (ref.py), tests only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ref as R
from repro_torch.kernels.tri_attn import scan_impl as SC
from repro_torch.kernels.tri_attn.kernel import (DECODE_NO_EMIT,
                                                 PackedTriSched, TriSched)

IMPLS = ("cuda", "torch", "ref", "bb", "bb_torch")


def _require_cuda(impl: str, t: torch.Tensor, op: str):
    if impl in ("cuda", "bb") and not t.is_cuda:
        raise ValueError(
            f"{op}: impl={impl!r} needs CUDA tensors, got {t.device}; pass "
            f"impl={'torch' if impl == 'cuda' else 'bb_torch'!r} for the "
            "plain PyTorch version")


def make_sched(s_len: int, *, block: int, window=None,
               prefix: int = 0) -> TriSched:
    """Square-tiled schedule of one sequence: ``window`` -> band,
    ``prefix`` -> prefix-causal, else ltm. The reference takes block_q and
    block_k but squares them for every kind, so the port takes one edge."""
    blk = min(block, s_len)
    if s_len % blk:
        raise ValueError(f"seq {s_len} not divisible by block {blk}")
    kind = "band" if window is not None else ("prefix" if prefix else "ltm")
    return TriSched(kind=kind, n=s_len // blk, bq=blk, bk=blk,
                    window=window, prefix=prefix)


class _TriAttention(torch.autograd.Function):
    """Custom VJP of the triangular attention (the reference's
    ``_pallas_attention`` / ``make_scan_attention``): impl 'cuda' runs the
    kernels, 'torch' their plain versions, on whatever device q is."""

    @staticmethod
    def forward(ctx, q, k, v, sched, scale, impl):
        if impl == "cuda":
            out, lse = K.fwd(q, k, v, sched, sm_scale=scale)
        else:
            out, lse = SC.fwd_torch(q, k, v, sched, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sched, ctx.scale, ctx.impl = sched, scale, impl
        return out

    @staticmethod
    def backward(ctx, do):
        args = ctx.saved_tensors + (do.contiguous(), ctx.sched)
        if ctx.impl == "cuda":
            dq, dk, dv = K.bwd(*args, sm_scale=ctx.scale)
        else:
            dq, dk, dv = SC.bwd_torch(*args, ctx.scale)
        return dq, dk, dv, None, None, None


def triangular_attention(q, k, v, *, window=None, prefix: int = 0,
                         impl: str = "cuda", block: int = 64):
    """Causal (optionally windowed / prefix-causal) attention of one
    request, differentiable under every impl.

    q: (B, H, S, D); k, v: (B, Hkv, S, D), H % Hkv == 0. Returns
    (B, H, S, D). impl 'bb' / 'bb_torch' run the paper's bounding-box
    baseline (the kernel / its plain version), forward only as in the
    reference: they raise on an operand that requires a grad, and on
    prefix > 0, where the reference's BB guard drops tiles the rows
    need."""
    s_len, d = q.shape[2], q.shape[3]
    scale = 1.0 / (d ** 0.5)
    if impl == "ref":
        return R.mha_reference(q, k, v, sm_scale=scale, window=window,
                               prefix=prefix)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; known {IMPLS}")
    if impl in ("bb", "bb_torch"):
        if any(x.requires_grad for x in (q, k, v)):
            raise ValueError(f"triangular_attention: impl={impl!r} is "
                             "forward only; pass operands that need no "
                             "grad")
        if prefix:
            raise ValueError(f"triangular_attention: impl={impl!r} refuses "
                             "prefix > 0 (the BB guard j <= i drops the "
                             "above-diagonal prefix tiles)")
    _require_cuda(impl, q, "triangular_attention")
    if impl in ("bb", "bb_torch"):
        args = (q.contiguous(), k.contiguous(), v.contiguous(),
                make_sched(s_len, block=block, window=window))
        if impl == "bb":
            return K.fwd_bb(*args, sm_scale=scale)[0]
        return SC.fwd_bb_torch(*args, scale)[0]
    sched = make_sched(s_len, block=block, window=window, prefix=prefix)
    return _TriAttention.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), sched, scale, impl)


def make_packed_sched(seq_lens, *, block: int, window=None,
                      prefix=0) -> PackedTriSched:
    """Packed ragged-batch schedule for per-request token lengths (each a
    multiple of ``block``). window / prefix: scalars for every member or
    per-request sequences; window -> band, prefix -> prefix, else ltm."""
    seq_lens = tuple(int(s) for s in seq_lens)
    r = len(seq_lens)
    windows = tuple(window) if isinstance(window, (list, tuple)) \
        else (window,) * r
    prefixes = tuple(prefix) if isinstance(prefix, (list, tuple)) \
        else (prefix,) * r
    if len(windows) != r or len(prefixes) != r:
        raise ValueError(
            f"per-request window/prefix lists must match the batch: "
            f"{len(windows)} windows / {len(prefixes)} prefixes for {r} "
            f"requests")
    members = []
    for s_len, w, p in zip(seq_lens, windows, prefixes):
        if s_len % block:
            raise ValueError(f"member seq {s_len} not padded to block "
                             f"{block}")
        kind = "band" if w is not None else ("prefix" if p else "ltm")
        members.append(TriSched(kind=kind, n=s_len // block, bq=block,
                                bk=block, window=w, prefix=p))
    return PackedTriSched(members=tuple(members))


class _PackedTriAttention(torch.autograd.Function):
    """Custom VJP of the packed attention (the reference's
    ``_packed_pallas_attention`` / ``make_packed_scan_attention``): the
    forward runs ``packed_fwd``, the backward the packed dq and dk/dv;
    impl 'cuda' runs the kernels, 'torch' their plain versions. Nothing is
    saved unless an operand needs a grad, so serving pays no more than
    the forward launch."""

    @staticmethod
    def forward(ctx, q, k, v, psched, scale, impl):
        if impl == "cuda":
            out, lse = K.packed_fwd(q, k, v, psched, sm_scale=scale)
        else:
            out, lse = SC.packed_fwd_torch(q, k, v, psched, scale)
        if any(ctx.needs_input_grad[:3]):
            ctx.save_for_backward(q, k, v, out, lse)
            ctx.psched, ctx.scale, ctx.impl = psched, scale, impl
        return out

    @staticmethod
    def backward(ctx, do):
        args = ctx.saved_tensors + (do.contiguous(), ctx.psched)
        if ctx.impl == "cuda":
            dq, dk, dv = K.packed_bwd(*args, sm_scale=ctx.scale)
        else:
            dq, dk, dv = SC.packed_bwd_torch(*args, ctx.scale)
        return dq, dk, dv, None, None, None


def packed_prefill_attention(q, k, v, psched: PackedTriSched, *,
                             sm_scale=None, impl: str = "cuda"):
    """Ragged batched attention over the packed layout (prefill and
    packed document training), differentiable under every impl.

    q: (B, H, S_total, D); k, v: (B, Hkv, S_total, D). One launch covers
    every request: sum_r blocks_r tile steps, no cross-request tiles; the
    backward is one packed dq and one packed dk/dv launch over the same
    member table. Returns (B, H, S_total, D)."""
    b, h, s_len, d = q.shape
    if s_len != psched.s_total:
        raise ValueError(f"packed operand has {s_len} rows but the "
                         f"schedule covers {psched.s_total}")
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    if impl in ("cuda", "torch"):
        _require_cuda(impl, q, "packed_prefill_attention")
        return _PackedTriAttention.apply(q.contiguous(), k.contiguous(),
                                         v.contiguous(), psched, scale, impl)
    if impl == "ref":
        outs, base = [], 0
        for m in psched.members:
            seg = slice(base, base + m.n * m.bq)
            outs.append(R.mha_reference(q[:, :, seg], k[:, :, seg],
                                        v[:, :, seg], sm_scale=scale,
                                        window=m.window, prefix=m.prefix))
            base += m.n * m.bq
        return torch.cat(outs, dim=2)
    raise ValueError(f"unknown impl {impl!r}; known {IMPLS}")


@dataclasses.dataclass(frozen=True)
class DecodeRoundSpec:
    """Static half of a packed decode round; the dynamic half is the
    (5, R) member table from ``make_decode_table``. ``capacity`` is the
    reference's bucketed grid size, kept for ABI and telemetry parity:
    the CUDA grid does not walk pad steps, it walks ``tiles``."""

    n_members: int  # table width R: max live slots + 1 (the pad member)
    capacity: int   # bucketed grid size >= the round's live tiles
    blk: int        # KV tile edge (divides S_cache)
    impl: str = "cuda"
    tiles: int = 0  # the round's live tiles (sum of member kv_tiles)


def make_decode_table(kv_lens, slots, *, blk: int, n_members: int,
                      n_slots: int, s_cache: int = 0, window=None):
    """One decode round's (5, n_members) int32 member table: rows starts
    | slot | kv_tiles | kv_len | kv_first. Unused columns are empty
    (cur, 0, 0, 0, 0); the last column is the pad member
    (cur, n_slots, DECODE_NO_EMIT, 0, 0). ``window`` band-limits a slot to
    its last w tokens (non-rolling caches only). Returns (table, needed)
    with ``needed`` the live tile count."""
    kv_lens = [int(s) for s in kv_lens]
    slots = [int(s) for s in slots]
    windows = list(window) if isinstance(window, (list, tuple)) \
        else [window] * len(kv_lens)
    if len(windows) != len(kv_lens):
        raise ValueError(f"per-slot window list must match the round: "
                         f"{len(windows)} windows for {len(kv_lens)} slots")
    if not len(kv_lens) == len(slots) <= n_members - 1:
        raise ValueError(f"{len(kv_lens)} live members need table width >= "
                         f"{len(kv_lens) + 1}, got {n_members}")
    if not all(s >= 1 for s in kv_lens):
        raise ValueError("live slots attend >= 1 token")
    if not all(w is None or w >= 1 for w in windows):
        raise ValueError("band-limited slots attend >= 1 token windows")
    if s_cache and kv_lens and max(kv_lens) > s_cache:
        raise ValueError(f"kv_lens {kv_lens} exceed the KV cache ({s_cache} "
                         f"rows); clamp to min(pos + 1, S_cache)")
    cols, cur = [], 0
    for kl, sl, w in zip(kv_lens, slots, windows):
        first = 0 if w is None else max(0, kl - int(w))
        t = -(-kl // blk) - first // blk
        cols.append((cur, sl, t, kl, first))
        cur += t
    while len(cols) < n_members - 1:
        cols.append((cur, 0, 0, 0, 0))
    cols.append((cur, n_slots, DECODE_NO_EMIT, 0, 0))
    return np.asarray(cols, np.int32).T.copy(), cur


def packed_decode_attention(q, k_cache, v_cache, tbl,
                            spec: DecodeRoundSpec, *, sm_scale=None):
    """Single-token attention for a whole mixed-position decode round.

    q: (B, H, D) rotated queries; k_cache, v_cache: (B, S_cache, Hkv, D)
    with the new token written; tbl: the (5, R) int32 table on q's device.
    Slots without a live member return zeros."""
    b, h, d = q.shape
    s_cache = k_cache.shape[1]
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    if tuple(tbl.shape) != (5, spec.n_members):
        raise ValueError(f"table {tuple(tbl.shape)} != (5, "
                         f"{spec.n_members})")
    if s_cache % spec.blk or spec.capacity < 1:
        raise ValueError(f"block {spec.blk} must divide S_cache {s_cache}")
    if spec.impl == "cuda":
        _require_cuda(spec.impl, q, "packed_decode_attention")
        full = K.packed_decode_fwd(q, k_cache, v_cache, tbl,
                                   capacity=spec.capacity, blk=spec.blk,
                                   tiles=spec.tiles, sm_scale=scale)
        covered = _covered_slots(tbl, b)
        return torch.where(covered[:, None, None], full[:b],
                           torch.zeros((), dtype=q.dtype, device=q.device))
    if spec.impl == "torch":
        return SC.packed_decode_torch(q, k_cache, v_cache, tbl,
                                      capacity=spec.capacity, blk=spec.blk,
                                      tiles=spec.tiles, scale=scale)
    if spec.impl == "ref":
        kv_len = _slot_reduce(tbl[1], tbl[3], b)
        kv_first = _slot_reduce(tbl[1], tbl[4], b)
        srng = torch.arange(s_cache, device=q.device)[None, :]
        valid = (srng >= kv_first[:, None]) & (srng < kv_len[:, None])
        out = _masked_decode_einsum(q, k_cache, v_cache, valid, scale)
        return torch.where((kv_len > 0)[:, None, None], out,
                           torch.zeros((), dtype=q.dtype, device=q.device))
    raise ValueError(f"unknown impl {spec.impl!r}; known {IMPLS}")


def _slot_reduce(slots, values, b):
    """(B,) scatter-max of per-member ``values`` onto their slots; the
    pad member's slot == B lands in a dropped extra row."""
    out = torch.zeros((b + 1,), dtype=torch.int32, device=slots.device)
    return out.scatter_reduce(0, slots.long(), values.to(torch.int32),
                              reduce="amax")[:b]


def _covered_slots(tbl, b):
    """(B,) bool: slots owned by some live member."""
    return _slot_reduce(tbl[1], (tbl[3] > 0).to(torch.int32), b) > 0


def _masked_decode_einsum(q, k_cache, v_cache, valid, scale):
    """Full-cache masked attention (the decode oracle): q (B, H, D),
    caches (B, S, Hkv, D), valid (B, S) -> (B, H, D)."""
    b, h, d = q.shape
    hkv = k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    s = torch.where(valid[:, None, None, :], s, R.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(b, h, d).to(q.dtype)


@dataclasses.dataclass(frozen=True)
class FusedStepSpec:
    """Static half of a fused step; the dynamic half is the (8, R) table
    from ``make_fused_table``. ``capacity`` (psched.steps + the bucketed
    decode capacity) is the reference's grid size, kept for telemetry
    parity: the CUDA grid walks ``tiles``, the round's live tiles."""

    n_members: int  # prefill members + decode columns + the pad member
    capacity: int   # bucketed grid size >= the round's live tiles
    blk: int        # tile edge (divides S_pack and S_cache)
    impl: str = "cuda"
    tiles: int = 0  # psched.steps + the round's live decode tiles


def make_fused_table(psched: PackedTriSched, kv_lens, slots, *, blk: int,
                     n_members: int, n_slots: int, s_cache: int = 0,
                     window=None):
    """One fused step's (8, n_members) int32 table: the prefill columns
    first (one per psched member, from its (7, R) table), then the decode
    columns of ``make_decode_table`` rebased by psched.steps, the pad
    member last. Rows:

      0 starts | 1 kind (0 prefill, 1 decode/pad) | 2 n or kv_tiles |
      3 w_b or kv_len | 4 p_b or kv_first | 5 q_off or slot | 6 win or 0 |
      7 pre or 0

    Returns (table, needed) with needed = psched.steps + live decode
    tiles."""
    pt = psched.table()
    r_p = pt.shape[1]
    if any(m.bq != blk or m.bk != blk for m in psched.members):
        raise ValueError(f"fused step needs square tiles == blk {blk}")
    dt, needed_dec = make_decode_table(
        kv_lens, slots, blk=blk, n_members=n_members - r_p, n_slots=n_slots,
        s_cache=s_cache, window=window)
    cols = [(t[0], 0, t[2], t[3], t[4], t[1], t[5], t[6]) for t in pt.T]
    cols += [(psched.steps + c[0], 1, c[2], c[3], c[4], c[1], 0, 0)
             for c in dt.T]
    return np.asarray(cols, np.int32).T.copy(), psched.steps + needed_dec


def fused_step_attention(q_pack, k_pack, v_pack, q_dec, k_cache, v_cache,
                         tbl, psched: PackedTriSched, spec: FusedStepSpec, *,
                         sm_scale=None):
    """One attention launch for a whole continuous-batching step.

    q_pack: (1, H, S_pack, D) packed admitted prompts, k_pack/v_pack
    (1, Hkv, S_pack, D); q_dec: (B, H, D) one new token per slot;
    k_cache/v_cache: (B, S_cache, Hkv, D) with the decode tokens written;
    tbl: the (8, R) int32 table on q's device. Returns (out_pack (1, H,
    S_pack, D), out_dec (B, H, D)); slots without a live decode member
    return zeros."""
    b, h, d = q_dec.shape
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    if tuple(tbl.shape) != (8, spec.n_members):
        raise ValueError(f"table {tuple(tbl.shape)} != (8, "
                         f"{spec.n_members})")
    if q_pack.shape[2] != psched.s_total or k_cache.shape[1] % spec.blk \
            or spec.capacity < psched.steps:
        raise ValueError(
            f"pack of {q_pack.shape[2]} rows for a {psched.s_total}-row "
            f"schedule, S_cache {k_cache.shape[1]} at block {spec.blk}, "
            f"capacity {spec.capacity} < {psched.steps} prefill steps")
    if spec.impl == "cuda":
        _require_cuda(spec.impl, q_pack, "fused_step_attention")
        o_pack, o_dec = K.fused_step_fwd(
            q_pack, k_pack, v_pack, q_dec, k_cache, v_cache, tbl,
            psched=psched, capacity=spec.capacity, tiles=spec.tiles,
            sm_scale=scale)
        covered = _fused_covered_slots(tbl, b)
        return o_pack, torch.where(covered[:, None, None], o_dec[:b],
                                   torch.zeros((), dtype=q_dec.dtype,
                                               device=q_dec.device))
    if spec.impl == "torch":
        return SC.fused_step_torch(
            q_pack, k_pack, v_pack, q_dec, k_cache, v_cache, tbl,
            capacity=spec.capacity, blk=spec.blk, tiles=spec.tiles,
            scale=scale)
    if spec.impl == "ref":
        r_p = len(psched.members)
        out_pack = packed_prefill_attention(q_pack, k_pack, v_pack, psched,
                                            sm_scale=scale, impl="ref")
        dec = tbl[:, r_p:]
        kv_len = _slot_reduce(dec[5], dec[3], b)
        kv_first = _slot_reduce(dec[5], dec[4], b)
        srng = torch.arange(k_cache.shape[1], device=q_dec.device)[None, :]
        valid = (srng >= kv_first[:, None]) & (srng < kv_len[:, None])
        out = _masked_decode_einsum(q_dec, k_cache, v_cache, valid, scale)
        return out_pack, torch.where(
            (kv_len > 0)[:, None, None], out,
            torch.zeros((), dtype=q_dec.dtype, device=q_dec.device))
    raise ValueError(f"unknown impl {spec.impl!r}; known {IMPLS}")


def _fused_covered_slots(tbl, b):
    """(B,) bool: slots owned by a live DECODE member of the fused table
    (prefill columns scatter into the dropped extra row)."""
    slots = torch.where(tbl[1] == 1, tbl[5], torch.full_like(tbl[5], b))
    return _slot_reduce(slots, (tbl[3] > 0).to(torch.int32), b) > 0
