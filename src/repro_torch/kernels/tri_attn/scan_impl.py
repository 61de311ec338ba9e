"""Plain PyTorch versions of the attention kernels.

Counterparts of the reference's ``scan`` impl (scan_impl.py: the forward
and the ``_packed_dq_cell`` / ``_packed_dkv_cell`` backward of
``make_packed_scan_attention``, ``packed_decode_scan``,
``fused_step_scan`` and the ``_fwd_cell`` / ``_dq_cell`` / ``_dkv_cell``
of ``make_scan_attention``, and the BB baseline ``fwd_bb``): the same
member tables, the same tile enumeration and the same online-softmax
order as the kernels, written as a Python loop over tiles with every
(batch, head) pair vectorized. One prefill-member body and one
decode-member body serve the forwards, as the kernels share theirs
(csrc/attn_tiles.cuh); one dq walk and one dk/dv
walk serve both backwards, over one request's row-major (dq) and
column-major (dk/dv) lambdas (``TriSched.rm_map`` / ``cm_map``) or over
the packed grid decoded from the (7, R) member table
(``_packed_steps``). They are the CPU path and the reference the CUDA
kernels are held against on the card; they are no yardstick of speed."""

from __future__ import annotations

import torch

from repro_torch.core import packing as PK
from repro_torch.kernels.tri_attn.kernel import (DECODE_NO_EMIT, MASK_VALUE,
                                                 PackedTriSched, TriSched,
                                                 check_bb_sched,
                                                 fused_step_meta, fwd_bb_meta)
from repro_torch.obs import launch as OBS


def _token_mask(i: int, j: int, blk: int, win: int, pre: int, device):
    """(blk, blk) mask of member tile (i, j): causal, the member's window
    (tokens, 0 = none) and bidirectional prefix (tokens, 0 = none)."""
    ar = torch.arange(blk, device=device)
    qp = i * blk + ar[:, None]
    kp = j * blk + ar[None, :]
    m = (kp <= qp) & ((qp - kp) < (win if win > 0 else 2 ** 30))
    return m | (kp < pre)


def _prefill_member(qg, k, v, out, lse, row0: int, n: int, w_b: int,
                    p_b: int, win: int, pre: int, blk: int, scale: float):
    """The n q-row tiles of one packed prefill member whose tiles start at
    tile row ``row0``: row i walks tiles j in [first_col, last_col] with the
    online softmax in f32. qg/out (B, Hkv, g, S, D), k/v (B, Hkv, S, D),
    lse (B, Hkv, g, S) or None."""
    b, hkv, g, _, d = qg.shape
    for i in range(n):
        rows = slice((row0 + i) * blk, (row0 + i + 1) * blk)
        qi = qg[:, :, :, rows].float()
        m_s = torch.full((b, hkv, g, blk), MASK_VALUE, dtype=torch.float32,
                         device=qg.device)
        l_s = torch.zeros_like(m_s)
        acc = torch.zeros((b, hkv, g, blk, d), dtype=torch.float32,
                          device=qg.device)
        for j in range(max(0, i - w_b + 1), max(i, p_b - 1) + 1):
            cols = slice((row0 + j) * blk, (row0 + j + 1) * blk)
            kj = k[:, :, cols].float()
            vj = v[:, :, cols].float()
            s = torch.einsum("bkgqd,bkcd->bkgqc", qi, kj) * scale
            s = torch.where(_token_mask(i, j, blk, win, pre, qg.device), s,
                            MASK_VALUE)
            m_new = torch.maximum(m_s, s.amax(dim=-1))
            alpha = torch.exp(m_s - m_new)
            p = torch.exp(s - m_new[..., None])
            l_s = l_s * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqc,bkcd->bkgqd", p, vj)
            m_s = m_new
        out[:, :, :, rows] = (acc / l_s[..., None]).to(out.dtype)
        if lse is not None:
            lse[:, :, :, rows] = m_s + torch.log(l_s)


def packed_fwd_torch(q, k, v, psched: PackedTriSched, scale: float):
    """Packed ragged forward. q (B, H, S_total, D); k, v (B, Hkv, S_total,
    D). Returns (out in q.dtype, lse f32)."""
    b, h, s_len, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    OBS.record_launch(
        OBS.meta_from_packed("tri_attn.packed_fwd", psched, impl="torch",
                             cells=b * h), (q, k, v))
    qg = q.reshape(b, hkv, g, s_len, d)
    out = torch.empty_like(q).reshape(b, hkv, g, s_len, d)
    lse = torch.empty((b, hkv, g, s_len), dtype=torch.float32,
                      device=q.device)
    row0 = 0
    for m, win, pre in zip(psched.members, psched.windows, psched.prefixes):
        _prefill_member(qg, k, v, out, lse, row0, m.n, m.w_b, m.p_b, win,
                        pre, psched.blk, scale)
        row0 += m.n
    return out.reshape(b, h, s_len, d), lse.reshape(b, h, s_len)


def _decode_member(q, k, v, out, slot: int, kv_tiles: int, kv_len: int,
                   kv_first: int, blk: int, scale: float):
    """One decode member: slot's query heads over its cache tokens
    [kv_first, kv_len), kv_tiles tiles from kv_first // blk, written to
    out[slot]. Columns owning no tiles (empty ones, the pad) write
    nothing."""
    b, h, d = q.shape
    s_cache, hkv = k.shape[1], k.shape[2]
    if not (0 <= slot < b) or kv_tiles <= 0 or \
            kv_tiles == DECODE_NO_EMIT or kv_len <= 0:
        return
    g = h // hkv
    cache_tiles = s_cache // blk
    ar = torch.arange(blk, device=q.device)
    qs = q[slot].float().reshape(hkv, g, d)
    m_s = torch.full((hkv, g), MASK_VALUE, dtype=torch.float32,
                     device=q.device)
    l_s = torch.zeros_like(m_s)
    acc = torch.zeros((hkv, g, d), dtype=torch.float32, device=q.device)
    for t in range(kv_tiles):
        tile = kv_first // blk + t
        toks = slice(min(tile, cache_tiles - 1) * blk,
                     (min(tile, cache_tiles - 1) + 1) * blk)
        kb = k[slot, toks].float()  # (blk, Hkv, D)
        vb = v[slot, toks].float()
        s = torch.einsum("kgd,tkd->kgt", qs, kb) * scale
        kpos = tile * blk + ar
        s = torch.where((kpos >= kv_first) & (kpos < kv_len), s, MASK_VALUE)
        m_new = torch.maximum(m_s, s.amax(dim=-1))
        alpha = torch.exp(m_s - m_new)
        p = torch.exp(s - m_new[..., None])
        l_s = l_s * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("kgt,tkd->kgd", p, vb)
        m_s = m_new
    out[slot] = (acc / l_s[..., None]).reshape(h, d).to(out.dtype)


def packed_decode_torch(q, k, v, tbl, *, capacity: int, blk: int,
                        tiles: int, scale: float):
    """Packed mixed-position decode round. q (B, H, D); k, v (B, S_cache,
    Hkv, D); tbl the (5, R) member table (any device). Returns (B, H, D)
    with slots not covered by a live member left zero."""
    b = q.shape[0]
    OBS.record_launch(
        OBS.meta_exact("tri_attn.packed_decode_fwd", "tri_attn",
                       impl="torch", kind="decode_round", steps=tiles,
                       block_shape=(1, blk),
                       bb_bound=b * (k.shape[1] // blk),
                       extra=(("capacity", capacity),)), (q, k, v))
    out = torch.zeros_like(q)
    for _, slot, kv_tiles, kv_len, kv_first in tbl.cpu().T.tolist():
        _decode_member(q, k, v, out, slot, kv_tiles, kv_len, kv_first, blk,
                       scale)
    return out


def fused_step_torch(q_pack, k_pack, v_pack, q_dec, k_cache, v_cache, tbl, *,
                     capacity: int, blk: int, tiles: int, scale: float):
    """Fused continuous-batching step: walks the (8, R) table member by
    member, prefill columns (kind 0) through the packed-prefill tile body
    and decode columns (kind 1) through the decode one. q_pack (1, H,
    S_pack, D); k_pack/v_pack (1, Hkv, S_pack, D); q_dec (B, H, D); caches
    (B, S_cache, Hkv, D). Returns (out_pack (1, H, S_pack, D), out_dec
    (B, H, D)) with slots not covered by a live decode member left zero."""
    _, h, s_pack, d = q_pack.shape
    b = q_dec.shape[0]
    hkv = k_pack.shape[1]
    OBS.record_launch(
        fused_step_meta("torch", b=b, h=h, s_pack=s_pack,
                        s_cache=k_cache.shape[1], blk=blk, tiles=tiles,
                        capacity=capacity, n_members=tbl.shape[1]),
        (q_pack, k_pack, v_pack, q_dec, k_cache, v_cache))
    qg = q_pack.reshape(1, hkv, h // hkv, s_pack, d)
    out_p = torch.zeros_like(qg)
    out_d = torch.zeros_like(q_dec)
    for _, kind, n, w, p, off, win, pre in tbl.cpu().T.tolist():
        if kind == 0:
            _prefill_member(qg, k_pack, v_pack, out_p, None, off, n, w, p,
                            win, pre, blk, scale)
        else:
            _decode_member(q_dec, k_cache, v_cache, out_d, off, n, w, p, blk,
                           scale)
    return out_p.reshape(1, h, s_pack, d), out_d


def fwd_torch(q, k, v, sched: TriSched, scale: float):
    """One request's ltm / band / prefix forward: the prefill-member body
    over the whole sequence. q (B, H, S, D); k, v (B, Hkv, S, D). Returns
    (out in q.dtype, lse (B, H, S) f32)."""
    b, h, s_len, d = q.shape
    hkv = k.shape[1]
    OBS.record_launch(OBS.meta_from_trisched("tri_attn.fwd", sched,
                                             impl="torch", cells=b * h),
                      (q, k, v))
    qg = q.reshape(b, hkv, h // hkv, s_len, d)
    out = torch.empty_like(qg)
    lse = torch.empty((b, hkv, h // hkv, s_len), dtype=torch.float32,
                      device=q.device)
    _prefill_member(qg, k, v, out, lse, 0, sched.n, sched.w_b, sched.p_b,
                    sched.window or 0, sched.prefix, sched.bq, scale)
    return out.reshape(b, h, s_len, d), lse.reshape(b, h, s_len)


def fwd_bb_torch(q, k, v, sched: TriSched, scale: float):
    """The BB baseline's forward (ltm or band; prefix raises): the n x n
    grid in the reference's order, row i taking tiles j = 0..n-1 with the
    j <= i guard and the token mask, which is the prefill-member body with
    every column of the row (w_b = n, no prefix). Returns (out in q.dtype,
    lse (B, H, S) f32)."""
    check_bb_sched(sched)
    b, h, s_len, d = q.shape
    hkv = k.shape[1]
    OBS.record_launch(fwd_bb_meta("torch", sched, b * h), (q, k, v))
    qg = q.reshape(b, hkv, h // hkv, s_len, d)
    out = torch.empty_like(qg)
    lse = torch.empty((b, hkv, h // hkv, s_len), dtype=torch.float32,
                      device=q.device)
    _prefill_member(qg, k, v, out, lse, 0, sched.n, sched.n, 0,
                    sched.window or 0, 0, sched.bq, scale)
    return out.reshape(b, h, s_len, d), lse.reshape(b, h, s_len)


def _bwd_tile(row0, i, j, blk, win, pre, k, v, qg, dog, lse, dlt, scale):
    """P and dS of member tile (i, j), the member's tiles starting at tile
    row ``row0``, for every (batch, kv head, group head): (B, Hkv, g, blk,
    blk) f32, plus the f32 q, k and do tiles."""
    ri = slice((row0 + i) * blk, (row0 + i + 1) * blk)
    rj = slice((row0 + j) * blk, (row0 + j + 1) * blk)
    qi, doi = qg[:, :, :, ri].float(), dog[:, :, :, ri].float()
    kj, vj = k[:, :, rj].float(), v[:, :, rj].float()
    s = torch.einsum("bkgqd,bkcd->bkgqc", qi, kj) * scale
    s = torch.where(_token_mask(i, j, blk, win, pre, qg.device), s,
                    MASK_VALUE)
    p = torch.exp(s - lse[:, :, :, ri, None])
    dp = torch.einsum("bkgqd,bkcd->bkgqc", doi, vj)
    return p, p * (dp - dlt[:, :, :, ri, None]) * scale, qi, kj, doi


def _grouped(q, do, lse, delta, hkv):
    """q, do, lse and delta with the query heads split (B, Hkv, g, ...)."""
    b, h, s_len, d = q.shape
    g = h // hkv
    return (q.reshape(b, hkv, g, s_len, d), do.reshape(b, hkv, g, s_len, d),
            lse.reshape(b, hkv, g, s_len), delta.reshape(b, hkv, g, s_len))


def _sched_steps(sched: TriSched, cm: bool):
    """One request's tile steps in the kernels' order, as (row0, i, j,
    first, last, win, pre) with row0 = 0: row-major (first/last the row's
    columns) or column-major (first/last the column's rows)."""
    win, pre = sched.window or 0, sched.prefix
    for lam in range(sched.cm_steps if cm else sched.rm_steps):
        if cm:
            i, j = sched.cm_map(lam)
            yield 0, i, j, sched.cm_first_row(j), sched.cm_last_row(j), \
                win, pre
        else:
            i, j = sched.rm_map(lam)
            yield 0, i, j, sched.rm_first_col(i), sched.rm_last_col(i), \
                win, pre


def _packed_steps(psched: PackedTriSched, cm: bool):
    """The packed grid's tile steps, decoded from the (7, R) member table
    as the reference's ``_packed_decode`` / ``_packed_decode_cm`` do: the
    member by ``request_from_starts``, (i, j) by ``member_map_params``
    (row-major) or ``member_cm_map_params`` (column-major). Returns the
    (row0, i, j, first, last, win, pre) tuples of every lambda, as
    ``_sched_steps``."""
    tbl = torch.as_tensor(psched.table())
    lam = torch.arange(psched.steps, dtype=torch.int32)
    r = PK.request_from_starts(lam, tbl[0], len(psched.members)).long()
    local = lam - tbl[0][r]
    n, w, p = tbl[2][r], tbl[3][r], tbl[4][r]
    if cm:
        i, j = PK.member_cm_map_params(local, n, w, p)
        first, last = PK.cm_first_row_params(j, p), \
            PK.cm_last_row_params(j, n, w)
    else:
        i, j = PK.member_map_params(local, n, w, p)
        first, last = PK.first_col_params(i, w), PK.last_col_params(i, p)
    cols = (tbl[1][r], i, j, first, last, tbl[5][r], tbl[6][r])
    return list(zip(*(torch.as_tensor(c).tolist() for c in cols)))


def _dq_walk(steps, q, k, v, do, lse, delta, blk: int, scale: float):
    """dq over row-major tile steps: reset at a row's first column, emit
    at its last. lse, delta (B, H, S) f32. Returns dq in q's dtype."""
    b, h, s_len, d = q.shape
    tile = _grouped(q, do, lse, delta, k.shape[1])
    dq = torch.empty_like(tile[0])
    for row0, i, j, first, last, win, pre in steps:
        if j == first:
            acc = torch.zeros(dq.shape[:3] + (blk, d), dtype=torch.float32,
                              device=q.device)
        _, ds, _, kj, _ = _bwd_tile(row0, i, j, blk, win, pre, k, v, *tile,
                                    scale)
        acc = acc + torch.einsum("bkgqc,bkcd->bkgqd", ds, kj)
        if j == last:
            dq[:, :, :, (row0 + i) * blk:(row0 + i + 1) * blk] = \
                acc.to(dq.dtype)
    return dq.reshape(b, h, s_len, d)


def _dkv_walk(steps, q, k, v, do, lse, delta, blk: int, scale: float):
    """dk and dv over column-major tile steps (reset at a column's first
    row, emit at its last), summed over each kv head's query heads.
    Returns (dk, dv) in k's dtype."""
    b, hkv = k.shape[:2]
    tile = _grouped(q, do, lse, delta, hkv)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for row0, i, j, first, last, win, pre in steps:
        if i == first:
            acc_k = torch.zeros((b, hkv, blk, k.shape[-1]),
                                dtype=torch.float32, device=q.device)
            acc_v = torch.zeros_like(acc_k)
        p, ds, qi, _, doi = _bwd_tile(row0, i, j, blk, win, pre, k, v,
                                      *tile, scale)
        acc_v = acc_v + torch.einsum("bkgqc,bkgqd->bkcd", p, doi)
        acc_k = acc_k + torch.einsum("bkgqc,bkgqd->bkcd", ds, qi)
        if i == last:
            cols = slice((row0 + j) * blk, (row0 + j + 1) * blk)
            dk[:, :, cols] = acc_k.to(dk.dtype)
            dv[:, :, cols] = acc_v.to(dv.dtype)
    return dk, dv


def dq_torch(q, k, v, do, lse, delta, sched: TriSched, scale: float):
    """dq over the row-major lambdas of one request. lse, delta (B, H, S)
    f32. Returns dq in q's dtype."""
    OBS.record_launch(OBS.meta_from_trisched("tri_attn.bwd_dq", sched,
                                             impl="torch",
                                             cells=q.shape[0] * q.shape[1]),
                      (q, k, v, do))
    return _dq_walk(_sched_steps(sched, cm=False), q, k, v, do, lse, delta,
                    sched.bq, scale)


def dkv_torch(q, k, v, do, lse, delta, sched: TriSched, scale: float):
    """dk and dv over the column-major lambdas of one request. Returns
    (dk, dv) in k's dtype."""
    OBS.record_launch(OBS.meta_from_trisched("tri_attn.bwd_dkv", sched,
                                             impl="torch",
                                             cells=q.shape[0] * q.shape[1]),
                      (q, k, v, do))
    return _dkv_walk(_sched_steps(sched, cm=True), q, k, v, do, lse, delta,
                     sched.bq, scale)


def bwd_torch(q, k, v, out, lse, do, sched: TriSched, scale: float):
    """Backward of ``fwd_torch``, as ``kernel.bwd`` composes it: delta =
    sum(do * out), then dq and dk/dv. Returns (dq, dk, dv)."""
    delta = (do.float() * out.float()).sum(dim=-1)
    return (dq_torch(q, k, v, do, lse, delta, sched, scale),
            *dkv_torch(q, k, v, do, lse, delta, sched, scale))


def packed_dq_torch(q, k, v, do, lse, delta, psched: PackedTriSched,
                    scale: float):
    """Packed dq over the row-major packed grid (the reference's
    ``_packed_dq_cell``). q, do (B, H, S_total, D); k, v (B, Hkv,
    S_total, D); lse, delta (B, H, S_total) f32. Returns dq in q's
    dtype."""
    OBS.record_launch(OBS.meta_from_packed("tri_attn.packed_bwd_dq", psched,
                                           impl="torch",
                                           cells=q.shape[0] * q.shape[1]),
                      (q, k, v, do))
    return _dq_walk(_packed_steps(psched, cm=False), q, k, v, do, lse,
                    delta, psched.blk, scale)


def packed_dkv_torch(q, k, v, do, lse, delta, psched: PackedTriSched,
                     scale: float):
    """Packed dk/dv over the column-major packed grid (the reference's
    ``_packed_dkv_cell``), summed over each kv head's query heads.
    Returns (dk, dv) in k's dtype."""
    OBS.record_launch(OBS.meta_from_packed("tri_attn.packed_bwd_dkv",
                                           psched, impl="torch",
                                           cells=q.shape[0] * q.shape[1]),
                      (q, k, v, do))
    return _dkv_walk(_packed_steps(psched, cm=True), q, k, v, do, lse,
                     delta, psched.blk, scale)


def packed_bwd_torch(q, k, v, out, lse, do, psched: PackedTriSched,
                     scale: float):
    """Backward of ``packed_fwd_torch``, as ``kernel.packed_bwd`` composes
    it: delta = sum(do * out), then dq and dk/dv. Returns (dq, dk, dv)."""
    delta = (do.float() * out.float()).sum(dim=-1)
    return (packed_dq_torch(q, k, v, do, lse, delta, psched, scale),
            *packed_dkv_torch(q, k, v, do, lse, delta, psched, scale))
