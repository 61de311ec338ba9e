"""Plain PyTorch versions of the packed attention kernels.

Counterparts of the reference's ``scan`` impl (scan_impl.py: the forward
of ``make_packed_scan_attention`` and ``packed_decode_scan``): the same
member tables, the same tile enumeration and the same online-softmax
order as the kernels, written as a Python loop over tiles with every
(batch, head) pair vectorized. They are the CPU path and the reference
the CUDA kernels are held against on the card; they are no yardstick of
speed.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.tri_attn.kernel import (DECODE_NO_EMIT, MASK_VALUE,
                                                 PackedTriSched)
from repro_torch.obs import launch as OBS


def _token_mask(i: int, j: int, blk: int, win: int, pre: int, device):
    """(blk, blk) mask of member tile (i, j): causal, the member's window
    (tokens, 0 = none) and bidirectional prefix (tokens, 0 = none)."""
    ar = torch.arange(blk, device=device)
    qp = i * blk + ar[:, None]
    kp = j * blk + ar[None, :]
    m = (kp <= qp) & ((qp - kp) < (win if win > 0 else 2 ** 30))
    return m | (kp < pre)


def packed_fwd_torch(q, k, v, psched: PackedTriSched, scale: float):
    """Packed ragged forward. q (B, H, S_total, D); k, v (B, Hkv, S_total,
    D). Each member row i walks its tiles j in [first_col, last_col] with
    the online softmax in f32. Returns (out in q.dtype, lse f32)."""
    b, h, s_len, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    blk = psched.blk
    OBS.record_launch(
        OBS.meta_from_packed("tri_attn.packed_fwd", psched, impl="torch",
                             cells=b * h), (q, k, v))
    qg = q.reshape(b, hkv, g, s_len, d)
    out = torch.empty_like(q).reshape(b, hkv, g, s_len, d)
    lse = torch.empty((b, hkv, g, s_len), dtype=torch.float32,
                      device=q.device)
    row0 = 0
    for m, win, pre in zip(psched.members, psched.windows, psched.prefixes):
        w_b, p_b = m.w_b, m.p_b
        for i in range(m.n):
            rows = slice((row0 + i) * blk, (row0 + i + 1) * blk)
            qi = qg[:, :, :, rows].float()
            m_s = torch.full((b, hkv, g, blk), MASK_VALUE,
                             dtype=torch.float32, device=q.device)
            l_s = torch.zeros_like(m_s)
            acc = torch.zeros((b, hkv, g, blk, d), dtype=torch.float32,
                              device=q.device)
            for j in range(max(0, i - w_b + 1), max(i, p_b - 1) + 1):
                cols = slice((row0 + j) * blk, (row0 + j + 1) * blk)
                kj = k[:, :, cols].float()
                vj = v[:, :, cols].float()
                s = torch.einsum("bkgqd,bkcd->bkgqc", qi, kj) * scale
                s = torch.where(_token_mask(i, j, blk, win, pre, q.device),
                                s, MASK_VALUE)
                m_new = torch.maximum(m_s, s.amax(dim=-1))
                alpha = torch.exp(m_s - m_new)
                p = torch.exp(s - m_new[..., None])
                l_s = l_s * alpha + p.sum(dim=-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bkgqc,bkcd->bkgqd", p, vj)
                m_s = m_new
            out[:, :, :, rows] = (acc / l_s[..., None]).to(q.dtype)
            lse[:, :, :, rows] = m_s + torch.log(l_s)
        row0 += m.n
    return out.reshape(b, h, s_len, d), lse.reshape(b, h, s_len)


def packed_decode_torch(q, k, v, tbl, *, capacity: int, blk: int,
                        tiles: int, scale: float):
    """Packed mixed-position decode round. q (B, H, D); k, v (B, S_cache,
    Hkv, D); tbl the (5, R) member table (any device). Each live member
    walks its kv_tiles cache tiles from kv_first // blk, masked to
    [kv_first, kv_len). Returns (B, H, D) with slots not covered by a live
    member left zero."""
    b, h, d = q.shape
    s_cache, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    cache_tiles = s_cache // blk
    OBS.record_launch(
        OBS.meta_exact("tri_attn.packed_decode_fwd", "tri_attn",
                       impl="torch", kind="decode_round", steps=tiles,
                       block_shape=(1, blk), bb_bound=b * cache_tiles,
                       extra=(("capacity", capacity),)), (q, k, v))
    out = torch.zeros_like(q)
    ar = torch.arange(blk, device=q.device)
    for _, slot, kv_tiles, kv_len, kv_first in tbl.cpu().T.tolist():
        if not (0 <= slot < b) or kv_tiles <= 0 or \
                kv_tiles == DECODE_NO_EMIT or kv_len <= 0:
            continue
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
            s = torch.where((kpos >= kv_first) & (kpos < kv_len), s,
                            MASK_VALUE)
            m_new = torch.maximum(m_s, s.amax(dim=-1))
            alpha = torch.exp(m_s - m_new)
            p = torch.exp(s - m_new[..., None])
            l_s = l_s * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("kgt,tkd->kgd", p,
                                                        vb)
            m_s = m_new
        out[slot] = (acc / l_s[..., None]).reshape(h, d).to(q.dtype)
    return out
