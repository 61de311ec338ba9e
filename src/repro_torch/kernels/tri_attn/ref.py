"""Oracle for triangular-domain attention (causal / band / prefix).

Port of ``repro/kernels/tri_attn/ref.py``: it materializes the full S x S
score matrix, so it is only usable at test scale."""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = float(np.finfo(np.float32).min)


def attention_mask(s_q: int, s_k: int, *, window=None, prefix: int = 0,
                   q_offset: int = 0, device=None):
    """Boolean (s_q, s_k) mask, True = attend: causal, AND q - k < window,
    OR k < prefix; q_offset shifts query positions."""
    qp = torch.arange(s_q, device=device)[:, None] + q_offset
    kp = torch.arange(s_k, device=device)[None, :]
    m = kp <= qp
    if window is not None:
        m &= (qp - kp) < window
    if prefix:
        m |= kp < prefix
    return m


def repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, Hkv, S, D) -> (B, H, S, D) by repeating each kv head G times."""
    g = n_heads // k.shape[1]
    return torch.repeat_interleave(k, g, dim=1) if g > 1 else k


def mha_reference(q, k, v, *, sm_scale=None, window=None, prefix: int = 0,
                  q_offset: int = 0, return_lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, Hkv, Sk, D). Returns out (B, H, Sq, D)
    [and lse (B, H, Sq) if return_lse]."""
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    k = repeat_kv(k, q.shape[1])
    v = repeat_kv(v, q.shape[1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(sq, sk, window=window, prefix=prefix,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l, v.float()).to(q.dtype)
    if return_lse:
        return out, m[..., 0] + torch.log(l[..., 0])
    return out
