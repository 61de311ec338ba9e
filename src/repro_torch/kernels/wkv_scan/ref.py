"""Oracle of the fused WKV6 (RWKV-6 Finch) recurrence.

Port of ``repro/kernels/wkv_scan/ref.py``. Per head (state S: (hd_k,
hd_v)):

    out_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
    S_t   = diag(w_t) S_{t-1} + k_t^T v_t,   w_t = exp(lw_t), lw_t <= 0

Shapes: r, k, v, lw (B, L, H, hd); u (H, hd); s0 (B, H, hd, hd).
Returns (out (B, L, H, hd), s_L), all f32. The steps run in order, one
(B, H) batch at a time, with elementwise products and sums (no matrix
product, so no TF32 on the card): it is also the plain version beside
the kernel.
"""

from __future__ import annotations

import torch


def wkv_ref(r, k, v, lw, u, s0=None):
    r, k, v, lw = (t.float() for t in (r, k, v, lw))
    u = u.float()
    b, l, h, hd = r.shape
    s = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    outs = []
    for t in range(l):
        rt, kt, vt = r[:, t], k[:, t], v[:, t]  # (B, H, hd)
        out = (rt[..., :, None] * s).sum(-2) \
            + (rt * u * kt).sum(-1, keepdim=True) * vt
        s = torch.exp(lw[:, t])[..., None] * s \
            + kt[..., :, None] * vt[..., None, :]
        outs.append(out)
    return torch.stack(outs, dim=1), s
