"""Oracle of the fused selective scan (Mamba-1 recurrence).

Port of ``repro/kernels/ssm_scan/ref.py``. Per batch, channel d and
state n:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
    y_t = C_t . h_t

Shapes: x, dt (B, L, D); A (D, N); Bt, Ct (B, L, N); h0 (B, D, N).
Returns (y (B, L, D), h_L (B, D, N)), all f32. The steps run in order
with elementwise products and a sum over N (no matrix product, so no
TF32 on the card): it is also the plain version beside the kernel.
"""

from __future__ import annotations

import torch


def selective_scan_ref(x, dt, A, Bt, Ct, h0=None):
    x, dt, A, Bt, Ct = (t.float() for t in (x, dt, A, Bt, Ct))
    b, l, d = x.shape
    n = A.shape[1]
    h = (torch.zeros((b, d, n), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(l):
        dtt = dt[:, t]                                   # (B, D)
        h = torch.exp(dtt[..., None] * A) * h \
            + (dtt * x[:, t])[..., None] * Bt[:, t, None, :]
        ys.append((h * Ct[:, t, None, :]).sum(-1))
    return torch.stack(ys, dim=1), h
