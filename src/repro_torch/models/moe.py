"""Token-choice top-k Mixture-of-Experts with capacity-bounded dispatch
(Mixtral / Jamba style; port of ``repro/models/moe.py``).

Routing is the reference's: top-k over the router logits, a softmax over
the selected logits, the Switch aux loss, and each (token, slot) ranked
within its (group, expert) by an exclusive cumulative count; a slot
ranked at or past the capacity C is dropped. The expert FFNs differ in
form only: the reference scatters the kept slots into a dense (G, E, C,
d) buffer and runs every expert over all C rows; here each expert runs
over its kept rows alone (gather, matmul, weighted scatter-add), so a
drop-free buffer costs no padding (E / k times the FLOPs and GBs of
transients at full width). The sums agree with the reference's within
tolerance, not bitwise. On the meta device (the dry-run) no routing
exists to count, so each expert runs over the G x C rows of the
reference's buffer: an upper bound of the port's work on kept rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.parallel import hints


def init_moe(gen, cfg, dtype, device, stack: int):
    """Router (f32) and expert weights with a leading E dim, stacked on a
    leading axis of ``stack`` layers."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": L.dense_init(gen, (d, e), d, torch.float32, device, stack),
        "wi": L.dense_init(gen, (e, d, f), d, dtype, device, stack),
        "wo": L.dense_init(gen, (e, f, d), f, dtype, device, stack),
    }
    if cfg.mlp_activation == "swiglu":
        p["wg"] = L.dense_init(gen, (e, d, f), d, dtype, device, stack)
    return p


def capacity(t: int, cfg, *, full_capacity: bool = False) -> tuple:
    """(G dispatch groups, C slots an expert a group) for T tokens: the
    reference's dense (G, E, C, d) buffer. full_capacity sizes C so that
    no slot is dropped (serving semantics: a decode must not drop what its
    prefill kept)."""
    e, k = cfg.n_experts, cfg.experts_per_token
    groups = int(hints.get("moe_groups", 1))
    if t % groups:
        groups = 1
    tg = t // groups
    cap = tg if full_capacity else max(1, int(k * tg / e *
                                              cfg.capacity_factor))
    return groups, cap


def route(params, xf, cfg, *, full_capacity: bool = False):
    """xf: (T, d). Returns (weights (T, k) f32, experts (T, k), keep (T,
    k) bool, aux), the capacity of ``capacity``."""
    t = xf.shape[0]
    e, k = cfg.n_experts, cfg.experts_per_token
    groups, cap = capacity(t, cfg, full_capacity=full_capacity)
    tg = t // groups

    logits = xf.float() @ params["router"]  # (T, E)
    top_logits, top_e = torch.topk(logits, k, dim=-1)
    weights = torch.softmax(top_logits, dim=-1)

    # load-balance aux (Switch-style): E * sum_e f_e * p_e
    probs = torch.softmax(logits, dim=-1)
    assign = F.one_hot(top_e, e).float().sum(1)  # (T, E)
    aux = e * torch.mean(assign.mean(0) * probs.mean(0))

    ge = top_e.reshape(groups, tg * k)
    onehot = F.one_hot(ge, e)  # (G, Tg*k, E)
    rank = onehot.cumsum(1) - onehot  # exclusive count
    rank = rank.gather(2, ge[..., None])[..., 0]
    return weights, top_e, (rank < cap).reshape(t, k), aux


def moe_mlp(params, x, cfg, *, return_aux: bool = True,
            full_capacity: bool = False):
    """x: (B, S, d) -> (B, S, d) [, aux load-balance loss]."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(b * s, d)
    weights, top_e, keep, aux = route(params, xf, cfg,
                                      full_capacity=full_capacity)
    # kept slots grouped by expert (a dropped slot takes the id e, last)
    slot_e = torch.where(keep, top_e, e).reshape(-1)
    order = torch.argsort(slot_e, stable=True)
    wi = hints.constrain(params["wi"], "moe_wi")
    wo = hints.constrain(params["wo"], "moe_wo")
    swiglu = cfg.mlp_activation == "swiglu"
    wg = hints.constrain(params["wg"], "moe_wi") if swiglu else None
    out = torch.zeros((b * s, d), dtype=torch.float32, device=x.device)
    if x.is_meta:
        # a meta tensor holds no routing to count: every expert takes the
        # G x C rows of the reference's dense buffer, an upper bound of
        # its kept rows, all experts in one batched pass (the same flops
        # and bytes as the loop below, in E times fewer ops)
        groups, cap = capacity(b * s, cfg, full_capacity=full_capacity)
        idx = order.new_empty((e, groups * cap))
        h = _expert_ffn(xf[idx], wi, wg, swiglu)
        out.index_add_(0, idx.reshape(-1), (h @ wo).float().reshape(-1, d)
                       * weights.new_empty((e * groups * cap, 1)))
    else:
        counts = torch.bincount(slot_e, minlength=e + 1).tolist()
        tok, w = order // k, weights.reshape(-1)[order]
        start = 0
        for ex, n in enumerate(counts[:e]):
            if n:
                idx = tok[start:start + n]
                h = _expert_ffn(xf[idx], wi[ex], wg[ex] if swiglu else None,
                                swiglu)
                out.index_add_(0, idx, (h @ wo[ex]).float()
                               * w[start:start + n, None])
            start += n
    out = out.reshape(b, s, d).to(x.dtype)
    return (out, aux) if return_aux else out


def _expert_ffn(rows, wi, wg, swiglu: bool):
    """An expert's hidden activations over its rows: swiglu, or squared
    ReLU."""
    if swiglu:
        return L._silu(rows @ wg) * (rows @ wi)
    h = torch.relu(rows @ wi)
    return h * h
