"""Three-term roofline on one H100, and the least time of each kernel's work
(port of ``repro/roofline/model.py``; the one source of the card's peaks
for the port and ``chip_smoke.py``).

  compute_s    = flops_per_device / PEAK_FLOPS[bf16]
  memory_s     = hbm_bytes_per_device / HBM_BYTES_PER_S
  collective_s = collective_bytes_per_device / NVLINK_BYTES_PER_S

The peaks are NVIDIA's datasheet figures for the H100 SXM5 80GB at its
700 W limit: dense bf16 on the tensor cores 989e12 FLOP/s, float32 on the
CUDA cores (no TF32: it would compute something else) 67e12, HBM3
3.35e12 B/s, NVLink 450e9 B/s a direction. A card set below 700 W runs
slower under load; the measured side of every comparison names its limit.

The dominant term is the bottleneck; a step takes at least the largest
term, and the sum of them with no overlap. MODEL_FLOPS = 6 N D (training)
or 2 N D (inference), N the active parameters, measures how much of the
counted compute is useful: remat's recompute, the padded vocabulary and
the masked halves of the diagonal tiles all show as a ratio below 1.

``memory_kernel_adj_s`` was the reference's memory term with the attention
scan's interior held in VMEM, which its CPU-compiled HLO could not see.
The port's count (``roofline/dispatch_count.py``) charges each kernel
region its own inputs and outputs and nothing inside it, so the two memory
terms are equal here; the field and its ``*_kernel_adj`` properties stay
for the reference's record keys.

``bound`` and the ``*_work`` functions below give the least time of each
kernel's work: each input read once and each output written once at
HBM_BYTES_PER_S, against its operations at the peak of their type; the
larger of the two. ``chip_smoke.py`` prints its rows' bounds through them,
and ``launch/compat.py``'s work functions give a kernel region's count on
the meta device from the same rules.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# NVIDIA H100 SXM5 80GB at 700 W, one card
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
HBM_BYTES_PER_S = 3.35e12   # HBM3
NVLINK_BYTES_PER_S = 450e9  # a direction
CARD_BYTES = 80e9           # device memory
# exponentials of the special function units: ex2 a clock on one SM
# (compute capability 9.0), the card's SMs, and its largest SM clock (the
# SXM5 boost; chip_smoke.py reads the card's own)
SFU_EXP_PER_CLOCK_SM = 16
H100_SMS = 132
H100_MAX_SM_CLOCK_HZ = 1.98e9


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float = 0.0
    hlo_flops_per_dev: float = 0.0
    n_chips: int = 1
    # equal to memory_s in the port (module docstring)
    memory_kernel_adj_s: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def dominant_kernel_adj(self) -> str:
        terms = {"compute": self.compute_s,
                 "memory": self.memory_kernel_adj_s or self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops summed over chips)."""
        total = self.hlo_flops_per_dev * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_at_bound(self) -> float:
        """Model FLOPs utilization if the step ran at the dominant term."""
        if self.bound_s == 0:
            return 0.0
        return mfu(self.model_flops, self.bound_s, self.n_chips)

    @property
    def bound_kernel_adj_s(self) -> float:
        return max(self.compute_s,
                   self.memory_kernel_adj_s or self.memory_s,
                   self.collective_s)

    @property
    def mfu_at_bound_kernel_adj(self) -> float:
        if self.bound_kernel_adj_s == 0:
            return 0.0
        return mfu(self.model_flops, self.bound_kernel_adj_s, self.n_chips)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "memory_kernel_adj_s": self.memory_kernel_adj_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "dominant_kernel_adj": self.dominant_kernel_adj,
            "model_flops": self.model_flops,
            "hlo_flops_per_dev": self.hlo_flops_per_dev,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_at_bound": self.mfu_at_bound,
            "mfu_at_bound_kernel_adj": self.mfu_at_bound_kernel_adj,
            "n_chips": self.n_chips,
        }


def terms_from_analysis(an: dict, *, n_chips: int,
                        model_flops: float = 0.0) -> RooflineTerms:
    """Terms of a per-device count (``dispatch_count.analyze``'s keys)."""
    peak = PEAK_FLOPS[torch.bfloat16]
    return RooflineTerms(
        compute_s=an["flops"] / peak,
        memory_s=an["hbm_bytes"] / HBM_BYTES_PER_S,
        memory_kernel_adj_s=an.get("hbm_bytes_kernel_adj",
                                   an["hbm_bytes"]) / HBM_BYTES_PER_S,
        collective_s=an["collective_bytes_total"] / NVLINK_BYTES_PER_S,
        model_flops=model_flops,
        hlo_flops_per_dev=an["flops"],
        n_chips=n_chips,
    )


def mfu(model_flops_: float, seconds: float, n_chips: int = 1) -> float:
    """Model FLOPs utilization of a step of ``seconds`` on ``n_chips``
    cards at the bf16 peak."""
    return model_flops_ / (n_chips * PEAK_FLOPS[torch.bfloat16]) / seconds


# ---------------------------------------------------------------------------
# MODEL_FLOPS
# ---------------------------------------------------------------------------


def model_flops(cfg, shape, *, include_backward: Optional[bool] = None
                ) -> float:
    """6*N*D for training (fwd 2ND + bwd 4ND); 2*N*D for inference steps.

    N = active params (MoE counts routed experts only); D = tokens processed
    in the step (decode: one per sequence)."""
    n_active = cfg.param_counts()["active"]
    d_tokens = shape.tokens_per_step
    train = shape.kind == "train" if include_backward is None \
        else include_backward
    return (6.0 if train else 2.0) * n_active * d_tokens


# ---------------------------------------------------------------------------
# Kernel bounds: the least time of a kernel's work on the card
# ---------------------------------------------------------------------------


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(ms, "bytes" or "operations"): the larger of ``nbytes`` at the HBM
    rate and ``flops`` at the peak of ``dtype``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_work(op: str, *, q_elems: int, k_elems: int, d: int, elt: int,
              pairs: int) -> tuple:
    """(bytes, flops) of the forward (op "fwd"), dq ("dq") or dk/dv
    ("dkv") over ``pairs`` unmasked (query, key) pairs summed over heads:
    each input read once and each output written once (q, k, v, out,
    lse; + do, delta; dq or dk and dv), against 4, 6 and 8 x D flops a
    pair (S and PV; S, dP and dS K; S, dP, P^T dO and dS^T Q)."""
    qkv = q_elems + 2 * k_elems
    rows = q_elems // d * 4  # one f32 per (b, h, row): lse, delta
    if op == "fwd":
        return elt * (qkv + q_elems) + rows, 4 * d * pairs
    if op == "dq":
        return elt * (qkv + 2 * q_elems) + 2 * rows, 6 * d * pairs
    if op == "dkv":
        return elt * (qkv + q_elems + 2 * k_elems) + 2 * rows, 8 * d * pairs
    raise ValueError(f"attn_work: op must be fwd, dq or dkv, got {op!r}")


def attn_bounds(q, k, pairs: int) -> dict:
    """``bound`` of the forward, dq and dk/dv (``attn_work``) of q (B, H,
    S, D) and k (B, Hkv, S, D) over ``pairs`` unmasked pairs, at the
    tensor-core rate of q's dtype."""
    kw = dict(q_elems=q.numel(), k_elems=k.numel(), d=q.shape[-1],
              elt=q.element_size(), pairs=pairs)
    return {op: bound(*attn_work(op, **kw), q.dtype)
            for op in ("fwd", "dq", "dkv")}


def decode_work(*, q_elems: int, b: int, h: int, d: int, elt: int,
                tbl_elems: int, kv_tokens: int, hkv: int,
                cache_elt: int) -> tuple:
    """(bytes, flops) of a decode round: q and the B rows of output, the
    table, and each slot's [kv_first, kv_len) rows of K and V once,
    against QK^T and PV, 4 D flops a (query head, cache token), on the
    float32 CUDA cores."""
    nbytes = (q_elems + b * h * d) * elt + tbl_elems * 4 \
        + kv_tokens * hkv * d * cache_elt * 2
    return nbytes, 4 * h * d * kv_tokens


def fused_step_work(*, pack_q_elems: int, pack_k_elems: int,
                    pack_v_elems: int, elt: int, live: int, h: int, d: int,
                    tbl_elems: int, kv_tokens: int, hkv: int, cache_elt: int,
                    pairs: int) -> tuple:
    """(bytes, prefill flops, decode flops) of one fused step: the pack's
    q, k, v and out, the live slots' q and out, the table and each slot's
    cache rows once; 4 D flops a pair of the prefill half (bf16 tensor
    cores) and 4 D a (query head, cache token) of the decode half (f32)."""
    nbytes = elt * (2 * pack_q_elems + pack_k_elems + pack_v_elems) \
        + elt * 2 * live * h * d + tbl_elems * 4 \
        + kv_tokens * hkv * d * cache_elt * 2
    return nbytes, 4 * d * h * pairs, 4 * h * d * kv_tokens


def fused_step_bound(**kw) -> tuple:
    """``bound`` of one fused step (``fused_step_work``'s arguments): its
    bytes against the prefill flops at the bf16 rate plus the decode
    flops at the float32 rate."""
    nbytes, pair_flops, token_flops = fused_step_work(**kw)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (pair_flops / PEAK_FLOPS[torch.bfloat16]
             + token_flops / PEAK_FLOPS[torch.float32]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ssm_work(b: int, l: int, d: int, n: int) -> tuple:
    """(bytes, f32 flops, exponentials) of a selective scan: x, dt, y (B,
    L, D) and Bt, Ct, A, h0, h_L once each in f32, 6 N + 1 flops and N
    exponentials a (b, t, d)."""
    nbytes = 4 * (3 * b * l * d + 2 * b * l * n + d * n + 2 * b * d * n)
    return nbytes, b * l * d * (6 * n + 1), b * l * d * n


def ssm_bound(b: int, l: int, d: int, n: int, clock_hz: float) -> dict:
    """The scan's least time: bytes, f32 flops, and the exponentials on
    the SFUs at ``clock_hz`` (the card's largest SM clock); ms each and
    the largest."""
    nbytes, flops, exps = ssm_work(b, l, d, n)
    parts = {"bytes": bound(nbytes, 0, torch.float32)[0],
             "flops": flops / PEAK_FLOPS[torch.float32] * 1e3,
             "exp": exps / (SFU_EXP_PER_CLOCK_SM * H100_SMS * clock_hz)
             * 1e3}
    worst = max(parts.values())
    return dict(parts, bound=worst,
                by="bytes" if worst == parts["bytes"] else "operations")


def wkv_work(b: int, l: int, h: int, hd: int) -> tuple:
    """(bytes, f32 flops) of WKV6: r, k, v, lw and out (B, L, H, hd), u,
    s0 and s_L once, 4 hd^2 flops a (b, t, head)."""
    n = b * l * h * hd
    return 5 * 4 * n + 4 * h * hd + 2 * 4 * b * h * hd * hd, \
        4 * hd * hd * b * l * h


def edm_work(kind: str, n_rows: int, d: int, blk: int) -> tuple:
    """(bytes, f32 flops) of EDM over N points of d dims: x once, and the
    output's tri(n) tiles of blk^2 (kind "ltm") or the N x N matrix
    ("bb") once, against (2 d + 4) flops a pair of the tri(n) tiles."""
    from repro_torch.core import mapping as M

    n = n_rows // blk
    x_bytes = 4 * n_rows * d
    flops = (2 * d + 4) * M.tri(n) * blk * blk
    if kind == "ltm":
        return 4 * M.tri(n) * blk * blk + x_bytes, flops
    if kind == "bb":
        return 4 * n_rows * n_rows + x_bytes, flops
    raise ValueError(f"edm_work: kind must be ltm or bb, got {kind!r}")


def dummy_work(blocks: int) -> tuple:
    """(bytes, flops) of a dummy kernel: one f32 written a block."""
    return 4 * blocks, 0


def three_body_flops(n_rows: int, d: int, blk: int) -> int:
    """Operations of the live tiles: 2 b^3 + 6 b^2 d each, tet(n)."""
    i = n_rows // blk
    return i * (i + 1) * (i + 2) // 6 * (2 * blk ** 3 + 6 * blk * blk * d)


def three_body_work(kind: str, n_rows: int, d: int, blk: int) -> tuple:
    """(bytes, f32 flops) of the three-body sums: x once and one f32 a
    tile of tet(n) (kind "tet") or n^3 ("bb3"), the live tiles' flops."""
    from repro_torch.core import mapping as M

    n = n_rows // blk
    tiles = {"tet": M.tet(n), "bb3": n ** 3}[kind]
    return 4 * n_rows * d + 4 * tiles, three_body_flops(n_rows, d, blk)
