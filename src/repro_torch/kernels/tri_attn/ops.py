"""Public packed attention ops (port of ``repro/kernels/tri_attn/ops.py``).

``packed_prefill_attention`` + ``make_packed_sched``: R requests of mixed
lengths concatenated along S, attended block-diagonally in ONE launch.
``packed_decode_attention`` + ``make_decode_table`` + ``DecodeRoundSpec``:
one mixed-position decode round per launch, each live slot attending only
its own valid KV prefix.

impl names:
  'cuda'  — the hand-written kernel (kernel.py -> csrc/); CUDA tensors
            only, it raises on CPU tensors rather than running anything
            else;
  'torch' — the plain PyTorch version (scan_impl.py), the counterpart of
            the reference's 'scan', on any device;
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

IMPLS = ("cuda", "torch", "ref")


def _require_cuda(impl: str, t: torch.Tensor, op: str):
    if impl == "cuda" and not t.is_cuda:
        raise ValueError(
            f"{op}: impl='cuda' needs CUDA tensors, got {t.device}; pass "
            "impl='torch' for the plain PyTorch version")


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


def packed_prefill_attention(q, k, v, psched: PackedTriSched, *,
                             sm_scale=None, impl: str = "cuda"):
    """Ragged batched attention over the packed layout (forward only).

    q: (B, H, S_total, D); k, v: (B, Hkv, S_total, D). One launch covers
    every request: sum_r blocks_r tile steps, no cross-request tiles.
    Returns (B, H, S_total, D)."""
    b, h, s_len, d = q.shape
    if s_len != psched.s_total:
        raise ValueError(f"packed operand has {s_len} rows but the "
                         f"schedule covers {psched.s_total}")
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    if impl == "cuda":
        _require_cuda(impl, q, "packed_prefill_attention")
        return K.packed_fwd(q, k, v, psched, sm_scale=scale)[0]
    if impl == "torch":
        return SC.packed_fwd_torch(q, k, v, psched, scale)[0]
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
