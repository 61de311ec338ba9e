"""Schedules of the packed attention launches and the CUDA kernel wrappers.

``TriSched`` / ``PackedTriSched`` port the reference's static schedule
metadata; ``PackedTriSched.table()`` is the (7, R) int32 member table ABI
(kernel.py:194-218 of the reference), byte for byte. ``DECODE_NO_EMIT``
is the decode pad member's sentinel.

``packed_fwd``, ``packed_decode_fwd`` and ``fused_step_fwd`` wrap the
hand-written kernels in ``csrc/packed_fwd.cu``, ``csrc/packed_decode.cu``
and ``csrc/fused_step.cu``; ``fwd``, ``bwd_dq`` and ``bwd_dkv`` (the
training path's forward and its two backward launches, which ``bwd``
composes) wrap ``csrc/tri_fwd.cu`` and ``csrc/tri_bwd.cu``; ``fwd_bb``
(the paper's bounding-box baseline of ``fwd``) wraps ``csrc/fwd_bb.cu``;
``packed_bwd_dq`` and ``packed_bwd_dkv`` (the backward of ``packed_fwd``,
which ``packed_bwd`` composes) wrap ``csrc/packed_bwd.cu``. The notes at
the top of each source say what bounds it on the H100 and why its grid
is one block per accumulator owner (fwd_bb's, one block per tile of the
n x n grid, says why it is not). On a CUDA tensor a wrapper launches
its kernel, through ``obs.launch.instrumented_launch``, or raises; it
runs the plain PyTorch version (scan_impl.py) only when its inputs lie
on the CPU. Each wrapper counts its launches in a plain integer
attribute (``.launches``), incremented where the kernel is launched and
nowhere else (``WRAPPERS`` lists them).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core import mapping as M
from repro_torch.core import packing as PK
from repro_torch.kernels import build as BUILD
from repro_torch.obs import launch as OBS

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# pad-member kv_tiles sentinel of the (5, R) decode table: emit never fires
DECODE_NO_EMIT = 2 ** 30

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
SUPPORTED_BLOCKS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@dataclasses.dataclass(frozen=True)
class TriSched:
    """Static schedule of one request's tile domain (bq == bk)."""

    kind: str  # 'ltm' | 'band' | 'prefix'
    n: int  # tiles per side
    bq: int
    bk: int
    window: Optional[int] = None  # tokens (band)
    prefix: int = 0  # tokens (prefix)

    def __post_init__(self):
        if self.kind not in ("ltm", "band", "prefix"):
            raise ValueError(f"unknown schedule kind {self.kind!r}")
        if self.kind == "band" and (self.window is None or self.window < 1
                                    or self.bq != self.bk):
            raise ValueError("band schedules need window >= 1 and square "
                             "tiles")

    @property
    def w_b(self) -> int:
        """Band width in tiles (tile j needed iff some q, k in the tiles
        have 0 <= q - k < window)."""
        if self.window is None:
            return self.n
        return min((self.window - 2) // self.bk + 2, self.n)

    @property
    def p_b(self) -> int:
        return -(-self.prefix // self.bk) if self.prefix else 0

    # ---- row-major enumeration (forward, dq) -----------------------------
    @property
    def rm_steps(self) -> int:
        if self.kind == "ltm":
            return M.tri(self.n)
        if self.kind == "band":
            return M.band_blocks(self.n, self.w_b)
        return M.prefix_full_blocks(self.n, self.p_b)

    def rm_map(self, lam):
        if self.kind == "ltm":
            return M.ltm_map(lam)
        if self.kind == "band":
            return M.band_map(lam, self.w_b)
        return M.prefix_full_map(lam, self.n, self.p_b)

    def rm_first_col(self, i):
        """First j of row i (w_b == n unless banded, so 0 then)."""
        return PK.first_col_params(i, self.w_b)

    def rm_last_col(self, i):
        """Last j of row i (p_b == 0 unless prefix, so i then)."""
        return PK.last_col_params(i, self.p_b)

    # ---- column-major enumeration (dk/dv) --------------------------------
    @property
    def cm_steps(self) -> int:
        return self.rm_steps  # same domain, another order

    def cm_map(self, lam):
        if self.kind == "ltm":
            return M.cm_map(lam, self.n)
        if self.kind == "band":
            return M.band_cm_map(lam, self.n, self.w_b)
        return M.prefix_cm_map(lam, self.n, self.p_b)

    def cm_first_row(self, j):
        return PK.cm_first_row_params(j, self.p_b)

    def cm_last_row(self, j):
        return PK.cm_last_row_params(j, self.n, self.w_b)


@dataclasses.dataclass(frozen=True)
class PackedTriSched:
    """Static metadata of ONE packed ragged-attention launch: member r's
    tokens occupy packed rows [rows[r] * blk, rows[r+1] * blk)."""

    members: tuple  # Tuple[TriSched, ...]

    def __post_init__(self):
        if not self.members:
            raise ValueError("packed schedule needs at least one member")
        blk = self.members[0].bq
        if any(m.bq != blk or m.bk != blk for m in self.members):
            raise ValueError("packed members must share one square block")

    @property
    def blk(self) -> int:
        return self.members[0].bq

    @property
    def steps(self) -> int:
        return sum(m.rm_steps for m in self.members)

    @property
    def total_tiles(self) -> int:
        return sum(m.n for m in self.members)

    @property
    def s_total(self) -> int:
        return self.total_tiles * self.blk

    @property
    def windows(self) -> tuple:
        return tuple(m.window or 0 for m in self.members)

    @property
    def prefixes(self) -> tuple:
        return tuple(m.prefix for m in self.members)

    def table(self) -> np.ndarray:
        """(7, R) int32 member table. Rows: 0 starts (cumulative tile-step
        offsets), 1 rows (cumulative tile-row offsets), 2 n, 3 w_b (== n
        unbanded), 4 p_b (0 = band family), 5 win (tokens, 0 = none),
        6 pre (tokens, 0 = none)."""
        starts, rows = [0], [0]
        for m in self.members:
            starts.append(starts[-1] + m.rm_steps)
            rows.append(rows[-1] + m.n)
        cols = [(s, t, m.n, m.w_b, m.p_b, w, p)
                for s, t, m, w, p in zip(starts[:-1], rows[:-1], self.members,
                                         self.windows, self.prefixes)]
        return np.asarray(cols, np.int32).T.copy()


@functools.lru_cache(maxsize=64)
def device_table(psched: PackedTriSched, device: torch.device) -> torch.Tensor:
    """The (7, R) table as an int32 tensor on ``device``, copied once per
    schedule so every layer of a packed forward shares one upload."""
    return torch.as_tensor(psched.table(), device=device)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def packed_fwd(q, k, v, psched: PackedTriSched, *, sm_scale=None):
    """Ragged batched prefill attention in ONE launch.

    q: (B, H, S_total, D); k, v: (B, Hkv, S_total, D), one dtype (f32 or
    bf16), contiguous. Returns (out (B, H, S_total, D) in q's dtype,
    lse (B, H, S_total) f32)."""
    b, h, s_len, d = q.shape
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    if not q.is_cuda:
        from repro_torch.kernels.tri_attn import scan_impl as SC

        return SC.packed_fwd_torch(q, k, v, psched, scale)
    hkv = k.shape[1]
    _check(k.is_cuda and v.is_cuda and k.device == q.device == v.device,
           "packed_fwd: q, k, v must lie on one CUDA device")
    _check(q.dtype in _DTYPE_CODES and k.dtype == q.dtype == v.dtype,
           f"packed_fwd: q/k/v must share f32 or bf16, got "
           f"{q.dtype}/{k.dtype}/{v.dtype}")
    _check(k.shape == v.shape == (b, hkv, s_len, d) and h % hkv == 0,
           f"packed_fwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
           f"v {tuple(v.shape)}")
    _check(all(x.is_contiguous() for x in (q, k, v)),
           "packed_fwd: q, k, v must be contiguous")
    _check(s_len == psched.s_total,
           f"packed_fwd: S={s_len} but the schedule covers "
           f"{psched.s_total}")
    _check(d in SUPPORTED_HEAD_DIMS and psched.blk in SUPPORTED_BLOCKS,
           f"packed_fwd: head_dim {d} / block {psched.blk} unsupported "
           f"(head_dim in {SUPPORTED_HEAD_DIMS}, block in "
           f"{SUPPORTED_BLOCKS})")
    lib = BUILD.load("packed_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_len), dtype=torch.float32, device=q.device)
    tbl = device_table(psched, q.device)
    meta = OBS.meta_from_packed("tri_attn.packed_fwd", psched, impl="cuda",
                                cells=b * h,
                                grid=(b, h, psched.total_tiles))
    OBS.instrumented_launch(
        meta, lib.packed_fwd_launch, (q, k, v),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), tbl.data_ptr(), len(psched.members), b, h, hkv,
        s_len, d, psched.blk, psched.total_tiles, scale,
        _DTYPE_CODES[q.dtype], _stream_ptr(q))
    packed_fwd.launches += 1
    return out, lse


packed_fwd.launches = 0


def packed_decode_fwd(q, k, v, tbl, *, capacity: int, blk: int, tiles: int,
                      sm_scale=None):
    """One launch for a whole mixed-position decode round.

    q: (B, H, D); k, v: (B, S_cache, Hkv, D), the native cache layout with
    the new token written; tbl: (5, R) int32 member table on q's device.
    ``tiles`` is the round's live tile count (sum of member kv_tiles),
    what the grid walks. Returns (B + 1, H, D) in q's dtype; rows of
    slots without a live member (and the pad row B) are left unwritten,
    so callers mask by the table's coverage (ops._covered_slots)."""
    b, h, d = q.shape
    s_cache, hkv = k.shape[1], k.shape[2]
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    if not q.is_cuda:
        from repro_torch.kernels.tri_attn import scan_impl as SC

        full = torch.zeros((b + 1, h, d), dtype=q.dtype, device=q.device)
        full[:b] = SC.packed_decode_torch(q, k, v, tbl, capacity=capacity,
                                          blk=blk, tiles=tiles, scale=scale)
        return full
    n_members = tbl.shape[1]
    _check(k.is_cuda and v.is_cuda and tbl.is_cuda
           and k.device == q.device == v.device == tbl.device,
           "packed_decode_fwd: q, caches and table must lie on one CUDA "
           "device")
    _check(q.dtype in _DTYPE_CODES and k.dtype in _DTYPE_CODES
           and v.dtype == k.dtype,
           f"packed_decode_fwd: q in f32/bf16 and k == v in f32/bf16, got "
           f"{q.dtype}/{k.dtype}/{v.dtype}")
    _check(k.shape == v.shape == (b, s_cache, hkv, d) and h % hkv == 0,
           f"packed_decode_fwd: shapes q {tuple(q.shape)} k "
           f"{tuple(k.shape)} v {tuple(v.shape)}")
    _check(tbl.dtype == torch.int32 and tuple(tbl.shape) == (5, n_members),
           f"packed_decode_fwd: table must be (5, R) int32, got "
           f"{tuple(tbl.shape)} {tbl.dtype}")
    _check(all(x.is_contiguous() for x in (q, k, v, tbl))
           and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
           "packed_decode_fwd: q, caches and table must be contiguous, "
           "the caches 16-byte aligned")
    _check(s_cache % blk == 0 and blk in SUPPORTED_BLOCKS
           and d in SUPPORTED_HEAD_DIMS,
           f"packed_decode_fwd: block {blk} must divide S_cache {s_cache}, "
           f"block in {SUPPORTED_BLOCKS}, head_dim {d} in "
           f"{SUPPORTED_HEAD_DIMS}")
    lib = BUILD.load("packed_decode")
    out = torch.empty((b + 1, h, d), dtype=q.dtype, device=q.device)
    meta = OBS.meta_exact("tri_attn.packed_decode_fwd", "tri_attn",
                          impl="cuda", kind="decode_round", steps=tiles,
                          block_shape=(1, blk),
                          bb_bound=b * (s_cache // blk), cells=hkv,
                          grid=(n_members, hkv),
                          extra=(("capacity", capacity),))
    OBS.instrumented_launch(
        meta, lib.packed_decode_launch, (q, k, v),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        tbl.data_ptr(), n_members, b, h, hkv, s_cache, d, blk, scale,
        _DTYPE_CODES[q.dtype], _DTYPE_CODES[k.dtype], _stream_ptr(q))
    packed_decode_fwd.launches += 1
    return out


packed_decode_fwd.launches = 0


def fused_step_meta(impl: str, *, b: int, h: int, s_pack: int, s_cache: int,
                    blk: int, tiles: int, capacity: int, n_members: int,
                    grid=None):
    """Launch geometry of one fused step: ``tiles`` (prefill steps + live
    decode tiles) per query head, where the reference's grid walks the
    bucketed ``capacity``; the BB bound is the pack's square plus every
    slot's whole cache."""
    return OBS.meta_exact(
        "tri_attn.fused_step_fwd", "tri_attn", impl=impl, kind="fused_step",
        steps=tiles, block_shape=(blk, blk),
        bb_bound=(s_pack // blk) ** 2 + b * (s_cache // blk), cells=h,
        grid=grid, extra=(("capacity", capacity), ("members", n_members)))


def fused_step_fwd(q_pack, k_pack, v_pack, q_dec, k_cache, v_cache, tbl, *,
                   psched: PackedTriSched, capacity: int, tiles: int,
                   sm_scale=None):
    """One launch for a whole continuous-batching engine step.

    q_pack: (1, H, S_pack, D) and k_pack, v_pack: (1, Hkv, S_pack, D), the
    round's admitted prompts in the packed layout of ``psched``; q_dec:
    (B, H, D) against k_cache, v_cache: (B, S_cache, Hkv, D), the native
    cache with the decode tokens written; tbl: the (8, R) int32 fused table
    on q's device, prefill columns first. ``tiles`` is the round's live
    tile count (psched.steps + live decode tiles), what the grid walks.
    Returns (o_pack (1, H, S_pack, D), o_dec (B + 1, H, D)), both in q's
    dtype; rows of o_dec whose slot has no live decode member (and the pad
    row B) are left unwritten, so callers mask by the table's coverage
    (ops._fused_covered_slots)."""
    _, h, s_pack, d = q_pack.shape
    b = q_dec.shape[0]
    s_cache, hkv = k_cache.shape[1], k_cache.shape[2]
    blk = psched.blk
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    if not q_pack.is_cuda:
        from repro_torch.kernels.tri_attn import scan_impl as SC

        o_pack, o_dec = SC.fused_step_torch(
            q_pack, k_pack, v_pack, q_dec, k_cache, v_cache, tbl,
            capacity=capacity, blk=blk, tiles=tiles, scale=scale)
        full = torch.zeros((b + 1, h, d), dtype=q_dec.dtype,
                           device=q_dec.device)
        full[:b] = o_dec
        return o_pack, full
    n_members, r_p = tbl.shape[1], len(psched.members)
    ins = (q_pack, k_pack, v_pack, q_dec, k_cache, v_cache, tbl)
    _check(all(x.is_cuda and x.device == q_pack.device for x in ins),
           "fused_step_fwd: every operand must lie on one CUDA device")
    _check(q_pack.dtype in _DTYPE_CODES and k_cache.dtype in _DTYPE_CODES
           and k_pack.dtype == v_pack.dtype == q_dec.dtype == q_pack.dtype
           and v_cache.dtype == k_cache.dtype,
           f"fused_step_fwd: pack and decode queries in one of f32/bf16, "
           f"caches in one of f32/bf16, got {q_pack.dtype}/{k_pack.dtype}/"
           f"{v_pack.dtype}/{q_dec.dtype} and {k_cache.dtype}/"
           f"{v_cache.dtype}")
    _check(k_pack.shape == v_pack.shape == (1, hkv, s_pack, d)
           and q_dec.shape == (b, h, d)
           and k_cache.shape == v_cache.shape == (b, s_cache, hkv, d)
           and h % hkv == 0,
           f"fused_step_fwd: shapes q_pack {tuple(q_pack.shape)} k_pack "
           f"{tuple(k_pack.shape)} v_pack {tuple(v_pack.shape)} q_dec "
           f"{tuple(q_dec.shape)} caches {tuple(k_cache.shape)}")
    _check(tbl.dtype == torch.int32 and tbl.ndim == 2 and tbl.shape[0] == 8
           and n_members > r_p,
           f"fused_step_fwd: table must be (8, R > {r_p}) int32, got "
           f"{tuple(tbl.shape)} {tbl.dtype}")
    _check(all(x.is_contiguous() for x in ins)
           and k_cache.data_ptr() % 16 == 0 and v_cache.data_ptr() % 16 == 0,
           "fused_step_fwd: operands and table must be contiguous, the "
           "caches 16-byte aligned")
    _check(s_pack == psched.s_total and s_cache % blk == 0
           and blk in SUPPORTED_BLOCKS and d in SUPPORTED_HEAD_DIMS,
           f"fused_step_fwd: S_pack {s_pack} (schedule {psched.s_total}) "
           f"and S_cache {s_cache} must be multiples of block {blk}, block "
           f"in {SUPPORTED_BLOCKS}, head_dim {d} in {SUPPORTED_HEAD_DIMS}")
    lib = BUILD.load("fused_step")
    o_pack = torch.empty_like(q_pack)
    o_dec = torch.empty((b + 1, h, d), dtype=q_dec.dtype,
                        device=q_dec.device)
    meta = fused_step_meta(
        "cuda", b=b, h=h, s_pack=s_pack, s_cache=s_cache, blk=blk,
        tiles=tiles, capacity=capacity, n_members=n_members,
        grid=((n_members - r_p) * hkv + psched.total_tiles * h,))
    OBS.instrumented_launch(
        meta, lib.fused_step_launch, ins[:6],
        q_pack.data_ptr(), k_pack.data_ptr(), v_pack.data_ptr(),
        o_pack.data_ptr(), q_dec.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), o_dec.data_ptr(), tbl.data_ptr(), n_members, r_p,
        psched.total_tiles, b, h, hkv, s_pack, s_cache, d, blk, scale,
        _DTYPE_CODES[q_pack.dtype], _DTYPE_CODES[k_cache.dtype],
        _stream_ptr(q_pack))
    fused_step_fwd.launches += 1
    return o_pack, o_dec


fused_step_fwd.launches = 0


def _cover(sched):
    """(rows a TriSched or PackedTriSched covers, its square tile edge)."""
    if isinstance(sched, PackedTriSched):
        return sched.s_total, sched.blk
    _check(sched.bq == sched.bk, f"square tiles only, got {sched.bq} x "
           f"{sched.bk}")
    return sched.n * sched.bq, sched.bq


def _check_attn(op: str, sched, q, *rest):
    """Raise unless q (B, H, S, D), rest = (k, v) (B, Hkv, S, D) and any
    further q-shaped operands (out, do) lie on one CUDA device in one
    dtype and layout the kernels take, tiled square by ``sched`` (a
    TriSched or a PackedTriSched)."""
    b, h, s_len, d = q.shape
    k = rest[0]
    hkv = k.shape[1]
    ins = (q,) + rest
    _check(all(x.is_cuda and x.device == q.device for x in ins),
           f"{op}: every operand must lie on one CUDA device")
    _check(q.dtype in _DTYPE_CODES and all(x.dtype == q.dtype for x in ins),
           f"{op}: operands must share f32 or bf16, got "
           f"{[str(x.dtype) for x in ins]}")
    _check(all(x.shape == (b, hkv, s_len, d) for x in rest[:2])
           and all(x.shape == q.shape for x in rest[2:]) and h % hkv == 0,
           f"{op}: shapes q {tuple(q.shape)} and "
           f"{[tuple(x.shape) for x in rest]}")
    _check(all(x.is_contiguous() for x in ins),
           f"{op}: operands must be contiguous")
    cover, blk = _cover(sched)
    _check(cover == s_len, f"{op}: S={s_len} but the schedule covers "
           f"{cover} rows in tiles of {blk}")
    _check(d in SUPPORTED_HEAD_DIMS and blk in SUPPORTED_BLOCKS,
           f"{op}: head_dim {d} / block {blk} unsupported (head_dim in "
           f"{SUPPORTED_HEAD_DIMS}, block in {SUPPORTED_BLOCKS})")


def _sched_args(sched: TriSched):
    """(n, w_b, p_b, window tokens or 0, prefix tokens) for the C entry
    points: the (n, w, p) member parameters of csrc/packing.cuh."""
    return (sched.n, sched.w_b, sched.p_b, sched.window or 0, sched.prefix)


def fwd(q, k, v, sched: TriSched, *, sm_scale=None):
    """Triangular-domain flash attention forward (ltm, band or prefix).

    q: (B, H, S, D); k, v: (B, Hkv, S, D), one dtype (f32 or bf16),
    contiguous. Returns (out (B, H, S, D) in q's dtype, lse (B, H, S)
    f32)."""
    b, h, s_len, d = q.shape
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    if not q.is_cuda:
        from repro_torch.kernels.tri_attn import scan_impl as SC

        return SC.fwd_torch(q, k, v, sched, scale)
    _check_attn("fwd", sched, q, k, v)
    lib = BUILD.load("tri_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_len), dtype=torch.float32, device=q.device)
    meta = OBS.meta_from_trisched("tri_attn.fwd", sched, impl="cuda",
                                  cells=b * h, grid=(sched.n, h, b))
    OBS.instrumented_launch(
        meta, lib.tri_fwd_launch, (q, k, v),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, k.shape[1], s_len, d, sched.bq,
        *_sched_args(sched), scale, _DTYPE_CODES[q.dtype], _stream_ptr(q))
    fwd.launches += 1
    return out, lse


fwd.launches = 0


def check_bb_sched(sched: TriSched):
    """fwd_bb takes ltm and band schedules only: the BB guard j <= i drops
    the above-diagonal tiles a prefix-causal row attends (the reference's
    ``fwd_bb`` returns wrong rows there), so a prefix schedule raises."""
    _check(sched.kind != "prefix",
           "fwd_bb: prefix-causal schedules are refused: the BB guard "
           "j <= i drops the above-diagonal prefix tiles")


def fwd_bb_meta(impl: str, sched: TriSched, cells: int):
    """The reference's launch geometry of fwd_bb: the n x n grid of each
    (batch, head) cell, tri(n) of it in the domain."""
    return OBS.meta_dense("tri_attn.fwd_bb", "tri_attn", impl=impl,
                          grid=(sched.n, sched.n),
                          block_shape=(sched.bq, sched.bk),
                          tiles_domain=M.tri(sched.n), cells=cells)


def fwd_bb(q, k, v, sched: TriSched, *, sm_scale=None):
    """The paper's bounding-box baseline of ``fwd`` (forward only, ltm or
    band): one block per tile of the n x n grid of each (batch, head),
    blocks above the diagonal discarded, each row's tile partials merged
    in the launch by its last block (csrc/fwd_bb.cu).

    q: (B, H, S, D); k, v: (B, Hkv, S, D), one dtype (f32 or bf16),
    contiguous. Returns (out (B, H, S, D) in q's dtype, lse (B, H, S)
    f32)."""
    b, h, s_len, d = q.shape
    scale = float(sm_scale if sm_scale is not None else 1.0 / (d ** 0.5))
    check_bb_sched(sched)
    if not q.is_cuda:
        from repro_torch.kernels.tri_attn import scan_impl as SC

        return SC.fwd_bb_torch(q, k, v, sched, scale)
    _check_attn("fwd_bb", sched, q, k, v)
    lib = BUILD.load("fwd_bb")
    n, blk = sched.n, sched.bq
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_len), dtype=torch.float32, device=q.device)
    part = torch.empty(b * h * M.tri(n) * (blk * d + 2 * blk),
                       dtype=torch.float32, device=q.device)
    arrivals = torch.zeros(b * h * n, dtype=torch.int32, device=q.device)
    OBS.instrumented_launch(
        fwd_bb_meta("cuda", sched, b * h), lib.fwd_bb_launch, (q, k, v),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), part.data_ptr(), arrivals.data_ptr(), b, h,
        k.shape[1], s_len, d, blk, n, sched.window or 0, scale,
        _DTYPE_CODES[q.dtype], _stream_ptr(q))
    fwd_bb.launches += 1
    return out, lse


fwd_bb.launches = 0


def _bwd_launch(name, c_fn, sched, q, k, v, do, lse, delta, outs, scale):
    """Checks and the launch shared by the four backward kernels: ``name``
    is the launch name (tri_attn.bwd_dq / bwd_dkv over a TriSched,
    tri_attn.packed_bwd_dq / packed_bwd_dkv over a PackedTriSched)."""
    b, h, s_len, d = q.shape
    op = name.split(".")[1]
    _check_attn(op, sched, q, k, v, do)
    _check(all(x.dtype == torch.float32 and x.shape == (b, h, s_len)
               and x.is_contiguous() and x.device == q.device
               for x in (lse, delta)),
           f"{op}: lse and delta must be contiguous (B, H, S) f32 on q's "
           f"device, got {tuple(lse.shape)} {lse.dtype} and "
           f"{tuple(delta.shape)} {delta.dtype}")
    hkv = k.shape[1]
    heads = h if name.endswith("_dq") else hkv
    if isinstance(sched, PackedTriSched):
        meta = OBS.meta_from_packed(name, sched, impl="cuda", cells=b * h,
                                    grid=(sched.total_tiles, heads, b))
        tail = (device_table(sched, q.device).data_ptr(),
                len(sched.members), sched.total_tiles)
    else:
        meta = OBS.meta_from_trisched(name, sched, impl="cuda", cells=b * h,
                                      grid=(sched.n, heads, b))
        tail = _sched_args(sched)
    OBS.instrumented_launch(
        meta, c_fn, (q, k, v, do),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs),
        b, h, hkv, s_len, d, _cover(sched)[1], *tail, scale,
        _DTYPE_CODES[q.dtype], _stream_ptr(q))


def bwd_dq(q, k, v, do, lse, delta, sched: TriSched, *, sm_scale=None):
    """dq over the row-major domain (csrc/tri_bwd.cu, tri_bwd_dq). lse and
    delta = sum(do * out): (B, H, S) f32. Returns dq in q's dtype."""
    scale = float(sm_scale if sm_scale is not None
                  else 1.0 / (q.shape[-1] ** 0.5))
    if not q.is_cuda:
        from repro_torch.kernels.tri_attn import scan_impl as SC

        return SC.dq_torch(q, k, v, do, lse, delta, sched, scale)
    dq = torch.empty_like(q)
    _bwd_launch("tri_attn.bwd_dq", BUILD.load("tri_bwd").tri_bwd_dq_launch,
                sched, q, k, v, do, lse, delta, (dq,), scale)
    bwd_dq.launches += 1
    return dq


bwd_dq.launches = 0


def bwd_dkv(q, k, v, do, lse, delta, sched: TriSched, *, sm_scale=None):
    """dk and dv over the column-major domain (csrc/tri_bwd.cu,
    tri_bwd_dkv), summed over each kv head's query heads in the kernel.
    Returns (dk, dv) in k's dtype."""
    scale = float(sm_scale if sm_scale is not None
                  else 1.0 / (q.shape[-1] ** 0.5))
    if not q.is_cuda:
        from repro_torch.kernels.tri_attn import scan_impl as SC

        return SC.dkv_torch(q, k, v, do, lse, delta, sched, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("tri_attn.bwd_dkv",
                BUILD.load("tri_bwd").tri_bwd_dkv_launch, sched,
                q, k, v, do, lse, delta, (dk, dv), scale)
    bwd_dkv.launches += 1
    return dk, dv


bwd_dkv.launches = 0


def bwd(q, k, v, out, lse, do, sched: TriSched, *, sm_scale=None):
    """Backward of ``fwd``: delta = sum(do * out) here, as the reference
    takes it, then the dq and the dk/dv launches. Returns (dq, dk, dv)
    shaped like q, k, v."""
    delta = (do.float() * out.float()).sum(dim=-1)
    dq = bwd_dq(q, k, v, do, lse, delta, sched, sm_scale=sm_scale)
    return (dq,) + tuple(bwd_dkv(q, k, v, do, lse, delta, sched,
                                 sm_scale=sm_scale))


def packed_bwd_dq(q, k, v, do, lse, delta, psched: PackedTriSched, *,
                  sm_scale=None):
    """Packed dq over the row-major packed grid (csrc/packed_bwd.cu,
    packed_bwd_dq): q, do (B, H, S_total, D); k, v (B, Hkv, S_total, D);
    lse and delta (B, H, S_total) f32. Returns dq in q's dtype."""
    scale = float(sm_scale if sm_scale is not None
                  else 1.0 / (q.shape[-1] ** 0.5))
    if not q.is_cuda:
        from repro_torch.kernels.tri_attn import scan_impl as SC

        return SC.packed_dq_torch(q, k, v, do, lse, delta, psched, scale)
    dq = torch.empty_like(q)
    _bwd_launch("tri_attn.packed_bwd_dq",
                BUILD.load("packed_bwd").packed_bwd_dq_launch, psched,
                q, k, v, do, lse, delta, (dq,), scale)
    packed_bwd_dq.launches += 1
    return dq


packed_bwd_dq.launches = 0


def packed_bwd_dkv(q, k, v, do, lse, delta, psched: PackedTriSched, *,
                   sm_scale=None):
    """Packed dk and dv over the column-major packed grid
    (csrc/packed_bwd.cu, packed_bwd_dkv), summed over each kv head's query
    heads in the kernel. Returns (dk, dv) in k's dtype."""
    scale = float(sm_scale if sm_scale is not None
                  else 1.0 / (q.shape[-1] ** 0.5))
    if not q.is_cuda:
        from repro_torch.kernels.tri_attn import scan_impl as SC

        return SC.packed_dkv_torch(q, k, v, do, lse, delta, psched, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("tri_attn.packed_bwd_dkv",
                BUILD.load("packed_bwd").packed_bwd_dkv_launch, psched,
                q, k, v, do, lse, delta, (dk, dv), scale)
    packed_bwd_dkv.launches += 1
    return dk, dv


packed_bwd_dkv.launches = 0


def packed_bwd(q, k, v, out, lse, do, psched: PackedTriSched, *,
               sm_scale=None):
    """Backward of ``packed_fwd``: delta = sum(do * out) here, as the
    reference takes it, then the packed dq and dk/dv launches. Returns
    (dq, dk, dv) shaped like q, k, v."""
    delta = (do.float() * out.float()).sum(dim=-1)
    dq = packed_bwd_dq(q, k, v, do, lse, delta, psched, sm_scale=sm_scale)
    return (dq,) + tuple(packed_bwd_dkv(q, k, v, do, lse, delta, psched,
                                        sm_scale=sm_scale))


# every kernel wrapper, by the launch name it records
WRAPPERS = {"tri_attn.packed_fwd": packed_fwd,
            "tri_attn.packed_decode_fwd": packed_decode_fwd,
            "tri_attn.fused_step_fwd": fused_step_fwd,
            "tri_attn.fwd": fwd, "tri_attn.fwd_bb": fwd_bb,
            "tri_attn.bwd_dq": bwd_dq,
            "tri_attn.bwd_dkv": bwd_dkv,
            "tri_attn.packed_bwd_dq": packed_bwd_dq,
            "tri_attn.packed_bwd_dkv": packed_bwd_dkv}


def member_map_device(local, n, w, p):
    """Evaluate the device ``member_map_params`` (csrc/packing.cuh) on
    int32 CUDA tensors of member-local lambdas and (n, w, p) parameters:
    the g(lambda) the prefill kernel walks, exposed so tests can hold it
    against the torch form. Not a kernel of the serving path."""
    _check(local.is_cuda and local.dtype == torch.int32,
           "member_map_device: int32 CUDA tensors only")
    count = local.numel()
    nwp = torch.stack([torch.as_tensor(x, device=local.device,
                                       dtype=torch.int32).expand(count)
                       for x in (n, w, p)]).contiguous()
    local = local.contiguous()
    out_i = torch.empty_like(local)
    out_j = torch.empty_like(local)
    lib = BUILD.load("packed_fwd")
    meta = OBS.meta_exact("core.member_map_probe", "core", impl="cuda",
                          kind="probe", steps=count, block_shape=(1,),
                          bb_bound=None)
    OBS.instrumented_launch(meta, lib.member_map_probe, (local, nwp),
                            local.data_ptr(), nwp.data_ptr(),
                            out_i.data_ptr(), out_j.data_ptr(), count,
                            _stream_ptr(local))
    return out_i, out_j
