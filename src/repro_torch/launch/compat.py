"""The table of the port's kernel regions (counterpart of the reference's
``KERNEL_REGION_OP_NAME_SPELLINGS``, ``repro/launch/compat.py:53-77``).

The reference's roofline found its kernel interiors by the op_name
spellings of its HLO; the port's consumers find theirs here: the
profiler's attribution (``roofline/attribution.py``) by the ``__global__``
names a region launches, the launch lint's profiler check
(``analysis/obs_lint.py``) by the same names, and the meta device's count
(``roofline/dispatch_count.py``) by each region's work function. One
tested table: every ``__global__`` function of ``csrc/`` has exactly one
entry (``tests/test_torch_roofline.py``), so a kernel added without an
entry fails one pinned test instead of vanishing from every reading.

Each ``Region`` names the wrapper (the launch name ``WRAPPERS`` records,
and its function in ``kernels/*/kernel.py``), the reference's
``pallas_call`` site (the row of ``PERF.md`` section 6, or none for the
port's probe and yardstick), the ``__global__`` functions it launches as
the profiler prints them, and ``work``: the region's ``Work`` from the
shapes and schedule its wrapper takes, by the rules of
``roofline/model.py`` that the bounds of section 6 use.

Two counts of an attention region's work, never mixed: ``flops`` is the
function's work, 4, 6 and 8 D flops a (query, key) pair that the mask
keeps for the forward, dq and dk/dv, so ``fwd`` and ``fwd_bb`` count the
same; ``launched_flops`` is what the schedule launches, its tiles x blk^2
pairs at the same rate a pair, which is what the reference's HLO walk
counts and what the paper's I compares.

The reference's ``cost_analysis_dict`` and its JAX version shims
(``auto_axis_types``, ``make_mesh``'s ``axis_types``) have no counterpart:
the port compiles no XLA program and builds no ``jax.sharding.Mesh``; its
abstract meshes are ``launch/mesh.py``'s.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Optional, Tuple

import torch

from repro_torch.roofline import model as RF


@dataclasses.dataclass(frozen=True)
class Work:
    """One launch's work: the function's flops, the flops of what its grid
    launches, the bytes it must move, and its least time on the card."""

    flops: float
    launched_flops: float
    bytes: float
    bound_ms: float
    bound_by: str


@dataclasses.dataclass(frozen=True)
class Region:
    name: str                 # the launch name WRAPPERS records
    wrapper: str              # kernels/<family>/kernel.py:<function>
    reference: str            # PERF.md section 6 row and pallas_call site
    kernels: Tuple[str, ...]  # __global__ functions it launches
    work: Optional[Callable[..., Work]]


def _work(flops, launched, nbytes, dtype) -> Work:
    ms, by = RF.bound(nbytes, flops, dtype)
    return Work(float(flops), float(launched), float(nbytes), ms, by)


def _tri(n: int) -> int:
    return n * (n + 1) // 2


def _tet(n: int) -> int:
    return n * (n + 1) * (n + 2) // 6


def sched_pairs(sched, s_len: int) -> int:
    """(query, key) pairs of one sequence of ``s_len`` rows that a
    TriSched's mask keeps: causal, banded to its window, or prefix-causal
    (a prefix of at least the sequence sees every key)."""
    causal = _tri(s_len)
    if sched.kind == "ltm":
        return causal
    if sched.kind == "band":  # row i keeps min(i + 1, w) keys
        w = min(sched.window, s_len)
        return _tri(w) + (s_len - w) * w
    p = min(sched.prefix, s_len)  # row i keeps max(i + 1, p) keys
    return p * p + causal - _tri(p)


def _members(sched):
    return getattr(sched, "members", (sched,))


def _attn(op: str, q, k, sched, *, tiles: Optional[int] = None) -> Work:
    """An attention launch of q (B, H, S, D), k (B, Hkv, S, D) over a
    TriSched or PackedTriSched: pairs member by member, ``tiles`` the
    grid's tiles a (b, h) (the schedule's own unless given)."""
    b, h, _, d = q.shape
    members = _members(sched)
    pairs = b * h * sum(sched_pairs(m, m.n * m.bq) for m in members)
    blk = members[0].bq
    if tiles is None:
        tiles = sum(m.rm_steps for m in members)
    nbytes, flops = RF.attn_work(op, q_elems=q.numel(), k_elems=k.numel(),
                                 d=d, elt=q.element_size(), pairs=pairs)
    per_pair = {"fwd": 4, "dq": 6, "dkv": 8}[op] * d
    return _work(flops, per_pair * b * h * tiles * blk * blk, nbytes,
                 q.dtype)


def _fwd(q, k, sched) -> Work:
    return _attn("fwd", q, k, sched)


def _fwd_bb(q, k, sched) -> Work:
    return _attn("fwd", q, k, sched, tiles=sched.n * sched.n)


def _dq(q, k, sched) -> Work:
    return _attn("dq", q, k, sched)


def _dkv(q, k, sched) -> Work:
    return _attn("dkv", q, k, sched)


def _decode(q, k_cache, tbl, tiles: int, blk: int) -> Work:
    """A decode round of q (B, H, D) against (B, S_cache, Hkv, D) caches:
    the grid walks ``tiles`` live tiles of blk cache tokens, each read for
    every query head. On the meta device the table's lengths are not
    known, so the live tokens are counted as whole tiles (at most blk - 1
    more a member than the chip's count)."""
    b, h, d = q.shape
    nbytes, flops = RF.decode_work(
        q_elems=q.numel(), b=b, h=h, d=d, elt=q.element_size(),
        tbl_elems=tbl.numel(), kv_tokens=tiles * blk, hkv=k_cache.shape[2],
        cache_elt=k_cache.element_size())
    return _work(flops, flops, nbytes, torch.float32)


def _fused(q_pack, k_pack, v_pack, q_dec, k_cache, tbl, psched,
           tiles: int) -> Work:
    """The fused step: the prefill half as ``packed_fwd`` over the pack,
    the decode half as a decode round of the live tiles past the
    prefill's steps (whole tiles, as ``_decode``)."""
    _, h, _, d = q_pack.shape
    blk = psched.blk
    kw = dict(pack_q_elems=q_pack.numel(), pack_k_elems=k_pack.numel(),
              pack_v_elems=v_pack.numel(), elt=q_pack.element_size(),
              live=q_dec.shape[0], h=h, d=d, tbl_elems=tbl.numel(),
              kv_tokens=(tiles - psched.steps) * blk, hkv=k_cache.shape[2],
              cache_elt=k_cache.element_size(),
              pairs=h * sum(sched_pairs(m, m.n * m.bq)
                            for m in psched.members))
    ms, by = RF.fused_step_bound(**kw)
    nbytes, pair_flops, token_flops = RF.fused_step_work(**kw)
    launched = 4 * d * h * psched.steps * blk * blk + token_flops
    return Work(float(pair_flops + token_flops), float(launched),
                float(nbytes), ms, by)


def _ssm(b: int, l: int, d: int, n: int) -> Work:
    nbytes, flops, _ = RF.ssm_work(b, l, d, n)
    sb = RF.ssm_bound(b, l, d, n, RF.H100_MAX_SM_CLOCK_HZ)
    return Work(float(flops), float(flops), float(nbytes), sb["bound"],
                sb["by"])


def _wkv(b: int, l: int, h: int, hd: int) -> Work:
    nbytes, flops = RF.wkv_work(b, l, h, hd)
    return _work(flops, flops, nbytes, torch.float32)


def _edm(kind: str):
    def work(n_rows: int, d: int, blk: int) -> Work:
        nbytes, flops = RF.edm_work(kind, n_rows, d, blk)
        n = n_rows // blk
        launched = flops if kind == "ltm" else flops // _tri(n) * n * n
        return _work(flops, launched, nbytes, torch.float32)
    return work


def _three_body(kind: str):
    def work(n_rows: int, d: int, blk: int) -> Work:
        nbytes, flops = RF.three_body_work(kind, n_rows, d, blk)
        n = n_rows // blk
        launched = flops if kind == "tet" else flops // _tet(n) * n ** 3
        return _work(flops, launched, nbytes, torch.float32)
    return work


def _dummy(blocks_of):
    def work(n: int) -> Work:
        nbytes, flops = RF.dummy_work(blocks_of(n))
        return _work(flops, flops, nbytes, torch.float32)
    return work


REGIONS = (
    Region("tri_attn.packed_fwd", "tri_attn/kernel.py:packed_fwd",
           "row 1, src/repro/kernels/tri_attn/kernel.py:437",
           ("packed_fwd_tc_kernel", "packed_fwd_kernel"), _fwd),
    Region("tri_attn.packed_decode_fwd",
           "tri_attn/kernel.py:packed_decode_fwd",
           "row 2, src/repro/kernels/tri_attn/kernel.py:797",
           ("packed_decode_kernel",), _decode),
    Region("tri_attn.fused_step_fwd", "tri_attn/kernel.py:fused_step_fwd",
           "row 3, src/repro/kernels/tri_attn/kernel.py:995",
           ("fused_step_kernel",), _fused),
    Region("tri_attn.fwd", "tri_attn/kernel.py:fwd",
           "row 4, src/repro/kernels/tri_attn/kernel.py:306",
           ("tri_fwd_tc_kernel", "tri_fwd_f32_kernel"), _fwd),
    Region("tri_attn.fwd_bb", "tri_attn/kernel.py:fwd_bb",
           "row 5, src/repro/kernels/tri_attn/kernel.py:1214",
           ("fwd_bb_tc_kernel", "fwd_bb_f32_kernel"), _fwd_bb),
    Region("tri_attn.bwd_dq", "tri_attn/kernel.py:bwd_dq",
           "row 6, src/repro/kernels/tri_attn/kernel.py:1103",
           ("tri_bwd_dq_tc_kernel", "tri_bwd_dq_kernel"), _dq),
    Region("tri_attn.bwd_dkv", "tri_attn/kernel.py:bwd_dkv",
           "row 7, src/repro/kernels/tri_attn/kernel.py:1126",
           ("tri_bwd_dkv_tc_kernel", "tri_bwd_dkv_kernel"), _dkv),
    Region("tri_attn.packed_bwd_dq", "tri_attn/kernel.py:packed_bwd_dq",
           "row 8, src/repro/kernels/tri_attn/kernel.py:581",
           ("packed_bwd_dq_tc_kernel", "packed_bwd_dq_kernel"), _dq),
    Region("tri_attn.packed_bwd_dkv", "tri_attn/kernel.py:packed_bwd_dkv",
           "row 9, src/repro/kernels/tri_attn/kernel.py:621",
           ("packed_bwd_dkv_tc_kernel", "packed_bwd_dkv_kernel"), _dkv),
    Region("tri_edm.ltm", "tri_edm/kernel.py:edm_ltm",
           "row 10, src/repro/kernels/tri_edm/kernel.py:60",
           ("edm_ltm_kernel",), _edm("ltm")),
    Region("tri_edm.bb", "tri_edm/kernel.py:edm_bb",
           "row 11, src/repro/kernels/tri_edm/kernel.py:95",
           ("edm_bb_kernel",), _edm("bb")),
    Region("tri_edm.dummy_ltm", "tri_edm/kernel.py:dummy_ltm",
           "row 12, src/repro/kernels/tri_edm/kernel.py:121",
           ("dummy_ltm_kernel",), _dummy(_tri)),
    Region("tri_3body.tet", "tri_3body/kernel.py:three_body_tet",
           "row 13, src/repro/kernels/tri_3body/kernel.py:94",
           ("three_body_tet_kernel",), _three_body("tet")),
    Region("tri_3body.bb3", "tri_3body/kernel.py:three_body_bb3",
           "row 14, src/repro/kernels/tri_3body/kernel.py:139",
           ("three_body_bb3_kernel",), _three_body("bb3")),
    Region("tri_3body.dummy_tet", "tri_3body/kernel.py:dummy_tet",
           "row 15, src/repro/kernels/tri_3body/kernel.py:167",
           ("dummy_tet_kernel",), _dummy(_tet)),
    Region("ssm_scan.selective_scan", "ssm_scan/kernel.py:selective_scan",
           "row 16, src/repro/kernels/ssm_scan/kernel.py:83",
           ("ssm_kernel",), _ssm),
    Region("wkv_scan.wkv", "wkv_scan/kernel.py:wkv",
           "row 17, src/repro/kernels/wkv_scan/kernel.py:76",
           ("wkv_kernel", "wkv_walk_kernel"), _wkv),
    # the port's own launches, with no pallas_call behind them
    Region("core.member_map_probe", "tri_attn/kernel.py:member_map_device",
           "none: a test probe of the device map",
           ("member_map_probe_kernel",), None),
    Region("tri_edm.empty_blocks", "tri_edm/kernel.py:empty_blocks",
           "none: the block dispatch yardstick",
           ("empty_blocks_kernel",), None),
)

BY_NAME = {r.name: r for r in REGIONS}


def kernel_names() -> set:
    """Every ``__global__`` function the table names."""
    return {k for r in REGIONS for k in r.kernels}


def kernel_regex():
    """One pattern over every region's ``__global__`` names, as the
    profiler prints them (a template's arguments after the name)."""
    return re.compile(r"\b(" + "|".join(sorted(kernel_names())) + r")\b")


def region_of_kernel(kernel: str) -> Optional[str]:
    """The region whose ``__global__`` function a profiler kernel name
    shows, or None for a kernel not of the port's csrc."""
    m = kernel_regex().search(kernel)
    if m is None:
        return None
    return next(r.name for r in REGIONS if m.group(1) in r.kernels)


def work(name: str, *args, **kw) -> Work:
    """``name``'s work at the given shapes (the wrapper's arguments)."""
    region = BY_NAME[name]
    if region.work is None:
        raise ValueError(f"{name}: no work function (the port's own "
                         "probe or yardstick)")
    return region.work(*args, **kw)
