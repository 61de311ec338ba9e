"""Launch lint, pass 3 of the block-space checker: the port's counterpart
of ``repro/analysis/jaxpr_lint.py``, which has no jaxpr to trace here.

Each public op of the 17 kernel sites is CALLED once, at a tiny shape on
the requested device (the attention ops twice: float32 at blk 16, the
CUDA-core bodies, and bfloat16 at blk 64, the tensor-core ones), under a
scoped metrics registry and ``obs.launch.capture``; the rules read what
was recorded:

  launch counts    ``launches_total`` per op, per launch name, equals a
                   declared literal (``EXPECTED``, written out, never read
                   from a wrapper): each attention forward, decode round
                   and fused step 1; the dense and the packed grad 3 each
                   (fwd + dq + dk/dv); every tri_edm and tri_3body entry 1;
                   ``wkv`` 1, whether the chunked kernel or, at L <= 64,
                   the walk; ``selective_scan`` 1;
  kernel path      on the card (impl "cuda") no launch is labelled
                   impl="torch": no plain version hides behind a kernel;
  member tables    the (7, R), (5, R) and (8, R) int32 tables: cumulative
                   rows ascending from 0, the packed table's offsets equal
                   ``core.packing.PackedSchedule``'s, and the decode pad
                   column (cur, n_slots, DECODE_NO_EMIT, 0, 0);
  capacities       every decode and fused launch's bucketed capacity a
                   power of two, at least its live tiles;
  dtype hygiene    no float64 or int64 operand in any recorded launch;
  tile counts      the plain versions' recorded ``tiles_launched`` equal
                   the step count of the ``core.schedule`` schedule of
                   the same domain (what the reference's HLO scan
                   invariant pinned).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.analysis.contracts import CheckResult
from repro_torch.core import schedule as S
from repro_torch.core.packing import PackedSchedule

# The attention ops' declared launches, each op run twice: in float32 at
# blk 16 (the CUDA-core bodies) and, as ".bf16", in bfloat16 at blk 64
# (the tensor-core bodies the models' main paths take).
ATTENTION: Dict[str, Dict[str, int]] = {
    "tri_attn.fwd": {"tri_attn.fwd": 1},
    "tri_attn.grad": {"tri_attn.fwd": 1, "tri_attn.bwd_dq": 1,
                      "tri_attn.bwd_dkv": 1},
    "tri_attn.fwd_bb": {"tri_attn.fwd_bb": 1},
    "tri_attn.packed_fwd": {"tri_attn.packed_fwd": 1},
    "tri_attn.packed_grad": {"tri_attn.packed_fwd": 1,
                             "tri_attn.packed_bwd_dq": 1,
                             "tri_attn.packed_bwd_dkv": 1},
    "tri_attn.decode_round": {"tri_attn.packed_decode_fwd": 1},
    "tri_attn.fused_step": {"tri_attn.fused_step_fwd": 1},
}

# op -> {launch name: count}: the declared launches of one call.
EXPECTED: Dict[str, Dict[str, int]] = {
    **ATTENTION,
    **{op + ".bf16": counts for op, counts in ATTENTION.items()},
    "tri_edm.ltm": {"tri_edm.ltm": 1},
    "tri_edm.bb": {"tri_edm.bb": 1},
    "tri_edm.dummy_ltm": {"tri_edm.dummy_ltm": 1},
    "tri_3body.tet": {"tri_3body.tet": 1},
    "tri_3body.bb3": {"tri_3body.bb3": 1},
    "tri_3body.total": {"tri_3body.tet": 1},
    "tri_3body.dummy_tet": {"tri_3body.dummy_tet": 1},
    "wkv_scan.wkv.walk": {"wkv_scan.wkv": 1},
    "wkv_scan.wkv.chunked": {"wkv_scan.wkv": 1},
    "ssm_scan.selective_scan": {"ssm_scan.selective_scan": 1},
}

# The 17 reference pallas_call sites and the op whose rule holds each.
SITE_RULES = {
    "tri_attn.packed_fwd": "tri_attn.packed_fwd",
    "tri_attn.packed_decode_fwd": "tri_attn.decode_round",
    "tri_attn.fused_step_fwd": "tri_attn.fused_step",
    "tri_attn.fwd": "tri_attn.fwd",
    "tri_attn.fwd_bb": "tri_attn.fwd_bb",
    "tri_attn.bwd_dq": "tri_attn.grad",
    "tri_attn.bwd_dkv": "tri_attn.grad",
    "tri_attn.packed_bwd_dq": "tri_attn.packed_grad",
    "tri_attn.packed_bwd_dkv": "tri_attn.packed_grad",
    "tri_edm.ltm": "tri_edm.ltm",
    "tri_edm.bb": "tri_edm.bb",
    "tri_edm.dummy_ltm": "tri_edm.dummy_ltm",
    "tri_3body.tet": "tri_3body.tet",
    "tri_3body.bb3": "tri_3body.bb3",
    "tri_3body.dummy_tet": "tri_3body.dummy_tet",
    "ssm_scan.selective_scan": "ssm_scan.selective_scan",
    "wkv_scan.wkv": "wkv_scan.wkv.chunked",
}

BLK = 16  # the float32 attention fixtures' tile edge (bf16: 64)
WIDE = (torch.float64, torch.int64)


def _res(rule, ok, detail=""):
    return CheckResult(pass_name="launch", rule=rule, ok=ok, detail=detail)


@dataclasses.dataclass
class OpCall:
    """One op, called once: ``fn(kernel)`` runs it with the kernel impl
    (or the plain one), ``steps`` maps each launch name to the step
    count of its domain's ``core.schedule`` schedule; a fused step's
    capacity is its prefill steps (``cap_base``) plus a decode bucket."""

    name: str
    fn: Callable[[bool], object]
    steps: Dict[str, int]
    cap_base: int = 0


def _rand(gen, device, *shape, grad=False):
    t = torch.randn(*shape, generator=gen).to(device)
    return t.requires_grad_(grad)


def _psched_members(psched) -> tuple:
    """The core.schedule members of a PackedTriSched's domains."""
    out = []
    for m in psched.members:
        if m.kind == "band":
            out.append(S.BandSchedule(n=m.n, w=m.w_b))
        elif m.kind == "prefix":
            out.append(S.PrefixSchedule(n=m.n, p=m.p_b))
        else:
            out.append(S.TriangularSchedule(n=m.n))
    return tuple(out)


def _packed_fixture(blk=BLK):
    from repro_torch.kernels.tri_attn import ops as OPS

    return OPS.make_packed_sched([2 * blk, blk, 3 * blk], block=blk,
                                 window=[None, 3 * blk // 2, None],
                                 prefix=[0, 0, blk])


def _kv(blk):
    """(kv_lens, s_cache) of a decode round at tile edge blk: a one-tile
    slot and a slot of several tiles."""
    s_cache = max(64, 2 * blk)
    return [5, s_cache - 24], s_cache


def _decode_fixture(device, blk=BLK):
    from repro_torch.kernels.tri_attn import ops as OPS
    from repro_torch.serve import decode as D

    (kv_lens, s_cache), slots, n_slots = _kv(blk), [0, 2], 3
    n_members = n_slots + 1
    tbl, needed = OPS.make_decode_table(kv_lens, slots, blk=blk,
                                        n_members=n_members,
                                        n_slots=n_slots, s_cache=s_cache)
    cap = D.round_capacity(needed)
    return dict(kv_lens=kv_lens, slots=slots, n_slots=n_slots,
                s_cache=s_cache, n_members=n_members, tbl=tbl,
                needed=needed, capacity=cap,
                tbl_dev=torch.as_tensor(tbl, device=device))


def _fused_fixture(device, blk=BLK):
    from repro_torch.kernels.tri_attn import ops as OPS
    from repro_torch.serve import decode as D

    psched = OPS.make_packed_sched([2 * blk, blk], block=blk)
    (kv_lens, s_cache), slots, b = _kv(blk), [0, 2], 3
    n_members = len(psched.members) + b + 1
    tbl, needed = OPS.make_fused_table(psched, kv_lens, slots, blk=blk,
                                       n_members=n_members, n_slots=b,
                                       s_cache=s_cache)
    dec_cap = D.round_capacity(needed - psched.steps)
    return dict(psched=psched, kv_lens=kv_lens, slots=slots, b=b,
                s_cache=s_cache, n_members=n_members, tbl=tbl,
                needed=needed, dec_cap=dec_cap,
                tbl_dev=torch.as_tensor(tbl, device=device))


def _attention_calls(device, gen, dtype, blk, suffix) -> List[OpCall]:
    """The attention ops at one (dtype, tile edge): one sequence of 4
    tiles, the packed / decode / fused fixtures at ``blk``."""
    from repro_torch.kernels.tri_attn import ops as OPS

    impl = lambda kernel, name="cuda", plain="torch": name if kernel \
        else plain
    rand = lambda *shape, grad=False: _rand(gen, device, *shape).to(
        dtype).requires_grad_(grad)
    b, h, hkv, d = 1, 4, 2, 16 if dtype == torch.float32 else 64
    s_len = 4 * blk
    ltm = S.TriangularSchedule(n=4).num_blocks

    def attn(kernel, grad=False, bb=False):
        q = rand(b, h, s_len, d, grad=grad)
        k, v = (rand(b, hkv, s_len, d, grad=grad) for _ in range(2))
        name = impl(kernel, "bb", "bb_torch") if bb else impl(kernel)
        out = OPS.triangular_attention(q, k, v, impl=name, block=blk)
        if grad:
            torch.autograd.grad(out.float().sum(), (q, k, v))
        return out

    psched = _packed_fixture(blk)
    p_steps = PackedSchedule.from_members(_psched_members(psched)).num_blocks

    def packed(kernel, grad=False):
        q = rand(b, h, psched.s_total, d, grad=grad)
        k, v = (rand(b, hkv, psched.s_total, d, grad=grad)
                for _ in range(2))
        out = OPS.packed_prefill_attention(q, k, v, psched,
                                           impl=impl(kernel))
        if grad:
            torch.autograd.grad(out.float().sum(), (q, k, v))
        return out

    dec = _decode_fixture(device, blk)

    def decode(kernel):  # the engine's: queries in dtype, an f32 cache
        q = rand(dec["n_slots"], h, d)
        kc, vc = (_rand(gen, device, dec["n_slots"], dec["s_cache"], hkv, d)
                  for _ in range(2))
        spec = OPS.DecodeRoundSpec(n_members=dec["n_members"],
                                   capacity=dec["capacity"], blk=blk,
                                   impl=impl(kernel), tiles=dec["needed"])
        return OPS.packed_decode_attention(q, kc, vc, dec["tbl_dev"], spec)

    fz = _fused_fixture(device, blk)

    def fused(kernel):
        ps, bb = fz["psched"], fz["b"]
        qp = rand(1, h, ps.s_total, d)
        kp, vp = (rand(1, hkv, ps.s_total, d) for _ in range(2))
        qd = rand(bb, h, d)
        kc, vc = (_rand(gen, device, bb, fz["s_cache"], hkv, d)
                  for _ in range(2))
        spec = OPS.FusedStepSpec(n_members=fz["n_members"],
                                 capacity=ps.steps + fz["dec_cap"], blk=blk,
                                 impl=impl(kernel), tiles=fz["needed"])
        return OPS.fused_step_attention(qp, kp, vp, qd, kc, vc,
                                        fz["tbl_dev"], ps, spec)

    dec_steps = PackedSchedule.decode_round(
        -(-kl // blk) for kl in dec["kv_lens"]).num_blocks
    fused_steps = PackedSchedule.mixed_step(
        _psched_members(fz["psched"]),
        [-(-kl // blk) for kl in fz["kv_lens"]]).num_blocks
    return [
        OpCall("tri_attn.fwd" + suffix, lambda kn: attn(kn),
               {"tri_attn.fwd": ltm}),
        OpCall("tri_attn.grad" + suffix, lambda kn: attn(kn, grad=True),
               dict.fromkeys(EXPECTED["tri_attn.grad"], ltm)),
        OpCall("tri_attn.fwd_bb" + suffix, lambda kn: attn(kn, bb=True),
               {"tri_attn.fwd_bb": S.DenseSchedule(n=4).num_blocks}),
        OpCall("tri_attn.packed_fwd" + suffix, lambda kn: packed(kn),
               {"tri_attn.packed_fwd": p_steps}),
        OpCall("tri_attn.packed_grad" + suffix,
               lambda kn: packed(kn, grad=True),
               dict.fromkeys(EXPECTED["tri_attn.packed_grad"], p_steps)),
        OpCall("tri_attn.decode_round" + suffix, decode,
               {"tri_attn.packed_decode_fwd": dec_steps}),
        OpCall("tri_attn.fused_step" + suffix, fused,
               {"tri_attn.fused_step_fwd": fused_steps},
               cap_base=fz["psched"].steps),
    ]


def op_calls(device) -> List[OpCall]:
    """Every public op of the 17 sites, at tiny shapes on ``device``."""
    from repro_torch.kernels.ssm_scan import ops as SSM
    from repro_torch.kernels.tri_3body import kernel as TK
    from repro_torch.kernels.tri_3body import ops as T3
    from repro_torch.kernels.tri_edm import kernel as EK
    from repro_torch.kernels.tri_edm import ops as EDM
    from repro_torch.kernels.wkv_scan import ops as WKV

    gen = torch.Generator().manual_seed(0)
    impl = lambda kernel, name="cuda", plain="torch": name if kernel \
        else plain
    x_edm = _rand(gen, device, 64, 3)
    x_3b = _rand(gen, device, 128, 3)
    n_edm, n_3b, n_dummy = 64 // 16, 128 // 64, 5

    def scan_inputs(seq):
        bs, hh, hd = 1, 2, 8
        r, k, v = (_rand(gen, device, bs, seq, hh, hd) for _ in range(3))
        lw = -torch.rand(bs, seq, hh, hd, generator=gen).to(device) - 0.1
        u = _rand(gen, device, hh, hd)
        return r, k, v, lw, u

    def wkv(kernel, seq):
        return WKV.wkv(*scan_inputs(seq), impl=impl(kernel))

    def ssm(kernel):
        bs, seq, dd, nn = 1, 24, 32, 4
        x = _rand(gen, device, bs, seq, dd)
        dt = torch.rand(bs, seq, dd, generator=gen).to(device) * 0.1
        a = -torch.rand(dd, nn, generator=gen).to(device) - 0.5
        bt, ct = (_rand(gen, device, bs, seq, nn) for _ in range(2))
        return SSM.selective_scan(x, dt, a, bt, ct, impl=impl(kernel))

    dummy_dev = lambda kernel: device if kernel else "cpu"
    return _attention_calls(device, gen, torch.float32, BLK, "") + \
        _attention_calls(device, gen, torch.bfloat16, 64, ".bf16") + [
        OpCall("tri_edm.ltm",
               lambda kn: EDM.edm(x_edm, 16, impl=impl(kn)),
               {"tri_edm.ltm": S.TriangularSchedule(n=n_edm).num_blocks}),
        OpCall("tri_edm.bb",
               lambda kn: EDM.edm(x_edm, 16, impl=impl(kn, "bb",
                                                        "bb_torch")),
               {"tri_edm.bb": S.DenseSchedule(n=n_edm).num_blocks}),
        OpCall("tri_edm.dummy_ltm",
               lambda kn: EK.dummy_ltm(n_dummy, device=dummy_dev(kn)),
               {"tri_edm.dummy_ltm":
                S.TriangularSchedule(n=n_dummy).num_blocks}),
        OpCall("tri_3body.tet",
               lambda kn: T3.three_body(x_3b, 64, impl=impl(kn)),
               {"tri_3body.tet": S.TetrahedralSchedule(n=n_3b).num_blocks}),
        OpCall("tri_3body.bb3",
               lambda kn: T3.three_body(x_3b, 64, impl=impl(kn, "bb3",
                                                            "bb3_torch")),
               {"tri_3body.bb3": S.Dense3DSchedule(n=n_3b).num_blocks}),
        OpCall("tri_3body.total",
               lambda kn: T3.three_body_total(x_3b, 64, impl=impl(kn)),
               {"tri_3body.tet": S.TetrahedralSchedule(n=n_3b).num_blocks}),
        OpCall("tri_3body.dummy_tet",
               lambda kn: TK.dummy_tet(n_dummy, device=dummy_dev(kn)),
               {"tri_3body.dummy_tet":
                S.TetrahedralSchedule(n=n_dummy).num_blocks}),
        OpCall("wkv_scan.wkv.walk", lambda kn: wkv(kn, 40), {}),
        OpCall("wkv_scan.wkv.chunked", lambda kn: wkv(kn, 80), {}),
        OpCall("ssm_scan.selective_scan", ssm, {}),
    ]


def run_op(call: OpCall, kernel: bool):
    """(registry, captured launches) of one call of ``call``."""
    from repro_torch.obs import launch as L
    from repro_torch.obs import metrics as MET

    reg = MET.Registry("launch_lint")
    with MET.scope(reg), L.capture() as got:
        call.fn(kernel)
    return reg, got


def _by_name(reg, impl=None) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for key, value in reg.counter_items():
        labels = dict(key[1:])
        if key[0] != "launches_total" or \
                (impl is not None and labels.get("impl") != impl):
            continue
        out[labels["name"]] = out.get(labels["name"], 0) + int(value)
    return out


def _capacity(meta):
    return dict(meta.extra).get("capacity")


def lint_ops(device="cpu") -> List[CheckResult]:
    """Launch counts, the kernel path, capacities and dtypes of every op
    with the device's impl ("cuda" on the card, the plain versions on the
    CPU)."""
    kernel = torch.device(device).type == "cuda"
    out = []
    for call in op_calls(device):
        reg, got = run_op(call, kernel)
        counts = _by_name(reg)
        want = EXPECTED[call.name]
        total = int(reg.counter_total("launches_total"))
        out.append(_res(
            f"launch.{call.name}.count",
            counts == want and total == sum(want.values()),
            f"launches_total {total} by name {counts} (declared {want})"))
        if kernel:
            plain = _by_name(reg, impl="torch")
            out.append(_res(
                f"launch.{call.name}.no_plain_launch", not plain,
                f"impl='torch' launches on the kernel path: "
                f"{plain or 'none'}"))
        wide = sorted({f"{m.name}:{dt}" for m, dts in got for dt in dts
                       if dt in WIDE})
        out.append(_res(
            f"launch.{call.name}.no_wide_dtypes", not wide,
            f"float64/int64 operands in {len(got)} recorded launches: "
            f"{wide or 'none'}"))
        caps = [(m.name, _capacity(m) - call.cap_base,
                 m.tiles_launched - call.cap_base) for m, _ in got
                if _capacity(m) is not None]
        if caps:
            bad = [c for c in caps
                   if c[1] < max(c[2], 1) or c[1] & (c[1] - 1)]
            out.append(_res(
                f"launch.{call.name}.capacity_pow2", not bad,
                f"(name, decode bucket, live decode tiles) {caps}: "
                "power-of-two buckets covering the live tiles"))
    return out


def lint_plain_tiles(device="cpu") -> List[CheckResult]:
    """The plain versions' recorded tiles_launched against the step count
    of the core.schedule schedule of the same domain."""
    out = []
    for call in op_calls(device):
        if not call.steps:
            continue
        _, got = run_op(call, kernel=False)
        seen = [(m.name, m.impl, m.tiles_launched) for m, _ in got]
        bad = [s for s in seen if s[1] != "torch"
               or s[2] != call.steps.get(s[0])]
        out.append(_res(
            f"launch.{call.name}.plain_tiles", bool(seen) and not bad,
            f"recorded (name, impl, tiles_launched) {seen} vs schedule "
            f"steps {call.steps}"))
    return out


def lint_tables() -> List[CheckResult]:
    """The member-table ABI of the packed, decode and fused launches."""
    from repro_torch.core.mapping import INT32_MAX
    from repro_torch.kernels.tri_attn import kernel as K

    out = []
    psched = _packed_fixture()
    tbl = psched.table()
    r = len(psched.members)
    ref = PackedSchedule.from_members(_psched_members(psched))
    ok = (tbl.shape == (7, r) and tbl.dtype == np.int32
          and tbl[0, 0] == 0 and tbl[1, 0] == 0
          and bool((np.diff(tbl[0]) > 0).all())
          and bool((np.diff(tbl[1]) > 0).all())
          and tuple(tbl[0]) == ref.offsets[:-1]
          and tuple(tbl[1]) == ref.row_offsets[:-1]
          and K.device_table(psched, torch.device("cpu")).dtype
          == torch.int32)
    out.append(_res(
        "launch.tables.packed", ok,
        f"(7, R) table {tbl.shape} {tbl.dtype}; starts {tbl[0].tolist()} "
        f"/ rows {tbl[1].tolist()} vs PackedSchedule offsets "
        f"{ref.offsets[:-1]} / row_offsets {ref.row_offsets[:-1]}"))

    dec = _decode_fixture("cpu")
    dt = dec["tbl"]
    pad = tuple(int(v) for v in dt[:, -1])
    want_pad = (dec["needed"], dec["n_slots"], K.DECODE_NO_EMIT, 0, 0)
    ok = (dt.shape == (5, dec["n_members"]) and dt.dtype == np.int32
          and dt[0, 0] == 0 and bool((np.diff(dt[0]) >= 0).all())
          and pad == want_pad and K.DECODE_NO_EMIT == 2 ** 30
          and K.DECODE_NO_EMIT > INT32_MAX // (2 * BLK))
    out.append(_res(
        "launch.tables.decode", ok,
        f"(5, R) table {dt.shape} {dt.dtype}; pad column {pad} vs declared "
        f"(cur, n_slots, DECODE_NO_EMIT, 0, 0) = {want_pad}"))

    fz = _fused_fixture("cpu")
    ft, r_p = fz["tbl"], len(fz["psched"].members)
    pad = tuple(int(v) for v in ft[:, -1])
    want_pad = (fz["needed"], 1, K.DECODE_NO_EMIT, 0, 0, fz["b"], 0, 0)
    ok = (ft.shape == (8, fz["n_members"]) and ft.dtype == np.int32
          and ft[0, 0] == 0 and bool((np.diff(ft[0]) >= 0).all())
          and bool((ft[1, :r_p] == 0).all())
          and bool((ft[1, r_p:] == 1).all())
          and int(ft[0, r_p]) == fz["psched"].steps and pad == want_pad)
    out.append(_res(
        "launch.tables.fused", ok,
        f"(8, R) table {ft.shape} {ft.dtype}; kind row {ft[1].tolist()} "
        f"split at {r_p}; pad column {pad} vs declared {want_pad}"))
    caps = (dec["capacity"], fz["dec_cap"])
    out.append(_res(
        "launch.tables.capacity_pow2",
        all(c & (c - 1) == 0 for c in caps)
        and dec["capacity"] >= dec["needed"]
        and fz["dec_cap"] >= fz["needed"] - fz["psched"].steps,
        f"decode capacity {dec['capacity']} for {dec['needed']} tiles, "
        f"fused decode bucket {fz['dec_cap']} for "
        f"{fz['needed'] - fz['psched'].steps}"))
    return out


def run(device="cpu") -> List[CheckResult]:
    out = []
    for rule_fn in (lint_ops, lint_plain_tiles, lint_tables):
        try:
            out.extend(rule_fn(device) if rule_fn is not lint_tables
                       else rule_fn())
        except Exception as e:  # a crash is a lint failure
            out.append(_res(f"launch.{rule_fn.__name__}", False,
                            f"exception: {type(e).__name__}: {e}"))
    return out
