"""Schedule contract verification, pass 2 of the block-space checker
(port of ``repro/analysis/verifier.py``).

For every contract declared in repro_torch.analysis.contracts the engine
proves,
per case (n up to 10^4, where exhaustive enumeration is impossible):

  counting     num_blocks / domain_blocks equal the contract's independent
               closed forms, and the declared segments PARTITION
               [0, num_blocks) (contiguous, ascending, widths summing to
               the launch count). For COVER kinds the per-segment active
               counts additionally sum to the domain size.
  boundaries   host_map at every segment's first/mid/last launch lands on
               the closed-form expected cell, inside the domain, and the
               declared inverse round-trips it (the uniqueness witness:
               an inverse that is a left inverse at all probes of a
               partition whose widths sum to the domain count leaves no
               room for a collision).
  traced       index_map on an int32 tensor of every boundary probe, on
               the requested device (the tensor forms run there: on the
               card, on the card), equals host_map (only within the
               certified int32 envelopes; cases outside set
               Case.traced=False).
  exhaustive   small-n cross-check (n <= ~64): full enumeration equals the
               domain set exactly — anchors the closed forms to the same
               ground truth the registry fuzz tests use.

MULTIPASS (REC) gets a dedicated engine: pass-level counting identities,
origin-square containment probing, and a small-n coverage bitmap.

The decode-side bucket contract (the port's serve.decode.round_capacity)
is also verified here: power-of-two, >= need, >= floor, minimal and
monotone, the bucketed grid sizes a decode round's spec carries.
"""

from __future__ import annotations

import bisect
from typing import List

import numpy as np
import torch

from repro_torch.analysis import contracts as C
from repro_torch.core import mapping as M
from repro_torch.core import schedule as S


def _res(rule, ok, detail=""):
    return C.CheckResult(pass_name="contracts", rule=rule, ok=ok,
                         detail=detail)


def _probe_lams(segs):
    """first / mid / last launch of every segment (deduped, sorted)."""
    out = set()
    for seg in segs:
        out.add(seg.origin)
        out.add(seg.origin + seg.width - 1)
        out.add(seg.origin + seg.width // 2)
    return sorted(out)


def _verify_case(con: C.ScheduleContract, case: C.Case,
                 device) -> List[C.CheckResult]:
    tag = f"contract.{con.kind}[{case.label}]"
    out = []
    sched = con.make(case)
    launched = con.launched(case)
    domain = con.domain(case)
    segs = list(con.segments(case))

    # -- counting ------------------------------------------------------------
    cursor, widths_ok = 0, True
    for seg in segs:
        if seg.origin != cursor or seg.width <= 0:
            widths_ok = False
            break
        cursor += seg.width
    count_ok = (sched.num_blocks == launched
                and sched.domain_blocks == domain
                and widths_ok and cursor == launched)
    detail = (f"launched {sched.num_blocks} vs closed form {launched}; "
              f"domain {sched.domain_blocks} vs {domain}; "
              f"{len(segs)} segments partition the launch range: "
              f"{widths_ok and cursor == launched}")
    if con.bijectivity == C.COVER:
        active_total = sum(con.seg_active_count(si, seg, case)
                           for si, seg in enumerate(segs))
        count_ok = count_ok and active_total == domain
        detail += f"; active closed-form total {active_total} vs {domain}"
    if con.bijectivity == C.BIJECTION:
        count_ok = count_ok and launched == domain
    out.append(_res(f"{tag}.counting", count_ok, detail))

    # -- boundary probing ----------------------------------------------------
    lams = _probe_lams(segs)
    bad = []
    cells = {}
    origins = [seg.origin for seg in segs]
    for lam in lams:
        cell = sched.host_map(lam)
        cells[lam] = tuple(cell)
        # locate the segment owning lam (origins ascending)
        si = bisect.bisect_right(origins, lam) - 1
        seg = segs[si]
        off = lam - seg.origin
        if lam == seg.origin and tuple(cell) != tuple(seg.first):
            bad.append((lam, cell, "first", seg.first))
            continue
        if (lam == seg.origin + seg.width - 1
                and tuple(cell) != tuple(seg.last)):
            bad.append((lam, cell, "last", seg.last))
            continue
        if con.bijectivity == C.BIJECTION:
            if not con.in_domain(cell, case):
                bad.append((lam, cell, "in_domain", None))
            elif con.inverse(cell, case) != lam:
                bad.append((lam, cell, "inverse", con.inverse(cell, case)))
        else:  # COVER: the declared active predicate must match reality,
            # and active cells must round-trip through the inverse.
            declared = con.active_at(off, seg, case)
            actual = con.in_domain(cell, case)
            if declared != actual:
                bad.append((lam, cell, "active", declared))
            elif actual and con.inverse(cell, case) != lam:
                bad.append((lam, cell, "inverse", con.inverse(cell, case)))
    out.append(_res(
        f"{tag}.boundaries", not bad,
        f"{len(lams)} probes (3 per segment); "
        + (f"first violation {bad[0]}" if bad
           else "all land on closed-form cells and round-trip")))

    # -- traced equivalence --------------------------------------------------
    if case.traced and lams:
        arr = torch.as_tensor(lams, dtype=torch.int32, device=device)
        coords = tuple(sched.index_map(arr))
        mism = 0
        for axis in range(len(coords)):
            got = coords[axis].cpu().numpy()
            exp = np.asarray([cells[l][axis] for l in lams])
            mism += int((got != exp).sum())
        out.append(_res(
            f"{tag}.traced", mism == 0,
            f"index_map on {arr.device.type} == host_map at {len(lams)} "
            f"boundary probes ({mism} coordinate mismatches)"))

    # -- exhaustive small-n cross-check --------------------------------------
    if case.exhaustive:
        cells = []
        for lam in range(sched.num_blocks):
            cell = tuple(sched.host_map(lam))
            if con.bijectivity == C.COVER and not con.in_domain(cell, case):
                continue
            cells.append(cell)
        uniq = len(set(cells)) == len(cells)
        full = len(cells) == domain
        dom_ok = all(con.in_domain(c, case) for c in cells)
        out.append(_res(
            f"{tag}.exhaustive", uniq and full and dom_ok,
            f"enumerated {len(cells)} useful cells (expect {domain}); "
            f"unique={uniq}, all in-domain={dom_ok}"))
    return out


def _verify_multipass(con: C.ScheduleContract,
                      case: C.Case) -> List[C.CheckResult]:
    """REC: counting identities + containment probes + small-n bitmap."""
    tag = f"contract.{con.kind}[{case.label}]"
    out = []
    sched = con.make(case)
    n = case.n
    m = case.kwargs.get("m", 1)
    passes = sched.passes()

    # counting: launched = sum of pass areas; useful cells partition tri(n)
    launched = sum(e * e * len(origins) for e, origins, _ in passes)
    useful = sum((len(origins) * e * (e + 1) // 2) if is_diag
                 else len(origins) * e * e
                 for e, origins, is_diag in passes)
    count_ok = (sched.num_blocks == launched
                and useful == M.tri(n)
                and sched.domain_blocks == M.tri(n))
    out.append(_res(
        f"{tag}.counting", count_ok,
        f"launched {launched} (= schedule {sched.num_blocks}); useful "
        f"closed form {useful} vs tri(n) {M.tri(n)}"))

    # containment: every origin square in-bounds; non-diagonal squares
    # entirely below the diagonal (worst cell is the top-right corner).
    bad = []
    for e, origins, is_diag in passes:
        for oi, oj in origins:
            if not (0 <= oi and 0 <= oj and oi + e <= n and oj + e <= n):
                bad.append(("bounds", e, (oi, oj)))
            elif not is_diag and oj + e - 1 > oi:
                bad.append(("diagonal", e, (oi, oj)))
            elif is_diag and oi != oj:
                bad.append(("diag-origin", e, (oi, oj)))
    out.append(_res(
        f"{tag}.containment", not bad,
        f"{sum(len(o) for _, o, _ in passes)} origin squares; "
        + (f"first violation {bad[0]}" if bad else "all inside the domain")))

    # small-n bitmap: every lower-tri cell painted exactly once
    if case.exhaustive:
        paint = np.zeros((n, n), np.int32)
        for i, j in sched.enumerate_host():
            paint[i, j] += 1
        tril = np.tril(np.ones((n, n), bool))
        ok = bool((paint[tril] == 1).all() and (paint[~tril] == 0).all())
        out.append(_res(
            f"{tag}.exhaustive", ok,
            f"bitmap cover at n={n}, m={m}: each of tri(n)={M.tri(n)} "
            f"cells painted exactly once: {ok}"))
    return out


def verify_contract(con: C.ScheduleContract,
                    device="cpu") -> List[C.CheckResult]:
    out = []
    for case in con.cases:
        try:
            if con.bijectivity == C.MULTIPASS:
                out.extend(_verify_multipass(con, case))
            else:
                out.extend(_verify_case(con, case, device))
        except Exception as e:  # a crash IS a contract violation
            out.append(_res(f"contract.{con.kind}[{case.label}]", False,
                            f"exception: {type(e).__name__}: {e}"))
    return out


def verify_registry_coverage(cons=None) -> List[C.CheckResult]:
    """Every make_schedule kind must have a contract (directly or via
    alias): a new kind cannot land without declaring one."""
    cons = C.schedule_contracts() if cons is None else cons
    missing = [k for k in C.REGISTERED_KINDS
               if C.KIND_ALIASES.get(k, k) not in cons]
    # and the declared registry list must actually match make_schedule
    stale = []
    for k in C.REGISTERED_KINDS:
        try:
            if k == "packed":
                S.make_schedule(k, 0, members=(S.TriangularSchedule(n=2),))
            elif k == "mixed":
                S.make_schedule(
                    k, 0, prefill_members=(S.TriangularSchedule(n=2),),
                    kv_tiles=(3,))
            elif k == "rec":
                S.make_schedule(k, 4, m=1)
            else:
                S.make_schedule(k, 4)
        except KeyError:
            stale.append(k)
    return [_res(
        "contracts.registry_coverage", not missing and not stale,
        f"registered kinds {len(C.REGISTERED_KINDS)}; missing contracts "
        f"{missing or 'none'}; stale registry entries {stale or 'none'}")]


def verify_bucket_contract() -> List[C.CheckResult]:
    """serve.decode.round_capacity: the bucketed grid size a decode
    round's spec carries."""
    from repro_torch.serve import decode as D

    bad = []
    prev = 0
    for need in range(0, 4097):
        cap = D.round_capacity(need)
        pow2 = cap & (cap - 1) == 0
        lower = cap >= max(need, 8)
        minimal = cap == 8 or cap // 2 < max(need, 8)
        mono = cap >= prev
        if not (pow2 and lower and minimal and mono):
            bad.append((need, cap))
        prev = cap
    distinct = len({D.round_capacity(v) for v in range(4097)})
    return [_res(
        "contracts.decode_bucket", not bad and distinct <= 10,
        f"round_capacity over [0, 4096]: power-of-two, >= need, minimal, "
        f"monotone; {distinct} distinct buckets (log-bounded); "
        + (f"first violation {bad[0]}" if bad else "ok"))]


def run(device="cpu") -> List[C.CheckResult]:
    out = verify_registry_coverage()
    for con in C.schedule_contracts().values():
        out.extend(verify_contract(con, device))
    out.extend(verify_bucket_contract())
    return out
