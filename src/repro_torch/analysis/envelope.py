"""Envelope certification, pass 1 of the block-space checker (port of
``repro/analysis/envelope.py``, derived for the port's own arithmetic).

``core/mapping.py`` and ``csrc/packing.cuh`` DECLARE the int32 envelopes
of the tensor and device maps as named constants (ISQRT_TRACED_MAX_X,
LTM_TRACED_MAX_LAM, TET_TRACED_MAX_LAM, the probe counts and clamps).
This pass DERIVES each one and fails where a declaration disagrees with
its derivation, or where a declared probe count is below what the
derivation requires:

  * float error of each candidate chain, per place it runs:
      torch.sqrt in float32   correctly rounded on the CPU (the IEEE sqrt
                              instruction) and on CUDA (PyTorch builds
                              without fast-math: sqrt.rn.f32);
      torch.pow(6 lam, 1/3)   torch has no cbrt: the exponent 1/3 is
                              rounded to float32, which moves the result
                              by (6 lam)^(fl(1/3) - 1/3), about the
                              exponent's error times ln(6 lam); plus
                              powf's own documented error (Sleef's u10
                              vector powf on the CPU: 1 ulp; CUDA's powf:
                              4 ulp, CUDA Math API);
      the device's sqrtf      correctly rounded (nvcc's default
                              -prec-sqrt=true);
      the device's cbrtf      1 ulp (CUDA Math API);
    each bound, taken at the top of the envelope, lower-bounds the
    integer probes each way;
  * int32 overflow of every intermediate: 8 lam + 1, the probe squares,
    tri(i) (i + 2) of tet(i), tri(i) of the row's j;
  * empirical certification of the tensor forms at every floor seam
    (x = r^2 and its neighbours, lam = tri(i) and tri(i) - 1, lam =
    tet(i) and tet(i) - 1) on the requested device; on the card also the
    device maps (``member_map_device``: ltm, band and prefix members at
    every tri(i) seam up to LTM_TRACED_MAX_LAM). The device tet_map is
    walked over its whole envelope by ``dummy_tet`` (chip_smoke.py).
"""

from __future__ import annotations

import math
import pathlib
import re

import numpy as np
import torch

from repro_torch.analysis.contracts import CheckResult
from repro_torch.core import mapping as M

U32 = 2.0 ** -24  # float32 unit roundoff (round to nearest)
ULP_REL = 2.0 ** -23  # one float32 ulp relative to the value, at most

# Documented maximum error, in ulps, of each root the maps take, where it
# runs. torch.sqrt and sqrtf are correctly rounded (half an ulp).
SQRT_ULP = {"cpu torch.sqrt": 0.5, "cuda torch.sqrt": 0.5,
            "cuda sqrtf": 0.5}
POW_ULP = {"cpu torch.pow": 1.0, "cuda torch.pow": 4.0}
CBRT_ULP = {"cuda cbrtf": 1.0}

PACKING_CUH = pathlib.Path(__file__).resolve().parents[1] / "csrc" / \
    "packing.cuh"


def _res(rule, ok, detail=""):
    return CheckResult(pass_name="envelope", rule=rule, ok=ok,
                       detail=detail)


def device_constants() -> dict:
    """The constants and the isqrt probe lines of csrc/packing.cuh."""
    src = PACKING_CUH.read_text(encoding="utf-8")
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src)}
    body = re.search(r"int isqrt_i32\(int x\) \{(.*?)\n\}", src, re.S)
    body = body.group(1) if body else ""
    consts["ISQRT_PROBES_UP"] = len(re.findall(r"if \(up \* up <= x", body))
    consts["ISQRT_PROBES_DOWN"] = len(re.findall(r"if \(r \* r > x\)", body))
    consts["sqrtf"] = "sqrtf(" in body
    consts["cbrtf"] = "cbrtf(6.0f" in src
    return consts


def _floor_steps(abs_err: float) -> int:
    """How many integer steps floor() of a value off by < abs_err can move:
    1 below one unit (the probes then repair it), else more."""
    return max(1, math.ceil(abs_err))


# ---------------------------------------------------------------------------
# isqrt and the 2-D map
# ---------------------------------------------------------------------------


def derive_isqrt() -> dict:
    """Each chain: the int -> float32 conversion (relative U32, halved by
    the root) and the root's rounding, at the top of the int32 range."""
    r_cap = math.isqrt(M.INT32_MAX)
    top = math.sqrt(M.INT32_MAX)
    errs = {where: top * (U32 / 2 + ulps * ULP_REL)
            for where, ulps in SQRT_ULP.items()}
    return {"r_cap": r_cap, "abs_err": errs,
            "probes_required": max(_floor_steps(e) for e in errs.values()),
            "envelope": M.INT32_MAX}


def _tensor_isqrt_boundaries(d: dict, device) -> CheckResult:
    rs = np.arange(1, d["r_cap"] + 1, dtype=np.int64)
    xs = np.concatenate([rs * rs - 1, rs * rs, rs * rs + 1,
                         [0, 1, 2, d["envelope"]]])
    xs = np.unique(xs[(xs >= 0) & (xs <= d["envelope"])])
    got = M._isqrt_tensor(torch.as_tensor(xs.astype(np.int32),
                                          device=device)).cpu().numpy()
    want = np.asarray([math.isqrt(int(x)) for x in xs])
    bad = int((got != want).sum())
    return _res("isqrt.boundaries", bad == 0,
                f"{len(xs)} floor seams r^2 - 1, r^2, r^2 + 1 over [0, "
                f"{d['envelope']}] on {torch.device(device).type}, {bad} "
                "mismatches")


def certify_isqrt(device="cpu"):
    d = derive_isqrt()
    dev = device_constants()
    worst = max(d["abs_err"].values())
    out = [
        _res("isqrt.float_error", worst < 1.0,
             "derived |err| at sqrt(INT32_MAX): " + ", ".join(
                 f"{w} {e:.3e}" for w, e in d["abs_err"].items())
             + " (< 1: the floor lands within one of floor(sqrt))"),
        _res("isqrt.probes", M.ISQRT_PROBES >= d["probes_required"],
             f"declared ISQRT_PROBES={M.ISQRT_PROBES}, derived requirement "
             f"{d['probes_required']}"),
        _res("isqrt.device_probes",
             dev["sqrtf"] and min(dev["ISQRT_PROBES_UP"],
                                  dev["ISQRT_PROBES_DOWN"])
             >= d["probes_required"],
             f"packing.cuh isqrt_i32: sqrtf candidate {dev['sqrtf']}, "
             f"{dev['ISQRT_PROBES_UP']} probe up / "
             f"{dev['ISQRT_PROBES_DOWN']} down, derived requirement "
             f"{d['probes_required']}"),
        _res("isqrt.probe_clamp",
             M.ISQRT_MAX_R == d["r_cap"] == dev.get("ISQRT_MAX_R")
             and M.ISQRT_MAX_R ** 2 <= M.INT32_MAX
             < (M.ISQRT_MAX_R + 1) ** 2,
             f"declared clamp {M.ISQRT_MAX_R} (device "
             f"{dev.get('ISQRT_MAX_R')}), derived isqrt(INT32_MAX) = "
             f"{d['r_cap']} (squares above it wrap int32)"),
        _res("isqrt.envelope", M.ISQRT_TRACED_MAX_X == d["envelope"],
             f"declared {M.ISQRT_TRACED_MAX_X}, derived {d['envelope']}"),
        _tensor_isqrt_boundaries(d, device),
    ]
    return out


def derive_ltm() -> dict:
    """8 lam + 1 in int32 binds the envelope; tri(i)'s i (i + 1) of the
    row's j must fit as well."""
    max_lam = (M.INT32_MAX - 1) // 8
    max_i = (math.isqrt(8 * max_lam + 1) - 1) // 2
    return {"max_lam": max_lam, "max_i": max_i,
            "tri_fits": max_i * (max_i + 1) <= M.INT32_MAX}


def _tri_seams(max_i: int, max_lam: int) -> np.ndarray:
    i = np.arange(1, max_i + 1, dtype=np.int64)
    t = i * (i + 1) // 2
    lams = np.unique(np.concatenate([t - 1, t, [0, max_lam]]))
    return lams[lams <= max_lam]


def certify_ltm(device="cpu"):
    d = derive_ltm()
    out = [
        _res("ltm.envelope",
             M.LTM_TRACED_MAX_LAM == d["max_lam"] and d["tri_fits"],
             f"declared {M.LTM_TRACED_MAX_LAM}, derived {d['max_lam']} "
             f"(8 lam + 1 in int32; i (i + 1) fits: {d['tri_fits']})"),
        _res("ltm.max_row", M.LTM_TRACED_MAX_I == d["max_i"],
             f"declared {M.LTM_TRACED_MAX_I}, derived {d['max_i']}"),
    ]
    lams = _tri_seams(d["max_i"], d["max_lam"])
    gi, gj = M.ltm_map(torch.as_tensor(lams.astype(np.int32),
                                       device=device))
    wi = np.asarray([(math.isqrt(8 * int(l) + 1) - 1) // 2 for l in lams])
    wj = lams - wi * (wi + 1) // 2
    bad = int(((gi.cpu().numpy() != wi) | (gj.cpu().numpy() != wj)).sum())
    out.append(_res(
        "ltm.boundaries", bad == 0,
        f"{len(lams)} row seams tri(i) - 1, tri(i) up to lam="
        f"{d['max_lam']} on {torch.device(device).type}, {bad} mismatches"))
    return out


# ---------------------------------------------------------------------------
# the 3-D row finder
# ---------------------------------------------------------------------------


def derive_tet() -> dict:
    """The clamp from tet(i)'s int32 intermediate, then the candidate's
    error at the top plane. The real cube root of 6 lam, for lam in
    [tet(i), tet(i + 1)), lies in (i, i + 2) (i^3 < i (i+1) (i+2) and
    (i+1) (i+2) (i+3) < (i+2)^3), so its floor is i or i + 1; a float
    error below one moves the floor at most one step further each way."""
    i = 1
    while (i + 1) * (i + 2) // 2 * (i + 3) <= M.INT32_MAX:
        i += 1
    max_i = i  # largest i with tri(i) (i + 2) <= INT32_MAX
    max_lam = max_i * (max_i + 1) * (max_i + 2) // 6 - 1
    x = 6.0 * max_lam
    y = x ** (1.0 / 3.0)
    # 6.0 * float(lam): two roundings of the argument, a third of which
    # reaches the cube root
    arg = y * (2 * U32) / 3
    # torch.pow's exponent: fl32(1/3), against 1/3
    e32 = float(np.float32(1.0 / 3.0))
    expo = y * abs(math.expm1((e32 - 1.0 / 3.0) * math.log(x)))
    errs = {where: arg + expo + ulps * ULP_REL * y
            for where, ulps in POW_ULP.items()}
    errs.update({where: arg + ulps * ULP_REL * y
                 for where, ulps in CBRT_ULP.items()})
    steps = max(_floor_steps(e) for e in errs.values())
    return {"max_i": max_i, "exact_planes": max_i - 1, "max_lam": max_lam,
            "abs_err": errs, "exponent_err": expo,
            "probes_up_required": steps,       # candidate as low as i - 1
            "probes_down_required": 1 + steps}  # as high as i + 1 + 1


def certify_tet(device="cpu"):
    d = derive_tet()
    dev = device_constants()
    worst = max(d["abs_err"].values())
    out = [
        _res("tet.float_error", worst < 1.0,
             f"derived |err| of the plane candidate at i={d['max_i']}: "
             + ", ".join(f"{w} {e:.3e}" for w, e in d["abs_err"].items())
             + f" (torch.pow's float32 exponent alone "
             f"{d['exponent_err']:.3e}; < 1 adds at most one floor step)"),
        _res("tet.probes_up", M.TET_PROBES_UP >= d["probes_up_required"],
             f"declared TET_PROBES_UP={M.TET_PROBES_UP}, derived "
             f"requirement {d['probes_up_required']}"),
        _res("tet.probes_down",
             M.TET_PROBES_DOWN >= d["probes_down_required"],
             f"declared TET_PROBES_DOWN={M.TET_PROBES_DOWN}, derived "
             f"requirement {d['probes_down_required']} (the real candidate "
             "reaches +1, float rounding one more)"),
        _res("tet.device_probes",
             dev["cbrtf"] and dev.get("TET_PROBES", 0)
             >= max(d["probes_up_required"], d["probes_down_required"]),
             f"packing.cuh tet_map: cbrtf candidate {dev['cbrtf']}, "
             f"TET_PROBES={dev.get('TET_PROBES')} each way, derived "
             f"requirement {d['probes_up_required']} up / "
             f"{d['probes_down_required']} down"),
        _res("tet.clamp",
             M.TET_TRACED_MAX_I == d["max_i"] == dev.get("TET_MAX_I"),
             f"declared clamp {M.TET_TRACED_MAX_I} (device "
             f"{dev.get('TET_MAX_I')}), derived largest i with "
             f"tri(i) (i + 2) <= INT32_MAX = {d['max_i']}"),
        _res("tet.envelope",
             M.TET_TRACED_EXACT_PLANES == d["exact_planes"]
             and M.TET_TRACED_MAX_LAM == d["max_lam"],
             f"declared planes <= {M.TET_TRACED_EXACT_PLANES} / lam <= "
             f"{M.TET_TRACED_MAX_LAM}, derived {d['exact_planes']} / "
             f"{d['max_lam']}"),
    ]
    tets = np.asarray([M.tet(i) for i in range(1, d["exact_planes"] + 1)],
                      np.int64)
    lams = np.unique(np.concatenate([tets - 1, tets, [0, d["max_lam"]]]))
    got = M.tet_map(torch.as_tensor(lams.astype(np.int32), device=device))
    got = np.stack([g.cpu().numpy() for g in got], axis=1)
    want = np.asarray([M.tet_map(int(l)) for l in lams])
    bad = int((got != want).any(axis=1).sum())
    out.append(_res(
        "tet.boundaries", bad == 0,
        f"{len(lams)} plane seams tet(i) - 1, tet(i) up to lam="
        f"{d['max_lam']} on {torch.device(device).type}, {bad} mismatches"))
    # one past the envelope the tensor map must leave the host map (the
    # final clamp pins it to the last exact plane), or the envelope would
    # be needlessly small
    past = d["max_lam"] + 1
    tensor_past = tuple(int(v) for v in M.tet_map(
        torch.tensor([past], dtype=torch.int32, device=device)))
    out.append(_res(
        "tet.envelope_tight", tensor_past != M.tet_map(past),
        f"lam={past}: tensor {tensor_past} vs host {M.tet_map(past)} "
        f"(clamped to plane {M.TET_TRACED_EXACT_PLANES} as declared)"))
    return out


# ---------------------------------------------------------------------------
# the device maps (the card only)
# ---------------------------------------------------------------------------


def certify_device_maps(device):
    """csrc/packing.cuh's member_map_params through member_map_device at
    every tri(i) seam of an ltm, a band and a prefix member up to
    LTM_TRACED_MAX_LAM, against the host closed forms."""
    from repro_torch.kernels.tri_attn import kernel as K

    n = M.LTM_TRACED_MAX_I + 1
    seams = _tri_seams(M.LTM_TRACED_MAX_I, M.LTM_TRACED_MAX_LAM)
    members = (("ltm", n, n, 0, M.tri(n), lambda l: M.ltm_map(l)),
               ("band", n, n // 2, 0, M.band_blocks(n, n // 2),
                lambda l: M.band_map(l, n // 2)),
               ("prefix", n, n, 1000, M.prefix_full_blocks(n, 1000),
                lambda l: M.prefix_full_map(l, n, 1000)))
    out = []
    for name, mn, w, p, blocks, host in members:
        lams = seams[seams < blocks]
        local = torch.as_tensor(lams.astype(np.int32), device=device)
        gi, gj = K.member_map_device(local, mn, w, p)
        got = np.stack([gi.cpu().numpy(), gj.cpu().numpy()], axis=1)
        want = np.asarray([host(int(l)) for l in lams])
        bad = int((got != want).any(axis=1).sum())
        out.append(_res(
            f"device.member_map.{name}", bad == 0,
            f"member_map_device (n={mn}, w={w}, p={p}) at {len(lams)} "
            f"seams tri(i) - 1, tri(i) up to {M.LTM_TRACED_MAX_LAM}, {bad} "
            "mismatches"))
    return out


def run(device="cpu"):
    """Every envelope certification -> list[CheckResult]."""
    out = certify_isqrt(device) + certify_ltm(device) + certify_tet(device)
    if torch.device(device).type == "cuda":
        out += certify_device_maps(device)
    return out
