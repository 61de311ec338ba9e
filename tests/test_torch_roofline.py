"""The port's roofline (src/repro_torch/roofline/, launch/compat.py) against
the reference's (src/repro/roofline/) on the CPU.

* The terms and model_flops on the H100's peaks, as tests/test_roofline.py
  holds the reference's on its own; model_flops equal to the reference's
  for every arch and shape.
* The dispatch count on meta: a plain matmul's flops exact, bytes by
  dtype and tuple outputs, views free; fwd against fwd_bb: launched flops
  at n^2 / tri(n) (the paper's I), the function's flops equal.
* The count against ``repro.roofline.hlo_parse.analyze_compiled`` of the
  reference's jitted steps on the smoke configs: the flops of the
  matmuls and the attention interiors within 2% on the prefill forward
  and 10% on the remat train step (exact here); the scan regions by their
  work functions against PERF.md section 6's bounds instead.
* Every bound PERF.md section 6 prints, to its printed digits.
* The compat table: every __global__ of csrc/ in exactly one entry, every
  wrapper of WRAPPERS named; each wrapper's meta branch returns the
  plain version's shapes and dtypes and leaves .launches at 0.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_wrapper_cases as WC
from repro.configs import registry as JREG
from repro.roofline import hlo_parse as HLO
from repro.roofline import model as JRF
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch.configs import registry as REG
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import mapping as M
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.launch import compat
from repro_torch.models import model as MD
from repro_torch.roofline import dispatch_count as DC
from repro_torch.roofline import model as RF
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# terms and model_flops
# ---------------------------------------------------------------------------


def test_roofline_terms_and_dominance():
    peak = RF.PEAK_FLOPS[torch.bfloat16]
    an = {"flops": peak, "hbm_bytes": RF.HBM_BYTES_PER_S / 2,
          "collective_bytes_total": RF.NVLINK_BYTES_PER_S / 4}
    t = RF.terms_from_analysis(an, n_chips=4, model_flops=4 * peak / 2)
    assert t.dominant == "compute"
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 0.5) < 1e-9
    assert abs(t.collective_s - 0.25) < 1e-9
    assert abs(t.useful_flops_ratio - 0.5) < 1e-9
    assert abs(t.mfu_at_bound - 0.5) < 1e-9
    # the port charges each kernel at its own inputs and outputs: the two
    # memory terms are one
    assert t.memory_kernel_adj_s == t.memory_s
    assert t.dominant_kernel_adj == t.dominant
    assert set(t.as_dict()) == set(JRF.RooflineTerms(0, 0, 0).as_dict())


def test_card_peaks():
    assert RF.PEAK_FLOPS == {torch.bfloat16: 989e12, torch.float32: 67e12}
    assert (RF.HBM_BYTES_PER_S, RF.NVLINK_BYTES_PER_S) == (3.35e12, 450e9)


def test_model_flops_train_vs_decode():
    cfg = REG.get_config("yi-9b")
    train = RF.model_flops(cfg, REG.get_shape("train_4k"))
    dec = RF.model_flops(cfg, REG.get_shape("decode_32k"))
    assert train / dec == pytest.approx((6 * 256 * 4096) / (2 * 128),
                                        rel=1e-6)


@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_model_flops_equal_the_references(arch):
    for shape in REG.SHAPES:
        assert RF.model_flops(REG.get_config(arch), REG.get_shape(shape)) \
            == JRF.model_flops(JREG.get_config(arch), JREG.get_shape(shape))


def test_mfu():
    # the issue's reckoning: yi-9b cut to 24 layers, 4096 tokens in 0.738 s
    cfg = REG.get_config("yi-9b")
    import dataclasses
    cut = dataclasses.replace(cfg, n_layers=24)
    mf = RF.model_flops(cut, ShapeConfig("t", 4096, 1, "train"))
    assert RF.mfu(mf, 0.7380) == pytest.approx(0.157, abs=5e-4)


# ---------------------------------------------------------------------------
# the dispatch count
# ---------------------------------------------------------------------------


def test_plain_matmul_flops_exact():
    an = DC.analyze(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32))
    assert an["flops"] == an["launched_flops"] == 2 * 64 * 128 * 32
    assert an["hbm_bytes"] == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert an["unknown_trip_loops"] == 0
    assert an["collective_bytes_total"] == 0


def test_batched_and_linear_matmul_flops():
    x, w = _meta(3, 5, 16), _meta(16, 8)
    an = DC.analyze(lambda x, w: torch.nn.functional.linear(x, w.t()), x, w)
    assert an["matmul_flops"] == 2 * 15 * 16 * 8
    an = DC.analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                    _meta(4, 6, 7), _meta(4, 7, 9))
    assert an["matmul_flops"] == 2 * 4 * 6 * 7 * 9


@pytest.mark.parametrize("dtype,size", [(torch.float32, 4),
                                        (torch.bfloat16, 2),
                                        (torch.int64, 8), (torch.bool, 1)])
def test_bytes_by_dtype(dtype, size):
    an = DC.analyze(lambda x: x.clone(), _meta(10, 12, dtype=dtype))
    assert an["hbm_bytes"] == 2 * 120 * size


def test_tuple_output_bytes():
    # max over a dim: one f32 input, an f32 and an int64 output
    an = DC.analyze(lambda x: torch.max(x, dim=1), _meta(6, 10))
    assert an["hbm_bytes"] == 4 * 60 + 4 * 6 + 8 * 6


def test_views_and_allocations_are_free():
    def views(x):
        return x.t(), x.view(-1), x[2:], x.transpose(0, 1), \
            x[:, None].expand(8, 3, 8), torch.empty_like(x)

    an = DC.analyze(views, _meta(8, 8))
    assert an["hbm_bytes"] == 0 and an["flops"] == 0


def test_expanded_input_read_once():
    an = DC.analyze(lambda a, b: a + b, _meta(1, 64).expand(32, 64),
                    _meta(32, 64))
    assert an["hbm_bytes"] == 4 * (64 + 2 * 32 * 64)


def test_memory_peak_and_split():
    w = _meta(256, 256, dtype=torch.bfloat16)

    def step(x):
        h = torch.relu(x @ w)  # 64 x 256 bf16 each
        return (h @ w).sum()

    an = DC.analyze(step, _meta(64, 256, dtype=torch.bfloat16),
                    categories={"params": w})
    mem = an["memory"]
    # params, x and two live (64, 256) products, then the bf16 sum beside
    # the second product
    assert mem["peak_bytes_per_device"] == 2 * (256 * 256 + 3 * 64 * 256) \
        + 2
    assert sum(mem["peak_split"].values()) == mem["peak_bytes_per_device"]
    assert mem["peak_split"]["params"] == 2 * 256 * 256


def test_train_step_split_sums_and_holds_the_state():
    cfg = REG.smoke_config("yi-9b")
    opt = OPT.OptConfig()
    state = TS.init_state(cfg, opt, device="meta")
    batch = REG.batch_specs(cfg, ShapeConfig("t", 128, 2, "train"))
    an = DC.analyze(TS.make_train_step(cfg, opt, attn_impl="cuda"), state,
                    batch, categories={"params": state.params,
                                       "optimizer": state.opt_state})
    mem = an["memory"]
    split = mem["peak_split"]
    leaves = jax.tree_util.tree_leaves(state.params)
    n_bytes = sum(t.numel() * t.element_size() for t in leaves)
    assert sum(split.values()) == mem["peak_bytes_per_device"]
    assert split["params"] == n_bytes
    # two f32 moments
    assert split["optimizer"] == 8 * sum(t.numel() for t in leaves)
    assert 0 < split["grads"] <= n_bytes
    # two layers: the forward twice (remat), dq and dk/dv once each
    assert {n: r["count"] for n, r in an["regions"].items()} == \
        {"tri_attn.fwd": 4, "tri_attn.bwd_dq": 2, "tri_attn.bwd_dkv": 2}


@pytest.mark.parametrize("n,blk", [(8, 16), (16, 64), (64, 64)])
def test_fwd_bb_launches_n2_over_tri_n_of_fwd(n, blk):
    """The paper's I_flops: the BB grid launches n^2 tiles, the LTM grid
    tri(n); both compute the same function."""
    sched = OPS.make_sched(n * blk, block=blk)
    q = _meta(2, 4, n * blk, 64, dtype=torch.bfloat16)
    k = _meta(2, 2, n * blk, 64, dtype=torch.bfloat16)
    from repro_torch.kernels.tri_attn import kernel as K

    fwd = DC.analyze(lambda q, k: K.fwd(q, k, k, sched), q, k)
    bb = DC.analyze(lambda q, k: K.fwd_bb(q, k, k, sched), q, k)
    assert bb["launched_flops"] / fwd["launched_flops"] == \
        pytest.approx(n * n / M.tri(n), rel=1e-12)
    assert bb["flops"] == fwd["flops"] == \
        4 * 64 * 2 * 4 * (n * blk) * (n * blk + 1) // 2
    assert fwd["launched_flops"] == 4 * 64 * 2 * 4 * M.tri(n) * blk * blk


# ---------------------------------------------------------------------------
# the count against the reference's HLO walk
# ---------------------------------------------------------------------------

B, S, BLK = 2, 256, 64


def _ref_flops(arch, kind):
    jcfg = JREG.smoke_config(arch)
    jshape = type(JREG.get_shape("train_4k"))("t", S, B, kind)
    params = JREG.params_specs(jcfg)
    batch = JREG.batch_specs(jcfg, jshape)
    if kind == "prefill":
        fn = JTS.make_prefill_step(jcfg, attn_impl="scan", block=BLK)
        comp = jax.jit(fn).lower(params, batch).compile()
    else:
        opt = JOPT.OptConfig()
        ost = jax.eval_shape(lambda p: JOPT.init_opt_state(opt, p), params)
        state = JTS.TrainState(params=params, opt_state=ost,
                               step=jax.ShapeDtypeStruct((), jnp.int32),
                               err_state=None)
        fn = JTS.make_train_step(jcfg, opt, attn_impl="scan", remat=True,
                                 block=BLK)
        comp = jax.jit(fn).lower(state, batch).compile()
    return HLO.analyze_compiled(comp)["flops"]


def _port_count(arch, kind):
    cfg = REG.smoke_config(arch)
    params = REG.params_specs(cfg)
    batch = REG.batch_specs(cfg, ShapeConfig("t", S, B, kind))
    if kind == "prefill":
        # the reference's prefill forward routes MoE at its capacity (the
        # port's prefill step runs drop-free: ROADMAP C)
        def fn(params, batch):
            h, _, _ = MD.forward(params, cfg, batch, attn_impl="cuda",
                                 collect_state=True, block=BLK)
            return MD.logits_from_hidden(params, cfg, h[:, -1:])

        return DC.analyze(fn, params, batch)
    opt = OPT.OptConfig()
    state = TS.TrainState(params, OPT.init_opt_state(params, opt), 0)
    return DC.analyze(TS.make_train_step(cfg, opt, attn_impl="cuda",
                                         remat=True, block=BLK), state, batch)


@pytest.mark.parametrize("arch,kind,rtol", [
    ("yi-9b", "prefill", 0.02), ("yi-9b", "train", 0.10),
    ("granite-moe-3b-a800m", "prefill", 0.02),
    ("granite-moe-3b-a800m", "train", 0.10)])
def test_count_matches_hlo_parse(arch, kind, rtol):
    want = _ref_flops(arch, kind)
    an = _port_count(arch, kind)
    got = an["launched_flops"]
    terms = {"matmuls": an["matmul_flops"],
             **{n: r["launched_flops"] for n, r in an["regions"].items()}}
    print(f"{arch} {kind}: hlo_parse {want:.6g}, the count {got:.6g} "
          f"({terms})")
    assert got == pytest.approx(want, rel=rtol), terms


def test_scan_regions_by_their_work_against_perf():
    """rows 16-17 at their chip shapes: the reference's HLO counts its
    scan fallbacks, not the kernels' work, so the work functions are held
    to PERF.md's bounds."""
    ssm = compat.work("ssm_scan.selective_scan", 4, 2048, 16384, 16)
    assert round(ssm.bound_ms, 4) == 0.5135 and ssm.bound_by == "operations"
    assert round(RF.ssm_bound(4, 2048, 16384, 16, 1.98e9)["bytes"], 4) \
        == 0.4839
    wkv = compat.work("wkv_scan.wkv", 4, 2048, 32, 64)
    assert round(wkv.bound_ms, 4) == 0.1014 and wkv.bound_by == "bytes"
    for arch, name in (("rwkv6-1.6b", "wkv_scan.wkv"),
                       ("jamba-1.5-large-398b", "ssm_scan.selective_scan")):
        cfg = REG.smoke_config(arch)
        params = REG.params_specs(cfg)
        batch = REG.batch_specs(cfg, ShapeConfig("t", 64, 2, "prefill"))
        an = DC.analyze(TS.make_prefill_step(cfg, attn_impl="cuda",
                                             block=16), params, batch)
        layers = sum(k != "attn" for k in cfg.layer_kinds)
        assert an["regions"][name]["count"] == layers


# ---------------------------------------------------------------------------
# PERF.md section 6's bounds, to their printed digits
# ---------------------------------------------------------------------------


def test_perf_bounds_unchanged():
    q = _meta(1, 32, 4096, 128, dtype=torch.bfloat16)
    k = _meta(1, 4, 4096, 128, dtype=torch.bfloat16)
    b = RF.attn_bounds(q, k, 32 * 4096 * 4097 // 2)
    assert [round(b[op][0], 4) for op in ("fwd", "dq", "dkv")] == \
        [0.1390, 0.2085, 0.2780]
    q = _meta(1, 96, 2048, 192, dtype=torch.bfloat16)
    k = _meta(1, 8, 2048, 192, dtype=torch.bfloat16)
    b = RF.attn_bounds(q, k, 96 * 2048 * 2049 // 2)
    assert [round(b[op][0], 6) for op in ("fwd", "dq", "dkv")] == \
        [0.156415, 0.234622, 0.312830]
    f32 = torch.float32
    assert round(RF.bound(*RF.edm_work("ltm", 65536, 3, 64), f32)[0], 4) \
        == 2.5669
    assert round(RF.bound(*RF.edm_work("bb", 65536, 3, 64), f32)[0], 4) \
        == 5.1286
    assert round(RF.bound(*RF.dummy_work(M.tri(23169)), f32)[0], 4) == 0.3205
    for kind in ("tet", "bb3"):
        ms, by = RF.bound(*RF.three_body_work(kind, 16384, 3, 128), f32)
        assert (round(ms, 4), by) == (23.9711, "operations")
    assert round(RF.bound(*RF.dummy_work(M.tet(1624)), f32)[0], 4) == 0.8539


# ---------------------------------------------------------------------------
# the compat table and the meta branches
# ---------------------------------------------------------------------------


def test_every_global_has_exactly_one_entry():
    found = []
    for src in sorted(CSRC.glob("*.cu*")):
        found += re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
            src.read_text())
    assert len(found) == len(set(found))
    named = [k for r in compat.REGIONS for k in r.kernels]
    assert sorted(named) == sorted(found)
    for kernel in found:
        assert compat.region_of_kernel(
            f"void {kernel}<128, 64>(int, float*)") is not None


def test_every_wrapper_has_an_entry():
    assert set(WC.WRAPPERS) <= set(compat.BY_NAME)
    assert all(compat.BY_NAME[n].work is not None for n in WC.WRAPPERS)
    assert len({r.name for r in compat.REGIONS}) == len(compat.REGIONS)


@pytest.mark.parametrize("name,dtype", [
    (n, torch.float32) for n in WC.NAMES] + [
    (n, torch.bfloat16) for n in WC.NAMES if n.startswith("tri_attn.")])
def test_meta_branch_matches_the_plain_version(name, dtype):
    for f in WC.WRAPPERS.values():
        f.launches = 0
    want = WC.call(name, "cpu", dtype)
    an = DC.analyze(lambda: WC.call(name, "meta", dtype))
    got = WC.call(name, "meta", dtype)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.is_meta for t in got)
    assert all(f.launches == 0 for f in WC.WRAPPERS.values())
    assert {n: r["count"] for n, r in an["regions"].items()} == {name: 1}
