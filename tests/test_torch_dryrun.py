"""The port's dry-run (launch/dryrun.py) and the registry's input specs.

* One cell in a subprocess, as tests/test_system.py holds the
  reference's: granite-moe-3b-a800m x decode_32k on the 256-chip mesh,
  its record's keys, ok, a dominant term, the per-device state under the
  rules, and what a pod mesh does not reckon.
* A card train cell cut to what the card runs: ok, the peak split
  summing to the peak, the state's bytes in it, the kernel regions
  counted; a skipped cell for the reference's reason; the tri_3body
  kernel cell.
* The registry's spec functions (batch, cache, decode, params and
  input_specs) against the reference's ``input_specs`` for every arch x
  shape: the same shapes and dtypes leaf for leaf.
* The MoE layer on meta counts every expert at the reference's capacity
  C; cpu tensors keep the routed path.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro_torch.configs import registry as REG
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DRY
from repro_torch.models import moe as MOE
from repro_torch.roofline import dispatch_count as DC

ROOT = Path(__file__).resolve().parents[1]
# the reference's run_cell record keys (src/repro/launch/dryrun.py)
REF_KEYS = {"arch", "shape", "mesh", "supported", "skip_reason", "opts",
            "tag", "n_chips", "mesh_shape", "lower_s", "compile_s",
            "analysis", "roofline", "ok"}
ANALYSIS_KEYS = {"flops", "hbm_bytes", "hbm_bytes_kernel_adj",
                 "collective_bytes", "collective_bytes_total",
                 "collective_counts", "unknown_trip_loops", "memory"}


def test_dryrun_single_cell_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-moe-3b-a800m", "--shape", "decode_32k", "--mesh",
         "single", "--out", str(tmp_path), "--force"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT), env=env)
    assert run.returncode == 0 and " ok " in run.stdout, \
        run.stdout + run.stderr[-2000:]
    rec = json.loads((tmp_path / "granite-moe-3b-a800m__decode_32k__single"
                      ".json").read_text())
    assert REF_KEYS <= set(rec) and ANALYSIS_KEYS <= set(rec["analysis"])
    assert rec["ok"] and rec["n_chips"] == 256
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["roofline"]["dominant"] in ("compute", "memory")
    assert rec["collective"].startswith("not reckoned")
    mem = rec["analysis"]["memory"]
    assert mem["activations"].startswith("not reckoned")
    state = mem["state_bytes_per_device"]
    assert 0 < state["params"] < 16e9 and 0 < state["cache"]
    assert state["total"] == state["params"] + state["cache"]
    # the engine's packed decode round, one launch a layer
    regions = rec["analysis"]["regions"]
    cfg = REG.get_config("granite-moe-3b-a800m")
    assert regions["tri_attn.packed_decode_fwd"]["count"] == cfg.n_layers


def test_card_train_cell_cut(tmp_path):
    rec = DRY.run_cell("yi-9b", "train_4k", "card", str(tmp_path),
                       force=True, n_layers=2, batch=1)
    assert rec["ok"], rec.get("traceback")
    assert REF_KEYS <= set(rec) and rec["n_chips"] == 1
    assert (rec["n_layers"], rec["global_batch"], rec["microbatches"]) == \
        (2, 1, 1)
    mem = rec["analysis"]["memory"]
    split = mem["peak_split"]
    assert sum(split.values()) == mem["peak_bytes_per_device"]
    cfg = dataclasses.replace(REG.get_config("yi-9b"), n_layers=2)
    n = cfg.param_counts()["total"]
    assert split["params"] == pytest.approx(2 * n, rel=0.01)  # bf16
    assert split["optimizer"] == pytest.approx(8 * n, rel=0.01)  # AdamW
    # a 2-layer step peaks at its f32 logits, before the grads exist
    assert 0 <= split["grads"] <= split["params"]
    assert split["activations"] > 0
    assert rec["fits"] == (mem["peak_bytes_per_device"] <= 80e9)
    assert {k: v["count"] for k, v in rec["analysis"]["regions"].items()} \
        == {"tri_attn.fwd": 4, "tri_attn.bwd_dq": 2, "tri_attn.bwd_dkv": 2}
    rf = rec["roofline"]
    assert rf["model_flops"] == 6 * cfg.param_counts()["active"] * 4096
    assert 0 < rf["mfu_at_bound"] < 1
    assert json.loads((tmp_path / "yi-9b__train_4k__card.json").read_text()
                      )["ok"]


def test_skipped_cell_keeps_the_references_reason(tmp_path):
    rec = DRY.run_cell("yi-9b", "long_500k", "card", str(tmp_path),
                       force=True)
    assert rec["supported"] is False and "ok" not in rec
    ok, why = JREG.supported(JREG.get_config("yi-9b"),
                             JREG.get_shape("long_500k"))
    assert not ok and why.split(":")[0] == rec["skip_reason"].split(":")[0] \
        == "pure full-attention arch"


def test_microbatches_and_knobs():
    assert DRY.TRAIN_KNOBS == {
        "mixtral-8x7b": ("adamw", 4), "granite-moe-3b-a800m": ("adamw", 8),
        "rwkv6-1.6b": ("adamw", 1), "yi-9b": ("adamw", 4),
        "nemotron-4-340b": ("adafactor", 8), "llama3-405b": ("adafactor", 8),
        "granite-34b": ("adamw", 4), "musicgen-large": ("adamw", 1),
        "internvl2-1b": ("adamw", 1),
        "jamba-1.5-large-398b": ("adafactor", 8)}
    shape = REG.get_shape("train_4k")
    assert DRY.microbatches_for("yi-9b", shape) == 4
    assert DRY.microbatches_for(
        "yi-9b", dataclasses.replace(shape, global_batch=1)) == 1
    assert DRY.microbatches_for("yi-9b", shape, ("mb=2",)) == 2
    card = DRY.make_mesh("card")
    moe = REG.get_config("granite-moe-3b-a800m")
    assert DRY._opt_hints(card, moe, ("moe_local",)) == {"moe_groups": 1}
    assert DRY._opt_hints(DRY.make_mesh("multi"), moe, ("moe_local",)) == \
        {"moe_groups": 32}


def test_tri_3body_cell(tmp_path):
    rec = DRY.run_tri_3body_cell(str(tmp_path), force=True)
    assert rec["ok"], rec.get("traceback")
    n = 256 // 8
    assert (rec["tiles_tet"], rec["tiles_bb3"]) == \
        (n * (n + 1) * (n + 2) // 6, n ** 3)
    assert rec["flops_ratio_bb3_over_tet"] == pytest.approx(
        rec["launch_reduction"])
    assert rec["tet"]["flops"] == rec["bb3"]["flops"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _same(got_tree, want_tree, label):
    want = {p: (tuple(x.shape), str(jnp.dtype(x.dtype)))
            for p, x in _flat_jax(want_tree)}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in _leaves(got_tree)}
    assert got == want, label
    assert all(x.is_meta for _, x in _leaves(got_tree))


@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_input_specs_match_the_references(arch):
    cfg, jcfg = REG.get_config(arch), JREG.get_config(arch)
    _same(REG.params_specs(cfg), JREG.params_specs(jcfg), (arch, "params"))
    for name in REG.SHAPES:
        shape, jshape = REG.get_shape(name), JREG.get_shape(name)
        if shape.is_decode:
            _same(REG.cache_specs(cfg, shape), JREG.cache_specs(jcfg, jshape),
                  (arch, name, "cache"))
            _same(REG.decode_specs(cfg, shape),
                  JREG.decode_specs(jcfg, jshape), (arch, name, "decode"))
        else:
            _same(REG.batch_specs(cfg, shape), JREG.batch_specs(jcfg, jshape),
                  (arch, name, "batch"))
    # input_specs assembles them as the reference's does
    got = REG.input_specs(arch, "decode_32k")
    assert set(got) == set(JREG.input_specs(arch, "decode_32k")) == \
        {"params", "cache", "tokens", "pos"}
    assert set(REG.input_specs(arch, "train_4k")) == {"params", "batch"}


def _flat_jax(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(str(getattr(p, "key", p)) for p in path), leaf)
            for path, leaf in flat]


def test_moe_meta_counts_each_expert_at_capacity():
    cfg = REG.smoke_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(cfg, capacity_factor=1.25)
    params = REG.params_specs(cfg)["layers"]["l0"]["ffn"]
    ffn = {k: v[0] for k, v in params.items()}
    b, s = 2, 64
    x = torch.empty((b, s, cfg.d_model), dtype=ffn["wi"].dtype,
                    device="meta")
    e, k, d, f = cfg.n_experts, cfg.experts_per_token, cfg.d_model, cfg.d_ff
    for full in (False, True):
        groups, cap = MOE.capacity(b * s, cfg, full_capacity=full)
        want_cap = b * s if full else int(k * b * s / e * 1.25)
        assert (groups, cap) == (1, want_cap)
        an = DC.analyze(lambda x: MOE.moe_mlp(ffn, x, cfg,
                                              full_capacity=full), x)
        router = 2 * b * s * d * e
        per_row = 2 * d * f * (3 if cfg.mlp_activation == "swiglu" else 2)
        assert an["matmul_flops"] == router + e * groups * cap * per_row


def test_moe_cpu_path_routes_as_before():
    """cpu tensors keep the routed per-expert path: the output equals a
    dense per-token reference of the same routing."""
    cfg = REG.smoke_config("mixtral-8x7b")
    rng = np.random.default_rng(3)
    from repro_torch.models import model as MD

    params = MD.init_params(cfg, seed=1, device="cpu")
    ffn = {k: v[0] for k, v in params["layers"]["l0"]["ffn"].items()}
    x = torch.as_tensor(rng.standard_normal((2, 8, cfg.d_model)),
                        dtype=torch.float32).to(params["embed"].dtype)
    out, _ = MOE.moe_mlp(ffn, x, cfg)
    xf = x.reshape(-1, cfg.d_model)
    w, top, keep, _ = MOE.route(ffn, xf, cfg)
    want = torch.zeros_like(xf, dtype=torch.float32)
    for t in range(xf.shape[0]):
        for j in range(cfg.experts_per_token):
            if keep[t, j]:
                h = MOE._expert_ffn(xf[t:t + 1], ffn["wi"][top[t, j]],
                                    ffn["wg"][top[t, j]], True)
                want[t] += (h @ ffn["wo"][top[t, j]]).float()[0] * w[t, j]
    torch.testing.assert_close(out.reshape(-1, cfg.d_model).float(),
                               want.to(x.dtype).float(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("arch,layers", [("rwkv6-1.6b", 2),
                                         ("jamba-1.5-large-398b", 8)])
def test_recurrent_train_cells(tmp_path, arch, layers):
    """rwkv6 and jamba train through their chunked scans (the scan kernels
    have no backward), which the record names: the cell counts, no scan
    region is launched, and the attention layers keep their kernels."""
    rec = DRY.run_cell(arch, "train_4k", "card", str(tmp_path), force=True,
                       n_layers=layers, batch=1)
    assert rec["ok"], rec.get("traceback")
    assert rec["scan_impl"] == "torch" and "no backward" in rec["scan_note"]
    regions = rec["analysis"]["regions"]
    assert not any(n.startswith(("wkv_scan", "ssm_scan")) for n in regions)
    attn = sum(k == "attn" for k in REG.get_config(arch).layer_kinds[
        :layers])
    assert regions.get("tri_attn.fwd", {}).get("count", 0) == 2 * attn


@pytest.mark.parametrize("arch,layers", [("rwkv6-1.6b", 2),
                                         ("jamba-1.5-large-398b", 8)])
def test_recurrent_train_on_the_scan_kernels_is_refused(arch, layers):
    """Without ``scan_impl="torch"`` a train step of rwkv6 or jamba sends
    its scans to the kernels, which refuse a gradient (they have no
    backward) on meta as on the card: no silent switch to the plain
    scan."""
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    cfg, shape = DRY.cell_config(arch, "train_4k", n_layers=layers, batch=1)
    params = REG.params_specs(cfg)
    opt = OPT.OptConfig(kind=DRY.TRAIN_KNOBS[arch][0])
    state = TS.TrainState(params=params,
                          opt_state=OPT.init_opt_state(params, opt), step=0)
    step = TS.make_train_step(cfg, opt, attn_impl="cuda", remat=False,
                              block=DRY.ATTN_BLOCK)
    with pytest.raises(Exception, match="backward|gradient"):
        step(state, REG.batch_specs(cfg, shape))
