"""Dry-run: reckon every (arch x shape x mesh) cell without running it (port
of ``repro/launch/dryrun.py``).

Each cell's step is built through the port's own entry points
(``make_train_step``, ``make_prefill_step``, and the engine's packed
decode round ``serve.decode.decode_step_packed``, or ``make_serve_step``
for an arch with no attention layer) with ``attn_impl="cuda"``, on meta
tensors (``configs/registry.py``'s specs), and counted once by
``roofline/dispatch_count.analyze``: the kernel wrappers' meta branches
count each kernel region by its ``launch/compat.py`` entry. A train cell
of an arch with rwkv or mamba layers counts its scans as the plain chunked
scans (``scan_impl="torch"``; the record's ``scan_impl`` and ``scan_note``
say so): the scan kernels have no backward. For each cell:

* on the card's mesh (``--mesh card``, ("data",) of 1): the roofline terms
  on the H100's peaks (``roofline/model.py``), ``model_flops`` and the MFU
  at the bound, the peak bytes the card holds and its split, and whether
  it fits in the card's 80 GB;
* on the reference's pod meshes (``single`` (16, 16), ``multi`` (2, 16,
  16), ``both``): the per-device params, grads and optimizer state (and a
  decode cell's cache) under the port's sharding rules
  (``parallel/sharding.py``), and the compute and memory terms of the
  count split evenly over the chips (the least each chip could do). No
  activation peak and no collective term are invented there: the record
  says they are not reckoned.

A record keeps the reference's keys; ``lower_s`` is the seconds to build
the cell's specs and step, ``compile_s`` the seconds of its counted pass.
Records go one JSON a cell under ``artifacts/dryrun_torch/``
(``artifacts/dryrun/`` stays the reference's). ``--n-layers`` and
``--batch`` cut a cell to what ``chip_smoke.py`` runs on the card.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
      --shape train_4k --mesh card --n-layers 24 --batch 1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --kernel tri_3body
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from repro_torch.configs import registry as REG
from repro_torch.launch import mesh as MESH
from repro_torch.parallel import compression as C
from repro_torch.parallel import hints as HN
from repro_torch.parallel import sharding as SH
from repro_torch.roofline import dispatch_count as DC
from repro_torch.roofline import model as RF
from repro_torch.train import optimizer as OPT

# Per-arch training knobs of the reference (its activation-memory napkin
# math for a 256-chip mesh; Adafactor for the >= 300B archs: AdamW's
# moments alone would not fit).
TRAIN_KNOBS = {
    # arch: (optimizer, microbatches)
    "mixtral-8x7b": ("adamw", 4),
    "granite-moe-3b-a800m": ("adamw", 8),
    "rwkv6-1.6b": ("adamw", 1),
    "yi-9b": ("adamw", 4),
    "nemotron-4-340b": ("adafactor", 8),
    "llama3-405b": ("adafactor", 8),
    "granite-34b": ("adamw", 4),
    "musicgen-large": ("adamw", 1),
    "internvl2-1b": ("adamw", 1),
    "jamba-1.5-large-398b": ("adafactor", 8),
}

# the attention tile of the port's kernels (the reference's scan took 512)
ATTN_BLOCK = 64

# "opts" is a comma-set: attn_tp,moe_local,act_seq,mb=<n>
OPT_CHOICES = ("attn_tp", "moe_local", "act_seq")

def make_mesh(kind: str):
    if kind == "card":
        return MESH.make_card_mesh()
    return MESH.make_production_mesh(multi_pod=(kind == "multi"))


def auto_opts(cfg, mesh, shape) -> tuple:
    """The reference's per-(arch, shape) defaults on ``mesh``:

    * moe_local: grouped per-DP-shard dispatch, only when the expert count
      does NOT divide the DP axis, and only for token-heavy shapes;
    * attn_rep: replicated attention when heads don't divide the TP axis,
      training only.
    """
    model_size = mesh.shape.get("model", 1)
    dp_size = SH._axis_size(mesh, SH.dp_axes(mesh))
    opts = []
    if cfg.n_experts and cfg.n_experts % dp_size != 0 \
            and not shape.is_decode:
        opts.append("moe_local")
    if cfg.n_heads % model_size and "attn" in cfg.layer_kinds \
            and shape.kind == "train":
        opts.append("attn_rep")
    return tuple(opts)


def _opt_hints(mesh, cfg, opts) -> dict:
    """The one hint the port's models read (``parallel/hints.py``):
    ``moe_groups``, the dispatch groups of moe_local (the DP size). The
    reference's layout hints have nothing to place on one device."""
    if "moe_local" in opts and cfg.n_experts:
        return {"moe_groups": SH._axis_size(mesh, SH.dp_axes(mesh))}
    return {}


def cell_config(arch: str, shape_name: str, *, n_layers=None, batch=None):
    """(cfg, shape) of a cell, its depth cut to ``n_layers`` and its global
    batch to ``batch`` where given."""
    cfg = REG.get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    shape = REG.get_shape(shape_name)
    if batch is not None:
        shape = dataclasses.replace(shape, global_batch=batch)
    return cfg, shape


def microbatches_for(arch: str, shape, opts=()) -> int:
    """The reference's knob (or an ``mb=<n>`` opt), halved until it divides
    the cell's batch."""
    mb = TRAIN_KNOBS.get(arch, ("adamw", 1))[1]
    for o in opts:
        if o.startswith("mb="):
            mb = int(o[3:])
    while shape.global_batch % mb:
        mb //= 2
    return max(1, mb)


def build_cell(cfg, shape, *, opt=None, microbatches: int = 1,
               compression: bool = False):
    """(fn, args, state) of one cell on meta tensors: ``fn(*args)`` is the
    step the port runs (a train cell's optimizer ``opt``, AdamW unless
    given; with ``compression``, the int8 error-feedback grad all-reduce
    over one rank, and its float32 err_state), ``state`` the trees that
    exist before it, by their category of the memory split ("params",
    "optimizer", "err_state", "cache")."""
    import torch

    from repro_torch.serve import decode as DEC
    from repro_torch.train import train_step as TS

    params = REG.params_specs(cfg)
    if shape.is_decode:
        cache = REG.cache_specs(cfg, shape)
        dspec = REG.decode_specs(cfg, shape)
        b = shape.global_batch
        if "attn" in cfg.layer_pattern:
            s_cache = DEC._attn_cache_len(cfg, cache)
            pos = torch.empty((b,), dtype=torch.int32, device="meta")

            @torch.no_grad()
            def fn(params, cache, tokens, pos):
                # the engine's round: every slot live over its whole cache
                return DEC.decode_step_packed(
                    params, cfg, cache, tokens, pos, [s_cache] * b,
                    list(range(b)), block=ATTN_BLOCK, impl="cuda")

            args = (params, cache, dspec["tokens"], pos)
        else:
            fn = TS.make_serve_step(cfg, attn_impl="cuda")
            args = (params, cache, dspec["tokens"], dspec["pos"])
        return fn, args, {"params": params, "cache": cache}
    batch = REG.batch_specs(cfg, shape)
    if shape.kind == "prefill":
        fn = TS.make_prefill_step(cfg, attn_impl="cuda", block=ATTN_BLOCK)
        return fn, (params, batch), {"params": params}
    opt = opt or OPT.OptConfig()
    opt_state = OPT.init_opt_state(params, opt)
    err = C.init_error_state(params) if compression else None
    state = TS.TrainState(params=params, opt_state=opt_state, step=0,
                          err_state=err)
    fn = TS.make_train_step(
        cfg, opt, microbatches=microbatches, attn_impl="cuda", remat=True,
        block=ATTN_BLOCK, scan_impl=train_scan_impl(cfg),
        compressed_allreduce=C.make_compressed_allreduce()
        if compression else None)
    trees = {"params": params, "optimizer": opt_state}
    if compression:
        trees["err_state"] = err
    return fn, (state, batch), trees


def train_scan_impl(cfg):
    """The scan impl a train cell is counted with: "torch" (the plain
    chunked scans) for an arch with rwkv or mamba layers, whose scan
    kernels have no backward; None (the kernels, as attention) else."""
    if {"rwkv", "mamba"} & set(cfg.layer_pattern):
        return "torch"
    return None


def count_cell(cfg, shape, *, opt=None, microbatches: int = 1,
               hints=None, compression: bool = False) -> dict:
    """The counted pass of one cell: ``dispatch_count.analyze``'s record,
    with the state trees (for the sharding rules) and the seconds."""
    t0 = time.time()
    with HN.hints(**(hints or {})):
        fn, args, trees = build_cell(cfg, shape, opt=opt,
                                     microbatches=microbatches,
                                     compression=compression)
        t1 = time.time()
        an = DC.analyze(fn, *args, categories=trees)
    return {"analysis": an, "trees": trees,
            "lower_s": round(t1 - t0, 2), "compile_s": round(time.time() - t1,
                                                             2)}


def state_bytes_per_device(cfg, shape, trees, mesh, microbatches: int) -> dict:
    """Per-device bytes of the cell's state under the sharding rules: the
    params, the grads (the params' dtype, float32 when microbatches are
    accumulated), the optimizer state and a decode cell's cache."""
    params = trees["params"]
    pspecs = SH.param_specs_tree(mesh, params)
    out = {"params": SH.per_device_bytes(params, pspecs, mesh)}
    if shape.kind == "train":
        out["grads"] = SH.per_device_bytes(
            params, pspecs, mesh, dtype_bytes=4 if microbatches > 1 else None)
        ost = trees["optimizer"]
        out["optimizer"] = SH.per_device_bytes(
            ost, SH.param_specs_tree(mesh, ost), mesh)
    if "cache" in trees:
        cache = trees["cache"]
        out["cache"] = SH.per_device_bytes(
            cache, SH.cache_shardings(mesh, cache), mesh)
    out["total"] = sum(out.values())
    return out


_COUNTS: dict = {}


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             force: bool = False, opts=(), tag: str = "",
             n_layers=None, batch=None) -> dict:
    suffix = f"__{tag}" if tag else ""
    out_path = os.path.join(
        out_dir, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    cfg, shape = cell_config(arch, shape_name, n_layers=n_layers,
                             batch=batch)
    ok, why = REG.supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "supported": ok, "skip_reason": why, "opts": sorted(opts),
           "tag": tag, "n_layers": cfg.n_layers,
           "global_batch": shape.global_batch}
    if not ok:
        _dump(out_path, rec)
        return rec
    mesh = make_mesh(mesh_kind)
    if "auto" in opts:
        opts = tuple(o for o in opts if o != "auto") \
            + auto_opts(cfg, mesh, shape)
        rec["opts"] = sorted(set(opts))
    n_chips = mesh.size
    rec["n_chips"] = n_chips
    rec["mesh_shape"] = mesh.shape
    try:
        opt_kind = TRAIN_KNOBS[arch][0]
        mb = microbatches_for(arch, shape, opts) if shape.kind == "train" \
            else 1
        rec["optimizer"], rec["microbatches"] = opt_kind, mb
        if shape.kind == "train" and train_scan_impl(cfg):
            rec["scan_impl"] = train_scan_impl(cfg)
            rec["scan_note"] = ("the plain chunked scan, not a kernel: the "
                                "scan kernels have no backward")
        hints = _opt_hints(mesh, cfg, opts)
        key = (arch, shape_name, n_layers, batch, opt_kind, mb,
               tuple(sorted(hints.items())))
        if key not in _COUNTS:
            _COUNTS[key] = count_cell(
                cfg, shape, opt=OPT.OptConfig(kind=opt_kind), microbatches=mb,
                hints=hints)
        cnt = _COUNTS[key]
        rec["lower_s"], rec["compile_s"] = cnt["lower_s"], cnt["compile_s"]
        an = dict(cnt["analysis"])
        mem = an.pop("memory")
        mf = RF.model_flops(cfg, shape)
        if mesh_kind == "card":
            rec["analysis"] = dict(an, memory=mem)
            rec["fits"] = mem["peak_bytes_per_device"] <= RF.CARD_BYTES
            terms = RF.terms_from_analysis(an, n_chips=1, model_flops=mf)
        else:
            per_dev = dict(an, flops=an["flops"] / n_chips,
                           hbm_bytes=an["hbm_bytes"] / n_chips,
                           hbm_bytes_kernel_adj=an["hbm_bytes"] / n_chips)
            state = state_bytes_per_device(cfg, shape, cnt["trees"], mesh,
                                           mb)
            rec["analysis"] = dict(per_dev, memory={
                "state_bytes_per_device": state,
                "activations": "not reckoned on a pod mesh",
                "peak_bytes_per_device": None})
            rec["collective"] = "not reckoned on a pod mesh"
            rec["split"] = "the count split evenly over the mesh's chips"
            terms = RF.terms_from_analysis(per_dev, n_chips=n_chips,
                                           model_flops=mf)
        rec["roofline"] = terms.as_dict()
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _dump(out_path, rec)
    return rec


def _dump(path, rec):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def run_tri_3body_cell(out_dir: str, *, n_rows: int = 256, block: int = 8,
                       d: int = 8, strict: bool = False,
                       force: bool = False) -> dict:
    """Roofline cell of the tri_3body family: the tet launch and the BB-3D
    baseline counted on meta through their kernel wrappers, with each
    one's flops, bytes, intensity and least time on the card, so the
    launch reduction shows beside the model cells. The reference's
    default tile (8) is below the kernels' smallest (64): the count is
    the rules' at that tile, which no launch of the card takes."""
    import torch

    from repro_torch.core import mapping as M
    from repro_torch.kernels.tri_3body import ops as OPS3

    tag = f"n{n_rows}_b{block}_d{d}" + ("_strict" if strict else "")
    out_path = os.path.join(out_dir, f"kernel__tri_3body__{tag}.json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    n = n_rows // block
    rec = {"kernel": "tri_3body", "n_rows": n_rows, "block": block,
           "d": d, "strict": strict,
           "tiles_tet": M.tet(n), "tiles_bb3": n ** 3,
           "launch_reduction": (n ** 3) / M.tet(n)}
    x = torch.empty((n_rows, d), dtype=torch.float32, device="meta")
    try:
        for name, impl in (("tet", "cuda"), ("bb3", "bb3")):
            t0 = time.time()
            an = DC.analyze(lambda x: OPS3.three_body(
                x, block, impl=impl, strict=strict), x)
            region = an["regions"][f"tri_3body.{name}"]
            rec[name] = {
                "compile_s": round(time.time() - t0, 2),
                "flops": an["flops"],
                "launched_flops": an["launched_flops"],
                "hbm_bytes": an["hbm_bytes"],
                "intensity_flops_per_byte":
                    an["flops"] / max(an["hbm_bytes"], 1.0),
                "bound_ms": region["bound_ms"],
            }
        rec["flops_ratio_bb3_over_tet"] = (
            rec["bb3"]["launched_flops"] / max(rec["tet"]["launched_flops"],
                                               1.0))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    _dump(out_path, rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma list: attn_tp,moe_local,act_seq,mb=<n>,auto")
    ap.add_argument("--tag", default="",
                    help="suffix for the output JSON (A/B experiments)")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth (the card's cut cells)")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the global batch (the card's cut cells)")
    ap.add_argument("--kernel", default=None, choices=["tri_3body"],
                    help="dry-run a standalone kernel cell instead of the "
                         "(arch x shape x mesh) grid")
    ap.add_argument("--kernel-n-rows", type=int, default=256)
    ap.add_argument("--kernel-block", type=int, default=8)
    ap.add_argument("--kernel-d", type=int, default=8)
    ap.add_argument("--strict", action="store_true",
                    help="tri_3body: a > b > c in-kernel masking")
    args = ap.parse_args(argv)
    opts = tuple(o for o in args.opt.split(",") if o)

    if args.kernel == "tri_3body":
        rec = run_tri_3body_cell(
            args.out, n_rows=args.kernel_n_rows, block=args.kernel_block,
            d=args.kernel_d, strict=args.strict, force=args.force)
        status = "ok" if rec.get("ok") else "FAIL " + rec.get("error", "")
        print(f"kernel tri_3body {status} tiles "
              f"{rec['tiles_tet']}/{rec['tiles_bb3']} "
              f"flops bb3/tet={rec.get('flops_ratio_bb3_over_tet', 0):.2f}")
        return 0 if rec.get("ok") else 1

    archs = REG.ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = (list(REG.SHAPES) if (args.all or args.shape is None)
              else [args.shape])
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failed = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape_name in shapes:
                t0 = time.time()
                rec = run_cell(arch, shape_name, mesh_kind, args.out,
                               force=args.force, opts=opts, tag=args.tag,
                               n_layers=args.n_layers, batch=args.batch)
                failed += rec.get("supported", True) and not rec.get("ok")
                status = ("SKIP " + rec.get("skip_reason", "")[:40]
                          if not rec.get("supported", True)
                          else "ok" if rec.get("ok") else
                          "FAIL " + rec.get("error", "")[:80])
                dom = rec.get("roofline", {}).get("dominant", "-")
                mem = rec.get("analysis", {}).get("memory", {})
                peak = mem.get("peak_bytes_per_device") or \
                    mem.get("state_bytes_per_device", {}).get("total", 0)
                print(f"[{time.time()-t0:7.1f}s] {mesh_kind:6s} {arch:24s} "
                      f"{shape_name:12s} {status} dom={dom} "
                      f"bytes/dev={peak / 1e9:.2f} GB", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
