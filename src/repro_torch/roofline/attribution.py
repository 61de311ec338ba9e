"""The card's kernels by region, from a ``torch.profiler`` window (the
port's answer to ``repro/roofline/hlo_parse.py``'s breakdown).

``attribute(prof, launches)`` sorts every device kernel of a window into:

* each ``launch/compat.py`` region, by the ``__global__`` names it
  launches;
* ``gemm``: cuBLAS, cuBLASLt (``nvjet``) and CUTLASS GEMMs;
* ``elementwise``: PyTorch's own kernels (``at::native``: elementwise,
  reductions, copies, indexing), split further by the aten op that
  launched each and the port module in that op's Python stack (for
  example ``train/optimizer.py``'s update against the loss and the norms);
* ``other``: everything else (memsets, and kernels of no known family).

Each group gets its device time, its launches and its share of the busy
time. A window taken late in a process has dropped launches on the card
(PR 25, call 22: 16 of 20 ``packed_bwd_dkv``), so a reading is held: the
launches of each region in the window must equal the wrappers'
``.launches`` over the same steps, and ``attribute`` raises rather than
return a reading where they differ. ``window`` runs the steps under the
profiler; the CLI takes each window in a fresh process:

    python -m repro_torch.roofline.attribution --arch yi-9b \\
        --n-layers 24 --seq 4096 --batch 1 --json FILE

trains a cut arch on the card with AdamW (random seeded weights), times
its steps, reads its peak memory (``torch.cuda.max_memory_allocated``
over the steps), takes one profiler window over one more step and writes
the reading, with the dry-run's reckoning of the same cut cell beside
it.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from collections import defaultdict

from repro_torch.launch import compat

GEMM_RE = re.compile(r"gemm|nvjet|cutlass|xmma|cublas|splitKreduce",
                     re.IGNORECASE)
PYTORCH_RE = re.compile(r"at::native|at_cuda_detail|elementwise_kernel")
PORT = "repro_torch/"


class WindowRefused(RuntimeError):
    """A window's region launches differ from the wrappers' counts."""


def _is_device(ev) -> bool:
    return str(getattr(ev, "device_type", "")).endswith("CUDA")


def _dev_us(ev) -> float:
    return float(getattr(ev, "device_time", 0.0)
                 or getattr(ev, "cuda_time", 0.0) or 0.0)


def group_of(kernel: str) -> str:
    """The group a device kernel's name falls in (module docstring)."""
    region = compat.region_of_kernel(kernel)
    if region is not None:
        return region
    if GEMM_RE.search(kernel):
        return "gemm"
    if PYTORCH_RE.search(kernel):
        return "elementwise"
    return "other"


def _frame(frame: str) -> str:
    """``.../repro_torch/train/optimizer.py(215): _adamw`` as
    ``train/optimizer.py:_adamw``."""
    path, _, rest = frame.partition("(")
    return path.split(PORT, 1)[1] + ":" + (rest.partition(": ")[2] or "?")


def _port_module(op) -> str:
    """The innermost frame of the port above a CPU op: in its recorded
    stack, or among the Python function events the profiler's Python
    tracer nests it under; "outside the port" when none is the port's."""
    for frame in getattr(op, "stack", None) or ():
        if PORT in frame:
            return _frame(frame)
    ev = op.cpu_parent
    while ev is not None:
        if PORT in ev.name:
            return _frame(ev.name)
        ev = ev.cpu_parent
    return "outside the port"


def _launchers(prof):
    """(kernel name, device us, aten op, port module) of each device
    kernel the profiler linked to the CPU event that launched it: the
    innermost aten op at or above that event, and the port's frame in its
    Python stack. The profiler may list one kernel on several events (the
    runtime launch, the op, the ops around it): each is taken once, from
    the innermost op that lists it, else from the launches under an op
    that lists none."""
    own, under = {}, {}
    for ev in prof.events():
        kernels = [] if _is_device(ev) else \
            list(getattr(ev, "kernels", ()) or ())
        if not kernels:
            continue
        op = ev
        while op is not None and not op.name.startswith("aten::"):
            op = op.cpu_parent
        op = op or ev
        side = own if op is ev else under
        side.setdefault(id(op), (op, []))[1].extend(kernels)
    outer = set()  # ops above another op that lists kernels
    for op, _ in own.values():
        up = op.cpu_parent
        while up is not None:
            outer.add(id(up))
            up = up.cpu_parent
    out = []
    for key, (op, kernels) in {**under, **own}.items():
        if key in outer:
            continue
        module = _port_module(op)
        out += [(k.name, float(k.duration), op.name, module)
                for k in kernels]
    return out


def attribute(prof, launches: dict, wall_ms: float = 0.0) -> dict:
    """The window's device time by group (module docstring). ``launches``
    is each wrapper's ``.launches`` over the window's steps (names of
    ``WRAPPERS``; zeros may be left out). Raises ``WindowRefused`` where a
    region's launches in the window differ from it."""
    groups = defaultdict(lambda: {"ms": 0.0, "launches": 0})
    for ev in prof.events():
        if not _is_device(ev):
            continue
        g = groups[group_of(ev.name)]
        g["ms"] += _dev_us(ev) / 1e3
        g["launches"] += 1
    seen = {r.name: groups[r.name]["launches"] if r.name in groups else 0
            for r in compat.REGIONS}
    want = {r.name: int(launches.get(r.name, 0)) for r in compat.REGIONS}
    if seen != want:
        bad = {n: (seen[n], want[n]) for n in seen if seen[n] != want[n]}
        raise WindowRefused(f"the window's region launches differ from the "
                            f"wrappers' (window, wrappers): {bad}")
    busy = sum(g["ms"] for g in groups.values())
    for g in groups.values():
        g["share"] = g["ms"] / busy if busy else 0.0
    by_op = defaultdict(lambda: {"ms": 0.0, "launches": 0})
    for name, us, op, module in _launchers(prof):
        if group_of(name) == "elementwise":
            row = by_op[(module, op)]
            row["ms"] += us / 1e3
            row["launches"] += 1
    modules = defaultdict(float)
    for (module, _), row in by_op.items():
        modules[module.split(":")[0]] += row["ms"]
    linked = sum(modules.values())
    unlinked = groups["elementwise"]["ms"] - linked \
        if "elementwise" in groups else 0.0
    if unlinked > 1e-6:
        modules["not linked to an op"] += unlinked
    return {
        "busy_ms": busy, "wall_ms": wall_ms,
        "busy_share": busy / wall_ms if wall_ms else None,
        "groups": dict(sorted(groups.items(), key=lambda kv: -kv[1]["ms"])),
        "elementwise_by_module": dict(sorted(modules.items(),
                                             key=lambda kv: -kv[1])),
        "elementwise_linked_ms": linked,
        "elementwise_by_op": [
            {"module": m, "op": o, **row} for (m, o), row in
            sorted(by_op.items(), key=lambda kv: -kv[1]["ms"])][:25],
        "launches_held": want,
    }


def window(fn, wrappers: dict, pad_s: float = 0.2):
    """Run ``fn()`` once under the profiler (CPU and CUDA, Python stacks)
    with each wrapper's ``.launches`` set to 0 before; returns (prof, the
    wrappers' launches over it, wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for f in wrappers.values():
        f.launches = 0
    torch.cuda.synchronize()
    # verbose: the ops' own Python stacks (``FunctionEvent.stack``), which
    # with_stack alone leaves empty under kineto
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True, experimental_config=torch._C._profiler.
                 _ExperimentalConfig(verbose=True)) as prof:
        time.sleep(pad_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(pad_s)
    return prof, {n: f.launches for n, f in wrappers.items()}, wall_ms


def all_wrappers() -> dict:
    from repro_torch.kernels.ssm_scan import kernel as SK
    from repro_torch.kernels.tri_3body import kernel as TK
    from repro_torch.kernels.tri_attn import kernel as K
    from repro_torch.kernels.tri_edm import kernel as EK
    from repro_torch.kernels.wkv_scan import kernel as WK

    out = {}
    for mod in (K, EK, TK, SK, WK):
        out.update(mod.WRAPPERS)
    return out


def train_reading(arch: str, *, n_layers: int, seq: int, batch: int,
                  steps: int) -> dict:
    """A cut ``arch`` trained on the card with AdamW (``OptConfig``'s
    defaults): the dry-run's count of the cell
    on meta (first, before the card's state is allocated), step times,
    the peak over the steps, and one attributed window over one more
    step."""
    import dataclasses

    import torch

    from repro_torch.configs import registry as REG
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as DRY
    from repro_torch.roofline import model as RF
    from repro_torch.train import data as DATA
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(REG.get_config(arch), n_layers=n_layers)
    shape = ShapeConfig("cut", seq, batch, "train")
    opt = OPT.OptConfig()
    out = {"arch": arch, "n_layers": n_layers, "seq": seq, "batch": batch,
           "optimizer": opt.kind,
           "model_flops": RF.model_flops(cfg, shape)}
    t0 = time.time()
    an = DRY.count_cell(cfg, shape, opt=opt)["analysis"]
    terms = RF.terms_from_analysis(an, n_chips=1,
                                   model_flops=out["model_flops"])
    out["reckoned"] = {"memory": an["memory"], "roofline": terms.as_dict(),
                       "regions": an["regions"],
                       "seconds": time.time() - t0}
    wrappers = all_wrappers()
    state = TS.init_state(cfg, opt, seed=0, device="cuda")
    ds = DATA.SyntheticLM(cfg, shape, seed=0, device="cuda")
    step = TS.make_train_step(cfg, opt, attn_impl="cuda", remat=True,
                              block=64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step(state, ds.batch(i))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["step_s"] = times
    med = statistics.median(times)
    out["mfu"] = RF.mfu(out["model_flops"], med)
    b = ds.batch(steps)
    prof, launches, wall_ms = window(lambda: step(state, b), wrappers)
    out["attribution"] = attribute(prof, launches, wall_ms)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--n-layers", type=int, required=True)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--json", default=None, help="write the reading here")
    args = ap.parse_args(argv)
    try:
        rec = train_reading(args.arch, n_layers=args.n_layers, seq=args.seq,
                            batch=args.batch, steps=args.steps)
    except WindowRefused as e:
        print(f"attribution: refused: {e}", file=sys.stderr)
        return 1
    text = json.dumps(rec, default=str)
    if args.json:
        with open(args.json, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
