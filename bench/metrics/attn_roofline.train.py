"""attn_roofline.train: the least time of the attention work the profiled
steps need (each layer's forward once, dq and dk/dv, over the unmasked
pairs inside each document's triangle, from the traffic's shapes) over the
device time of the port's attention kernels in the profiler window.
Recomputation and wasted tiles show as lost share."""

from bench.roofline import attribution as A
from bench.core import spec
from bench.roofline import model as RF


def read(ctx):
    win = ctx.get("profile") if ctx["kind"] == "train" else None
    if win is None:
        return None
    dev = win.kernel_seconds(A.ATTN_KERNEL_RE)
    if not dev:
        return None
    m = ctx["model"]
    least = sum(spec.family(m).attn_layers(m) * RF.train_attn_seconds(
        r["lengths"], rows=r["rows"], heads=m["n_heads"],
        kv_heads=m["n_kv_heads"], head_dim=m["head_dim"])
        for r in ctx["profile_rows"])
    return 100.0 * least / dev
