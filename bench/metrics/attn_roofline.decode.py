"""attn_roofline.decode: over the decode rounds of the profiler window that
records Python stacks, the least time of their decode attention (each live
slot's query and output, and its K and V cache up to its length, read
once) over the device time of the kernels that computed it: the port's
packed decode kernel, found by name, and on lockstep rounds the kernels
launched from ``models/layers.py:decode_attention`` but its output
projection (``aten::mm``)."""

from bench.roofline import attribution as A
from bench.roofline import model as RF
from bench.core import spec
from bench.core import weights as W

PROJ = ("aten::mm", "aten::matmul", "aten::addmm")
LOCKSTEP = "models/layers.py:decode_attention"


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    win, rounds = ctx["stack_profile"], ctx["stack_rounds"]
    if win is None or not rounds or not win.launchers:
        return None
    # the packed kernel is launched through its C entry, under no aten op,
    # so it is found among all of the window's kernels
    dev = win.kernel_seconds(A.ATTN_KERNEL_RE) + sum(
        t for name, t, op, mod in win.launchers
        if mod == LOCKSTEP and op not in PROJ
        and not A.ATTN_KERNEL_RE.search(name)) / 1e6
    if not dev:
        return None
    m = ctx["model"]
    cache_elt = W.DTYPES[ctx["engine"]["cache_dtype"]].itemsize
    least = sum(spec.family(m).attn_layers(m) * RF.decode_attn_seconds(
        r["kv_lens"], heads=m["n_heads"], kv_heads=m["n_kv_heads"],
        head_dim=m["head_dim"], elt=W.DTYPES[m["dtype"]].itemsize,
        cache_elt=cache_elt) for r in rounds)
    return 100.0 * least / dev
