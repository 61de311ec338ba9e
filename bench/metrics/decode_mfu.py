"""decode_mfu: over the window's decode rounds, the sum of each round's
least time at the card's peaks over the sum of their ``engine.decode_round``
spans. A round's least time is the larger of its model flops (2 x the
matmul parameters x the live slots) at the bf16 peak and its bytes (every
layer's matrices and the head once, and each live slot's cache up to its
length) at the HBM rate; the family's file gives the parameters and the
cache's bytes a token."""

from bench.core import spec
from bench.core import weights as W
from bench.roofline import model as RF


def read(ctx):
    if ctx["kind"] != "serve":
        return None
    spans = [d / 1e3 for n, d in ctx["spans"] if n == "engine.decode_round"]
    rounds = ctx["rounds"]
    if not spans or len(spans) != len(rounds):
        return None
    m = ctx["model"]
    fam = spec.family(m)
    n = fam.matmul_params(m)
    elt = W.DTYPES[m["dtype"]].itemsize
    per_tok = fam.cache_bytes_per_token(
        m, W.DTYPES[ctx["engine"]["cache_dtype"]].itemsize)
    least = sum(RF.bound(n * elt + per_tok * sum(r["kv_lens"]),
                         2.0 * n * len(r["kv_lens"])) for r in rounds)
    return 100.0 * least / sum(spans)
