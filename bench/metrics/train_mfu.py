"""train_mfu: the window's model flops, 6 x the matmul parameters a token
uses (the family's file counts them: for a dense model every layer's
matrices and the head; the embedding lookup does no product) x the
loss-bearing tokens of every step, over the steps' host time at the card's
bf16 peak. Padding and recomputation count as lost work."""

from bench.core import spec
from bench.roofline import model as RF


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    tokens = sum(s["loss_tokens"] for s in ctx["steps"])
    secs = sum(s["seconds"] for s in ctx["steps"])
    m = ctx["model"]
    return 100.0 * 6 * spec.family(m).matmul_params(m) * tokens \
        / (secs * RF.PEAK_BF16_FLOPS)
