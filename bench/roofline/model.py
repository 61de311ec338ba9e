"""The H100's peaks and the least time of the work the benchmark counts.

Copied from the port's ``roofline/model.py`` (the datasheet peaks, ``bound``,
``attn_work`` and ``decode_work``) so that a later change to the program
cannot move the yardstick. The peaks are NVIDIA's for the H100 SXM5 80GB at
its 700 W limit; a card set below it runs slower, and every result names the
card and its limit beside the number.
"""

from __future__ import annotations

# dense bf16 on the tensor cores, and float32 on the CUDA cores (no TF32)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS
          ) -> float:
    """Least seconds of a piece of work: the larger of ``nbytes`` at the HBM
    rate and ``flops`` at ``peak_flops``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def attn_work(op: str, *, q_elems: int, k_elems: int, d: int, elt: int,
              pairs: int) -> tuple:
    """(bytes, flops) of the attention forward ("fwd"), dq ("dq") or dk/dv
    ("dkv") over ``pairs`` unmasked (query, key) pairs summed over heads:
    each input read once and each output written once (q, k, v, out, lse;
    + do, delta; dq or dk and dv), against 4, 6 and 8 x D flops a pair."""
    qkv = q_elems + 2 * k_elems
    rows = q_elems // d * 4  # one f32 per (b, h, row): lse, delta
    if op == "fwd":
        return elt * (qkv + q_elems) + rows, 4 * d * pairs
    if op == "dq":
        return elt * (qkv + 2 * q_elems) + 2 * rows, 6 * d * pairs
    if op == "dkv":
        return elt * (qkv + q_elems + 2 * k_elems) + 2 * rows, 8 * d * pairs
    raise ValueError(f"attn_work: op must be fwd, dq or dkv, got {op!r}")


def causal_pairs(lengths, heads: int) -> int:
    """Unmasked (query, key) pairs of causal attention over documents of
    ``lengths`` real tokens, summed over ``heads``."""
    return heads * sum(n * (n + 1) // 2 for n in lengths)


def train_attn_seconds(lengths, *, rows: int, heads: int, kv_heads: int,
                       head_dim: int, elt: int = 2) -> float:
    """Least seconds of one layer's attention in a training step over a row
    of ``rows`` tokens holding documents of ``lengths``: the forward once,
    dq and dk/dv, each at its own bound."""
    kw = dict(q_elems=rows * heads * head_dim,
              k_elems=rows * kv_heads * head_dim, d=head_dim, elt=elt,
              pairs=causal_pairs(lengths, heads))
    return sum(bound(*attn_work(op, **kw)) for op in ("fwd", "dq", "dkv"))


def decode_work(*, q_elems: int, b: int, h: int, d: int, elt: int,
                tbl_elems: int, kv_tokens: int, hkv: int,
                cache_elt: int) -> tuple:
    """(bytes, flops) of a decode round's attention: q and the B rows of
    output, the table, and each slot's cache rows of K and V once, against
    QK^T and PV, 4 D flops a (query head, cache token), on the float32
    CUDA cores."""
    nbytes = (q_elems + b * h * d) * elt + tbl_elems * 4 \
        + kv_tokens * hkv * d * cache_elt * 2
    return nbytes, 4 * h * d * kv_tokens


def decode_attn_seconds(kv_lens, *, heads: int, kv_heads: int, head_dim: int,
                        elt: int = 2, cache_elt: int = 4) -> float:
    """Least seconds of one layer's decode attention over live slots whose
    caches hold ``kv_lens`` tokens."""
    nbytes, flops = decode_work(
        q_elems=len(kv_lens) * heads * head_dim, b=len(kv_lens), h=heads,
        d=head_dim, elt=elt, tbl_elems=0, kv_tokens=sum(kv_lens),
        hkv=kv_heads, cache_elt=cache_elt)
    return bound(nbytes, flops, PEAK_F32_FLOPS)
