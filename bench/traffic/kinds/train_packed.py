"""train_packed: rows of documents with lognormal lengths (``doc_len``),
packed first-fit-decreasing into ``row_tokens`` rows, each document padded
to ``block``; the ``rows`` fullest rows of one draw from ``shape_seed``
make the pool. The port's packed train step runs them."""

import numpy as np

from bench.core import traffic as T

DRIVER = "train"
PACKED = True


def geometry(mix: dict):
    """(the rows as lists of document lengths, the block): the shortest run
    of drawn documents whose first-fit-decreasing packing opens one bin
    more than the mix's rows, packed, and its ``rows`` fullest bins kept
    (the least full, just opened, is dropped)."""
    rng = T.stream_rng(mix["shape_seed"], 0)
    cap, blk, rows = mix["row_tokens"], mix["block"], mix["rows"]
    lens = T.lognormal_lengths(rng, mix["doc_len"], 64 * rows)
    padded = np.cumsum(-(-lens // blk) * blk)
    k = int(np.searchsorted(padded, rows * cap))
    while True:
        bins = T.pack_ffd(lens[:k], cap, blk)
        if len(bins) > rows:
            break
        k += 1
        if k > len(lens):
            raise ValueError("the drawn documents do not fill the mix's rows")
    fill = [sum(-(-int(lens[i]) // blk) * blk for i in b) for b in bins]
    keep = sorted(range(len(bins)), key=lambda b: (-fill[b], b))[:rows]
    return [[int(lens[i]) for i in bins[b]] for b in sorted(keep)], blk
