"""serve_open: an open loop of independent users for ``horizon_s`` seconds
of traffic: arrivals at the mean ``rate_per_s`` by the mix's arrival law,
lognormal prompt and output lengths. The gaps and sizes are one schedule
drawn from ``shape_seed``, the same for every run seed; the run seed draws
the prompt tokens."""

import math

import numpy as np

from bench.core import traffic as T

DRIVER = "serve"
OPEN = True


def schedule(mix: dict, seed: int, vocab: int):
    """The requests (``traffic.ServeRequest``) by due time."""
    shape = T.stream_rng(mix["shape_seed"], 0)
    n = int(math.ceil(mix["rate_per_s"] * mix["horizon_s"]))
    law = mix["arrivals"]
    gaps = T.arrivals(law).gaps(shape, mix["rate_per_s"], n, law)
    p_lens = T.lognormal_lengths(shape, mix["prompt_len"], n)
    o_lens = T.lognormal_lengths(shape, mix["output_len"], n)
    rng = T.stream_rng(seed, 2)
    due = np.cumsum(gaps)
    return [T.ServeRequest(i, float(due[i]), -1,
                           rng.integers(0, vocab, size=int(p_lens[i])),
                           int(o_lens[i]))
            for i in range(n)]
