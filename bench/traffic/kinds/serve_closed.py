"""serve_closed: a closed loop of ``clients``, each sending its next
request (``prompt_len`` tokens for ``output_len`` new ones) the moment its
last one finishes."""

import numpy as np

DRIVER = "serve"
OPEN = False


def prompt(mix: dict, seed: int, vocab: int, client: int, k: int):
    """Client ``client``'s k-th prompt."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 3, client, k])
    return rng.integers(0, vocab, size=mix["prompt_len"])
