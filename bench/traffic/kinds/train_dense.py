"""train_dense: ``rows`` rows of ``row_tokens`` tokens, one whole sequence
each. The port's dense train step runs them."""

DRIVER = "train"
PACKED = False


def geometry(mix: dict):
    return [[mix["row_tokens"]]] * mix["rows"], mix["row_tokens"]
