"""The numbers that decide ``correct``: the program's readings against the
plain reference's, each beside the limit kept in ``bench/limits/<cell>.json``.

Training (the first ``checked_steps`` steps of the run, which go through
the window's own step and feed):
  loss_gap    the gap between the program's loss and the reference's at
              the first step (the later steps' losses, after a first AdamW
              update that moves every weight by about the learning rate,
              swing with the update's rounding; they are kept in the
              detail);
  grad_gap    the worst leaf's gap between the norms of the first step's
              gradient as the optimizer got it (the program's read from its
              AdamW first moment, m / (1 - b1)) and the reference's, over
              the larger of the reference's norm of that leaf and of the
              median leaf;
  update_gap  the same for the norm of each leaf's change over the checked
              steps, leaving out a leaf whose reference gradient is under a
              thousandth of the median leaf's (it moves by round-off).
Serving:
  tok_gap     the widest gap by which a served greedy token's logit lies
              below the reference's best at that position.
"""

from __future__ import annotations

import math

from bench.core import stats

SMALL_GRAD = 1e-3


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    med = stats.median(ref[p] for p in keep)
    return max(abs(prog[p] - ref[p]) / max(ref[p], med) for p in keep)


def train_readings(prog: dict, ref: dict) -> dict:
    """prog, ref: {"loss": [...], "grad_norm": {leaf: norm},
    "update_norm": {leaf: norm}}."""
    g = ref["grad_norm"]
    med = stats.median(g.values())
    moving = [p for p in g if g[p] >= SMALL_GRAD * med]
    return {
        "loss_gap": abs(prog["loss"][0] - ref["loss"][0]),
        "grad_gap": _leaf_gap(prog["grad_norm"], g, list(g)),
        "update_gap": _leaf_gap(prog["update_norm"], ref["update_norm"],
                                moving),
    }


def train_detail(prog: dict, ref: dict) -> dict:
    """The readings' parts: each step's two losses, and each leaf's two
    norms, named by the leaf's path."""
    name = "/".join
    return {"loss": [prog["loss"], ref["loss"]],
            "grad_norm": {name(p): [prog["grad_norm"][p], v]
                          for p, v in ref["grad_norm"].items()},
            "update_norm": {name(p): [prog["update_norm"][p], v]
                            for p, v in ref["update_norm"].items()}}


def token_gaps(ref_logits, served) -> list:
    """For each served token, the reference's best logit at its position
    minus the reference's logit of that token. ref_logits: (n, V) float32;
    served: n token ids."""
    import torch

    idx = torch.as_tensor(list(served), device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, idx[:, None])[:, 0]
    return (best - got).tolist()


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) with every reading at or
    under its limit for correct; a reading that is missing or not finite
    (shown as null) fails."""
    ok = {k: v is not None and math.isfinite(v) and v <= limits[k]
          for k, v in readings.items()}
    shown = {k: {"value": v if v is not None and math.isfinite(v) else None,
                 "limit": limits[k]} for k, v in readings.items()}
    return all(ok.values()), shown
