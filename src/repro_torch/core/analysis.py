"""Space-of-computation accounting: the paper's launched / useful / wasted
blocks per strategy and its model of the improvement factor I.

Port of ``repro/core/analysis.py``. The counts are structural (host
integers); the card's own I comes from timing the BB and LTM kernels
(``chip_smoke.py``'s paper phase), which ``improvement_factor`` models
with the mapping-cost ratio k = tau / beta.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core import mapping as M


@dataclasses.dataclass(frozen=True)
class StrategyStats:
    name: str
    launched: int
    useful: int
    wasted: int
    waste_fraction: float
    block_ratio_vs_bb: float  # BB launched / this launched (I at k = 1)


def strategy_stats(n: int, band_w: int | None = None,
                   rec_m: int = 1) -> Dict[str, StrategyStats]:
    """Launched/useful/wasted blocks of every strategy at n tiles a side."""
    bb = n * n
    out: Dict[str, StrategyStats] = {}

    def add(name: str, launched: int, useful: int):
        out[name] = StrategyStats(
            name=name, launched=launched, useful=useful,
            wasted=launched - useful,
            waste_fraction=1.0 - useful / max(launched, 1),
            block_ratio_vs_bb=bb / max(launched, 1))

    t = M.tri(n)
    add("bb", bb, t)
    add("ltm", t, t)
    add("utm", t, t)
    h, w = M.rb_grid_shape(n)
    # every lower-triangle cell appears exactly once in the fold, so the
    # valid count is tri(n) for both parities
    add("rb", h * w, t)
    try:
        add("rec", M.rec_total_blocks(n, rec_m), t)
    except ValueError:
        pass  # n is not rec_m * 2^k
    if band_w is not None:
        b = M.band_blocks(n, band_w)
        add("band", b, b)
        add("bb_band", bb, b)
    return out


def improvement_factor(n: int, k_cost: float = 1.0) -> float:
    """The paper's eq. (11): I = beta n^2 / (tau T(n)) with tau = k beta,
    k the mapping-overhead ratio (the paper measures k ~ 1.74 on Kepler,
    I ~ 1.15)."""
    return (n * n) / (k_cost * M.tri(n))


def flops_saved_fraction(n: int, band_w: int | None = None) -> float:
    """Fraction of the BB tile work the domain-exact schedule removes."""
    useful = M.band_blocks(n, band_w) if band_w else M.tri(n)
    return 1.0 - useful / (n * n)
