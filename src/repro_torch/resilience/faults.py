"""Retry policy, the poisoned-output error and the degradation-ladder
registry (the parts of ``repro/resilience/faults.py`` the engine uses;
seeded fault injection, ``FaultPlan``, is not ported yet)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


class PoisonedOutput(RuntimeError):
    """Raised by the engine's finite-guard when a round's output contains
    NaN/Inf."""


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff and seeded jitter:
    delay(attempt) = base * factor^attempt * (1 + jitter * u), capped."""

    max_retries: int = 3
    base_s: float = 0.005
    factor: float = 2.0
    jitter: float = 0.5
    cap_s: float = 0.25
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0 or self.base_s < 0.0:
            raise ValueError("RetryPolicy needs max_retries >= 0 and "
                             "base_s >= 0")
        self._rng = np.random.default_rng(self.seed)

    def delay(self, attempt: int) -> float:
        u = float(self._rng.random())
        d = self.base_s * (self.factor ** attempt) * (1.0 + self.jitter * u)
        return min(d, self.cap_s)


# Per-phase ladders, fastest -> most conservative (the reference's names).
LADDERS: Dict[str, Tuple[str, ...]] = {
    "admit": ("packed", "packed_scan", "sequential"),
    "decode": ("packed", "lockstep"),
    "map": ("traced", "host"),
    "step": ("fused", "split"),
    "capacity": ("requested", "rebucketed"),
    "engine": ("active", "quarantined", "restored"),
    "route": ("primary", "failover"),
}

TRANSITIONS: Tuple[Tuple[str, str, str], ...] = tuple(
    (phase, ladder[i], ladder[j])
    for phase, ladder in LADDERS.items()
    for i in range(len(ladder))
    for j in range(i + 1, len(ladder)))


def is_registered_transition(phase: str, frm: str, to: str) -> bool:
    """True iff (phase, frm, to) moves strictly DOWN a declared ladder;
    the "map" ladder's transitions ride on the admit phase."""
    if (phase, frm, to) in TRANSITIONS:
        return True
    return phase == "admit" and ("map", frm, to) in TRANSITIONS
