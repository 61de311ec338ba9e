"""Straggler detection (``RoundWatch`` of ``repro/resilience/health.py``)."""

from __future__ import annotations

from collections import deque
from typing import Optional


class RoundWatch:
    """Flags a round that took more than ``factor`` x the median of the
    last ``window`` rounds, once ``min_samples`` rounds are known (cold
    rounds, which pay kernel builds, never flag)."""

    def __init__(self, *, factor: float = 3.0, window: int = 64,
                 min_samples: int = 5):
        if factor <= 1.0 or min_samples < 2:
            raise ValueError("RoundWatch needs factor > 1, min_samples >= 2")
        self.factor = factor
        self.min_samples = min_samples
        self._durations: deque = deque(maxlen=window)
        self.flagged = 0

    def median(self) -> Optional[float]:
        if not self._durations:
            return None
        s = sorted(self._durations)
        return s[len(s) // 2]

    def observe(self, duration_s: float) -> bool:
        med = self.median()
        slow = (len(self._durations) >= self.min_samples
                and med is not None and med > 0.0
                and duration_s > self.factor * med)
        self._durations.append(duration_s)
        if slow:
            self.flagged += 1
        return slow
