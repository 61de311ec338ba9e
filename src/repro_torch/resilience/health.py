"""Liveness and straggler detection (port of
``repro/resilience/health.py``): ``HeartbeatMonitor`` tracks per-worker
beats (a fleet's replicas), ``RoundWatch`` one engine's round durations.
Both are host-side arithmetic on the caller's clock, so injected delays on
a ``VirtualClock`` register deterministically."""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Optional, Sequence, Set


@dataclasses.dataclass
class WorkerHealth:
    last_beat: Optional[float] = None
    last_step: int = -1


class HeartbeatMonitor:
    """Per-worker liveness: ``failed()`` lists the workers with no beat
    for more than ``timeout_s``."""

    def __init__(self, workers: Sequence[int], *, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.health: Dict[int, WorkerHealth] = {
            w: WorkerHealth() for w in workers}

    def beat(self, worker: int, step: int, now: Optional[float] = None):
        h = self.health[worker]
        h.last_beat = time.monotonic() if now is None else now
        h.last_step = step

    def failed(self, now: Optional[float] = None) -> Set[int]:
        now = time.monotonic() if now is None else now
        return {w for w, h in self.health.items()
                if h.last_beat is not None
                and now - h.last_beat > self.timeout_s}


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
