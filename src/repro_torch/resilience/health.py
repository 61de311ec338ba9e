"""Liveness and straggler detection (port of
``repro/resilience/health.py``): ``HeartbeatMonitor`` tracks per-worker
beats and step times (a fleet's replicas, a training group's ranks),
``RoundWatch`` one engine's round durations. Both are host-side
arithmetic on the caller's clock, so injected delays on a
``VirtualClock`` register deterministically."""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Optional, Sequence, Set


@dataclasses.dataclass
class WorkerHealth:
    last_beat: Optional[float] = None
    last_step: int = -1
    step_times: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=16))


class HeartbeatMonitor:
    """Per-worker liveness and step latency: ``failed()`` lists the
    workers with no beat for more than ``timeout_s``; ``stragglers()``
    those whose mean recent step time exceeds ``straggler_factor`` x the
    median worker's (a beat's step time is the time since the worker's
    last beat over the steps it advanced)."""

    def __init__(self, workers: Sequence[int], *, timeout_s: float = 60.0,
                 straggler_factor: float = 1.5):
        self.timeout_s = timeout_s
        self.straggler_factor = straggler_factor
        self.health: Dict[int, WorkerHealth] = {
            w: WorkerHealth() for w in workers}

    def beat(self, worker: int, step: int, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        h = self.health[worker]
        if h.last_beat is not None and step > h.last_step:
            h.step_times.append(
                (now - h.last_beat) / max(1, step - h.last_step))
        h.last_beat, h.last_step = now, step

    def failed(self, now: Optional[float] = None) -> Set[int]:
        now = time.monotonic() if now is None else now
        return {w for w, h in self.health.items()
                if h.last_beat is not None
                and now - h.last_beat > self.timeout_s}

    def stragglers(self) -> Set[int]:
        means = {w: sum(h.step_times) / len(h.step_times)
                 for w, h in self.health.items() if h.step_times}
        if len(means) < 2:
            return set()
        med = sorted(means.values())[len(means) // 2]
        return {w for w, m in means.items()
                if m > self.straggler_factor * med}


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
