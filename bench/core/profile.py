"""The profiler window: a short steady stretch of the cell's own work under
``torch.profiler`` (CPU and CUDA activities, kept in memory), reduced to
the device's busy time, the kernels by name, and the idle gaps by what the
host was doing while the device waited.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

from bench.roofline import attribution as A


class Window:
    """One profiler window's reduction. Times in seconds."""

    def __init__(self, prof, wall_s: float, with_stack: bool):
        self.wall_s = wall_s
        self.kernels = A.kernels(prof)
        self.busy_s = A.busy_us(self.kernels) / 1e6
        self.launchers = A.launchers(prof) if with_stack else []
        self._prof = prof

    def kernel_seconds(self, pattern) -> float:
        """Device seconds of the kernels whose name ``pattern`` finds."""
        return sum(e - s for n, s, e in self.kernels
                   if pattern.search(n)) / 1e6

    def top_ops(self, k: int = 10):
        by = defaultdict(float)
        for n, s, e in self.kernels:
            by[n] += (e - s) / 1e6
        return sorted(([n[:200], v] for n, v in by.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, k: int = 10):
        """Idle device time between kernels, summed by the innermost host
        event running at each gap's middle; the ``k`` largest."""
        merged = []
        for _, s, e in self.kernels:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        gaps = [(b[0] - a[1], (a[1] + b[0]) / 2)
                for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
        gaps.sort(reverse=True)
        cpu = sorted(((ev.time_range.start, ev.time_range.end, ev.name)
                      for ev in self._prof.events() if not A.is_device(ev)),
                     key=lambda r: r[0])
        starts = [c[0] for c in cpu]
        by = defaultdict(float)
        for length, mid in gaps[:2000]:
            label = "host between ops (Python)"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4000, -1), -1):
                if cpu[j][1] >= mid:
                    label = cpu[j][2]
                    break
            by[label[:200]] += length / 1e6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda r: -r[1])[:k]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}


def take(fn, *, with_stack: bool, pad_s: float = 0.05) -> Window:
    """Run ``fn()`` under the profiler; the window's wall time runs from
    the call to the device's last work after it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    kw = {}
    if with_stack:
        # the ops' own Python stacks, which with_stack alone leaves empty
        kw = dict(with_stack=True, experimental_config=torch._C._profiler.
                  _ExperimentalConfig(verbose=True))
    with profile(activities=acts, **kw) as prof:
        time.sleep(pad_s)
        t0 = time.perf_counter()
        fn()
        sync()
        wall = time.perf_counter() - t0
        time.sleep(pad_s)
    return Window(prof, wall, with_stack)
