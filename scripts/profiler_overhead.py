"""Host time a tiny CUDA kernel launch takes before and after one
torch.profiler window in the same process.

    python3 scripts/profiler_overhead.py

On the card: 5 timings of 20000 synchronized ``add_`` launches each
(microseconds a launch, host wall clock), then one profiler window
(CUDA activity only) around a single launch, 5 timings again, then one
window with CPU and CUDA activity, 5 again. Prints the three lists and
the card's name and power limit. It is why ``chip_smoke.py`` runs the
checker's profiler windows in a process of their own: a window left its
process's later launches slower.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch


def per_launch_us(x, n: int = 20000) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_overhead: no CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(16, device="cuda")
    for _ in range(3):
        per_launch_us(x, 2000)
    rows = [("before", [per_launch_us(x) for _ in range(5)])]
    for label, acts in (("after a CUDA window", [ProfilerActivity.CUDA]),
                        ("after a CPU+CUDA window",
                         [ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        with profile(activities=acts):
            x.add_(1)
            torch.cuda.synchronize()
        rows.append((label, [per_launch_us(x) for _ in range(5)]))
    for label, us in rows:
        print(f"{label}: " + ", ".join(f"{u:.3f}" for u in us)
              + " us a launch")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
