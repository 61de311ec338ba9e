"""Preemption-safe, resumable training loop (port of the loop half of
``repro/train/fault_tolerance.py``; the elastic re-planning, replan_mesh
and shard_assignment, waits with ``parallel/``, ROADMAP queue A).

Recovery invariant: crash at any step -> restore the latest checkpoint ->
replay the remaining batches == a bitwise-identical final state, because
the data pipeline is a pure function of (seed, step) and the train step is
deterministic (its kernels use no atomics).
"""

from __future__ import annotations

import signal
from typing import Callable, Optional, Tuple


class PreemptionGuard:
    """Converts SIGTERM (or the given signals) into a checked flag so the
    loop can checkpoint and stop at a step boundary."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = False
        self._signals = signals
        self._prev = {}

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False

    def _handler(self, signum, frame):
        self._flag = True

    @property
    def preempted(self) -> bool:
        return self._flag


class SimulatedFailure(RuntimeError):
    def __init__(self, step):
        super().__init__(f"simulated node failure at step {step}")
        self.step = step


def run_training(state, train_step: Callable, batch_fn: Callable,
                 n_steps: int, *, manager=None, guard=None,
                 fail_at: Optional[int] = None) -> Tuple[object, list]:
    """Drive ``train_step`` from state.step to n_steps.

    batch_fn(step) -> batch (a pure function: restart-safe); manager: a
    CheckpointManager for cadenced saves (and the save on preemption);
    fail_at: raise SimulatedFailure before running that step (tests).
    Returns (final_state, metrics_log)."""
    log = []
    step = int(state.step)
    while step < n_steps:
        if guard is not None and guard.preempted:
            if manager is not None:
                manager.save_sync(state, step)
            break
        if fail_at is not None and step == fail_at:
            raise SimulatedFailure(step)
        state, metrics = train_step(state, batch_fn(step))
        step += 1
        log.append({k: float(v) for k, v in metrics.items()})
        if manager is not None and manager.should_save(step):
            manager.save_sync(state, step)
    return state, log
