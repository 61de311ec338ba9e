"""Fault tolerance of training (port of ``repro/train/fault_tolerance.py``):
the preemption guard, the resumable loop with its heartbeat, and the
elastic re-planning (``replan_mesh``, ``shard_assignment``), pure
functions from the live-worker set to a new mesh and data shards. The
monitor is ``resilience/health.HeartbeatMonitor``. After a re-plan the
survivors form a new ``launch/mesh.init_data_group`` group and each rank
restores the last checkpoint (``train/checkpoint.restore``), written by
any one process.

Recovery invariant: crash at any step -> restore the latest checkpoint ->
replay the remaining batches == a bitwise-identical final state, because
the data pipeline is a pure function of (seed, step) and the train step is
deterministic (its kernels use no atomics).
"""

from __future__ import annotations

import signal
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def replan_mesh(n_chips: int, *, model: int = 16, pod_size: int = 256
                ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The largest usable mesh from ``n_chips`` surviving chips, as the
    reference plans it: the model axis kept (halved while it does not
    fit), whole lost pods shrinking the pod axis, partial losses the data
    axis. Deterministic in n_chips. The port's groups take only a model
    axis of 1 (``launch/mesh.data_parallel_size``)."""
    if n_chips < model:
        while model > 1 and n_chips < model:
            model //= 2
    pods = max(1, n_chips // pod_size)
    per_pod = n_chips // pods
    data = max(1, per_pod // model)
    if pods > 1:
        return (pods, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def shard_assignment(n_shards: int, workers: Sequence[int]
                     ) -> Dict[int, List[int]]:
    """Deterministic round-robin data-shard ownership for the live set."""
    workers = sorted(workers)
    out: Dict[int, List[int]] = {w: [] for w in workers}
    for s in range(n_shards):
        out[workers[s % len(workers)]].append(s)
    return out


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
                 monitor=None, worker: int = 0,
                 fail_at: Optional[int] = None) -> Tuple[object, list]:
    """Drive ``train_step`` from state.step to n_steps.

    batch_fn(step) -> batch (a pure function: restart-safe); manager: a
    CheckpointManager for cadenced saves (and the save on preemption);
    monitor: a HeartbeatMonitor that ``worker`` beats after each step;
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
        if monitor is not None:
            monitor.beat(worker, step)
        log.append({k: float(v) for k, v in metrics.items()})
        if manager is not None and manager.should_save(step):
            manager.save_sync(state, step)
    return state, log
