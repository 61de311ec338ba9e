"""Seeded fault injection, retry policy, the poisoned-output error and the
degradation-ladder registry (port of ``repro/resilience/faults.py``).

A ``FaultPlan`` is an explicit, seeded list of faults. Each fault names
its kind, the engine phase it strikes ("admit", "decode", or "launch" for
the launch hook), the phase-local round, and how many times it fires
before clearing. Matching is a pure function of (phase, round, strike
history), so a faulted run replays exactly.

  launch_error  the round raises ``InjectedLaunchError``;
  admit_oom     the admission raises ``InjectedOOM``;
  poison        the round's output is NaN-corrupted where the engine's
                finite guard inspects it (admit states, decode logits);
  straggler     the round takes ``delay_s`` longer on the engine's clock.

The port's engine does not absorb what ``maybe_fail`` raises: a single
engine leaves ``run()`` with an ``EngineStepError``, and only a ``Fleet``
fails over on it (``serve/fleet.py``). ``install_launch_hook`` registers a
plan with ``obs.launch``, so faults with ``phase="launch"`` raise at the
launch site itself, before a kernel or a plain version runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("launch_error", "admit_oom", "poison", "straggler")
PHASES = ("admit", "decode", "launch")


class InjectedLaunchError(RuntimeError):
    """A deterministic stand-in for a failed kernel launch."""


class InjectedOOM(RuntimeError):
    """A deterministic stand-in for an out-of-memory admission failure."""


class PoisonedOutput(RuntimeError):
    """Raised by the engine's finite-guard when a round's output contains
    NaN/Inf."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault. ``round`` is phase-local; ``times`` counts its
    strikes across retries and rungs; ``member`` scopes an admit fault to
    one request of a sequential admission (-1 = any); ``slot`` scopes
    decode poison (-1 = first live slot); ``engine`` scopes the fault to
    one fleet replica (-1 = every engine)."""

    kind: str
    phase: str
    round: int
    times: int = 1
    member: int = -1
    slot: int = -1
    delay_s: float = 0.0
    engine: int = -1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS or self.phase not in PHASES \
                or self.round < 0 or self.times < 1:
            raise ValueError(f"bad fault {self}")


class FaultPlan:
    """A seeded, replayable set of faults and their strike bookkeeping;
    every match consumes one strike, so a fault fires exactly ``times``
    times however the engine interleaves retries and rungs."""

    def __init__(self, faults: Sequence[Fault] = (), *, seed: int = 0):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.seed = seed
        self._fired: Dict[int, int] = {}
        self._launch_calls = 0

    @classmethod
    def random(cls, seed: int, *, n_rounds: int = 8, rate: float = 0.25,
               kinds: Sequence[str] = FAULT_KINDS,
               phases: Sequence[str] = ("admit", "decode"),
               delay_s: float = 1.0,
               engines: Sequence[int] = (-1,)) -> "FaultPlan":
        """Each (phase, round) cell faults with probability ``rate``."""
        rng = np.random.default_rng(seed)
        faults: List[Fault] = []
        for phase in phases:
            for rnd in range(n_rounds):
                if rng.random() >= rate:
                    continue
                kind = str(rng.choice(list(kinds)))
                if kind == "admit_oom" and phase != "admit":
                    kind = "launch_error"
                faults.append(Fault(
                    kind=kind, phase=phase, round=rnd,
                    times=int(rng.integers(1, 3)),
                    delay_s=delay_s if kind == "straggler" else 0.0,
                    engine=(int(rng.choice(list(engines)))
                            if tuple(engines) != (-1,) else -1)))
        return cls(faults, seed=seed)

    def for_engine(self, engine: int) -> "FaultPlan":
        """A fresh sub-plan of the faults scoped to ``engine`` and every
        engine-agnostic one, with its own strike bookkeeping."""
        return FaultPlan([f for f in self.faults if f.engine in (-1, engine)],
                         seed=self.seed)

    def _strike(self, idx: int) -> bool:
        fired = self._fired.get(idx, 0)
        if fired >= self.faults[idx].times:
            return False
        self._fired[idx] = fired + 1
        return True

    def maybe_fail(self, phase: str, rnd: int, *,
                   member: Optional[int] = None) -> float:
        """Raise for an error-kind fault matching (phase, round, member);
        return the summed straggler delay otherwise."""
        delay = 0.0
        for idx, f in enumerate(self.faults):
            if f.kind == "poison" or f.phase != phase or f.round != rnd:
                continue
            if member is not None and f.member not in (-1, member):
                continue
            if not self._strike(idx):
                continue
            if f.kind == "straggler":
                delay += f.delay_s
            elif f.kind == "admit_oom":
                raise InjectedOOM(f"injected OOM: {phase} round {rnd}")
            else:
                raise InjectedLaunchError(
                    f"injected launch failure: {phase} round {rnd}")
        return delay

    def poison_slots(self, rnd: int, live: Sequence[int]) -> List[int]:
        """Decode rows whose logits this round's injected poison hits."""
        out: List[int] = []
        for idx, f in enumerate(self.faults):
            if f.kind != "poison" or f.phase != "decode" or f.round != rnd:
                continue
            slot = f.slot if f.slot >= 0 else (live[0] if live else -1)
            if slot in live and slot not in out and self._strike(idx):
                out.append(slot)
        return out

    def poisons_admit(self, rnd: int) -> bool:
        """Whether this admit round's packed prefill states come back
        NaN-corrupted."""
        for idx, f in enumerate(self.faults):
            if f.kind == "poison" and f.phase == "admit" \
                    and f.round == rnd and self._strike(idx):
                return True
        return False

    def on_launch(self, meta) -> None:
        """obs.launch hook: phase="launch" faults, matched on the
        sequential index of the launches this plan has seen."""
        idx = self._launch_calls
        self._launch_calls += 1
        for f_i, f in enumerate(self.faults):
            if f.phase == "launch" and f.round == idx and \
                    f.kind in ("launch_error", "admit_oom") and \
                    self._strike(f_i):
                raise InjectedLaunchError(
                    f"injected launch failure at launch #{idx} "
                    f"({meta.name})")


@contextlib.contextmanager
def install_launch_hook(plan: FaultPlan):
    """Register ``plan`` with obs.launch for the extent of the block."""
    from repro_torch.obs import launch as L

    prev = L.set_launch_hook(plan.on_launch)
    try:
        yield plan
    finally:
        L.set_launch_hook(prev)


class VirtualClock:
    """A monotone clock an engine or fleet can own: ``clock()`` reads it,
    ``clock.sleep(dt)`` advances it at once, so straggler delays,
    heartbeats and probation are deterministic."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float):
        if dt < 0.0:
            raise ValueError(f"clock cannot go back ({dt})")
        self.t += dt

    sleep = advance


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
