"""Fleet front end: N engine replicas, tile-cost routing, deterministic
failover (port of ``repro/serve/fleet.py``).

A request of S prompt tokens costs tri(ceil(S / block)) tiles in its admit
round's packed grid. The fleet routes each request to the replica with
the fewest outstanding tiles (queued + in-flight), so per-replica tile
totals stay within one maximal request of each other, and each replica's
queue head still rides its next admit round.

Failover. Each replica runs with ``escalate_step_errors=True``: a poisoned
output raises instead of being retried or quarantined in place, and an
injected fault leaves its round as an ``EngineStepError``. The fleet fails
over on exactly these: an injected ``InjectedLaunchError`` or
``InjectedOOM``, a ``PoisonedOutput``, an ``EngineStepError`` caused by
one of them, and a round that outlasts the heartbeat budget (a
straggler). Any other exception — a real kernel error — propagates out of
``Fleet.run``. On failover the fleet (1) snapshots the victim, (2) moves
its finished requests into the fleet's terminal set and migrates its
in-flight (slot order) then queued requests to the least-loaded healthy
replica's queue head, and (3) parks the victim, emptied
(``strip_for_restart``, round indices and generator kept), for a
probation window; should the victim's own snapshot fail, the fleet
salvages from the periodic one it takes of each working replica every
``snapshot_every`` fleet rounds. Since ``Request.feed`` is prompt +
tokens already emitted and greedy decoding is deterministic, the peer
re-prefills the exact pre-fault state with the same kernels: the final
token streams equal a fault-free single engine's. A circuit breaker
stretches the window to ``probation_rounds`` after ``breaker_k``
consecutive faulted rounds; with no healthy replica left the victim is
restored at once.

Every transition is a counted metric (schema.FLEET_COUNTERS /
FLEET_GAUGES) and a trace event (``failover``, ``engine_quarantine``,
``rebalance``) checked against ``faults.LADDERS``. Everything runs off one
shared clock, a ``VirtualClock`` by default, so a faulted fleet run
replays exactly.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import mapping as M
from repro_torch.obs import metrics as MET
from repro_torch.obs import schema as SCH
from repro_torch.obs import sinks as SK
from repro_torch.resilience import faults as F
from repro_torch.resilience import health as H
from repro_torch.resilience import snapshot as SNAP
from repro_torch.serve.engine import Engine, EngineStepError, Request

# Registered fleet transitions -> the trace event each emits.
TRANSITION_EVENTS: Dict[Tuple[str, str, str], str] = {
    ("engine", "active", "quarantined"): "engine_quarantine",
    ("engine", "quarantined", "restored"): "rebalance",
    ("route", "primary", "failover"): "failover",
}


def failover_cause(err: BaseException) -> bool:
    """True for the faults a fleet fails over on: injected ones and
    poisoned outputs, raised directly or as an EngineStepError's cause."""
    if isinstance(err, EngineStepError):
        err = err.cause
    return isinstance(err, (F.InjectedLaunchError, F.InjectedOOM,
                            F.PoisonedOutput))


class Fleet:
    """N engine replicas behind tile-cost routing with deterministic
    failover; submit() then run() until drained, like one Engine."""

    def __init__(self, params, cfg, *, engines: int = 2,
                 engine_kw: Optional[dict] = None, clock=None,
                 fault_plan: Optional[F.FaultPlan] = None,
                 heartbeat_timeout_s: float = 60.0, snapshot_every: int = 4,
                 breaker_k: int = 3, probation_rounds: int = 8,
                 max_fleet_tiles: int = 0):
        if engines < 1 or breaker_k < 1 or probation_rounds < 1:
            raise ValueError("a fleet needs engines, breaker_k and "
                             "probation_rounds >= 1")
        self.params, self.cfg = params, cfg
        self.n = engines
        self.clock = clock if clock is not None else F.VirtualClock()
        self.engine_kw = dict(engine_kw or {})
        # each replica's faults, with strike bookkeeping that survives its
        # restores: a consumed fault never re-fires
        self._plans: Dict[int, Optional[F.FaultPlan]] = {
            e: fault_plan.for_engine(e) if fault_plan is not None else None
            for e in range(engines)}
        self.engines: List[Optional[Engine]] = [
            Engine(params, cfg, fault_plan=self._plans[e], clock=self.clock,
                   escalate_step_errors=True, **self.engine_kw)
            for e in range(engines)]
        self.monitor = H.HeartbeatMonitor(range(engines),
                                          timeout_s=heartbeat_timeout_s)
        self.watches = {e: H.RoundWatch() for e in range(engines)}
        # engine -> its latest periodic snapshot (snapshot_every 0: none)
        self.snapshot_every = snapshot_every
        self._snaps: Dict[int, SNAP.EngineSnapshot] = {}
        self.breaker_k = breaker_k
        self.probation_rounds = probation_rounds
        self.max_fleet_tiles = max_fleet_tiles
        # engine -> (emptied snapshot, fleet round it may restore at)
        self._pending_restore: Dict[int, Tuple[SNAP.EngineSnapshot,
                                               int]] = {}
        self._consecutive = {e: 0 for e in range(engines)}
        # requests the fleet holds terminally (a victim's finished ones,
        # fleet-shed ones); disjoint from every live engine's requests
        self._terminal: List[Request] = []
        self._round = 0
        self.registry = MET.Registry("fleet")
        self.quarantine_log: List[dict] = []
        self._set_quarantine_gauge()

    # -- telemetry -----------------------------------------------------------
    def _inc(self, name: str, value: int = 1,
             engine: Optional[int] = None):
        labels = None if engine is None else {"engine": str(engine)}
        self.registry.counter_inc(name, value, labels)
        MET.counter_inc(name, value, labels)

    def _set_quarantine_gauge(self):
        n = len(self._pending_restore)
        self.registry.gauge_set("engines_quarantined", n)
        MET.gauge_set("engines_quarantined", n)

    @property
    def stats(self) -> dict:
        st = {name: int(self.registry.counter_total(name))
              for name in SCH.FLEET_COUNTERS}
        st["engines_quarantined"] = int(self.registry.gauge_value(
            "engines_quarantined", default=0))
        st["rounds"] = self._round
        st["quarantine_log"] = list(self.quarantine_log)
        return st

    def _transition(self, phase: str, frm: str, to: str, payload: dict):
        """The one gate of every fleet lifecycle move: checked against
        LADDERS and emitted as its trace event."""
        if not F.is_registered_transition(phase, frm, to):
            raise AssertionError(
                f"unregistered fleet transition {phase}: {frm} -> {to}")
        if SK.trace_enabled():
            SK.emit_event({"type": TRANSITION_EVENTS[(phase, frm, to)],
                           **payload})

    # -- routing -------------------------------------------------------------
    def _outstanding_tiles(self, eng: Engine) -> int:
        reqs = list(eng.queue) + [r for r in eng.slot_req if r is not None]
        return sum(eng._prefill_tiles(r) for r in reqs)

    def _live(self) -> List[int]:
        return [e for e in range(self.n) if self.engines[e] is not None]

    def _least_loaded(self, candidates) -> int:
        return min(candidates, key=lambda e: (
            self._outstanding_tiles(self.engines[e]), e))

    def submit(self, prompt: np.ndarray, max_new: int, uid: int,
               deadline_s: Optional[float] = None):
        """Route to the live replica with the fewest outstanding tiles
        (ties to the lowest index), with its deadline. The replica may
        shed at its own ``max_queue_tiles`` first; the fleet then sheds
        at ``max_fleet_tiles``."""
        if not self._live():
            self._restore_due(force=True)
        target = self._least_loaded(self._live())
        eng = self.engines[target]
        eng.submit(prompt, max_new, uid, deadline_s=deadline_s)
        tiles = M.tri(-(-int(np.asarray(prompt).size) // eng.prefill_block))
        self._inc("fleet_requests_routed_total", engine=target)
        self._inc("fleet_routed_tiles_total", tiles, engine=target)
        self._shed_fleet_overload()

    def _shed_fleet_overload(self):
        """While the fleet's queued tiles exceed ``max_fleet_tiles``, shed
        the heaviest request that is no replica's queue head."""
        if not self.max_fleet_tiles:
            return
        while True:
            live = self._live()
            total = sum(self.engines[e]._prefill_tiles(r)
                        for e in live for r in self.engines[e].queue)
            candidates = [(self.engines[e]._prefill_tiles(r), e, i)
                          for e in live
                          for i, r in enumerate(self.engines[e].queue)
                          if i > 0]
            if total <= self.max_fleet_tiles or not candidates:
                return
            _, e, i = max(candidates)
            victim = self.engines[e].queue.pop(i)
            victim.status, victim.done = "shed", True
            victim.error = (f"fleet shed: queued tiles over "
                            f"{self.max_fleet_tiles}; heaviest non-head")
            self._terminal.append(victim)
            self._inc("fleet_requests_shed_total", engine=e)

    # -- drive loop ----------------------------------------------------------
    def tick(self):
        """One fleet round: restore replicas whose probation elapsed, then
        advance every live replica one engine round."""
        if self._pending_restore:
            self._restore_due(force=not self._live())
        for e in range(self.n):
            eng = self.engines[e]
            if eng is not None:
                self._drive(e, eng)
        self._round += 1

    def _drive(self, e: int, eng: Engine):
        working = not eng.idle()
        t0 = float(self.clock())
        self.monitor.beat(e, self._round, now=t0)
        try:
            eng.round()
        except Exception as err:  # noqa: BLE001 — only injected faults
            if not failover_cause(err):
                raise
            self._on_engine_fault(e, eng, f"{type(err).__name__}: {err}")
            return
        now = float(self.clock())
        if working and self.watches[e].observe(now - t0):
            self._inc("fleet_rounds_straggler_total", engine=e)
        if e in self.monitor.failed(now=now):
            # the round committed, but took longer than the liveness
            # budget: the replica counts as dead and its work migrates
            self._on_engine_fault(e, eng, (
                f"heartbeat timeout: round took {now - t0:.3f}s > "
                f"{self.monitor.timeout_s}s"))
            return
        if working:
            self._consecutive[e] = 0
            if self.snapshot_every and \
                    self._round % self.snapshot_every == 0:
                self._snaps[e] = SNAP.snapshot(eng)

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive the fleet until drained and every parked replica is back.
        Returns {uid: tokens} for every terminal request."""
        for _ in range(max_steps):
            if self._drained() and not self._pending_restore:
                break
            self.tick()
        return self.results()

    def _drained(self) -> bool:
        return all(eng is None or eng.idle() for eng in self.engines)

    # -- failover ------------------------------------------------------------
    def _on_engine_fault(self, e: int, eng: Engine, reason: str):
        """Snapshot the victim, salvage its finished requests, migrate the
        rest to a healthy replica, park the victim for its probation."""
        self._consecutive[e] += 1
        consec = self._consecutive[e]
        try:
            snap = SNAP.snapshot(eng)
        except Exception:  # noqa: BLE001 — salvage from the periodic one
            snap = self._snaps.get(e)
            if snap is None:
                raise
        window = self.probation_rounds if consec >= self.breaker_k else 1
        self.engines[e] = None
        self._pending_restore[e] = (SNAP.strip_for_restart(snap),
                                    self._round + window)
        self._set_quarantine_gauge()
        self.quarantine_log.append(
            {"engine": e, "round": self._round, "consecutive": consec,
             "probation_rounds": window, "reason": reason})
        self._transition(
            "engine", "active", "quarantined",
            {"engine": e, "round": self._round, "consecutive": consec,
             "probation_rounds": window, "reason": reason[:200]})
        # ages are rebased as Engine.restore does, so deadlines keep
        # measuring elapsed age across the move
        shift, at = float(self.clock()) - snap.clock_now, snap.clock_now
        self._terminal.extend(SNAP._req_from_dict(d, shift, at)
                              for d in snap.finished)
        inflight = [SNAP._req_from_dict(d, shift, at) for d in snap.slot_req
                    if d is not None]
        for r in inflight:
            r.replays += 1
        moved = inflight + [SNAP._req_from_dict(d, shift, at)
                            for d in snap.queue]
        for r in moved:
            r.status, r.done = "queued", False
        live = self._live()
        if not live:
            # no healthy peer: restore this replica now (liveness beats
            # probation) and migrate to it
            self._restore_engine(e)
            live = [e]
        target = self._least_loaded(live)
        self.engines[target].queue[0:0] = moved
        self._inc("fleet_failovers_total", engine=e)
        self._inc("fleet_requests_migrated_total", len(moved), engine=e)
        self._transition(
            "route", "primary", "failover",
            {"engine": e, "target": target, "round": self._round,
             "migrated": len(moved), "reason": reason[:200]})
        self._shed_fleet_overload()

    def _restore_due(self, force: bool = False):
        for e in sorted(self._pending_restore):
            if force or self._round >= self._pending_restore[e][1]:
                self._restore_engine(e)
                force = False  # liveness needs ONE replica back, not all

    def _restore_engine(self, e: int):
        snap, _ = self._pending_restore.pop(e)
        self.engines[e] = SNAP.restore(
            snap, params=self.params, fault_plan=self._plans[e],
            clock=self.clock, escalate_step_errors=True)
        self._set_quarantine_gauge()
        self._inc("fleet_engine_restores_total", engine=e)
        self._transition("engine", "quarantined", "restored",
                         {"engine": e, "round": self._round,
                          "reason": "probation_elapsed"})

    # -- results -------------------------------------------------------------
    def results(self) -> Dict[int, List[int]]:
        res = {r.uid: list(r.out) for r in self._terminal}
        for eng in self.engines:
            if eng is not None:
                res.update({r.uid: r.out for r in eng.finished})
        return res

    def report(self) -> Dict[int, dict]:
        """Per-request lifecycle report across the fleet: every submitted
        request appears exactly once, with the engine holding it (None for
        fleet-held terminal requests)."""
        rep: Dict[int, dict] = {}
        for r in self._terminal:
            rep[r.uid] = {"status": r.status, "tokens": len(r.out),
                          "replays": r.replays, "error": r.error,
                          "engine": None}
        for e, eng in enumerate(self.engines):
            if eng is None:
                continue
            for uid, entry in eng.report().items():
                if uid in rep:
                    raise AssertionError(
                        f"request {uid} reported by engine {e} and the "
                        "fleet: failover double-accounted it")
                rep[uid] = dict(entry, engine=e)
        return rep
