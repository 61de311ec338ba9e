"""Batched serving engine (port of ``repro/serve/engine.py``; the
reference's options that no caller here sets — deadlines, load shedding,
fifo admission, prompt buckets, the decode auto-mode's measured cost table
(``auto_cost_measure``) — are not ported).

A fixed batch of B slots, each with its own absolute position, so a
finished slot is refilled without draining the batch. Two step modes:

  split  every admit round prefills all its requests in ONE packed ragged
         launch per layer (``decode.packed_prefill``) and splices each
         request's KV rows into its slot; every decode round advances all
         live slots either in one packed launch per layer
         (``decode.decode_step_packed``) or in the lockstep full-cache
         einsum (``models.layers.decode_attention``), as ``decode_mode``
         says (below);
  fused  a round that admits requests does it together with advancing
         every live slot, in ONE mixed launch per layer
         (``decode.fused_step``); a round with nothing to admit is a split
         decode round.

Which requests ride together is cost-ordered: the oldest queued request
always rides, the remaining free slots alternate the lightest and heaviest
pending by tile count tri(ceil(S / block)).

Which path a decode round takes (``decode_mode``):

  auto      (the default, as in the reference) a cost crossover per round:
            with tiles[b] = ceil(kv_len_b / block) over the live slots,
            the round goes packed only when
            ratio * sum(tiles) < B * max(tiles), i.e. when lockstep's
            pad-to-max waste beats the packed round's premium a tile;
            otherwise lockstep. ``ratio`` is PACKED_TILE_COST_RATIO;
  packed    every round packed;
  lockstep  every round the full-cache einsum (plain impl only).

The lockstep einsum is the counterpart of the reference's XLA einsum and
no kernel, so "auto" with ``decode_impl="cuda"`` runs the packed kernel on
the rounds the rule sends packed and the einsum on the others: on the
card a round the rule sends lockstep (a batch without position skew)
decodes with no hand-written kernel. An explicit "lockstep" with impl
"cuda" is refused. The reference's decode ladder (packed -> lockstep) is
not ported: a failing packed round raises ``EngineStepError`` like any
other, and auto never re-runs it lockstep.

A NaN/Inf guard inspects every round's output. A poisoned admit round is
retried with bounded, seeded backoff and then walks the admit ladder
(``resilience.faults.LADDERS``), each transition counted in
``launches_degraded_total``:

  prefill_impl="torch"   packed -> sequential
  prefill_impl="cuda"    packed (no rung runs the plain version)

A poisoned fused round takes the rung step: fused -> split: its admits are
requeued at the head and the round re-runs through the split kernels. A
poisoned decode slot is quarantined and its request replayed from prompt
+ emitted tokens. Any other exception — a kernel's launch error, a failed
shape check, a fault a ``FaultPlan`` injects — is neither retried nor
degraded: it leaves ``run`` as an ``EngineStepError`` (with the round's
uncommitted admits back at the queue head), so a failing kernel never
hides behind the plain version. Every request that ``run`` returns ended
``done`` or ``failed`` (poisoned past the last rung).

An architecture with a recurrent layer (rwkv6) has no packed or fused
path: as in the reference, its admits are sequential and its decode
rounds lockstep, and with impl "cuda" both run the WKV kernel at L = 1,
so the kernel's ladder still holds no plain rung. Unlike the reference,
an admit first zeroes the slot's state (a retired request's state stays
in its slot, and a lockstep round advances every slot), prefills
prompt[:-1] on the slot's batch-1 view of the cache (no other slot's
state moves), and leaves the last token to the first decode round,
which applies it once. The reference applies it twice (ROADMAP C).

With ``escalate_step_errors`` (set by a ``Fleet`` on its replicas) a
poisoned output is not retried, degraded or quarantined either: it raises,
before the round commits, so the fleet can migrate the replica's requests.

Kernel builds happen at construction when an impl is "cuda", so a build
failure raises there; before that, an arch whose attention head dim no
forward kernel body takes is refused (head dims 16-128 and nemotron-4's
192 are served).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as DEV
from repro_torch.core import mapping as M
from repro_torch.kernels import build as BUILD
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as MET
from repro_torch.obs import schema as SCH
from repro_torch.obs import sinks as SK
from repro_torch.obs import trace as TR
from repro_torch.resilience import faults as F
from repro_torch.resilience import health as H
from repro_torch.serve import decode as D
from repro_torch.serve import kv_cache as KV

STATS_LOG_ROUNDS = 1024  # rounds kept by the stats ring logs
QUARANTINE_ROUNDS = 8    # decode rounds a poisoned slot sits out
# decode auto-mode: the packed round's cost a tile over lockstep's. 2.3 is
# the reference's figure, read on its CPU harness (bench_packed); the
# card's own crossover is measured by chip_smoke.py and kept in PERF.md,
# and the rule keeps the reference's constant
PACKED_TILE_COST_RATIO = 2.3
DECODE_MODES = ("auto", "packed", "lockstep")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    status: str = "queued"
    replays: int = 0
    error: Optional[str] = None

    @property
    def feed(self) -> np.ndarray:
        """Tokens to prefill on (re)admission: prompt + emitted tokens."""
        if not self.out:
            return self.prompt
        return np.concatenate([self.prompt,
                               np.asarray(self.out, np.int32)])


class EngineStepError(RuntimeError):
    """A round raised something other than a poisoned output (a kernel's
    launch error, a failed check, an injected fault). Never retried or
    degraded."""

    def __init__(self, phase: str, rnd: int, cause: BaseException):
        super().__init__(f"{phase} round {rnd} failed: "
                         f"{type(cause).__name__}: {cause}")
        self.phase, self.round, self.cause = phase, rnd, cause


def admit_ladder(prefill_mode: str, prefill_impl: str) -> Tuple[str, ...]:
    """The admit round's rungs, fastest first. The kernel's ladder holds
    no rung that runs the plain version."""
    if prefill_mode == "sequential":
        return ("sequential",)
    return ("packed",) if prefill_impl == "cuda" else ("packed", "sequential")


def _poison(states):
    """NaN copy of the float leaves of packed prefill states (an injected
    admit poison, landing where the finite guard looks)."""
    if isinstance(states, dict):
        return {k: _poison(v) for k, v in states.items()}
    return torch.full_like(states, float("nan"))


class Engine:
    """In-process engine; submit() then run() until drained."""

    IMPLS = ("cuda", "torch")

    def __init__(self, params, cfg, *, slots: int = 4, max_len: int = 512,
                 cache_dtype=torch.float32, temperature: float = 0.0,
                 seed: int = 0, prefill_mode: str = "packed",
                 prefill_block: int = 16, prefill_impl: str = "cuda",
                 decode_mode: str = "auto", decode_block: int = 16,
                 decode_impl: str = "cuda", step_mode: str = "split",
                 retry: Optional[F.RetryPolicy] = None,
                 fault_plan: Optional[F.FaultPlan] = None, clock=None,
                 escalate_step_errors: bool = False,
                 device=DEV.DEFAULT_DEVICE):
        if prefill_mode not in ("packed", "sequential"):
            raise ValueError(f"prefill_mode {prefill_mode!r}")
        if decode_mode not in DECODE_MODES:
            raise ValueError(f"decode_mode {decode_mode!r}")
        if step_mode not in ("split", "fused"):
            raise ValueError(f"step_mode {step_mode!r}")
        for impl in (prefill_impl, decode_impl):
            if impl not in self.IMPLS:
                raise ValueError(f"impl {impl!r}; known {self.IMPLS}")
        attn_only = all(k == "attn" for k in cfg.layer_kinds)
        if attn_only and (
                (prefill_mode, prefill_impl) == ("sequential", "cuda") or
                (decode_mode, decode_impl) == ("lockstep", "cuda")):
            raise ValueError("sequential prefill and lockstep decode run the "
                             "plain version: pass impl='torch' with them")
        for impl in (prefill_impl, decode_impl):
            T.check_kernel_head_dim(cfg, impl)
        if not D.traced_prefill_ok([max_len], prefill_block):
            raise ValueError(
                f"max_len {max_len} at block {prefill_block} exceeds the "
                f"traced map envelope (LTM_TRACED_MAX_LAM); the host-map "
                f"prefill is not ported")
        self.device = DEV.resolve(device)
        if "cuda" in (prefill_impl, decode_impl):
            if self.device.type != "cuda":
                raise ValueError("impl='cuda' needs device='cuda'; pass "
                                 "impl='torch' on the CPU")
            BUILD.build_all()
        # the constructor's arguments, which a snapshot rebuilds from;
        # retry, fault_plan, clock and escalation belong to the process
        self._init_kw = dict(
            slots=slots, max_len=max_len, cache_dtype=cache_dtype,
            temperature=temperature, seed=seed, prefill_mode=prefill_mode,
            prefill_block=prefill_block, prefill_impl=prefill_impl,
            decode_mode=decode_mode, decode_block=decode_block,
            decode_impl=decode_impl, step_mode=step_mode,
            device=str(self.device))
        self.params, self.cfg = params, cfg
        self.B, self.max_len = slots, max_len
        self.cache = MD.init_cache(cfg, slots, max_len, cache_dtype,
                                   self.device)
        self.pos = torch.zeros((slots,), dtype=torch.int32,
                               device=self.device)
        self.last_tok = torch.zeros((slots, 1), dtype=torch.int64,
                                    device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * slots
        self.remaining = np.zeros((slots,), np.int64)
        self.queue: List[Request] = []
        self.finished: List[Request] = []
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # recurrent state carries across a packed concatenation and has no
        # packed-member notion: such archs admit sequentially and decode in
        # lockstep, as the reference's engine does
        self._recurrent = not attn_only
        self.prefill_mode = prefill_mode if attn_only else "sequential"
        self.prefill_block = prefill_block
        self.prefill_impl = prefill_impl
        self._admit_stages = admit_ladder(self.prefill_mode, prefill_impl)
        self.decode_mode = decode_mode if attn_only else "lockstep"
        self.decode_impl = decode_impl
        self.step_mode = step_mode if attn_only else "split"
        self.s_cache = D._attn_cache_len(cfg, self.cache, max_len)
        self.decode_block = D.decode_block_for(decode_block, self.s_cache)
        if self.step_mode == "fused" and \
                not D.traced_prefill_ok([max_len], self.decode_block):
            raise ValueError(
                f"max_len {max_len} at the fused step's block "
                f"{self.decode_block} exceeds the traced map envelope")
        self.retry = retry if retry is not None else F.RetryPolicy(seed=seed)
        self.fault_plan = fault_plan
        self.clock = clock if clock is not None else time.monotonic
        self.escalate_step_errors = escalate_step_errors
        self.quarantined: Dict[int, int] = {}  # slot -> release round
        self._rolling = cfg.sliding_window is not None
        self._round_watch = H.RoundWatch()
        self._admit_round_idx = 0
        self._decode_round_idx = 0
        self.registry = MET.Registry("engine")
        self._admit_order_log = MET.RingLog(maxlen=STATS_LOG_ROUNDS)
        self._admit_round_tiles = MET.RingLog(maxlen=STATS_LOG_ROUNDS)
        self._failures = MET.RingLog(maxlen=STATS_LOG_ROUNDS)

    # -- telemetry -----------------------------------------------------------
    def _inc(self, name: str, value: int = 1):
        """Per-engine registry, mirrored globally as engine_<name>."""
        self.registry.counter_inc(name, value)
        MET.counter_inc("engine_" + name, value)

    def _inc_res(self, name: str, value: int = 1):
        """Resilience counters keep their canonical *_total names."""
        self.registry.counter_inc(name, value)
        MET.counter_inc(name, value)

    @property
    def stats(self) -> dict:
        """Read-only view of the registry-backed counters and logs."""
        st = {name: int(self.registry.counter_value(name))
              for name in SCH.ENGINE_COUNTERS + SCH.RESILIENCE_COUNTERS}
        st["admit_order_log"] = self._admit_order_log.items()
        st["admit_round_tiles"] = self._admit_round_tiles.items()
        st["admit_rounds_total"] = self._admit_order_log.total_appended
        st["admit_log_dropped"] = self._admit_order_log.dropped
        st["failures"] = self._failures.items()
        return st

    def report(self) -> Dict[int, dict]:
        """Per-request lifecycle report: status, tokens, replays, error."""
        reqs = (list(self.finished)
                + [r for r in self.slot_req if r is not None]
                + list(self.queue))
        return {r.uid: {"status": r.status, "tokens": len(r.out),
                        "replays": r.replays, "error": r.error}
                for r in reqs}

    # -- resilience plumbing -------------------------------------------------
    def _sleep(self, dt: float):
        """Advance an injectable clock (VirtualClock.sleep) or really
        sleep, capped by the retry policy."""
        if dt <= 0.0:
            return
        sleeper = getattr(self.clock, "sleep", None)
        if sleeper is not None:
            sleeper(dt)
        else:
            time.sleep(min(dt, self.retry.cap_s))

    def _fault(self, phase: str, rnd: int, **kw):
        """The fault plan's injection point: raises an injected error or
        sleeps a straggler's delay on the engine's clock."""
        if self.fault_plan is not None:
            self._sleep(self.fault_plan.maybe_fail(phase, rnd, **kw))

    def _finish(self, req: Request, status: str,
                error: Optional[str] = None):
        req.status = status
        req.done = True
        req.error = error
        self.finished.append(req)

    def _record_failure(self, req: Request, phase: str, rnd: int,
                        err: BaseException):
        msg = f"{type(err).__name__}: {err}"
        self._finish(req, "failed", error=msg)
        self._inc_res("requests_failed_total")
        self._failures.append({"uid": req.uid, "phase": phase,
                               "round": rnd, "error": msg})

    def _requeue(self, reqs: List[Request]):
        """Put a round's uncommitted admits back at the queue head."""
        for req in reqs:
            req.status = "queued"
        self.queue[0:0] = reqs

    def _degrade(self, phase: str, rnd: int, frm: str, to: str,
                 reason: str):
        """One rung down a declared ladder: counted and traced."""
        if not F.is_registered_transition(phase, frm, to):
            raise AssertionError(
                f"unregistered degradation {phase}: {frm} -> {to}")
        self._inc_res("launches_degraded_total")
        if SK.trace_enabled():
            SK.emit_event({"type": "degrade", "phase": phase, "from": frm,
                           "to": to, "round": rnd, "reason": reason[:200]})

    def _attempt(self, fn, n_affected: int):
        """One ladder stage; a poisoned output is retried with bounded,
        seeded backoff and re-raised once the retries are spent (at once
        on a fleet replica)."""
        for attempt in range(self.retry.max_retries + 1):
            try:
                return fn()
            except F.PoisonedOutput:
                if self.escalate_step_errors or \
                        attempt == self.retry.max_retries:
                    raise
                self._inc_res("requests_retried_total", n_affected)
                self._sleep(self.retry.delay(attempt))

    def _run_ladder(self, phase: str, rnd: int, stages, runner,
                    n_affected: int):
        """Walk ``stages`` fastest first: a stage whose output stays
        poisoned hands the round to the next one, and past the last one
        (or on a fleet replica) the PoisonedOutput propagates. Anything
        else raises EngineStepError at once."""
        for si, stage in enumerate(stages):
            try:
                return self._attempt(lambda: runner(stage), n_affected)
            except F.PoisonedOutput as e:
                if si + 1 == len(stages) or self.escalate_step_errors:
                    raise
                self._degrade(phase, rnd, stage, stages[si + 1],
                              reason=f"{type(e).__name__}: {e}")
            except Exception as e:  # noqa: BLE001 — surfaced, not absorbed
                raise EngineStepError(phase, rnd, e) from e

    # -- admission -----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new: int, uid: int):
        prompt = np.asarray(prompt, np.int32)
        if prompt.size == 0:
            raise ValueError(f"request {uid}: empty prompt")
        if prompt.size > self.max_len:
            raise ValueError(
                f"request {uid}: prompt of {prompt.size} tokens exceeds "
                f"max_len={self.max_len} — its KV splice would overflow "
                f"the slot cache (raise max_len or truncate)")
        self.queue.append(Request(uid, prompt, max_new))

    def _prefill_into_slot(self, slot: int, req: Request):
        """Sequential host-map prefill: run the request's feed through
        lockstep decode steps. Other slots' rows are rewritten at their
        own positions with their own last tokens, which is idempotent for
        attention caches (see models/layers.py). A recurrent arch takes
        ``_prefill_recurrent`` instead."""
        if self._recurrent:
            return self._prefill_recurrent(slot, req)
        toks = req.feed
        for t_idx, tok in enumerate(toks):
            self.last_tok[slot, 0] = int(tok)
            self.pos[slot] = t_idx
            MD.decode_step(self.params, self.cfg, self.cache, self.last_tok,
                           self.pos)
        self.slot_req[slot] = req
        self.remaining[slot] = req.max_new - len(req.out)
        self._inc("prefill_launches", len(toks))
        self._inc("prefill_requests")
        self._inc("prefill_tokens", len(toks))

    def _prefill_recurrent(self, slot: int, req: Request):
        """Admit into a recurrent arch's slot: zero the slot's state, run
        feed[:-1] through decode steps on the slot's batch-1 view of the
        cache (the in-place steps move no other slot), and leave feed[-1]
        to the next decode round, at position len(feed) - 1."""
        view = {name: {leaf: t[:, slot:slot + 1] for leaf, t in leaves.items()}
                for name, leaves in self.cache.items()}
        for leaves in view.values():
            for t in leaves.values():
                t.zero_()
        feed = req.feed
        toks = torch.as_tensor(feed, dtype=torch.int64, device=self.device)
        for t_idx in range(len(feed) - 1):
            MD.decode_step(self.params, self.cfg, view,
                           toks[t_idx:t_idx + 1, None], t_idx,
                           attn_impl=self.prefill_impl)
        self.last_tok[slot, 0] = int(feed[-1])
        self.pos[slot] = len(feed) - 1
        self.slot_req[slot] = req
        self.remaining[slot] = req.max_new - len(req.out)
        self._inc("prefill_launches", len(feed) - 1)
        self._inc("prefill_requests")
        self._inc("prefill_tokens", len(feed) - 1)

    def _admit_packed(self, pairs, rnd: int):
        """ONE packed prefill launch per layer for every (slot, request)
        pair, then per-slot KV splicing, committed only after the output
        guard passes."""
        self._fault("admit", rnd)
        prompts = [req.feed for _, req in pairs]
        with TR.span("engine.admit_batch", requests=len(pairs)) as sp:
            _, starts, lens, _, states = D.packed_prefill(
                self.params, self.cfg, prompts, block=self.prefill_block,
                attn_impl=self.prefill_impl, device=self.device)
            sp.attach(states["l0"]["k"])
        if self.fault_plan is not None and self.fault_plan.poisons_admit(rnd):
            states = _poison(states)
        if not D.states_finite(states):
            raise F.PoisonedOutput(
                f"admit round {rnd}: non-finite packed prefill states")
        self._inc("prefill_launches")
        self._inc("prefill_requests", len(pairs))
        self._inc("prefill_tokens", sum(lens))
        for (slot, req), start, length in zip(pairs, starts, lens):
            KV.splice_slot(self.cache, slot, states, start, length,
                           rolling=self._rolling)
            self.last_tok[slot, 0] = int(req.feed[-1])
            self.pos[slot] = length - 1
            self.slot_req[slot] = req
            self.remaining[slot] = req.max_new - len(req.out)

    def _prefill_tiles(self, req: Request) -> int:
        """Packed-prefill cost of one request: tri(ceil(S / block))."""
        return M.tri(-(-len(req.feed) // self.prefill_block))

    def _pick_requests(self, take: int) -> List[Request]:
        """Pop ``take`` queued requests: the oldest always rides, then the
        lightest / heaviest pending alternate."""
        tiles = [self._prefill_tiles(r) for r in self.queue]
        heavy = iter(sorted(range(len(tiles)), key=lambda i: (-tiles[i], i)))
        light = iter(sorted(range(len(tiles)), key=lambda i: (tiles[i], i)))
        picked, used = [0], {0}
        for t in range(take - 1):
            ends = light if t % 2 == 0 else heavy
            i = next(j for j in ends if j not in used)
            picked.append(i)
            used.add(i)
        reqs = [self.queue[i] for i in picked]
        for i in sorted(picked, reverse=True):
            self.queue.pop(i)
        return reqs

    def _release_quarantine(self):
        rnd = self._decode_round_idx
        for slot in [s for s, rel in list(self.quarantined.items())
                     if rnd >= rel]:
            del self.quarantined[slot]
        if self.queue and self.quarantined \
                and not any(r is not None for r in self.slot_req) \
                and len(self.quarantined) >= self.B:
            first = min(self.quarantined,
                        key=lambda s: (self.quarantined[s], s))
            del self.quarantined[first]

    def _take_admits(self):
        """Pop this round's admits, one per free slot: (slot, request)
        pairs, or [] when nothing can be admitted."""
        self._release_quarantine()
        free = [s for s in range(self.B) if self.slot_req[s] is None
                and s not in self.quarantined]
        take = min(len(free), len(self.queue))
        if not take:
            return []
        reqs = self._pick_requests(take)
        for req in reqs:
            req.status = "running"
        return list(zip(free, reqs))

    def _log_admits(self, reqs: List[Request]):
        self._inc("admit_rounds")
        self._admit_order_log.append(
            [(r.uid, self._prefill_tiles(r)) for r in reqs])
        self._admit_round_tiles.append(
            sum(self._prefill_tiles(r) for r in reqs))

    def _admit(self):
        pairs = self._take_admits()
        if not pairs:
            return
        self._log_admits([req for _, req in pairs])
        rnd = self._admit_round_idx
        self._admit_round_idx += 1

        def runner(stage):
            if stage == "packed":
                return self._admit_packed(pairs, rnd)
            for member, (slot, req) in enumerate(pairs):
                self._fault("admit", rnd, member=member)
                self._prefill_into_slot(slot, req)

        def uncommitted():
            return [req for slot, req in pairs if self.slot_req[slot] is not req]

        try:
            self._run_ladder("admit", rnd, self._admit_stages, runner,
                             n_affected=len(pairs))
        except F.PoisonedOutput as e:
            if self.escalate_step_errors:
                self._requeue(uncommitted())
                raise
            for slot, req in pairs:
                if self.slot_req[slot] is req:
                    self.slot_req[slot] = None
                self._record_failure(req, "admit", rnd, e)
        except EngineStepError:
            self._requeue(uncommitted())
            raise

    # -- decode loop ---------------------------------------------------------
    def _round_mode(self, tiles: List[int]) -> str:
        """The decode round's path: "packed" or "lockstep" (see the module
        docstring's cost rule for "auto")."""
        if self.decode_mode != "auto":
            return self.decode_mode
        return ("packed" if PACKED_TILE_COST_RATIO * sum(tiles)
                < self.B * max(tiles) else "lockstep")

    def _decode_round(self, live, kv_lens, rnd: int, mode: str):
        self._fault("decode", rnd)
        with TR.span("engine.decode_round", mode=mode,
                     live=len(live)) as sp:
            if mode == "packed":
                logits, cache, _ = D.decode_step_packed(
                    self.params, self.cfg, self.cache, self.last_tok,
                    self.pos, kv_lens, live, block=self.decode_block,
                    impl=self.decode_impl)
            else:
                logits, cache = MD.decode_step(self.params, self.cfg,
                                               self.cache, self.last_tok,
                                               self.pos,
                                               attn_impl=self.decode_impl)
            sp.attach(logits)
        return logits, cache

    def _guard_decode(self, logits, live, rnd: int) -> List[int]:
        """Live slots whose logits are non-finite (an injected poison
        lands where this guard looks); on a fleet replica any raises
        before the round commits."""
        logits_np = logits.float().cpu().numpy()
        if self.fault_plan is not None:
            for s in self.fault_plan.poison_slots(rnd, live):
                logits_np[s] = np.nan
        bad = D.poisoned_slots(logits_np, live)
        if bad and self.escalate_step_errors:
            raise F.PoisonedOutput(
                f"decode round {rnd}: non-finite logits in slots {bad}")
        return bad

    def _quarantine(self, bad: List[int], rnd: int):
        """Free each poisoned slot for QUARANTINE_ROUNDS rounds and replay
        its request, prefilled on prompt + emitted tokens, first."""
        replays: List[Request] = []
        for slot in bad:
            req = self.slot_req[slot]
            self.slot_req[slot] = None
            self.quarantined[slot] = rnd + 1 + QUARANTINE_ROUNDS
            req.replays += 1
            replays.append(req)
            self._inc_res("slots_quarantined_total")
            if SK.trace_enabled():
                SK.emit_event({"type": "quarantine", "slot": slot,
                               "uid": req.uid, "round": rnd,
                               "reason": "nonfinite_logits"})
        self._requeue(replays)

    def _emit(self, slot: int, tok: int, pos: int):
        """Append a sampled token to the slot's request; retire it when
        its budget or the cache is spent."""
        req = self.slot_req[slot]
        req.out.append(int(tok))
        self.remaining[slot] -= 1
        if self.remaining[slot] <= 0 or pos >= self.max_len - 1:
            self._finish(req, "done")
            self.slot_req[slot] = None

    def step(self):
        """One decode round across all live slots, packed or lockstep as
        ``_round_mode`` picks; logits pass the NaN/Inf guard before any
        token is committed."""
        live = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not live:
            return
        pos_np = self.pos.cpu().numpy()
        kv_lens = [int(min(pos_np[s] + 1, self.s_cache)) for s in live]
        tiles = [-(-kl // self.decode_block) for kl in kv_lens]
        mode = self._round_mode(tiles)
        self._inc("decode_rounds")
        self._inc("decode_tiles_packed", sum(tiles))
        self._inc("decode_tiles_padded", len(live) * max(tiles))
        rnd = self._decode_round_idx
        self._decode_round_idx += 1
        t0 = float(self.clock())
        try:
            logits, cache = self._decode_round(live, kv_lens, rnd, mode)
        except Exception as e:  # noqa: BLE001 — surfaced, not absorbed
            raise EngineStepError("decode", rnd, e) from e
        self._inc("decode_packed_launches" if mode == "packed"
                  else "decode_lockstep_launches")
        if self._round_watch.observe(float(self.clock()) - t0):
            self._inc_res("rounds_straggler_total")
        logits = logits[:, 0]
        bad = self._guard_decode(logits, live, rnd)
        self._quarantine(bad, rnd)
        nxt = D.sample_logits(logits, temperature=self.temperature,
                              vocab_size=self.cfg.vocab_size,
                              generator=self.generator)
        self.cache = cache
        adv = np.zeros((self.B,), np.int32)
        adv[[s for s in live if s not in bad]] = 1
        self.pos += torch.as_tensor(adv, device=self.device)
        self.last_tok = nxt[:, None].to(torch.int64)
        pos_np, nxt_np = self.pos.cpu().numpy(), nxt.cpu().numpy()
        for slot in live:
            if self.slot_req[slot] is not None:
                self._emit(slot, nxt_np[slot], int(pos_np[slot]))

    # -- fused continuous batching -------------------------------------------
    def step_fused(self):
        """One FUSED round: admit every queued request a free slot can take
        AND advance every live slot, in ONE mixed launch per layer
        (decode.fused_step). Rounds with nothing to admit are split decode
        rounds (step()), one packed decode launch per layer.

        A poisoned output takes the rung step: fused -> split: the admits
        are requeued at the head and the round re-runs through the split
        kernels (greedy tokens are the same either way). Any other
        exception requeues the admits and raises EngineStepError."""
        pairs = self._take_admits()
        if not pairs:
            return self.step()
        reqs = [req for _, req in pairs]
        a_rnd, d_rnd = self._admit_round_idx, self._decode_round_idx
        live = [s for s in range(self.B) if self.slot_req[s] is not None]
        pos_np = self.pos.cpu().numpy()
        kv_lens = [int(min(pos_np[s] + 1, self.s_cache)) for s in live]
        self._inc("fused_rounds")
        try:
            self._fault("admit", a_rnd)
            if live:
                self._fault("decode", d_rnd)
            with TR.span("engine.fused_step", requests=len(pairs),
                         live=len(live)) as sp:
                (logits_admit, logits_dec, cache, states, _, starts, lens,
                 info) = D.fused_step(
                    self.params, self.cfg, self.cache,
                    [req.feed for req in reqs], self.last_tok, self.pos,
                    kv_lens, live, block=self.decode_block,
                    impl=self.decode_impl)
                sp.attach(logits_dec)
            if self.fault_plan is not None and \
                    self.fault_plan.poisons_admit(a_rnd):
                states = _poison(states)
            if not D.states_finite(states):
                raise F.PoisonedOutput(
                    f"fused round {d_rnd}: non-finite packed states")
        except F.PoisonedOutput as e:
            self._inc("fused_fallbacks")
            self._degrade("step", d_rnd, "fused", "split",
                          reason=f"{type(e).__name__}: {e}")
            self._requeue(reqs)
            self._admit()
            self.step()
            return
        except Exception as e:  # noqa: BLE001 — surfaced, not absorbed
            self._requeue(reqs)
            raise EngineStepError("fused", d_rnd, e) from e
        # commit, in the split order: admit splice, then decode
        self._admit_round_idx += 1
        self._decode_round_idx += 1
        self._log_admits(reqs)
        self._inc("fused_launches")
        self._inc("fused_tiles", info["tiles"])
        self._inc("prefill_requests", len(pairs))
        self._inc("prefill_tokens", sum(lens))
        if live:
            self._inc("decode_rounds")
        self.cache = cache
        for (slot, req), start, length in zip(pairs, starts, lens):
            KV.splice_slot(self.cache, slot, states, start, length,
                           rolling=self._rolling)
            self.slot_req[slot] = req
            self.remaining[slot] = req.max_new - len(req.out)
        bad = self._guard_decode(logits_dec, live, d_rnd)
        self._quarantine(bad, d_rnd)
        # the decode tokens are drawn first, then the admits' first tokens
        kw = dict(temperature=self.temperature,
                  vocab_size=self.cfg.vocab_size, generator=self.generator)
        nxt = D.sample_logits(logits_dec, **kw).cpu().numpy()
        adm = D.sample_logits(logits_admit, **kw).cpu().numpy()
        new_pos = pos_np.copy()
        new_last = self.last_tok.cpu().numpy().copy()
        for slot in live:
            if slot not in bad:
                new_pos[slot] += 1
                new_last[slot, 0] = nxt[slot]
                self._emit(slot, nxt[slot], int(new_pos[slot]))
        for (slot, _), length, tok in zip(pairs, lens, adm):
            new_pos[slot] = length  # the sampled token's position
            new_last[slot, 0] = tok
            self._emit(slot, tok, length)
        self.pos = torch.as_tensor(new_pos, device=self.device)
        self.last_tok = torch.as_tensor(new_last, device=self.device)

    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slot_req)

    def round(self):
        """ONE scheduling round, the unit a fleet advances a replica by: a
        fused step, or a split admit + decode pair."""
        if self.step_mode == "fused":
            self._release_quarantine()
            if not self.idle():
                self.step_fused()
            return
        self._admit()
        self.step()

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive rounds until drained (or max_steps rounds). Returns
        {uid: tokens} for every request that reached a terminal state (see
        report() for statuses); raises EngineStepError when a round raised
        anything but a poisoned output."""
        for _ in range(max_steps):
            if self.idle():
                break
            self.round()
        return {r.uid: r.out for r in self.finished}

    # -- crash safety --------------------------------------------------------
    def snapshot(self):
        """The engine's state as an EngineSnapshot
        (resilience/snapshot.py)."""
        from repro_torch.resilience import snapshot as SNAP

        return SNAP.snapshot(self)

    @classmethod
    def restore(cls, snap, **overrides):
        """Rebuild an engine from an EngineSnapshot; run() resumes
        token-identically (see resilience/snapshot.restore)."""
        from repro_torch.resilience import snapshot as SNAP

        return SNAP.restore(snap, **overrides)
