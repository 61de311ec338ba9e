"""Batched serving engine, split mode (port of ``repro/serve/engine.py``;
the fused step, snapshot/restore, the fleet and the reference's options
that no caller here sets — deadlines, load shedding, fifo admission,
prompt buckets, the decode auto-mode — are not ported yet).

A fixed batch of B slots, each with its own absolute position, so a
finished slot is refilled without draining the batch. Every admit round
prefills all its requests in ONE packed ragged launch per layer
(``decode.packed_prefill``) and splices each request's KV rows into its
slot; every decode round advances all live slots in one packed launch per
layer (``decode.decode_step_packed``), or, with the plain impl only, in
the lockstep full-cache einsum. Which requests ride together is
cost-ordered: the oldest queued request always rides, the remaining free
slots alternate the lightest and heaviest pending by tile count
tri(ceil(S / block)).

A NaN/Inf guard inspects every round's output. A poisoned admit round is
retried with bounded, seeded backoff and then walks the admit ladder
(``resilience.faults.LADDERS``), each transition counted in
``launches_degraded_total``:

  prefill_impl="torch"   packed -> sequential
  prefill_impl="cuda"    packed (no rung runs the plain version)

A poisoned decode slot is quarantined and its request replayed from
prompt + emitted tokens. Any other exception — a kernel's launch error, a
failed shape check — is neither retried nor degraded: it leaves ``run``
as an ``EngineStepError``, so a failing kernel never hides behind the
plain version. Every request that ``run`` returns ended ``done`` or
``failed`` (poisoned past the last rung).

Kernel builds happen at construction when an impl is "cuda", so a build
failure raises there.
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
    launch error, a failed check). Never retried or degraded."""

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


class Engine:
    """In-process engine; submit() then run() until drained."""

    IMPLS = ("cuda", "torch")

    def __init__(self, params, cfg, *, slots: int = 4, max_len: int = 512,
                 cache_dtype=torch.float32, temperature: float = 0.0,
                 seed: int = 0, prefill_mode: str = "packed",
                 prefill_block: int = 16, prefill_impl: str = "cuda",
                 decode_mode: str = "packed", decode_block: int = 16,
                 decode_impl: str = "cuda",
                 retry: Optional[F.RetryPolicy] = None,
                 device=DEV.DEFAULT_DEVICE):
        if prefill_mode not in ("packed", "sequential"):
            raise ValueError(f"prefill_mode {prefill_mode!r}")
        if decode_mode not in ("packed", "lockstep"):
            raise ValueError(f"decode_mode {decode_mode!r}")
        for impl in (prefill_impl, decode_impl):
            if impl not in self.IMPLS:
                raise ValueError(f"impl {impl!r}; known {self.IMPLS}")
        if (prefill_mode, prefill_impl) == ("sequential", "cuda") or \
                (decode_mode, decode_impl) == ("lockstep", "cuda"):
            raise ValueError("sequential prefill and lockstep decode run the "
                             "plain version: pass impl='torch' with them")
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
        self.prefill_block = prefill_block
        self.prefill_impl = prefill_impl
        self._admit_stages = admit_ladder(prefill_mode, prefill_impl)
        self.decode_mode = decode_mode
        self.decode_impl = decode_impl
        self.s_cache = D._attn_cache_len(cfg, self.cache)
        self.decode_block = D.decode_block_for(decode_block, self.s_cache)
        self.retry = retry if retry is not None else F.RetryPolicy(seed=seed)
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
    _COUNTERS = ("prefill_launches", "prefill_requests", "prefill_tokens",
                 "admit_rounds", "decode_rounds", "decode_packed_launches",
                 "decode_lockstep_launches", "decode_tiles_packed",
                 "decode_tiles_padded")

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
              for name in self._COUNTERS}
        for name in SCH.RESILIENCE_COUNTERS:
            st[name] = int(self.registry.counter_value(name))
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
        seeded backoff and re-raised once the retries are spent."""
        for attempt in range(self.retry.max_retries + 1):
            try:
                return fn()
            except F.PoisonedOutput:
                if attempt == self.retry.max_retries:
                    raise
                self._inc_res("requests_retried_total", n_affected)
                time.sleep(self.retry.delay(attempt))

    def _run_ladder(self, phase: str, rnd: int, stages, runner,
                    n_affected: int):
        """Walk ``stages`` fastest first: a stage whose output stays
        poisoned hands the round to the next one, and past the last one
        the PoisonedOutput propagates. Anything else raises
        EngineStepError at once."""
        for si, stage in enumerate(stages):
            try:
                return self._attempt(lambda: runner(stage), n_affected)
            except F.PoisonedOutput as e:
                if si + 1 == len(stages):
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
        attention caches (see models/layers.py)."""
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

    def _admit_packed(self, pairs, rnd: int):
        """ONE packed prefill launch per layer for every (slot, request)
        pair, then per-slot KV splicing, committed only after the output
        guard passes."""
        prompts = [req.feed for _, req in pairs]
        with TR.span("engine.admit_batch", requests=len(pairs)) as sp:
            _, starts, lens, _, states = D.packed_prefill(
                self.params, self.cfg, prompts, block=self.prefill_block,
                attn_impl=self.prefill_impl, device=self.device)
            sp.attach(states["l0"]["k"])
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

    def _admit(self):
        self._release_quarantine()
        free = [s for s in range(self.B) if self.slot_req[s] is None
                and s not in self.quarantined]
        take = min(len(free), len(self.queue))
        if not take:
            return
        reqs = self._pick_requests(take)
        pairs = list(zip(free, reqs))
        for req in reqs:
            req.status = "running"
        self._inc("admit_rounds")
        self._admit_order_log.append(
            [(r.uid, self._prefill_tiles(r)) for r in reqs])
        self._admit_round_tiles.append(
            sum(self._prefill_tiles(r) for r in reqs))
        rnd = self._admit_round_idx
        self._admit_round_idx += 1

        def runner(stage):
            if stage == "packed":
                return self._admit_packed(pairs, rnd)
            for slot, req in pairs:
                self._prefill_into_slot(slot, req)

        try:
            self._run_ladder("admit", rnd, self._admit_stages, runner,
                             n_affected=len(pairs))
        except F.PoisonedOutput as e:
            for slot, req in pairs:
                if self.slot_req[slot] is req:
                    self.slot_req[slot] = None
                self._record_failure(req, "admit", rnd, e)

    # -- decode loop ---------------------------------------------------------
    def _decode_round(self, live, kv_lens):
        with TR.span("engine.decode_round", mode=self.decode_mode,
                     live=len(live)) as sp:
            if self.decode_mode == "packed":
                logits, cache, _ = D.decode_step_packed(
                    self.params, self.cfg, self.cache, self.last_tok,
                    self.pos, kv_lens, live, block=self.decode_block,
                    impl=self.decode_impl)
            else:
                logits, cache = MD.decode_step(self.params, self.cfg,
                                               self.cache, self.last_tok,
                                               self.pos)
            sp.attach(logits)
        return logits, cache

    def step(self):
        """One decode round across all live slots (packed or lockstep);
        logits pass the NaN/Inf guard before any token is committed."""
        active = np.array([r is not None for r in self.slot_req])
        if not active.any():
            return
        live = [s for s in range(self.B) if active[s]]
        pos_np = self.pos.cpu().numpy()
        kv_lens = [int(min(pos_np[s] + 1, self.s_cache)) for s in live]
        tiles = [-(-kl // self.decode_block) for kl in kv_lens]
        self._inc("decode_rounds")
        self._inc("decode_tiles_packed", sum(tiles))
        self._inc("decode_tiles_padded", len(live) * max(tiles))
        rnd = self._decode_round_idx
        self._decode_round_idx += 1
        t0 = time.monotonic()
        try:
            logits, cache = self._decode_round(live, kv_lens)
        except Exception as e:  # noqa: BLE001 — surfaced, not absorbed
            raise EngineStepError("decode", rnd, e) from e
        self._inc("decode_packed_launches" if self.decode_mode == "packed"
                  else "decode_lockstep_launches")
        if self._round_watch.observe(time.monotonic() - t0):
            self._inc_res("rounds_straggler_total")
        logits = logits[:, 0]
        bad = D.poisoned_slots(logits.cpu().numpy(), live)
        replays: List[Request] = []
        for slot in bad:
            req = self.slot_req[slot]
            self.slot_req[slot] = None
            self.quarantined[slot] = rnd + 1 + QUARANTINE_ROUNDS
            req.replays += 1
            req.status = "queued"
            replays.append(req)
            self._inc_res("slots_quarantined_total")
            if SK.trace_enabled():
                SK.emit_event({"type": "quarantine", "slot": slot,
                               "uid": req.uid, "round": rnd,
                               "reason": "nonfinite_logits"})
        if replays:
            self.queue[0:0] = replays
        nxt = D.sample_logits(logits, temperature=self.temperature,
                              vocab_size=self.cfg.vocab_size,
                              generator=self.generator)
        nxt_np = nxt.cpu().numpy()
        self.cache = cache
        adv = active.copy()
        for slot in bad:
            adv[slot] = False
        self.pos += torch.as_tensor(adv, dtype=torch.int32,
                                    device=self.device)
        self.last_tok = nxt[:, None].to(torch.int64)
        pos_np = self.pos.cpu().numpy()
        for slot in range(self.B):
            req = self.slot_req[slot]
            if req is None:
                continue
            req.out.append(int(nxt_np[slot]))
            self.remaining[slot] -= 1
            if self.remaining[slot] <= 0 or \
                    int(pos_np[slot]) >= self.max_len - 1:
                self._finish(req, "done")
                self.slot_req[slot] = None

    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slot_req)

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive admission + decode until drained (or max_steps rounds).
        Returns {uid: tokens} for every request that reached a terminal
        state (see report() for statuses); raises EngineStepError when a
        round raised anything but a poisoned output."""
        for _ in range(max_steps):
            self._admit()
            if self.idle():
                break
            self.step()
        return {r.uid: r.out for r in self.finished}
