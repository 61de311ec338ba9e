"""A serving cell: the port's ``Engine`` on the configuration's settings,
driven by an open or a closed loop from the bench's generator.

The engine is synchronous: between two of its rounds the loop submits every
request that has come due, and after each round it stamps every token that
reached the host. Traffic starts during set-up (``warmup_s`` of the open
loop, ``warmup_waves`` of the closed loop) so the window opens on a steady
queue; only requests due inside the window enter the time to first token.
The open loop's window lasts ``seconds``; the closed loop's runs on until
the wave running at ``seconds`` has finished, so its rate is over whole
waves.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from bench.core import checks, profile, spec, stats, traffic
from bench.core import weights as W


class Loop:
    """The load generator around one engine. ``reqs`` holds every request
    it sent (stats.Request), ``rounds`` each round's decode: the live
    slots' cache lengths and whether the packed kernel ran it."""

    def __init__(self, engine, mix: dict, seed: int, vocab: int,
                 fault: str | None = None):
        self.eng, self.mix, self.seed, self.vocab = engine, mix, seed, vocab
        self.fault = fault
        self.reqs: dict = {}
        self.live: dict = {}      # uid -> (engine request, stats request)
        self.n_fin = 0
        self.rounds: list = []
        self.kind = traffic.kind(mix)
        self.open = self.kind.OPEN
        self.t_base = None
        if self.open:
            self.pending = self.kind.schedule(mix, seed, vocab)
            self.next = 0
        else:
            self.sent = [0] * mix["clients"]
        # a closed loop's clients send no more while it drains
        self.draining = False

    def _submit(self, prompt, max_new: int, due: float, now: float,
                uid: int):
        self.eng.submit(np.asarray(prompt, np.int32), max_new, uid)
        r = stats.Request(uid, due, len(prompt), max_new)
        r.submitted = now
        self.reqs[uid] = r
        self.live[uid] = (self.eng.queue[-1], r)

    def _client_send(self, client: int, now: float):
        k = self.sent[client]
        self.sent[client] += 1
        uid = k * self.mix["clients"] + client
        self._submit(self.kind.prompt(self.mix, self.seed, self.vocab,
                                      client, k),
                     self.mix["output_len"], now, now, uid)

    def start(self):
        self.t_base = time.perf_counter()
        self.resume()

    def resume(self):
        """Every client of a closed loop sends its next request."""
        self.draining = False
        if not self.open:
            now = time.perf_counter()
            for c in range(self.mix["clients"]):
                self._client_send(c, now)

    def submit_due(self, now: float):
        if not self.open:
            return
        while self.next < len(self.pending) and \
                self.t_base + self.pending[self.next].due <= now:
            q = self.pending[self.next]
            self._submit(q.prompt, q.max_new, self.t_base + q.due, now, q.uid)
            self.next += 1

    def next_due(self) -> float:
        if self.open and self.next < len(self.pending):
            return self.t_base + self.pending[self.next].due
        return float("inf")

    def round(self):
        """Submit what is due, run one engine round (or wait for the next
        arrival when the engine is idle), stamp the tokens."""
        now = time.perf_counter()
        self.submit_due(now)
        if self.eng.idle():
            wait = self.next_due() - now
            if wait == float("inf"):
                raise RuntimeError("the loop ran out of traffic")
            time.sleep(max(wait, 0.0))
            return
        packed0 = self.eng.registry.counter_value("decode_packed_launches")
        self.eng.round()
        t = time.perf_counter()
        kv = []
        fin = self.eng.finished[self.n_fin:]
        self.n_fin = len(self.eng.finished)
        for uid, (ereq, r) in list(self.live.items()):
            new = len(ereq.out) - len(r.token_times)
            if new:
                if self.fault == "token_altered" and not r.token_times:
                    ereq.out[0] = (ereq.out[0] + 1) % self.vocab
                kv += [r.prompt_len + j for j in
                       range(len(r.token_times), len(ereq.out))]
                r.token_times += [t] * new
        for ereq in fin:
            r = self.live.pop(ereq.uid)[1]
            r.status = ereq.status
            if not self.open and not self.draining:
                self._client_send(ereq.uid % self.mix["clients"], t)
        if kv:
            packed = self.eng.registry.counter_value(
                "decode_packed_launches") > packed0
            self.rounds.append({"kv_lens": kv, "packed": packed, "end": t})


def _engine(params, cfg, conf: dict, impl: str, device: str):
    from repro_torch.serve.engine import Engine

    e = dict(conf["engine"])
    e["cache_dtype"] = W.DTYPES[e["cache_dtype"]]
    return Engine(params, cfg, prefill_impl=impl, decode_impl=impl,
                  device=device, **e)


def _sample(loop: Loop, engine, seed: int, want: int) -> list:
    """Finished requests drawn from the seed, the longest first, until they
    hold ``want`` served tokens."""
    done = [r for r in engine.finished if r.status == "done"]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.out), r.uid))
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 9])
    rest = [done[i] for i in rng.permutation(len(done))
            if done[i] is not longest]
    out, n = [longest], len(longest.out)
    for r in rest:
        if n >= want:
            break
        out.append(r)
        n += len(r.out)
    return out


def run(c: dict, seed: int, seconds: float, trace: bool, device: str,
        impl: str, t_start: float, fault: str | None = None) -> dict:
    """One run of a serving cell. ``fault`` "token_altered" plants a
    break under the timed path, for the tests: each request's first served
    token is changed where the engine produced it."""
    from repro_torch.obs import sinks as SK

    cuda = device.startswith("cuda")
    conf, mix = c["config"], c["traffic"]
    m = spec.model(conf)
    cfg = spec.program_config(conf)
    params = W.make_params(m, seed, device)
    eng = _engine(params, cfg, conf, impl, device)
    loop = Loop(eng, mix, seed, m["vocab_size"], fault)
    loop.start()
    if loop.open:
        t0 = loop.t_base + mix["warmup_s"]
        while time.perf_counter() < t0:
            loop.round()
        t0 = time.perf_counter()
    else:
        want = mix["clients"] * mix["warmup_waves"]
        while len(eng.finished) < want:
            loop.round()
        t0 = time.perf_counter()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
    setup_s = time.time() - t_start
    n_round0 = len(loop.rounds)

    tmp = None
    if trace:
        tmp = tempfile.TemporaryDirectory()
        SK.enable(trace_dir=tmp.name, run_id="window")
    t1 = t0 + seconds
    while time.perf_counter() < t1:
        loop.round()
    if not loop.open:
        # the closed loop's window ends with the wave running at t1, so
        # its rate is over whole waves
        loop.draining = True
        while not eng.idle():
            loop.round()
        t1 = max(t for r in loop.reqs.values() for t in r.token_times)
    spans = []
    if trace:
        SK.disable()
        import json

        with open(os.path.join(tmp.name, "trace-window.jsonl")) as fh:
            spans = [json.loads(line) for line in fh]
        spans = [(e["name"], e["duration_ms"]) for e in spans
                 if e.get("type") == "span"]
        tmp.cleanup()
    reqs = list(loop.reqs.values())
    win_rounds = loop.rounds[n_round0:]
    e2e = {"setup_s": setup_s,
           "serve_tokens_per_s": stats.tokens_in(reqs, t0, t1) / (t1 - t0)}
    itl = stats.itl_samples(reqs, t0, t1)
    e2e["itl_p95_ms"] = stats.percentile(itl, 95) * 1e3
    if loop.open:
        e2e["ttft_p95_ms"] = stats.percentile(
            stats.ttft_samples(reqs, t0, t1), 95) * 1e3
        attempted = len(stats.due_in(reqs, t0, t1))
        failed = stats.failed_in(reqs, t0, t1)
    else:
        attempted = sum(t0 <= r.submitted < t1 for r in reqs)
        failed = sum(r.status in ("shed", "failed", "deadline_miss")
                     for r in reqs if t0 <= r.submitted < t1)
    out = {"attempted": attempted, "failed": failed, "end_to_end": e2e}
    win_peak = torch.cuda.max_memory_allocated() if cuda else 0
    out["memory_peak_bytes"] = max(setup_peak, win_peak) if cuda else 0

    if trace:
        # the stretches hold the mix of admissions and decode rounds that
        # the window holds: a closed loop's is one whole wave, which its
        # window repeats; an open loop's busy stretch is five seconds of its
        # traffic (a single second can hold one long admission and little
        # else), and the stretch with Python stacks, which slow the host
        # and only find the decode rounds' kernels, one second
        if loop.open:
            b_fn, s_fn = (lambda: _rounds(loop, 5.0)), \
                (lambda: _rounds(loop, 1.0))
        else:
            b_fn = s_fn = (lambda: _wave(loop))
        busy = profile.take(b_fn, with_stack=False)
        n_b = len(loop.rounds)
        stack = profile.take(s_fn, with_stack=True)
        out["ctx"] = {"kind": "serve", "open": loop.open, "model": m,
                      "engine": conf["engine"], "requests": reqs, "t0": t0,
                      "t1": t1, "spans": spans, "rounds": win_rounds,
                      "profile": busy, "stack_profile": stack,
                      "stack_rounds": loop.rounds[n_b:]}

    # the sample, then the program's state goes before the reference runs
    sample = _sample(loop, eng, seed, mix["sample_tokens"])
    seqs = [np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
            for r in sample]
    rows = [list(range(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.out)))
            for r in sample]
    served = [list(r.out) for r in sample]
    out["sample"] = {"requests": len(sample),
                     "tokens": sum(len(s) for s in served)}
    del eng, loop
    if cuda:
        torch.cuda.empty_cache()
    from bench.reference import model as RM

    logits = RM.served_logits(params, m, seqs, rows, RM.Precision("f32"),
                              device)
    gaps = [g for lg, s in zip(logits, served)
            for g in checks.token_gaps(lg, s)]
    out["readings"] = {"tok_gap": max(gaps) if gaps else None}
    out["ref_inputs"] = (params, m, seqs, rows, served)
    return out


def _rounds(loop: Loop, seconds: float):
    t_end = time.perf_counter() + seconds
    while time.perf_counter() < t_end:
        loop.round()


def _wave(loop: Loop):
    """Every client of a closed loop sends one request; rounds run until
    the engine has finished them all."""
    loop.resume()
    loop.draining = True
    while not loop.eng.idle():
        loop.round()
