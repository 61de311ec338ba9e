"""A training cell: the port's ``make_train_step`` (AdamW, remat) driven from
the seed over the mix's pool of rows.

Set-up builds one train state, drives it through the first
``checked_steps`` steps with the window's own step and feed (each on a
different row), reads what the comparison needs from it, warms up the
row lengths the pool holds, and hands the same state to the window. The
window runs whole steps until ``seconds`` have passed; the rate is over
all of them and all of their time. The reference follows the checked steps
once the window has closed and the program's state is freed.
"""

from __future__ import annotations

import time

import torch

from bench.core import checks, profile, spec, traffic
from bench.core import weights as W


def _program_batch(row, packed: bool, device, half: bool) -> dict:
    mask = row.mask.copy()
    if half:
        keep = mask.sum() // 2
        mask[mask.cumsum() > keep] = 0.0
    as_t = lambda a, dt: torch.as_tensor(a[None], device=device).to(dt)
    b = {"tokens": as_t(row.tokens, torch.int32),
         "labels": as_t(row.labels, torch.int32)}
    if packed or half:
        b["mask"] = as_t(mask, torch.float32)
    if packed:
        b["positions"] = as_t(row.positions, torch.int32)
    return b


def _reference_batch(row, device) -> dict:
    import numpy as np

    seg = np.repeat(np.arange(len(row.pads)), row.pads)
    as_t = lambda a, dt: torch.as_tensor(a, device=device).to(dt)
    return {"tokens": as_t(row.tokens, torch.int64),
            "labels": as_t(row.labels, torch.int64),
            "mask": as_t(row.mask, torch.float32),
            "positions": as_t(row.positions, torch.int64),
            "segments": as_t(seg, torch.int64)}


def _norms_of(tree: dict, m: dict, scale: float = 1.0) -> dict:
    return {p: float(torch.linalg.vector_norm(W.get(tree, p).float()))
            * scale for p, *_ in W.leaf_specs(m)}


def run(c: dict, seed: int, seconds: float, trace: bool, device: str,
        impl: str, t_start: float, fault: str | None = None) -> dict:
    """One run of a training cell. ``fault`` plants a break under the timed
    path, for the tests and the calibration: "state_unchanged" (a step
    returns its state as it was), "half_batch" (the loss leaves out the
    second half of each row's loss-bearing tokens, the mean taken over the
    rest) or "lr_high" (AdamW's learning rate 1.2 times the
    configuration's)."""
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS
    from repro_torch.kernels.tri_attn import ops as attn_ops

    cuda = device.startswith("cuda")
    conf, mix = c["config"], c["traffic"]
    m, tr, o = spec.model(conf), conf["train"], conf["optimizer"]
    cfg, opt = spec.program_config(conf), OPT.OptConfig(**o)
    if fault == "lr_high":
        opt = OPT.OptConfig(**dict(o, lr=o["lr"] * 1.2))
    if impl == "cuda":
        from repro_torch.kernels import build

        build.build_all()
    packed = traffic.kind(mix).PACKED
    rows = traffic.train_rows(mix, seed, m["vocab_size"])
    batches = [_program_batch(r, packed, device, fault == "half_batch")
               for r in rows]
    kw = dict(attn_impl=impl, remat=tr["remat"], block=tr["block"])
    if packed:
        steps = [TS.make_train_step(cfg, opt, packed=attn_ops.make_packed_sched(
            r.pads, block=tr["block"]), **kw) for r in rows]
    else:
        steps = [TS.make_train_step(cfg, opt, **kw)] * len(rows)
    params = W.make_params(m, seed, device)
    state = TS.TrainState(params=params,
                          opt_state=OPT.init_opt_state(params, opt), step=0)

    def step(i):
        nonlocal state
        k = i % len(rows)
        keep = None
        if fault == "state_unchanged":
            keep = ({p: W.get(state.params, p).clone()
                     for p, *_ in W.leaf_specs(m)},
                    {k2: {p: W.get(state.opt_state[k2], p).clone()
                          for p, *_ in W.leaf_specs(m)}
                     for k2 in state.opt_state})
        state, met = steps[k](state, batches[k])
        if keep is not None:
            with torch.no_grad():
                for p, t in keep[0].items():
                    W.get(state.params, p).copy_(t)
                for k2, tree in keep[1].items():
                    for p, t in tree.items():
                        W.get(state.opt_state[k2], p).copy_(t)
        return met, rows[k].loss_tokens

    # the checked steps, through the window's own step and feed
    n_checked = tr["checked_steps"]
    prog = {"loss": []}
    for i in range(n_checked):
        met, _ = step(i)
        prog["loss"].append(float(met["loss"]))
        if i == 0:
            prog["grad_norm"] = _norms_of(state.opt_state["m"], m,
                                          1.0 / (1.0 - o["b1"]))
    prog["update_norm"] = {
        p: float(torch.linalg.vector_norm(W.get(state.params, p).float()
                                          - t0.float()))
        for p, t0 in W.leaves(m, seed, device)}
    # warm up each row length of the pool not yet stepped
    seen = {len(r.tokens) for r in rows[:n_checked]}
    i = n_checked
    for j in range(n_checked, len(rows)):
        if len(rows[j].tokens) not in seen:
            seen.add(len(rows[j].tokens))
            rows[i % len(rows)], rows[j] = rows[j], rows[i % len(rows)]
            batches[i % len(rows)], batches[j] = batches[j], \
                batches[i % len(rows)]
            steps[i % len(rows)], steps[j] = steps[j], steps[i % len(rows)]
            step(i)
            i += 1
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.time() - t_start

    done = []
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        _, ntok = step(i)
        te = time.perf_counter()
        done.append((ts, te, ntok, i % len(rows)))
        i += 1
        if te - t0 >= seconds:
            break
    window_s = done[-1][1] - t0
    tokens = sum(d[2] for d in done)
    out = {"attempted": len(done), "failed": 0,
           "end_to_end": {"train_tokens_per_s": tokens / window_s,
                          "setup_s": setup_s}}
    win_peak = torch.cuda.max_memory_allocated() if cuda else 0
    out["memory_peak_bytes"] = max(setup_peak, win_peak) if cuda else 0

    if trace:
        prof_rows = [i % len(rows), (i + 1) % len(rows)]

        def two_steps():
            nonlocal i
            for _ in range(2):
                step(i)
                i += 1

        # the busy window records no Python stacks, which slow the host
        win = profile.take(two_steps, with_stack=False)
        stack_win = profile.take(two_steps, with_stack=True)
        out["ctx"] = {
            "kind": "train", "model": m, "window_s": window_s,
            "steps": [{"seconds": te - ts, "loss_tokens": n,
                       "lengths": rows[k].doc_lens}
                      for ts, te, n, k in done],
            "profile": win, "stack_profile": stack_win,
            "profile_rows": [{"lengths": rows[k].doc_lens,
                              "rows": len(rows[k].tokens)}
                             for k in prof_rows],
            "window_peak_bytes": win_peak}

    # the program's state goes before the reference runs
    ref_rows = [_reference_batch(r, device) for r in rows[:n_checked]]
    del state, steps, batches, params
    if cuda:
        torch.cuda.empty_cache()
    from bench.reference import model as RM
    from bench.reference import train as RT

    ref = RT.train(m, o, seed, ref_rows, device, RM.Precision("f32"))
    out["readings"] = checks.train_readings(prog, ref)
    out["detail"] = checks.train_detail(prog, ref)
    return out
