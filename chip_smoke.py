"""Drive the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py [--layers N] [--train-layers N]

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build the eight CUDA sources of src/repro_torch/csrc (nvcc, sm_90a);
  3. kernels: each kernel of the serving path at full yi-9b width (H=32,
     Hkv=4, D=128, blk=64, bf16 q/k/v, f32 decode cache) against its
     plain PyTorch version on the card (outputs within atol 4e-3 + rtol
     1e-2, log-sum-exp within atol 1e-2), timed with CUDA events beside
     the plain version, one library call (scaled_dot_product_attention
     with the equivalent mask; used nowhere in the port) and the bound
     max(bytes / 3.35 TB/s, flops / peak), both counted from what this
     run's masks and kv lengths need;
  4. serving: yi-9b at full width (48 layers unless --layers cuts it) with
     random seeded bf16 weights, an Engine with both kernels serving 8
     skewed requests; asserts every request done, no degrade, no failure,
     and kernel launches == layers x engine launches; a torch.profiler
     window over a few more decode rounds (device busy share, top
     kernels); then a smoke-size float32 engine with the kernels and with
     the plain versions, which must emit identical greedy tokens;
  5. training kernels: tri_attn.fwd and its dq and dk/dv backward at the
     train phase's attention shape (B 1, H 32, Hkv 4, S 4096, D 128, ltm,
     blk 64, bf16) against their plain versions on the same inputs
     (OUT_TOL, lse LSE_TOL), timed beside the plain versions, SDPA
     (is_causal forward; its autograd backward beside dq and dk/dv) and
     the bound; band and prefix schedules at blk 16 and 64 on small
     shapes;
  6. packed training kernels: packed_fwd and the packed dq and dk/dv
     (tri_attn.packed_bwd) at the packed train phase's attention shape
     (one row of the 8 documents 1500/1000/600/370/250/100/60/40 padded
     to blk 64 multiples, 4096 rows, ltm members; H 32, Hkv 4, D 128,
     bf16) against their plain versions, timed beside them, SDPA with the
     block-diagonal causal mask (forward; its autograd backward beside dq
     and dk/dv) and the bound; mixed ltm/prefix/band members at blk 16
     and 64; two runs of the backward bitwise equal;
  7. the paper's experiment: dummy_ltm over the whole certified ltm_map
     envelope (n = 23169, 268,412,865 blocks) equal to i + j on the card;
     edm_ltm and edm_bb against their plain versions (EDM tolerances of
     tests/oracles.py) in full at N = 16384 (d 1-4, squared, bf16) and at
     N = 65536 on 4096 sampled tiles plus every tile past the 2^31-element
     offset, BB's lower tiles equal to LTM's bit for bit, its upper tiles
     and every self-distance exactly 0; fwd_bb at the train phase's
     attention shape against fwd_bb_torch and tri_fwd (OUT_TOL, LSE_TOL),
     two runs bitwise equal, its counters n^2 and tri(n) per (batch,
     head), band windows at blk 16 and 64; the plain versions,
     torch.cdist and SDPA timed; then the experiment through the entry
     points with every count at 0 before and asserted after (no plain
     version): ops.edm cuda and bb over N 16384/32768/65536 x d 1-4 at
     blk 64 and N 65536, d 3 at blk 128 (I_edm = t_bb / t_ltm beside the
     structural n^2 / tri(n) of kernel_summary and the paper's Kepler
     1.12-1.15), dummy_ltm at n = 1024, 4096 and 23169, and
     triangular_attention bb against cuda (I_attn);
  8. training: yi-9b at full width (24 of 48 layers unless --train-layers
     says otherwise: the 48-layer AdamW state does not fit 80 GB) for 3
     steps of seq 4096, batch 1, remat, random seeded bf16 weights,
     SyntheticLM batches; asserts finite positive losses, kernel launches
     of exactly 2 x layers (fwd, with the remat recompute) and layers (dq,
     dk/dv) a step, and no plain-version launch; a profiler window over a
     fourth step; then, on the same state, packed document training:
     3 steps of PackedDocsLM rows of the 8 documents (3920 real tokens a
     step) with launches of exactly 2 x layers (packed_fwd) and layers
     (packed dq, dk/dv) a step, no other kernel and no plain version; a
     profiler window over a fourth; one forward+backward of the packed
     row and of the pad-to-max batch (8 x 1536, through tri_fwd/tri_bwd)
     on the same parameters, whose losses agree within PAD_LOSS_RTOL;
     then smoke-size float32 training on the card: 3 steps with the
     kernels and with the plain versions agree, 20 steps lower the loss,
     6 steps straight and 3 + checkpoint + restore + 3 end in
     bitwise-equal states; 3 packed steps with the kernels and with the
     plain versions agree, and packed and padded losses agree (rtol
     1e-5).
The last lines are the card line, the {"kernels": [...]} line and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no TF32
# bf16 outputs of ~0.05-1 differ by at most a bf16 ulp; a skipped 64-key
# tile moves out by ~1e-2 and lse by ~6e-2, so both limits catch it
OUT_TOL = dict(atol=4e-3, rtol=1e-2)
LSE_TOL = dict(atol=1e-2, rtol=0.0)
# the packed train phase's documents (real tokens), padded to blk 64
TRAIN_DOCS = (1500, 1000, 600, 370, 250, 100, 60, 40)
# bf16 packed and pad-to-max losses round at other places (other matmul
# shapes, other tile edges): each token's logits move by ~1e-2, their
# mean cross entropy over 3920 tokens by far less than 0.5%
PAD_LOSS_RTOL = 5e-3


def _fail(msg: str):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _reset_launches(K):
    """Every kernel wrapper's launch count to 0, just before a path."""
    for fn in K.WRAPPERS.values():
        fn.launches = 0


def _launches(K) -> dict:
    return {name: fn.launches for name, fn in K.WRAPPERS.items()}


def _close(name, got, want, tol=OUT_TOL):
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **tol):
        _fail(f"{name}: kernel disagrees with its reference "
              f"(max abs err {err}, tolerance {tol})")
    return err


def kernel_phase(dev, K, OPS, SC):
    """Both kernels at full yi-9b width vs plain version and SDPA."""
    import torch.nn.functional as F

    rng = np.random.default_rng(0)
    h, hkv, d, blk = 32, 4, 128, 64
    dt = torch.bfloat16

    def rand(*shape, dtype=dt):
        return torch.as_tensor(rng.standard_normal(shape, np.float32),
                               device=dev).to(dtype)

    # packed prefill: ltm ~1000, band ~500 (window 300), prefix ~250
    # (64-token bidirectional prefix), ltm ~90, padded to blk multiples
    lens = [1024, 512, 256, 128]
    psched = OPS.make_packed_sched(lens, block=blk,
                                   window=[None, 300, None, None],
                                   prefix=[0, 0, 64, 0])
    s = psched.s_total
    q, k, v = rand(1, h, s, d), rand(1, hkv, s, d), rand(1, hkv, s, d)
    out, lse = K.packed_fwd(q, k, v, psched)
    torch.cuda.synchronize()
    want_out, want_lse = SC.packed_fwd_torch(q, k, v, psched, d ** -0.5)
    err_fwd = max(_close("packed_fwd out", out, want_out),
                  _close("packed_fwd lse", lse, want_lse, LSE_TOL))
    mask = torch.zeros((s, s), dtype=torch.bool, device=dev)
    base = 0
    for m in psched.members:
        n_tok = m.n * blk
        seg = slice(base, base + n_tok)
        qp = torch.arange(n_tok, device=dev)[:, None]
        kp = torch.arange(n_tok, device=dev)[None, :]
        mm = kp <= qp
        if m.window is not None:
            mm &= (qp - kp) < m.window
        if m.prefix:
            mm |= kp < m.prefix
        mask[seg, seg] = mm
        base += n_tok
    lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                 enable_gqa=True)
    _close("packed_fwd vs SDPA", out, lib())
    fwd_ms = _median_ms(lambda: K.packed_fwd(q, k, v, psched), 20)
    fwd_plain = _median_ms(
        lambda: SC.packed_fwd_torch(q, k, v, psched, d ** -0.5), 3, 1)
    fwd_lib = _median_ms(lib, 20)
    fwd_bytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) \
        + 4 * lse.numel()
    # QK^T and PV: 2 * D multiply-adds per head for each unmasked pair
    pairs = int(mask.sum())
    fwd_flops = 4 * d * h * pairs
    fwd_bound, fwd_by = _bound(fwd_bytes, fwd_flops, dt)

    # decode round: 4 skewed slots over a 2048-token f32 cache
    b, s_cache = 4, 2048
    kv_lens = [2000, 37, 900, 300]
    tbl_np, needed = OPS.make_decode_table(kv_lens, list(range(b)), blk=blk,
                                           n_members=b + 1, n_slots=b,
                                           s_cache=s_cache)
    tbl = torch.as_tensor(tbl_np, device=dev)
    qd = rand(b, h, d)
    kc = rand(b, s_cache, hkv, d, dtype=torch.float32)
    vc = rand(b, s_cache, hkv, d, dtype=torch.float32)
    spec = OPS.DecodeRoundSpec(n_members=b + 1, capacity=needed, blk=blk,
                               impl="cuda", tiles=needed)
    got = OPS.packed_decode_attention(qd, kc, vc, tbl, spec)
    torch.cuda.synchronize()
    want = SC.packed_decode_torch(qd, kc, vc, tbl, capacity=needed, blk=blk,
                                  tiles=needed, scale=d ** -0.5)
    err_dec = _close("packed_decode", got, want)
    valid = torch.arange(s_cache, device=dev)[None, :] < torch.as_tensor(
        kv_lens, device=dev)[:, None]
    q32 = qd.float()[:, :, None]
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    dec_lib = lambda: F.scaled_dot_product_attention(
        q32, kt, vt, attn_mask=valid[:, None, None], enable_gqa=True)
    _close("packed_decode vs SDPA", got, dec_lib()[:, :, 0])
    dec_ms = _median_ms(lambda: K.packed_decode_fwd(
        qd, kc, vc, tbl, capacity=needed, blk=blk, tiles=needed), 50)
    dec_plain = _median_ms(lambda: SC.packed_decode_torch(
        qd, kc, vc, tbl, capacity=needed, blk=blk, tiles=needed,
        scale=d ** -0.5), 3, 1)
    dec_lib_ms = _median_ms(dec_lib, 50)
    # each slot reads its [kv_first, kv_len) rows of K and V once
    kv_tokens = int((tbl_np[3] - tbl_np[4]).sum())
    dec_bytes = (qd.numel() + b * h * d) * qd.element_size() \
        + tbl.numel() * 4 + kv_tokens * hkv * d * kc.element_size() * 2
    dec_flops = 4 * h * d * kv_tokens
    dec_bound, dec_by = _bound(dec_bytes, dec_flops, torch.float32)
    ctx = dict(psched=psched, qkv=(q, k, v), out=out, pairs=pairs,
               fwd_lib=lib, kv_lens=kv_lens, dec=(qd, kc, vc), dec_out=got,
               kv_tokens=kv_tokens, dec_lib=dec_lib)
    return ctx, [
        {"name": "tri_attn.packed_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/packed_fwd.cu",
         "replaces": "src/repro/kernels/tri_attn/kernel.py:384",
         "max_abs_err": err_fwd, "ms": fwd_ms, "plain_ms": fwd_plain,
         "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": fwd_lib,
         "shape": {"lens": lens, "H": h, "Hkv": hkv, "D": d, "blk": blk,
                   "steps": psched.steps, "pairs": pairs}},
        {"name": "tri_attn.packed_decode_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/packed_decode.cu",
         "replaces": "src/repro/kernels/tri_attn/kernel.py:742",
         "max_abs_err": err_dec, "ms": dec_ms, "plain_ms": dec_plain,
         "bound_ms": dec_bound, "bound_by": dec_by,
         "library_ms": dec_lib_ms,
         "shape": {"kv_lens": kv_lens, "H": h, "Hkv": hkv, "D": d,
                   "blk": blk, "S_cache": s_cache, "tiles": needed,
                   "kv_tokens": kv_tokens}},
    ]


def fused_kernel_phase(dev, K, OPS, SC, D, ctx):
    """tri_attn.fused_step_fwd at full yi-9b width: the prefill members of
    the packed_fwd row admitted into slots 4-7 of B = 8 while slots 0-3
    decode the packed_decode row's kv_lens, on the same tensors. Held
    against the plain version, and against the split kernels: bitwise on
    the prefill half (same body, same 256 threads); the decode half runs
    its body at 256 threads where packed_decode runs 512, so it is held at
    OUT_TOL and its bitwise equality is reported."""
    rng = np.random.default_rng(1)
    psched = ctx["psched"]
    qp, kp, vp = ctx["qkv"]
    qd4, kc4, vc4 = ctx["dec"]
    kv_lens, live = ctx["kv_lens"], list(range(len(ctx["kv_lens"])))
    b, h, d = 8, qd4.shape[1], qd4.shape[2]
    blk, s_cache = psched.blk, kc4.shape[1]

    def more(x):  # slots 4-7 (being admitted) hold other data
        extra = torch.as_tensor(rng.standard_normal(x.shape, np.float32),
                                device=dev).to(x.dtype)
        return torch.cat([x, extra]).contiguous()

    qd, kc, vc = more(qd4), more(kc4), more(vc4)
    n_members = len(psched.members) + b + 1
    tbl_np, needed = OPS.make_fused_table(psched, kv_lens, live, blk=blk,
                                          n_members=n_members, n_slots=b,
                                          s_cache=s_cache)
    tbl = torch.as_tensor(tbl_np, device=dev)
    capacity = psched.steps + D.round_capacity(needed - psched.steps)
    spec = OPS.FusedStepSpec(n_members=n_members, capacity=capacity,
                             blk=blk, impl="cuda", tiles=needed)
    ins = (qp, kp, vp, qd, kc, vc, tbl)
    o_pack, o_dec = OPS.fused_step_attention(*ins, psched, spec)
    torch.cuda.synchronize()
    want_pack, want_dec = SC.fused_step_torch(
        *ins, capacity=capacity, blk=blk, tiles=needed, scale=d ** -0.5)
    err = max(_close("fused_step pack", o_pack, want_pack),
              _close("fused_step decode", o_dec, want_dec))
    if not torch.equal(o_pack, ctx["out"]):
        _fail("fused_step: the prefill half is not bitwise equal to "
              "packed_fwd on the same tensors")
    _close("fused_step decode vs packed_decode_fwd", o_dec[live],
           ctx["dec_out"])
    dec_bitwise = torch.equal(o_dec[live], ctx["dec_out"])
    if torch.count_nonzero(o_dec[len(live):]):
        _fail("fused_step: slots without a live decode member are not 0")
    raw = lambda: K.fused_step_fwd(*ins, psched=psched, capacity=capacity,
                                   tiles=needed)
    dtbl_np, dneeded = OPS.make_decode_table(kv_lens, live, blk=blk,
                                             n_members=len(live) + 1,
                                             n_slots=len(live),
                                             s_cache=s_cache)
    dtbl = torch.as_tensor(dtbl_np, device=dev)

    def split():
        K.packed_fwd(qp, kp, vp, psched)
        K.packed_decode_fwd(qd4, kc4, vc4, dtbl, capacity=dneeded, blk=blk,
                            tiles=dneeded)

    def library():
        ctx["fwd_lib"]()
        ctx["dec_lib"]()

    # re-read the split kernels beside the fused one, in turns
    times = {"fused": [], "split": [], "fwd": [], "dec": []}
    for _ in range(2):
        times["fwd"].append(_median_ms(lambda: K.packed_fwd(qp, kp, vp,
                                                            psched), 10))
        times["dec"].append(_median_ms(lambda: K.packed_decode_fwd(
            qd4, kc4, vc4, dtbl, capacity=dneeded, blk=blk,
            tiles=dneeded), 25))
        times["fused"].append(_median_ms(raw, 10))
        times["split"].append(_median_ms(split, 10))
    fused_ms = statistics.median(times["fused"])
    plain_ms = _median_ms(lambda: SC.fused_step_torch(
        *ins, capacity=capacity, blk=blk, tiles=needed, scale=d ** -0.5),
        3, 1)
    lib_ms = _median_ms(library, 10)
    hkv = kp.shape[1]
    elt = qp.element_size()
    nbytes = elt * (2 * qp.numel() + kp.numel() + vp.numel()) \
        + elt * 2 * len(live) * h * d + tbl.numel() * 4 \
        + ctx["kv_tokens"] * hkv * d * kc.element_size() * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (4 * d * h * ctx["pairs"] / PEAK_FLOPS[torch.bfloat16]
             + 4 * h * d * ctx["kv_tokens"] / PEAK_FLOPS[torch.float32]) * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else \
        (t_ops, "operations")
    print(f"fused: fused_step_fwd {times['fused']} ms, split kernels summed "
          f"{times['split']} ms, packed_fwd {times['fwd']} ms, "
          f"packed_decode_fwd {times['dec']} ms (re-read in turns); decode "
          f"half bitwise equal to packed_decode_fwd: {dec_bitwise}; "
          f"{nbytes} bytes, grid {(n_members - len(psched.members)) * hkv} "
          f"decode + {psched.total_tiles * h} prefill blocks", flush=True)
    return {"name": "tri_attn.fused_step_fwd", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_step.cu",
            "replaces": "src/repro/kernels/tri_attn/kernel.py:909",
            "max_abs_err": err, "ms": fused_ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            "library": "two SDPA calls (prefill with the dense block mask, "
                       "decode with the kv mask): no single PyTorch call "
                       "computes the mixed function",
            "split_ms": statistics.median(times["split"]),
            "reread_ms": {"tri_attn.packed_fwd": times["fwd"],
                          "tri_attn.packed_decode_fwd": times["dec"]},
            "decode_half_bitwise": dec_bitwise,
            "shape": {"lens": [m.n * blk for m in psched.members],
                      "kv_lens": kv_lens, "B": b, "S_cache": s_cache,
                      "tiles": needed, "capacity": capacity,
                      "bytes": nbytes}}


def _check_served(label, eng, results, uids, max_new, cfg):
    report = eng.report()
    st = eng.stats
    if sorted(results) != sorted(uids) or any(
            r["status"] != "done" for r in report.values()):
        _fail(f"{label}: not every request is done: {report}")
    if any(len(results[u]) != m for u, m in zip(uids, max_new)):
        _fail(f"{label}: a request emitted the wrong number of tokens")
    if any(not 0 <= t < cfg.vocab_size for u in results for t in results[u]):
        _fail(f"{label}: a token lies outside the vocabulary")
    if st["launches_degraded_total"] or st["requests_failed_total"]:
        _fail(f"{label}: degraded={st['launches_degraded_total']} "
              f"failed={st['requests_failed_total']}")
    return st


def _serve(eng, prompts, max_new):
    for uid, (p, m) in enumerate(zip(prompts, max_new)):
        eng.submit(p, max_new=m, uid=uid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0


def serving_phase(dev, layers: int, card: str, K):
    """Split then fused serving at full width on one set of random
    weights; returns each kernel's launches on its path."""
    import dataclasses

    from repro_torch.configs import yi_9b
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Engine

    cfg = yi_9b.CONFIG
    if layers != cfg.n_layers:
        print(f"serving: depth cut to {layers} of {cfg.n_layers} layers "
              f"(--layers)", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    t0 = time.perf_counter()
    params = MD.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"serving: yi-9b {cfg.n_layers}L d_model={cfg.d_model} "
          f"H={cfg.n_heads} Hkv={cfg.n_kv_heads} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size}: {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB of bf16 weights in {time.perf_counter() - t0:.1f} s",
          flush=True)
    kw = dict(slots=4, max_len=2048, prefill_block=64, decode_block=64,
              prefill_impl="cuda", decode_impl="cuda", decode_mode="packed",
              device=dev)
    n_l = cfg.n_layers
    rng = np.random.default_rng(1)

    # split mode: 8 skewed prompts, 32 new tokens each
    prompt_lens = [1000, 90, 500, 250, 700, 60, 380, 150]
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in prompt_lens]
    max_new = [32] * len(prompts)
    eng = Engine(params, cfg, **kw)
    _reset_launches(K)
    results, wall = _serve(eng, prompts, max_new)
    counts = _launches(K)
    launches = {n: counts.pop(n) for n in ("tri_attn.packed_fwd",
                                           "tri_attn.packed_decode_fwd")}
    st = _check_served("serving", eng, results, range(len(prompts)),
                       max_new, cfg)
    if launches["tri_attn.packed_fwd"] != n_l * st["prefill_launches"] or \
            launches["tri_attn.packed_decode_fwd"] != \
            n_l * st["decode_packed_launches"] or \
            st["decode_packed_launches"] != st["decode_rounds"] or \
            not all(launches.values()) or any(counts.values()):
        _fail(f"serving: kernel launches {launches} != {n_l} layers x "
              f"engine launches (prefill {st['prefill_launches']}, decode "
              f"{st['decode_packed_launches']} of {st['decode_rounds']})")
    new_tokens = sum(len(v) for v in results.values())
    prompt_tokens = sum(prompt_lens)
    print(f"serving: {len(results)} requests, {prompt_tokens} prompt + "
          f"{new_tokens} generated tokens in {wall:.3f} s: "
          f"{new_tokens / wall:.1f} generated tokens/s "
          f"({(prompt_tokens + new_tokens) / wall:.1f} tokens/s incl. "
          f"prefill); admit rounds {st['admit_rounds']}, prefill launches "
          f"{st['prefill_launches']}, decode rounds {st['decode_rounds']}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"card {card}", flush=True)
    for uid, n in enumerate((900, 40, 600, 200)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n), max_new=6,
                   uid=1000 + uid)
    eng.round()  # admit + first decode round, outside the window
    profile_rounds(eng, 4, "packed decode rounds", card)
    eng.run()
    del eng

    # fused mode: 12 prompts with staggered budgets, so that admit rounds
    # carry live decode slots; split mode on the same traffic beside it
    prompt_lens = [1000, 90, 500, 250, 700, 60, 380, 150, 820, 45, 610, 220]
    prompts = [rng.integers(1, cfg.vocab_size, size=n) for n in prompt_lens]
    max_new = [8, 40, 16, 32, 24, 12, 36, 20, 28, 10, 18, 30]
    eng = Engine(params, cfg, step_mode="fused", **kw)
    _reset_launches(K)
    results, wall = _serve(eng, prompts, max_new)
    counts = _launches(K)
    fused_launches = counts.pop("tri_attn.fused_step_fwd")
    st = _check_served("fused serving", eng, results, range(len(prompts)),
                       max_new, cfg)
    mixed = st["decode_rounds"] - st["decode_packed_launches"]
    if fused_launches != n_l * st["fused_launches"] or \
            counts.pop("tri_attn.packed_decode_fwd") != \
            n_l * st["decode_packed_launches"] or any(counts.values()) \
            or not fused_launches or mixed < 4 or st["fused_fallbacks"]:
        _fail(f"fused serving: launches fused {fused_launches}, decode "
              f"{K.packed_decode_fwd.launches}, prefill "
              f"{K.packed_fwd.launches} for {n_l} layers x engine fused "
              f"{st['fused_launches']} / decode "
              f"{st['decode_packed_launches']}; mixed rounds {mixed}")
    new_tokens = sum(len(v) for v in results.values())
    split_eng = Engine(params, cfg, **kw)
    split_results, split_wall = _serve(split_eng, prompts, max_new)
    _check_served("split serving", split_eng, split_results,
                  range(len(prompts)), max_new, cfg)
    del split_eng
    print(f"fused serving: {len(results)} requests, {sum(prompt_lens)} "
          f"prompt + {new_tokens} generated tokens: fused {wall:.3f} s, "
          f"{new_tokens / wall:.1f} generated tokens/s; split on the same "
          f"traffic {split_wall:.3f} s, {new_tokens / split_wall:.1f} "
          f"generated tokens/s; fused rounds {st['fused_rounds']} "
          f"({mixed} with live decode slots), decode-only rounds "
          f"{st['decode_packed_launches']}, fused tiles {st['fused_tiles']}; "
          f"card {card}", flush=True)
    # a profiler window over fused rounds that carry admits: three long
    # requests decode while one-token requests take the fourth slot
    for uid, n in enumerate((900, 600, 200)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n), max_new=40,
                   uid=2000 + uid)
    eng.round()  # admits the long ones, no live slot: outside the window
    for uid, n in enumerate((700, 150, 400, 90, 300, 500)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n), max_new=1,
                   uid=2100 + uid)
    eng.round()
    profile_rounds(eng, 4, "fused rounds (1 admit + 3 live slots each)",
                   card)
    eng.run()
    del eng
    snapshot_phase(params, cfg, kw, rng, card)
    del params
    torch.cuda.empty_cache()
    return dict(launches, **{"tri_attn.fused_step_fwd": fused_launches})


def snapshot_phase(params, cfg, kw, rng, card):
    """Snapshot a fused engine mid-run, finish it, restore the snapshot on
    the same params and finish again: identical tokens."""
    from repro_torch.resilience import snapshot as SNAP
    from repro_torch.serve.engine import Engine

    eng = Engine(params, cfg, step_mode="fused", **kw)
    max_new = [6, 14, 9, 12, 4, 10]
    for uid, (n, m) in enumerate(zip((640, 90, 300, 1200, 40, 500),
                                     max_new)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n), max_new=m,
                   uid=uid)
    for _ in range(5):
        eng.round()
    t0 = time.perf_counter()
    snap = SNAP.snapshot(eng)
    snap_s = time.perf_counter() - t0
    first = eng.run()
    again = SNAP.restore(snap, params=params).run()
    if first != again or sorted(first) != list(range(len(max_new))):
        _fail(f"snapshot: restored tokens {again} != {first}")
    print(f"snapshot: fused engine cut after 5 rounds ({snap_s:.3f} s to "
          f"copy the cache to host), restored on the same params: identical "
          f"tokens for {len(first)} requests; card {card}", flush=True)


def profile_rounds(eng, rounds: int, label: str, card):
    """torch.profiler over ``rounds`` engine rounds."""
    profile_window(lambda: [eng.round() for _ in range(rounds)], rounds,
                   "round", label, card)


def profile_window(fn, count: int, unit: str, label: str, card):
    """torch.profiler over ``fn()`` (``count`` rounds or steps): device
    busy time against wall time, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []  # device kernels only: host ops carry their kernels' time too
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0 and str(ev.device_type).endswith("CUDA"):
            rows.append((dev_us / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    top = "; ".join(f"{name[:60]} {ms:.2f} ms x{n}" for ms, n, name in rows[:6])
    print(f"profile: {count} {label}, wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{n_kernels / count:.0f} kernel launches a {unit}; top: "
          f"{top or 'no device time in the trace'}; card {card}", flush=True)


def smoke_identity(dev):
    """Smoke-size float32 engines on the card: split and fused with the
    kernels, fused with the plain versions, all emit identical greedy
    tokens; a 2-replica fleet with one injected launch error per step mode
    emits them too."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import model as MD
    from repro_torch.resilience import faults as F
    from repro_torch.serve.engine import Engine
    from repro_torch.serve.fleet import Fleet

    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n)
               for n in (37, 5, 60, 18, 23)]
    max_new = [8, 3, 6, 9, 5]
    kw = dict(slots=2, max_len=128, prefill_block=16, decode_block=16,
              decode_mode="packed", device=dev)
    outs = {}
    for name, impl, mode in (("split cuda", "cuda", "split"),
                             ("split torch", "torch", "split"),
                             ("fused cuda", "cuda", "fused"),
                             ("fused torch", "torch", "fused")):
        eng = Engine(params, cfg, prefill_impl=impl, decode_impl=impl,
                     step_mode=mode, **kw)
        outs[name], _ = _serve(eng, prompts, max_new)
        _check_served(f"smoke {name}", eng, outs[name], range(len(prompts)),
                      max_new, cfg)
    for name, got in outs.items():
        if got != outs["split cuda"]:
            _fail(f"smoke: {name} tokens {got} != split cuda "
                  f"{outs['split cuda']}")
    for mode in ("split", "fused"):
        fleet = Fleet(params, cfg, engines=2, heartbeat_timeout_s=5.0,
                      engine_kw=dict(kw, step_mode=mode),
                      fault_plan=F.FaultPlan([F.Fault(
                          "launch_error", "decode", 1, times=99, engine=0)]))
        for uid, (p, m) in enumerate(zip(prompts, max_new)):
            fleet.submit(p, max_new=m, uid=uid)
        got = fleet.run(max_steps=200)
        st = fleet.stats
        if got != outs["split cuda"] or not st["fleet_failovers_total"] or \
                any(r["status"] != "done" for r in fleet.report().values()):
            _fail(f"smoke fleet ({mode}): tokens {got} != "
                  f"{outs['split cuda']} or no failover: {st}")
    print(f"smoke: float32 engines, split/fused x cuda/torch greedy tokens "
          f"identical for {len(prompts)} requests; 2-replica fleet with an "
          f"injected launch error fails over to identical tokens in both "
          f"step modes", flush=True)


def train_kernel_phase(dev, K, OPS, SC):
    """tri_attn.fwd, bwd dq and bwd dk/dv at the attention shape of the
    train phase (one yi-9b layer at seq 4096: B 1, H 32, Hkv 4, D 128,
    ltm, blk 64, bf16) against their plain versions on the same inputs,
    timed beside them, SDPA and the bound; band and prefix schedules at
    blk 16 and 64 on small shapes."""
    import torch.nn.functional as F

    rng = np.random.default_rng(3)
    dt = torch.bfloat16

    def case(b, h, hkv, s, d):
        return [torch.as_tensor(rng.standard_normal(shape, np.float32),
                                device=dev).to(dt)
                for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d),
                              (b, h, s, d))]

    def check(label, q, k, v, do, sched):
        """The three kernels against their plain versions; returns the
        errors and the kernels' outputs."""
        scale = q.shape[-1] ** -0.5
        out, lse = K.fwd(q, k, v, sched)
        delta = (do.float() * out.float()).sum(dim=-1)
        dq = K.bwd_dq(q, k, v, do, lse, delta, sched)
        dk, dv = K.bwd_dkv(q, k, v, do, lse, delta, sched)
        torch.cuda.synchronize()
        w_out, w_lse = SC.fwd_torch(q, k, v, sched, scale)
        w_dq = SC.dq_torch(q, k, v, do, lse, delta, sched, scale)
        w_dk, w_dv = SC.dkv_torch(q, k, v, do, lse, delta, sched, scale)
        errs = (max(_close(f"{label} fwd out", out, w_out),
                    _close(f"{label} fwd lse", lse, w_lse, LSE_TOL)),
                _close(f"{label} bwd dq", dq, w_dq),
                max(_close(f"{label} bwd dk", dk, w_dk),
                    _close(f"{label} bwd dv", dv, w_dv)))
        return errs, (out, lse, delta)

    for kind in ("band", "prefix"):
        for blk in (16, 64):
            window, prefix = (blk + 5, 0) if kind == "band" else \
                (None, blk + 3)
            q, k, v, do = case(2, 8, 2, 6 * blk, 128)
            check(f"{kind} blk {blk}", q, k, v, do,
                  OPS.make_sched(6 * blk, block=blk, window=window,
                                 prefix=prefix))
    b, h, hkv, s, d, blk = 1, 32, 4, 4096, 128, 64
    q, k, v, do = case(b, h, hkv, s, d)
    sched = OPS.make_sched(s, block=blk)
    scale = d ** -0.5
    errs, (out, lse, delta) = check("ltm", q, k, v, do, sched)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    _close("fwd vs SDPA", out, sdpa())
    bw = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*bw, is_causal=True,
                                           enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(o_lib, bw, do, retain_graph=True)
    ms = {"fwd": _median_ms(lambda: K.fwd(q, k, v, sched), 5),
          "dq": _median_ms(lambda: K.bwd_dq(q, k, v, do, lse, delta, sched),
                           5),
          "dkv": _median_ms(lambda: K.bwd_dkv(q, k, v, do, lse, delta,
                                              sched), 5)}
    plain = {"fwd": _median_ms(lambda: SC.fwd_torch(q, k, v, sched, scale),
                               3, 1),
             "dq": _median_ms(lambda: SC.dq_torch(q, k, v, do, lse, delta,
                                                  sched, scale), 3, 1),
             "dkv": _median_ms(lambda: SC.dkv_torch(q, k, v, do, lse, delta,
                                                    sched, scale), 3, 1)}
    lib_fwd, lib_bwd = _median_ms(sdpa, 10), _median_ms(sdpa_bwd, 5)
    pairs = h * s * (s + 1) // 2  # unmasked (query, key) pairs, ltm
    bounds = _attn_bounds(q, k, pairs)
    names = {"fwd": ("tri_attn.fwd", "src/repro_torch/csrc/tri_fwd.cu",
                     "src/repro/kernels/tri_attn/kernel.py:293",
                     "SDPA is_causal forward"),
             "dq": ("tri_attn.bwd_dq", "src/repro_torch/csrc/tri_bwd.cu",
                    "src/repro/kernels/tri_attn/kernel.py:1090",
                    "SDPA is_causal backward through autograd (dq, dk and "
                    "dv together: no PyTorch call computes dq alone)"),
             "dkv": ("tri_attn.bwd_dkv", "src/repro_torch/csrc/tri_bwd.cu",
                     "src/repro/kernels/tri_attn/kernel.py:1090",
                     "SDPA is_causal backward through autograd (dq, dk and "
                     "dv together)")}
    out_rows = []
    for key, err in zip(("fwd", "dq", "dkv"), errs):
        name, src, rep, lib = names[key]
        out_rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "max_abs_err": err, "ms": ms[key], "plain_ms": plain[key],
            "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
            "library_ms": lib_fwd if key == "fwd" else lib_bwd,
            "library": lib,
            "shape": {"B": b, "H": h, "Hkv": hkv, "S": s, "D": d,
                      "blk": blk, "kind": "ltm", "pairs": pairs}})
    return out_rows


def _attn_bounds(q, k, pairs: int) -> dict:
    """Bounds of the forward, dq and dk/dv over ``pairs`` unmasked
    (query, key) pairs summed over heads: each input read once and each
    output written once (q, k, v, out, lse; + do, delta; dq or dk and dv)
    against 4, 6 and 8 x D flops a pair (S and PV; S, dP and dS K; S, dP,
    P^T dO and dS^T Q) at the bf16 tensor-core rate."""
    d, elt = q.shape[-1], q.element_size()
    qkv = q.numel() + 2 * k.numel()
    rows = q.numel() // d * 4  # one f32 per (b, h, row): lse, delta
    return {"fwd": _bound(elt * (qkv + q.numel()) + rows, 4 * d * pairs,
                          q.dtype),
            "dq": _bound(elt * (qkv + 2 * q.numel()) + 2 * rows,
                         6 * d * pairs, q.dtype),
            "dkv": _bound(elt * (qkv + q.numel() + 2 * k.numel())
                          + 2 * rows, 8 * d * pairs, q.dtype)}


def packed_train_kernel_phase(dev, K, OPS, SC):
    """packed_fwd and the packed dq and dk/dv at the attention shape of the
    packed train phase (one row of TRAIN_DOCS padded to blk 64: 4096 rows,
    8 ltm members; B 1, H 32, Hkv 4, D 128, bf16) against their plain
    versions on the same inputs, timed beside them, SDPA with the
    block-diagonal causal mask and the bound; mixed ltm/prefix/band
    members at blk 16 and 64 on small shapes. Every run of the backward is
    repeated and must be bitwise equal (no atomics). Returns the rows of
    the two backward kernels and packed_fwd's reading at this shape."""
    import torch.nn.functional as F

    rng = np.random.default_rng(4)
    dt = torch.bfloat16

    def case(h, hkv, s, d):
        return [torch.as_tensor(rng.standard_normal(shape, np.float32),
                                device=dev).to(dt)
                for shape in ((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d),
                              (1, h, s, d))]

    def check(label, q, k, v, do, psched):
        scale = q.shape[-1] ** -0.5
        out, lse = K.packed_fwd(q, k, v, psched)
        delta = (do.float() * out.float()).sum(dim=-1)
        grads = (K.packed_bwd_dq(q, k, v, do, lse, delta, psched),
                 *K.packed_bwd_dkv(q, k, v, do, lse, delta, psched))
        again = (K.packed_bwd_dq(q, k, v, do, lse, delta, psched),
                 *K.packed_bwd_dkv(q, k, v, do, lse, delta, psched))
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(grads, again)):
            _fail(f"{label}: two runs of packed_bwd differ")
        w_out, w_lse = SC.packed_fwd_torch(q, k, v, psched, scale)
        w_dq = SC.packed_dq_torch(q, k, v, do, lse, delta, psched, scale)
        w_dk, w_dv = SC.packed_dkv_torch(q, k, v, do, lse, delta, psched,
                                         scale)
        errs = (max(_close(f"{label} packed_fwd out", out, w_out),
                    _close(f"{label} packed_fwd lse", lse, w_lse, LSE_TOL)),
                _close(f"{label} packed_bwd dq", grads[0], w_dq),
                max(_close(f"{label} packed_bwd dk", grads[1], w_dk),
                    _close(f"{label} packed_bwd dv", grads[2], w_dv)))
        return errs, (out, lse, delta)

    for blk in (16, 64):
        psched = OPS.make_packed_sched([5 * blk, 2 * blk, 3 * blk, blk],
                                       block=blk,
                                       window=[None, None, blk + 3, None],
                                       prefix=[0, blk + 1, 0, 0])
        check(f"mixed blk {blk}", *case(8, 2, psched.s_total, 128), psched)
    h, hkv, d, blk = 32, 4, 128, 64
    lens = [-(-n // blk) * blk for n in TRAIN_DOCS]
    psched = OPS.make_packed_sched(lens, block=blk)
    s = psched.s_total
    q, k, v, do = case(h, hkv, s, d)
    scale = d ** -0.5
    errs, (out, lse, delta) = check("ltm docs", q, k, v, do, psched)
    mask = torch.zeros((s, s), dtype=torch.bool, device=dev)
    base = 0
    for n_tok in lens:
        mask[base:base + n_tok, base:base + n_tok] = torch.ones(
            (n_tok, n_tok), dtype=torch.bool, device=dev).tril()
        base += n_tok
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)
    _close("packed_fwd vs SDPA (block-diagonal causal mask)", out, sdpa())
    bw = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    o_lib = F.scaled_dot_product_attention(*bw, attn_mask=mask,
                                           enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(o_lib, bw, do, retain_graph=True)
    ms = {"fwd": _median_ms(lambda: K.packed_fwd(q, k, v, psched), 5),
          "dq": _median_ms(lambda: K.packed_bwd_dq(q, k, v, do, lse, delta,
                                                   psched), 5),
          "dkv": _median_ms(lambda: K.packed_bwd_dkv(q, k, v, do, lse,
                                                     delta, psched), 5)}
    plain = {"fwd": _median_ms(lambda: SC.packed_fwd_torch(q, k, v, psched,
                                                           scale), 3, 1),
             "dq": _median_ms(lambda: SC.packed_dq_torch(
                 q, k, v, do, lse, delta, psched, scale), 3, 1),
             "dkv": _median_ms(lambda: SC.packed_dkv_torch(
                 q, k, v, do, lse, delta, psched, scale), 3, 1)}
    lib_fwd, lib_bwd = _median_ms(sdpa, 10), _median_ms(sdpa_bwd, 5)
    pairs = h * int(mask.sum())  # unmasked (query, key) pairs
    bounds = _attn_bounds(q, k, pairs)
    shape = {"B": 1, "H": h, "Hkv": hkv, "D": d, "blk": blk, "docs":
             list(TRAIN_DOCS), "member_lens": lens, "S": s, "kind": "ltm",
             "steps": psched.steps, "pairs": pairs}
    lib = ("SDPA backward through autograd with the block-diagonal causal "
           "mask (dq, dk and dv together: no PyTorch call computes one "
           "alone)")
    rows = [{"name": f"tri_attn.packed_bwd_{key}", "route": "cuda",
             "source": "src/repro_torch/csrc/packed_bwd.cu",
             "replaces": "src/repro/kernels/tri_attn/kernel.py:549",
             "max_abs_err": err, "ms": ms[key], "plain_ms": plain[key],
             "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
             "library_ms": lib_bwd, "library": lib, "shape": shape}
            for key, err in zip(("dq", "dkv"), errs[1:])]
    fwd_reading = {"max_abs_err": errs[0], "ms": ms["fwd"],
                   "plain_ms": plain["fwd"], "bound_ms": bounds["fwd"][0],
                   "bound_by": bounds["fwd"][1], "library_ms": lib_fwd,
                   "library": "SDPA forward with the block-diagonal causal "
                              "mask", "shape": shape}
    return rows, fwd_reading


# EDM tolerances of tests/oracles.py (edm, edm_sq; bf16 edm): sqrt
# amplifies the f32 roundoff of d^2 ~ 0 (a + b - 2ab)
EDM_TOL = {(torch.float32, False): dict(atol=2e-3, rtol=1e-4),
           (torch.float32, True): dict(atol=1e-5, rtol=1e-5),
           (torch.bfloat16, False): dict(atol=5e-2, rtol=5e-2)}
# the paper's measured BB / LTM time ratio of its EDM on Kepler
PAPER_I_KEPLER = (1.12, 1.15)
# the paper's experiment: pairwise distances of N points in d = 1..4
# features at blk 64, and the op's default blk 128 at N = 65536, d = 3
EDM_SWEEP = tuple((n_rows, d, 64) for n_rows in (16384, 32768, 65536)
                  for d in (1, 2, 3, 4)) + ((65536, 3, 128),)
EDM_HEADLINE = (65536, 3, 64)
EDM_FULL_ROWS = 16384  # checked in full against the plain version
EDM_SAMPLE = 4096  # tiles sampled at the largest N
DUMMY_NS = (1024, 4096)  # besides the envelope's last row
# the train phase's attention (B, H, Hkv, S, D, blk)
ATTN_SHAPE = (1, 32, 4, 4096, 128, 64)
PAPER_REPS, PAPER_WARMUP = 5, 1


def _isqrt64(x):
    """Exact floor(sqrt(x)) of an int64 tensor below 2^52: the float64
    candidate, corrected one step each way."""
    r = torch.sqrt(x.double()).floor().long()
    r = torch.where(r * r > x, r - 1, r)
    return torch.where((r + 1) * (r + 1) <= x, r + 1, r)


def _check_dummy(out, n: int):
    """dummy_ltm's output against the closed form i + j of every lambda,
    computed on the card in int64 in chunks; returns the lambdas
    checked."""
    t = n * (n + 1) // 2
    if tuple(out.shape) != (t, 1):
        _fail(f"dummy_ltm({n}): shape {tuple(out.shape)} != ({t}, 1)")
    step = 1 << 26
    for t0 in range(0, t, step):
        lam = torch.arange(t0, min(t, t0 + step), dtype=torch.int64,
                           device=out.device)
        i = (_isqrt64(8 * lam + 1) - 1) // 2
        j = lam - i * (i + 1) // 2
        bad = int((out[t0:t0 + step, 0] != (i + j).float()).sum())
        if bad:
            _fail(f"dummy_ltm({n}): {bad} of lambdas [{t0}, "
                  f"{t0 + len(lam)}) differ from i + j")
    return t


def _edm_close(name, got, want, tol):
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **tol):
        _fail(f"{name}: kernel disagrees with its plain version (max abs "
              f"err {err}, tolerance {tol})")
    return err


def _check_edm(EK, ER, x, blk, squared, sample: int, rng):
    """edm_ltm and edm_bb on x against the plain version: every tile when
    ``sample`` is 0, else a seeded sample of ``sample`` tiles plus every
    tile with an output element at or past offset 2^31 in either output.
    Also: BB's lower tiles equal LTM's bit for bit, BB's upper tiles and
    the diagonal self-distances are exact zeros. Returns the max abs
    error and the tiles checked against the plain version."""
    n_rows = x.shape[0]
    n = n_rows // blk
    t = n * (n + 1) // 2
    tol = EDM_TOL[(x.dtype, squared)]
    ltm = EK.edm_ltm(x, blk, squared=squared)
    bb = EK.edm_bb(x, blk, squared=squared)
    torch.cuda.synchronize()
    ii, jj = ER.tile_coords(n, x.device)
    bb_tiles = bb.view(n, blk, n, blk)
    step = max(1, (1 << 26) // (blk * blk))
    for t0 in range(0, t, step):
        sl = slice(t0, t0 + step)
        if not torch.equal(ltm[sl], bb_tiles[ii[sl], :, jj[sl], :]):
            _fail(f"edm N={n_rows} blk={blk}: BB's lower tiles differ from "
                  f"LTM's in lambdas [{t0}, {t0 + step})")
    rows = torch.arange(blk, device=x.device)
    for r0 in range(0, n_rows, blk * 64):  # 64 tile rows at a time
        band = bb[r0:r0 + blk * 64]
        tile_i = (r0 + torch.arange(band.shape[0], device=x.device)) // blk
        upper = (torch.arange(n_rows, device=x.device) // blk)[None, :] > \
            tile_i[:, None]
        if bool(((band != 0) & upper).any()):
            _fail(f"edm_bb N={n_rows} blk={blk}: nonzero upper tiles")
    diag = torch.tensor([i * (i + 1) // 2 + i for i in range(n)],
                        device=x.device)
    if int(torch.count_nonzero(ltm[diag][:, rows, rows])):
        _fail(f"edm N={n_rows} blk={blk}: nonzero self-distance")
    if sample:
        two31 = 2 ** 31
        # LTM tile lambda ends at (lambda + 1) b^2 - 1; BB tile (i, j) at
        # ((i + 1) b - 1) N + (j + 1) b - 1
        far = ((torch.arange(t, device=x.device) + 1) * blk * blk - 1
               >= two31) | (((ii + 1) * blk - 1) * n_rows + (jj + 1) * blk
                            - 1 >= two31)
        pick = torch.as_tensor(rng.choice(t, min(sample, t), replace=False),
                               device=x.device)
        far[pick] = True
        lams = torch.nonzero(far)[:, 0]
    else:
        lams = torch.arange(t, device=x.device)
        _edm_close(f"edm_bb N={n_rows} d={x.shape[1]}", bb,
                   EK.edm_bb_torch(x, blk, squared=squared), tol)
    err = 0.0
    for t0 in range(0, len(lams), step):
        lam = lams[t0:t0 + step]
        want = EK.edm_tiles(x, blk, ii[lam], jj[lam], squared=squared)
        err = max(err, _edm_close(f"edm_ltm N={n_rows} d={x.shape[1]}",
                                  ltm[lam], want, tol))
    return err, len(lams)


def paper_phase(dev, K, OPS, SC):
    """The paper's experiment on the card: dummy_ltm (the mapping alone),
    the EDM by g(lambda) (edm_ltm) against the bounding box (edm_bb), and
    the BB attention forward (fwd_bb) against tri_fwd. Checks each kernel
    against its plain version, times the plain versions and the library
    calls, then drives the experiment through the entry points (ops.edm,
    dummy_ltm, triangular_attention) with every count at 0 before and
    read after. Returns the four kernels' rows."""
    import torch.nn.functional as F

    from repro_torch.core import mapping as M
    from repro_torch.kernels.tri_edm import kernel as EK
    from repro_torch.kernels.tri_edm import ops as EOPS
    from repro_torch.kernels.tri_edm import ref as ER
    from repro_torch.obs import launch as OBS
    from repro_torch.obs import metrics as MET

    rng = np.random.default_rng(15)

    def points(n_rows, d, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal((n_rows, d), np.float32),
                               device=dev).to(dtype)

    # -- dummy_ltm over the whole certified envelope -----------------------
    n_env = M.LTM_TRACED_MAX_I
    checked = _check_dummy(EK.dummy_ltm(n_env, device=dev), n_env)
    for n in DUMMY_NS:
        _check_dummy(EK.dummy_ltm(n, device=dev), n)
    if not torch.equal(EK.dummy_ltm(DUMMY_NS[0], device=dev),
                       EK.dummy_ltm_torch(DUMMY_NS[0], dev)):
        _fail("dummy_ltm disagrees with its plain version")
    print(f"paper: dummy_ltm at n = {n_env} equals i + j for all {checked} "
          f"lambdas (int64 closed form on the card)", flush=True)

    # -- EDM correctness ----------------------------------------------------
    edm_err = {"tri_edm.ltm": 0.0}
    for d in (1, 2, 3, 4):
        err, _ = _check_edm(EK, ER, points(EDM_FULL_ROWS, d), 64, False, 0,
                            rng)
        edm_err["tri_edm.ltm"] = max(edm_err["tri_edm.ltm"], err)
    x = points(EDM_FULL_ROWS, 3)
    _check_edm(EK, ER, x, 64, True, 0, rng)
    _check_edm(EK, ER, x.to(torch.bfloat16), 64, False, 0, rng)
    big = [c for c in EDM_SWEEP if c[0] == EDM_HEADLINE[0]]
    for n_rows, d, blk in big:
        err, count = _check_edm(EK, ER, points(n_rows, d), blk, False,
                                EDM_SAMPLE, rng)
        edm_err["tri_edm.ltm"] = max(edm_err["tri_edm.ltm"], err)
        print(f"paper: edm N={n_rows} d={d} blk={blk}: {count} tiles "
              f"against the plain version ({EDM_SAMPLE} sampled + every "
              f"tile past offset 2^31), BB lower == LTM bitwise, zeros "
              f"exact; max "
              f"abs err {err:.3g}", flush=True)
    torch.cuda.empty_cache()

    # -- fwd_bb correctness at the train phase's attention shape ------------
    def qkv(b, h, hkv, s, d):
        return [torch.as_tensor(rng.standard_normal(shape, np.float32),
                                device=dev).to(torch.bfloat16)
                for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]

    attn_err = 0.0
    for blk in (16, 64):
        sched = OPS.make_sched(6 * blk, block=blk, window=blk + 5)
        q, k, v = qkv(2, 8, 2, 6 * blk, 128)
        out, lse = K.fwd_bb(q, k, v, sched)
        for label, (w_out, w_lse) in (
                ("plain", SC.fwd_bb_torch(q, k, v, sched, 128 ** -0.5)),
                ("tri_fwd", K.fwd(q, k, v, sched))):
            _close(f"fwd_bb band blk {blk} vs {label} out", out, w_out)
            _close(f"fwd_bb band blk {blk} vs {label} lse", lse, w_lse,
                   LSE_TOL)
    b, h, hkv, s, d, blk = ATTN_SHAPE
    q, k, v = qkv(b, h, hkv, s, d)
    sched = OPS.make_sched(s, block=blk)
    scale = d ** -0.5
    n_attn = sched.n
    reg = MET.Registry("fwd_bb")
    with MET.scope(reg):
        out, lse = K.fwd_bb(q, k, v, sched)
    again = K.fwd_bb(q, k, v, sched)
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
        _fail("fwd_bb: two runs differ")
    summ = OBS.kernel_summary(reg)["tri_attn.fwd_bb"]
    if (summ["launches"], summ["tiles_launched"], summ["tiles_domain"]) != \
            (1, n_attn * n_attn * b * h, M.tri(n_attn) * b * h):
        _fail(f"fwd_bb counters {summ}")
    w_out, w_lse = SC.fwd_bb_torch(q, k, v, sched, scale)
    f_out, f_lse = K.fwd(q, k, v, sched)
    attn_err = max(_close("fwd_bb out", out, w_out),
                   _close("fwd_bb lse", lse, w_lse, LSE_TOL),
                   _close("fwd_bb vs tri_fwd out", out, f_out),
                   _close("fwd_bb vs tri_fwd lse", lse, f_lse, LSE_TOL))
    del again, w_out, w_lse, f_out, f_lse
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    _close("fwd_bb vs SDPA", out, sdpa())
    print(f"paper: fwd_bb at B {b} H {h} Hkv {hkv} S {s} D {d} blk {blk} "
          f"matches fwd_bb_torch and tri_fwd (max abs err {attn_err:.3g}), "
          f"two runs bitwise equal, counters {summ['tiles_launched']} "
          f"launched / {summ['tiles_domain']} in the domain", flush=True)

    # -- plain versions and library calls (outside the counted path) --------
    n_rows, d_h, blk_h = EDM_HEADLINE
    x = points(n_rows, d_h)
    plain = {
        "tri_edm.ltm": _median_ms(lambda: EK.edm_ltm_torch(x, blk_h), 1, 1),
        "tri_edm.bb": _median_ms(lambda: EK.edm_bb_torch(x, blk_h), 1, 1),
        "tri_edm.dummy_ltm": _median_ms(
            lambda: EK.dummy_ltm_torch(n_env, dev), 3, 1),
        "tri_attn.fwd_bb": _median_ms(
            lambda: SC.fwd_bb_torch(q, k, v, sched, scale), 3, 1)}
    cdist = _median_ms(lambda: torch.cdist(x, x), 5, 1)
    library = {"tri_edm.ltm": cdist, "tri_edm.bb": cdist,
               "tri_edm.dummy_ltm": None,
               "tri_attn.fwd_bb": _median_ms(sdpa, 10)}
    del x
    torch.cuda.empty_cache()

    # -- the experiment, through the entry points, counted ------------------
    for mod in (K, EK):
        _reset_launches(mod)
    reg = MET.Registry("paper")
    sweep, per = [], PAPER_REPS + PAPER_WARMUP
    with MET.scope(reg), torch.no_grad():
        for e_rows, e_d, e_blk in EDM_SWEEP:
            x = points(e_rows, e_d)
            cfg_reg = MET.Registry("edm config")
            with MET.scope(cfg_reg):
                t_ltm = _median_ms(lambda: EOPS.edm(x, e_blk, impl="cuda"),
                                   PAPER_REPS, PAPER_WARMUP)
                t_bb = _median_ms(lambda: EOPS.edm(x, e_blk, impl="bb"),
                                  PAPER_REPS, PAPER_WARMUP)
            e_n = e_rows // e_blk
            flops = (2 * e_d + 4) * M.tri(e_n) * e_blk * e_blk
            sweep.append({
                "N": e_rows, "d": e_d, "blk": e_blk, "ltm_ms": t_ltm,
                "bb_ms": t_bb, "I_edm": t_bb / t_ltm,
                "I_struct": OBS.kernel_summary(cfg_reg)["tri_edm.ltm"][
                    "improvement_vs_bb"],
                "ltm_bound_ms": _bound(
                    4 * M.tri(e_n) * e_blk * e_blk + 4 * x.numel(), flops,
                    torch.float32)[0],
                "bb_bound_ms": _bound(4 * e_rows * e_rows + 4 * x.numel(),
                                      flops, torch.float32)[0]})
            del x
        dummy_ms = {n: _median_ms(lambda: EK.dummy_ltm(n, device=dev),
                                  PAPER_REPS, PAPER_WARMUP)
                    for n in DUMMY_NS + (n_env,)}
        attn_ms = {impl: _median_ms(
            lambda: OPS.triangular_attention(q, k, v, impl=impl, block=blk),
            PAPER_REPS, PAPER_WARMUP) for impl in ("bb", "cuda")}
    launches = {**_launches(EK), **_launches(K)}
    want = {"tri_edm.ltm": per * len(EDM_SWEEP),
            "tri_edm.bb": per * len(EDM_SWEEP),
            "tri_edm.dummy_ltm": per * (len(DUMMY_NS) + 1),
            "tri_attn.fwd_bb": per, "tri_attn.fwd": per}
    for mod in (EK, K):
        _check_launches("paper", mod, reg, {
            name: c for name, c in want.items() if name in mod.WRAPPERS})
    torch.cuda.empty_cache()

    i_attn = attn_ms["bb"] / attn_ms["cuda"]
    for row in sweep:
        print(f"paper: edm N={row['N']} d={row['d']} blk={row['blk']}: LTM "
              f"{row['ltm_ms']:.4f} ms (bound {row['ltm_bound_ms']:.4f}), "
              f"BB {row['bb_ms']:.4f} ms (bound {row['bb_bound_ms']:.4f}); "
              f"I_edm {row['I_edm']:.4f} (structural n^2/tri(n) "
              f"{row['I_struct']:.4f}; the paper on Kepler "
              f"{PAPER_I_KEPLER[0]}-{PAPER_I_KEPLER[1]})", flush=True)
    for n, ms in dummy_ms.items():
        print(f"paper: dummy_ltm n={n}: {ms:.4f} ms, "
              f"{ms * 1e6 / M.tri(n):.4f} ns a block", flush=True)
    print(f"paper: attention at B {b} H {h} S {s} blk {blk}: fwd_bb "
          f"{attn_ms['bb']:.4f} ms, tri_fwd {attn_ms['cuda']:.4f} ms, I_attn "
          f"{i_attn:.4f} (structural "
          f"{n_attn * n_attn / M.tri(n_attn):.4f})", flush=True)

    head = next(r for r in sweep if (r["N"], r["d"], r["blk"]) == EDM_HEADLINE)
    n_h = EDM_HEADLINE[0] // EDM_HEADLINE[2]
    x_bytes = 4 * EDM_HEADLINE[0] * EDM_HEADLINE[1]
    flops_h = (2 * EDM_HEADLINE[1] + 4) * M.tri(n_h) * EDM_HEADLINE[2] ** 2
    shape = {"N": EDM_HEADLINE[0], "d": EDM_HEADLINE[1],
             "blk": EDM_HEADLINE[2], "dtype": "float32"}
    lib_edm = ("torch.cdist(x, x): the full N x N f32 matrix (no PyTorch "
               "call gives the packed output)")
    bounds = {
        "tri_edm.ltm": _bound(4 * M.tri(n_h) * EDM_HEADLINE[2] ** 2 + x_bytes,
                              flops_h, torch.float32),
        "tri_edm.bb": _bound(4 * EDM_HEADLINE[0] ** 2 + x_bytes, flops_h,
                             torch.float32),
        "tri_edm.dummy_ltm": _bound(4 * M.tri(n_env), 0, torch.float32),
        "tri_attn.fwd_bb": _attn_bounds(q, k, h * s * (s + 1) // 2)["fwd"]}
    rows = [
        {"name": "tri_edm.ltm", "source": "src/repro_torch/csrc/tri_edm.cu",
         "replaces": "src/repro/kernels/tri_edm/kernel.py:50",
         "max_abs_err": edm_err["tri_edm.ltm"], "ms": head["ltm_ms"],
         "library": lib_edm, "shape": shape, "sweep": sweep},
        {"name": "tri_edm.bb", "source": "src/repro_torch/csrc/tri_edm.cu",
         "replaces": "src/repro/kernels/tri_edm/kernel.py:90",
         "max_abs_err": edm_err["tri_edm.ltm"], "ms": head["bb_ms"],
         "library": lib_edm, "shape": shape, "I_edm": head["I_edm"],
         "I_struct": head["I_struct"]},
        {"name": "tri_edm.dummy_ltm",
         "source": "src/repro_torch/csrc/tri_edm.cu",
         "replaces": "src/repro/kernels/tri_edm/kernel.py:117",
         "max_abs_err": 0.0, "ms": dummy_ms[n_env],
         "library": None, "shape": {"n": n_env, "blocks": M.tri(n_env)},
         "ms_by_n": {str(n): ms for n, ms in dummy_ms.items()},
         "ns_per_block": dummy_ms[n_env] * 1e6 / M.tri(n_env)},
        {"name": "tri_attn.fwd_bb", "source": "src/repro_torch/csrc/fwd_bb.cu",
         "replaces": "src/repro/kernels/tri_attn/kernel.py:1205",
         "max_abs_err": attn_err, "ms": attn_ms["bb"],
         "library": "SDPA is_causal forward",
         "shape": {"B": b, "H": h, "Hkv": hkv, "S": s, "D": d, "blk": blk,
                   "kind": "ltm"},
         "tri_fwd_ms": attn_ms["cuda"], "I_attn": i_attn}]
    for row in rows:
        name = row["name"]
        row.update(route="cuda", plain_ms=plain[name],
                   bound_ms=bounds[name][0], bound_by=bounds[name][1],
                   library_ms=library[name], launches=launches[name])
    return rows


def _timed(step, times: list):
    """``step`` with its wall time (synchronized) appended to ``times``."""
    def timed_step(state, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return state, metrics

    return timed_step


def _check_launches(label, K, reg, want_nonzero: dict) -> dict:
    """Every wrapper's count equals ``want_nonzero`` (0 for the others)
    and no plain version ran; returns the nonzero counts."""
    launches = _launches(K)
    want = dict.fromkeys(launches, 0)
    want.update(want_nonzero)
    plain = {n: reg.counter_value("launches_total", {"name": n,
                                                     "impl": "torch"})
             for n in want}
    if launches != want or any(plain.values()):
        _fail(f"{label}: kernel launches {launches} != {want}, or plain "
              f"versions ran {plain}")
    return dict(want_nonzero)


def train_phase(dev, layers: int, card, K, OPS):
    """yi-9b at full width, ``layers`` deep, for 3 training steps of seq
    4096 through the kernels, then 3 packed document steps on the same
    state; returns each kernel's launches on the dense and on the packed
    path."""
    from repro_torch.configs import yi_9b
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.obs import metrics as MET
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    cfg = dataclasses.replace(yi_9b.CONFIG, n_layers=layers)
    seq, steps = 4096, 3
    print(f"train: depth cut to {layers} of {yi_9b.CONFIG.n_layers} layers "
          f"(12 bytes a parameter of bf16 weights and grads and f32 AdamW "
          f"moments: all 48 layers need ~106 GB)", flush=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = OPT.OptConfig()
    t0 = time.perf_counter()
    state = TS.init_state(cfg, opt, seed=0, device=dev)
    n_params = sum(x.numel() for x in _leaves(state.params))
    torch.cuda.synchronize()
    state_gb = torch.cuda.memory_allocated() / 1e9
    print(f"train: yi-9b {layers}L d_model={cfg.d_model} H={cfg.n_heads} "
          f"Hkv={cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size}: "
          f"{n_params / 1e9:.3f} B params, {state_gb:.2f} GB of weights and "
          f"AdamW moments in {time.perf_counter() - t0:.1f} s", flush=True)
    ds = DATA.SyntheticLM(cfg, ShapeConfig("train_4k", seq, 1, "train"),
                          seed=0, device=dev)
    step = TS.make_train_step(cfg, opt, attn_impl="cuda", remat=True,
                              block=64)
    times = []
    reg = MET.Registry("train_phase")
    _reset_launches(K)
    with MET.scope(reg):
        state, log = FT.run_training(state, _timed(step, times), ds.batch,
                                     steps)
    launches = _check_launches(
        "train", K, reg, {"tri_attn.fwd": 2 * layers * steps,
                          "tri_attn.bwd_dq": layers * steps,
                          "tri_attn.bwd_dkv": layers * steps})
    losses = [m["loss"] for m in log]
    if len(losses) != steps or not all(np.isfinite(losses)) or \
            min(losses) <= 0:
        _fail(f"train: losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"train: {steps} steps of {seq} tokens, losses {losses}, grad "
          f"norms {[m['grad_norm'] for m in log]}; step times {times} s, "
          f"{seq / statistics.median(times):.1f} trained tokens/s (median "
          f"step); peak memory {peak_gb:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} "
          f"(state {state_gb:.2f}); launches {launches}; card {card}",
          flush=True)
    profile_window(lambda: step(state, ds.batch(steps)), 1, "step",
                   "training step", card)
    packed_launches = packed_train(cfg, opt, state, card, K, OPS)
    del state
    torch.cuda.empty_cache()
    return launches, packed_launches


def packed_train(cfg, opt, state, card, K, OPS):
    """Packed document training on the train phase's state (the 24-layer
    state is reused: a second one does not fit): 3 steps of PackedDocsLM
    rows of TRAIN_DOCS through packed_fwd and the packed dq and dk/dv, a
    profiler window over a fourth, then one forward+backward of the packed
    row and of the pad-to-max batch on the same parameters. Returns the
    kernels' launches over the 3 steps."""
    from repro_torch.models import model as MD
    from repro_torch.obs import metrics as MET
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import train_step as TS

    layers, blk, steps = cfg.n_layers, 64, 3
    dev = state.params["embed"].device
    docs = DATA.PackedDocsLM(cfg, TRAIN_DOCS, block=blk, seed=0, device=dev)
    psched = OPS.make_packed_sched(docs.member_lens, block=blk)
    step = TS.make_train_step(cfg, opt, attn_impl="cuda", remat=True,
                              block=blk, packed=psched)
    real = sum(TRAIN_DOCS)
    times = []
    first = int(state.step)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reg = MET.Registry("packed_train")
    _reset_launches(K)
    with MET.scope(reg):
        state, log = FT.run_training(state, _timed(step, times), docs.batch,
                                     first + steps)
    launches = _check_launches(
        "packed train", K, reg,
        {"tri_attn.packed_fwd": 2 * layers * steps,
         "tri_attn.packed_bwd_dq": layers * steps,
         "tri_attn.packed_bwd_dkv": layers * steps})
    losses = [m["loss"] for m in log]
    if len(losses) != steps or not all(np.isfinite(losses)) or \
            min(losses) <= 0:
        _fail(f"packed train: losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"packed train: {steps} steps of one {docs.s_total}-row packed "
          f"row ({len(TRAIN_DOCS)} documents, {real} real tokens, "
          f"{psched.steps} tiles a head against {len(TRAIN_DOCS)} x "
          f"{max(docs.member_lens) // blk}^2 = "
          f"{len(TRAIN_DOCS) * (max(docs.member_lens) // blk) ** 2} "
          f"pad-to-max), losses {losses}; step times {times} s, "
          f"{real / statistics.median(times):.1f} real tokens/s (median "
          f"step); peak memory {peak_gb:.2f} GB; launches {launches}; card "
          f"{card}", flush=True)
    profile_window(lambda: step(state, docs.batch(first + steps)), 1,
                   "step", "packed training step", card)

    def fwd_bwd(batch, packed):
        views = TS.trainable(state.params)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, _ = MD.loss_fn(views, cfg, batch, attn_impl="cuda",
                             remat=True, block=blk, packed=packed)
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    packed_loss, packed_s = fwd_bwd(docs.batch(first + steps + 1), psched)
    padded = docs.padded_batch(first + steps + 1)
    reg = MET.Registry("padded")
    _reset_launches(K)
    with MET.scope(reg):
        padded_loss, padded_s = fwd_bwd(padded, None)
    _check_launches("padded fwd+bwd", K, reg,
                          {"tri_attn.fwd": 2 * layers,
                           "tri_attn.bwd_dq": layers,
                           "tri_attn.bwd_dkv": layers})
    if not np.isclose(packed_loss, padded_loss, rtol=PAD_LOSS_RTOL, atol=0):
        _fail(f"packed loss {packed_loss} != pad-to-max loss {padded_loss} "
              f"(rtol {PAD_LOSS_RTOL})")
    print(f"packed vs pad-to-max, same parameters and documents: forward+"
          f"backward {packed_s:.4f} s packed ({docs.s_total} rows) against "
          f"{padded_s:.4f} s pad-to-max ({tuple(padded['tokens'].shape)}); "
          f"losses {packed_loss} and {padded_loss} (rtol {PAD_LOSS_RTOL}); "
          f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
          f"card {card}", flush=True)
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def smoke_training(dev):
    """Smoke-size float32 training on the card: the kernels against the
    plain versions over 3 steps, the loss falling over 20, and a resumed
    run bitwise equal to an unbroken one."""
    from repro_torch.configs import registry as REG
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import optimizer as OPT
    from repro_torch.train import train_step as TS

    cfg = REG.smoke_config("yi-9b")
    opt = OPT.OptConfig(lr=3e-3, warmup_steps=2, total_steps=20)
    ds = DATA.SyntheticLM(cfg, ShapeConfig("t", 64, 4, "train"), seed=0,
                          device=dev)
    base = TS.init_state(cfg, opt, seed=0, device=dev)
    steps = {impl: TS.make_train_step(cfg, opt, attn_impl=impl, block=16)
             for impl in ("cuda", "torch")}
    losses = {impl: [m["loss"] for m in FT.run_training(
        copy.deepcopy(base), fn, ds.batch, 3)[1]]
        for impl, fn in steps.items()}
    # f32 on both sides, sums in other orders: 1e-5 relative at most
    if not np.allclose(losses["cuda"], losses["torch"], rtol=1e-5, atol=0):
        _fail(f"smoke training: kernel losses {losses['cuda']} != plain "
              f"{losses['torch']}")
    _, log = FT.run_training(copy.deepcopy(base), steps["cuda"], ds.batch,
                             20)
    if not log[-1]["loss"] < log[0]["loss"] - 0.5:
        _fail(f"smoke training: 20 steps did not lower the loss: "
              f"{[m['loss'] for m in log]}")
    ckpt = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    straight, _ = FT.run_training(copy.deepcopy(base), steps["cuda"],
                                  ds.batch, 6)
    FT.run_training(copy.deepcopy(base), steps["cuda"], ds.batch, 3,
                    manager=CKPT.CheckpointManager(str(ckpt), every=3))
    resumed, _ = CKPT.restore(str(ckpt), base, device=dev)
    resumed, _ = FT.run_training(resumed, steps["cuda"], ds.batch, 6)
    shutil.rmtree(ckpt)
    pairs = list(zip(_leaves({"p": straight.params, "o": straight.opt_state}),
                     _leaves({"p": resumed.params, "o": resumed.opt_state})))
    if resumed.step != straight.step or \
            not all(torch.equal(a, b) for a, b in pairs):
        _fail("smoke training: 3 + checkpoint + restore + 3 steps differ "
              "from 6 straight steps")
    print(f"smoke training: float32, 3 steps kernels {losses['cuda']} vs "
          f"plain {losses['torch']}; 20 steps {log[0]['loss']:.4f} -> "
          f"{log[-1]['loss']:.4f}; 6 steps straight == 3 + checkpoint + "
          f"restore + 3, bitwise over {len(pairs)} tensors", flush=True)
    smoke_packed_training(dev, cfg, opt, base)


def smoke_packed_training(dev, cfg, opt, base):
    """Smoke-size float32 packed document training on the card: 3 steps
    with the kernels and with the plain versions agree, and the packed
    row's loss equals the pad-to-max batch's on the same parameters."""
    from repro_torch.kernels.tri_attn import ops as OPS
    from repro_torch.models import model as MD
    from repro_torch.train import data as DATA
    from repro_torch.train import fault_tolerance as FT
    from repro_torch.train import train_step as TS

    blk = 16
    docs = DATA.PackedDocsLM(cfg, (61, 9, 30, 17, 3), block=blk, seed=0,
                             device=dev)
    psched = OPS.make_packed_sched(docs.member_lens, block=blk)
    losses = {impl: [m["loss"] for m in FT.run_training(
        copy.deepcopy(base), TS.make_train_step(
            cfg, opt, attn_impl=impl, block=blk, packed=psched),
        docs.batch, 3)[1]] for impl in ("cuda", "torch")}
    # f32 on both sides, sums in other orders: 1e-5 relative at most
    if not np.allclose(losses["cuda"], losses["torch"], rtol=1e-5, atol=0):
        _fail(f"smoke packed training: kernel losses {losses['cuda']} != "
              f"plain {losses['torch']}")
    with torch.no_grad():
        packed, padded = (MD.loss_fn(base.params, cfg, batch, block=blk,
                                     packed=ps)[0].item()
                          for batch, ps in ((docs.batch(0), psched),
                                            (docs.padded_batch(0), None)))
    if not np.isclose(packed, padded, rtol=1e-5, atol=0):
        _fail(f"smoke packed training: packed loss {packed} != pad-to-max "
              f"{padded}")
    print(f"smoke packed training: float32, 3 steps kernels "
          f"{losses['cuda']} vs plain {losses['torch']}; packed loss "
          f"{packed} == pad-to-max {padded} (rtol 1e-5)", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=48,
                    help="cut the served model's depth (default: all 48)")
    ap.add_argument("--train-layers", type=int, default=24,
                    help="depth of the trained model (default 24: the "
                         "48-layer AdamW state does not fit 80 GB)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: no CUDA card")
    src = Path(__file__).resolve().parent / "src"
    sys.path.insert(0, str(src))
    try:
        from repro_torch.kernels import build as BUILD
        from repro_torch.kernels.tri_attn import kernel as K
        from repro_torch.kernels.tri_attn import ops as OPS
        from repro_torch.kernels.tri_attn import scan_impl as SC
        from repro_torch.serve import decode as D
    except ImportError as e:
        _fail(f"cannot import repro_torch from {src}: {e}")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"card: {card}", flush=True)
    build_s = BUILD.build_all()
    print(f"build: {build_s:.1f} s (nvcc, sm_90a) into {BUILD.build_dir()}",
          flush=True)
    ctx, kernels = kernel_phase(dev, K, OPS, SC)
    kernels.append(fused_kernel_phase(dev, K, OPS, SC, D, ctx))
    del ctx
    kernels += train_kernel_phase(dev, K, OPS, SC)
    packed_rows, packed_fwd_train = packed_train_kernel_phase(dev, K, OPS,
                                                              SC)
    kernels += packed_rows
    torch.cuda.empty_cache()
    kernels += paper_phase(dev, K, OPS, SC)
    print("kernels: " + "; ".join(
        f"{k['name']} {k['ms']:.4f} ms (plain {k['plain_ms']:.3f}, library "
        + ("none" if k["library_ms"] is None else f"{k['library_ms']:.4f}")
        + f", bound {k['bound_ms']:.4f} by {k['bound_by']}) err "
        f"{k['max_abs_err']:.3g}" for k in kernels), flush=True)
    launches = serving_phase(dev, args.layers, card, K)
    smoke_identity(dev)
    dense, packed = train_phase(dev, args.train_layers, card, K, OPS)
    launches.update(dense)
    launches.update({n: c for n, c in packed.items()
                     if n != "tri_attn.packed_fwd"})
    packed_fwd_train["launches"] = packed["tri_attn.packed_fwd"]
    smoke_training(dev)
    for k in kernels:
        if "launches" in k:  # the paper phase counted its own path
            continue
        k["launches"] = launches[k["name"]]
        if k["name"] == "tri_attn.packed_fwd":
            # its serving reading and launches above, its packed-training
            # ones here
            k["at_train_shape"] = packed_fwd_train
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
