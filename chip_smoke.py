"""Drive the PyTorch/CUDA port (src/repro_torch) end to end on one NVIDIA card.

    python3 chip_smoke.py [--layers N]

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from src/repro_torch/csrc (nvcc, sm_90a);
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
     the plain versions, which must emit identical greedy tokens.
The last lines are the card line, the {"kernels": [...]} line and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
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
    return [
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


def serving_phase(dev, layers: int, card: str, K):
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
    eng = Engine(params, cfg, slots=4, max_len=2048, prefill_block=64,
                 decode_block=64, prefill_impl="cuda", decode_impl="cuda",
                 decode_mode="packed", device=dev)
    rng = np.random.default_rng(1)
    prompt_lens = [1000, 90, 500, 250, 700, 60, 380, 150]
    max_new = 32
    for uid, n in enumerate(prompt_lens):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n), max_new=max_new,
                   uid=uid)
    K.packed_fwd.launches = 0
    K.packed_decode_fwd.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"tri_attn.packed_fwd": K.packed_fwd.launches,
                "tri_attn.packed_decode_fwd": K.packed_decode_fwd.launches}
    st = eng.stats
    report = eng.report()
    if sorted(results) != list(range(len(prompt_lens))) or any(
            r["status"] != "done" for r in report.values()):
        _fail(f"serving: not every request is done: {report}")
    if any(len(results[u]) != max_new for u in results):
        _fail("serving: a request emitted the wrong number of tokens")
    if any(not 0 <= t < cfg.vocab_size for u in results for t in results[u]):
        _fail("serving: a token lies outside the vocabulary")
    if st["launches_degraded_total"] or st["requests_failed_total"]:
        _fail(f"serving: degraded={st['launches_degraded_total']} "
              f"failed={st['requests_failed_total']}")
    n_l = cfg.n_layers
    if launches["tri_attn.packed_fwd"] != n_l * st["prefill_launches"] or \
            launches["tri_attn.packed_decode_fwd"] != \
            n_l * st["decode_packed_launches"] or \
            st["decode_packed_launches"] != st["decode_rounds"] or \
            not all(launches.values()):
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
    profile_decode(eng, cfg, rng, card)
    del eng, params
    torch.cuda.empty_cache()
    return launches


def profile_decode(eng, cfg, rng, card, rounds: int = 4):
    """torch.profiler over a few packed decode rounds of 4 fresh requests:
    device busy time against wall time, and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    for uid, n in enumerate((900, 40, 600, 200)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=n),
                   max_new=rounds + 2, uid=1000 + uid)
    eng.run(max_steps=1)  # admit + first decode round, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(max_steps=rounds)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run()
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
    print(f"profile: {rounds} packed decode rounds, wall {wall_ms:.1f} ms, "
          f"device busy {busy:.1f} ms ({100 * busy / wall_ms:.1f}%), "
          f"{n_kernels / rounds:.0f} kernel launches a round; top: "
          f"{top or 'no device time in the trace'}; card {card}", flush=True)


def smoke_identity(dev):
    """Smoke-size float32 engine: kernels and plain versions emit identical
    greedy tokens on the card."""
    from repro_torch.configs import registry as REG
    from repro_torch.models import model as MD
    from repro_torch.serve.engine import Engine

    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n)
               for n in (37, 5, 60, 18, 23)]
    outs = {}
    for impl in ("cuda", "torch"):
        eng = Engine(params, cfg, slots=2, max_len=128, prefill_block=16,
                     decode_block=16, prefill_impl=impl, decode_impl=impl,
                     decode_mode="packed", device=dev)
        for uid, p in enumerate(prompts):
            eng.submit(p, max_new=8, uid=uid)
        outs[impl] = eng.run()
        if eng.stats["launches_degraded_total"]:
            _fail(f"smoke engine ({impl}) degraded")
    if outs["cuda"] != outs["torch"]:
        _fail(f"smoke engine: kernel tokens {outs['cuda']} != plain "
              f"{outs['torch']}")
    print(f"smoke: float32 engine, cuda == torch greedy tokens for "
          f"{len(prompts)} requests", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=48,
                    help="cut the served model's depth (default: all 48)")
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
    kernels = kernel_phase(dev, K, OPS, SC)
    print("kernels: " + "; ".join(
        f"{k['name']} {k['ms']:.4f} ms (plain {k['plain_ms']:.3f}, SDPA "
        f"{k['library_ms']:.4f}, bound {k['bound_ms']:.4f} by "
        f"{k['bound_by']}) err {k['max_abs_err']:.3g}" for k in kernels),
        flush=True)
    launches = serving_phase(dev, args.layers, card, K)
    smoke_identity(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
