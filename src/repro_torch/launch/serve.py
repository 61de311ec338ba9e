"""Serving entry point of the port (port of ``repro/launch/serve.py``).

Serves a batch of random prompts through the continuous-batching engine
on the smoke config of ``--arch`` (any of the registry's ten): on the
card by default (the tri_attn kernels; for rwkv6-1.6b the WKV kernel,
for jamba-1.5-large-398b the selective-scan kernel, under sequential
admission and lockstep decode, which the engine picks for an arch with
recurrent layers), or with ``--device cpu`` on the plain PyTorch
versions. Weights are random from ``--seed``
(``models.model.init_params``).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --requests 6
    PYTHONPATH=src python -m repro_torch.launch.serve --step-mode fused
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import device as DEV
from repro_torch.configs import registry as REG
from repro_torch.models import model as MD
from repro_torch.serve.engine import Engine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-9b", choices=REG.ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-mode", default="packed",
                    choices=["packed", "sequential"],
                    help="packed = one ragged launch per admit round; "
                         "sequential = per-token loop (--device cpu only)")
    ap.add_argument("--prefill-block", type=int, default=16)
    ap.add_argument("--decode-mode", default="packed",
                    choices=["packed", "lockstep"],
                    help="packed = one mixed-position launch per decode "
                         "round; lockstep = full-cache einsum (--device cpu "
                         "only)")
    ap.add_argument("--decode-block", type=int, default=16)
    ap.add_argument("--step-mode", default="split",
                    choices=["split", "fused"],
                    help="fused = admits and decodes in one launch a round")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels; cpu: their plain versions")
    args = ap.parse_args(argv)

    impl = DEV.attn_impl(args.device)
    cfg = REG.smoke_config(args.arch)
    attn_only = all(k == "attn" for k in cfg.layer_kinds)
    if impl == "cuda" and attn_only and (args.prefill_mode == "sequential"
                                         or args.decode_mode == "lockstep"):
        ap.error("sequential prefill and lockstep decode run the plain "
                 "version of attention: pass --device cpu with them")
    params = MD.init_params(cfg, seed=args.seed, device=args.device)
    engine = Engine(params, cfg, slots=args.slots, max_len=args.max_len,
                    temperature=args.temperature, seed=args.seed,
                    prefill_mode=args.prefill_mode,
                    prefill_block=args.prefill_block, prefill_impl=impl,
                    decode_mode=args.decode_mode,
                    decode_block=args.decode_block, decode_impl=impl,
                    step_mode=args.step_mode, device=args.device)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for uid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, args.prompt_len + 1))
        engine.submit(prompt, max_new=args.max_new, uid=uid)
    results = engine.run()
    dt = time.time() - t0
    n_tok = sum(len(v) for v in results.values())
    for uid in sorted(results):
        print(f"req {uid}: {len(results[uid])} tokens -> "
              f"{results[uid][:8]}...")
    st = engine.stats
    print(f"{len(results)}/{args.requests} requests, {n_tok} tokens "
          f"in {dt:.1f}s ({n_tok / dt:.1f} tok/s, {args.slots} slots, "
          f"device={args.device}, step_mode={engine.step_mode})")
    print(f"prefill[{engine.prefill_mode}]: {st['prefill_launches']} "
          f"launches for {st['prefill_requests']} requests / "
          f"{st['prefill_tokens']} tokens over {st['admit_rounds']} "
          f"admit rounds")
    print(f"decode[{engine.decode_mode}]: {st['decode_rounds']} rounds "
          f"({st['decode_packed_launches']} packed / "
          f"{st['decode_lockstep_launches']} lockstep), tiles "
          f"{st['decode_tiles_packed']} packed vs "
          f"{st['decode_tiles_padded']} pad-to-max; fused "
          f"{st['fused_rounds']} rounds, {st['fused_launches']} launches")
    return results, engine


if __name__ == "__main__":
    main()
