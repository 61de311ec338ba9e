"""Training entry point of the port (port of ``repro/launch/train.py``).

Runs real steps: on the card by default (the tri_attn kernels), or with
``--device cpu`` on the plain PyTorch versions. The smoke config unless
``--full-config``; checkpointing, the preemption guard and deterministic
restart as in the reference.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --steps 50 \\
        --batch 8 --seq 128 --ckpt-dir <dir>
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs import registry as REG
from repro_torch.configs.base import ShapeConfig
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import data as DATA
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS


def _numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_numel(v) for v in tree.values())
    return tree.numel()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="yi-9b", choices=REG.ARCH_IDS)
    ap.add_argument("--full-config", action="store_true",
                    help="the full-scale config instead of the smoke one")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels; cpu: their plain versions")
    args = ap.parse_args(argv)

    cfg = (REG.get_config(args.arch) if args.full_config
           else REG.smoke_config(args.arch))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    opt = OPT.OptConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                        total_steps=args.steps)
    impl = "cuda" if args.device == "cuda" else "torch"

    state = TS.init_state(cfg, opt, seed=args.seed, device=args.device)
    n_params = _numel(state.params)
    print(f"arch={cfg.name} (reduced={not args.full_config}) "
          f"params={n_params / 1e6:.2f}M steps={args.steps} "
          f"device={args.device} attention={impl}")

    ds = DATA.SyntheticLM(cfg, shape, seed=args.seed, device=args.device)
    step_fn = TS.make_train_step(cfg, opt, microbatches=args.microbatches,
                                 attn_impl=impl, remat=True)
    manager = (CKPT.CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
               if args.ckpt_dir else None)
    if manager is not None and CKPT.latest_step(args.ckpt_dir) is not None:
        state, _ = CKPT.restore(args.ckpt_dir, state, device=args.device)
        print(f"restored checkpoint at step {state.step}")

    t0 = time.time()
    last = [t0]

    def logging_step(state, batch):
        state, metrics = step_fn(state, batch)
        s = state.step
        if s % args.log_every == 0 or s == args.steps:
            dt = time.time() - last[0]
            last[0] = time.time()
            print(f"step {s:5d} loss={float(metrics['loss']):.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} ({dt:.2f}s)",
                  flush=True)
        return state, metrics

    with FT.PreemptionGuard() as guard:
        state, log = FT.run_training(state, logging_step, ds.batch,
                                     args.steps, manager=manager,
                                     guard=guard)
    if manager is not None:
        manager.save_sync(state, state.step)
    print(f"done: {state.step} steps in {time.time() - t0:.1f}s; final loss "
          f"{log[-1]['loss']:.4f}" if log else "no steps run")
    return state, log


if __name__ == "__main__":
    main()
