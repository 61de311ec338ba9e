"""Quickstart on the PyTorch/CUDA port: train a small LM with LTM-scheduled
attention, checkpoint, restore, and generate (examples/quickstart.py on
repro_torch).

On the card the attention forward and its dq and dk/dv run the tri_attn
kernels; with --device cpu their plain PyTorch versions.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import tempfile

import torch

from repro_torch import device as DEV
from repro_torch.configs import registry as REG
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import model as MD
from repro_torch.serve import decode as D
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import data as DATA
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def main(device="cuda", state=None):
    """``state``: a TrainState to start from (default: ``init_state``'s
    from seed 0), e.g. the reference's carried across by
    ``train_step.state_from_jax``."""
    impl = DEV.attn_impl(device)
    # 1. a reduced Yi-9B-family config (GQA llama-arch, LTM attention)
    cfg = REG.smoke_config("yi-9b")
    print(f"arch {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} vocab={cfg.vocab_size} "
          f"on {device} (attention impl {impl})")

    # 2. train 30 steps on the synthetic pipeline
    opt = OPT.OptConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    if state is None:
        state = TS.init_state(cfg, opt, seed=0, device=device)
    shape = ShapeConfig("quickstart", seq_len=128, global_batch=8,
                        kind="train")
    ds = DATA.SyntheticLM(cfg, shape, seed=0, device=device,
                          act_dtype=torch.float32)
    step = TS.make_train_step(cfg, opt, attn_impl=impl)
    losses = []
    for i in range(30):
        state, metrics = step(state, ds.batch(i))
        losses.append(float(metrics["loss"]))
        if i % 10 == 0:
            print(f"  step {i:3d} loss {losses[-1]:.4f}")
    first, last = losses[0], losses[-1]
    print(f"loss {first:.3f} -> {last:.3f}")
    assert last < first, "training must reduce loss"

    # 3. checkpoint round-trip
    with tempfile.TemporaryDirectory() as d:
        CKPT.save(d, state, state.step)
        restored, _ = CKPT.restore(d, state, device=device)
        assert restored.step == state.step == 30
        assert all(torch.equal(a, b) for a, b in zip(
            _leaves(restored.params), _leaves(state.params)))
        print(f"checkpoint round-trip ok (step {restored.step})")

    # 4. greedy generation from the trained params
    cache = MD.init_cache(cfg, 2, 64, torch.float32, device)
    toks, cache, pos = D.generate(
        state.params, cfg, cache,
        first_tokens=torch.tensor([[1], [2]], device=device),
        start_pos=0, n_tokens=12, attn_impl=impl)
    assert toks.shape == (2, 12) and pos.tolist() == [12, 12]
    print("generated:", toks.tolist())
    print("quickstart OK")
    return {"losses": losses, "tokens": toks.tolist()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels; cpu: their plain versions")
    main(ap.parse_args().device)
