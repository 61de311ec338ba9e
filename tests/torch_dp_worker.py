"""One rank of the data-parallel runs of tests/test_torch_elastic.py, and
the scale-noting hook the compression tests share.

Spawned (``torch.multiprocessing``, start method "spawn") once per rank of
a gloo group whose ranks meet through a ``FileStore``; imports only the
port. Each rank trains the smoke yi-9b (float32, plain attention) from the
state in ``<out_dir>/init.pt`` on its own rows of every batch: plain and
compressed DP steps over the group, each on the batches as drawn and on
the same batches with an uneven loss mask (``uneven_mask``); then a
restore of a checkpoint one process wrote and one more step. It saves
what it ends with to ``<out_dir>/rank<r>.pt``.
"""

import copy
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.configs import registry as REG
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as MESH
from repro_torch.parallel import compression as C
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import data as DATA
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

BLOCK = 16
SEQ, BATCH = 32, 4
STEPS = 2
THREADS = 1
# (mode, compressed, masked) of the DP runs
MODES = (("plain", False, False), ("compressed", True, False),
         ("plain_masked", False, True), ("compressed_masked", True, True))


def setup():
    cfg = dataclasses.replace(REG.smoke_config("yi-9b"), dtype="float32")
    opt = OPT.OptConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    ds = DATA.SyntheticLM(cfg, ShapeConfig("dp", SEQ, BATCH, "train"),
                          seed=0, device="cpu")
    return cfg, opt, ds


def uneven_mask() -> torch.Tensor:
    """A (BATCH, SEQ) loss mask whose halves keep 40 and 60 tokens: rows 0
    and 1 (rank 0 of 2) and rows 2 and 3 (rank 1) weigh differently."""
    mask = torch.ones(BATCH, SEQ)
    mask[0, :24] = 0.0
    mask[3, :4] = 0.0
    return mask


def whole_batch(ds, step: int, masked: bool) -> dict:
    batch = ds.batch(step)
    return dict(batch, mask=uneven_mask()) if masked else batch


def shard(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s rows of ``batch``."""
    rows = batch["labels"].shape[0] // world
    return {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}


def noting_scales(hook, scales: dict):
    """``hook``, noting before it codes each leaf's scale by its dotted
    key: max|g + err| over the whole (stacked) leaf / 127."""

    def note(g, e, key):
        if isinstance(g, dict):
            for k in g:
                note(g[k], e[k], f"{key}.{k}" if key else k)
            return
        whole = torch.stack(g) if isinstance(g, list) else g
        scales[key] = torch.clamp(torch.max(torch.abs(whole.float() + e)),
                                  min=1e-30) / 127.0

    def allreduce(grads, err):
        note(grads, err, "")
        return hook(grads, err)

    return allreduce


def run(rank: int, world: int, store_path: str, out_dir: str,
        ckpt_dir: str):
    torch.set_num_threads(THREADS)
    group = MESH.init_data_group(
        "cpu", MESH.AbstractMesh(("data",), (world,)), rank=rank,
        store_path=store_path)
    try:
        cfg, opt, ds = setup()
        init = torch.load(f"{out_dir}/init.pt", weights_only=False)
        out = {"mesh": MESH.make_local_mesh().shape}
        plain = TS.make_train_step(cfg, opt, attn_impl="torch", block=BLOCK)
        comp = TS.make_train_step(
            cfg, opt, attn_impl="torch", block=BLOCK,
            compressed_allreduce=C.make_compressed_allreduce(group))
        for mode, compressed, masked in MODES:
            state = copy.deepcopy(init)
            if not compressed:
                state.err_state = None
            state, log = FT.run_training(
                state, comp if compressed else plain,
                lambda s: shard(whole_batch(ds, s, masked), rank, world),
                STEPS)
            out[mode] = {"params": state.params,
                         "opt_state": state.opt_state,
                         "err_state": state.err_state,
                         "losses": [m["loss"] for m in log]}
        target = TS.init_state(cfg, opt, seed=7, device="cpu")
        state, manifest = CKPT.restore(ckpt_dir, target, device="cpu")
        out["restored"] = {"step": state.step, "manifest": manifest,
                           "params": copy.deepcopy(state.params)}
        state, log = FT.run_training(
            state, plain, lambda s: shard(ds.batch(s), rank, world),
            state.step + 1)
        out["resumed"] = {"step": state.step, "params": state.params,
                          "loss": log[-1]["loss"]}
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
