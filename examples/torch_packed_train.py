"""Packed ragged-document training on the port: one launch per direction,
zero pad (examples/packed_train.py on repro_torch).

Training on documents of mixed lengths usually pads every document to the
longest and runs a dense-masked backward — re-buying the O(n^2) bounding
box the paper's g(lambda) eliminates. The packed path puts the documents
on one packed row, runs block-diagonal attention per document, and
backpropagates through the packed autograd Function: forward, dq, and
dk/dv each walk ONE 1-D grid of sum_r tri(n_r) tiles for the whole batch.
The same tiny model trains on the same skewed documents through both
layouts: (a) identical losses, (b) the tile savings.

On the card the packed steps run tri_attn.packed_fwd and the packed dq
and dk/dv kernels, the padded ones tri_attn.fwd and its backward; they
take blocks of 16-128, so the reference's block of 4 is raised to 16
there and its document lengths scaled by 4 (both printed). With
--device cpu the plain versions run the reference's sizes.

  PYTHONPATH=src python examples/torch_packed_train.py
  PYTHONPATH=src python examples/torch_packed_train.py --device cpu
"""

import argparse
import copy

import numpy as np

from repro_torch import device as DEV
from repro_torch.configs import registry as REG
from repro_torch.core import mapping as M
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.obs import launch as OBS
from repro_torch.train import data as DATA
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

DOC_LENS, BLOCK = (37, 5, 11, 3), 4  # the reference's sizes: heavy skew


def sizes(device):
    """(document lengths, block): the reference's on the CPU; on the card
    the block raised to the smallest the kernels take, the lengths by the
    same factor."""
    if DEV.attn_impl(device) != "cuda":
        return DOC_LENS, BLOCK
    scale = -(-K.SUPPORTED_BLOCKS[0] // BLOCK)
    lens = tuple(s * scale for s in DOC_LENS)
    print(f"the card's kernels take blocks {K.SUPPORTED_BLOCKS}: block "
          f"{BLOCK} -> {BLOCK * scale}, documents {DOC_LENS} -> {lens} "
          f"(x{scale})")
    return lens, BLOCK * scale


def main(device="cuda", state=None):
    """``state``: the TrainState both layouts start from (default:
    ``init_state``'s from seed 0), e.g. the reference's carried across by
    ``train_step.state_from_jax``; each layout trains its own copy."""
    impl = DEV.attn_impl(device)
    doc_lens, block = sizes(device)
    cfg = REG.smoke_config("yi-9b")
    docs = DATA.PackedDocsLM(cfg, doc_lens, block=block, seed=0,
                             device=device)
    psched = OPS.make_packed_sched(docs.member_lens, block=block,
                                   window=cfg.sliding_window)

    opt = OPT.OptConfig()
    packed_step = TS.make_train_step(cfg, opt, attn_impl=impl,
                                     packed=psched, block=block,
                                     aux_weight=0.0)
    padded_step = TS.make_train_step(cfg, opt, attn_impl=impl, block=block,
                                     aux_weight=0.0)
    if state is None:
        state = TS.init_state(cfg, opt, seed=0, device=device)
    state_p, state_d = copy.deepcopy(state), copy.deepcopy(state)

    losses = []
    for step in range(3):
        with OBS.capture() as launches:
            state_p, met_p = packed_step(state_p, docs.batch(step))
        state_d, met_d = padded_step(state_d, docs.padded_batch(step))
        lp, ld = float(met_p["loss"]), float(met_d["loss"])
        losses.append((lp, ld))
        print(f"step {step}: packed loss {lp:.4f}  padded loss {ld:.4f}")
        assert np.isclose(lp, ld, rtol=1e-5), \
            "packed training must match padded"
    # one packed launch per direction a layer (the forward twice: remat)
    names = sorted({m.name for m, _ in launches})
    assert names == ["tri_attn.packed_bwd_dkv", "tri_attn.packed_bwd_dq",
                     "tri_attn.packed_fwd"], names
    counts = {nm: sum(m.name == nm for m, _ in launches) for nm in names}
    assert counts == {"tri_attn.packed_fwd": 2 * cfg.n_layers,
                      "tri_attn.packed_bwd_dq": cfg.n_layers,
                      "tri_attn.packed_bwd_dkv": cfg.n_layers}, counts

    ns = [s // block for s in docs.member_lens]
    n_max = max(ns)
    tiles_packed = 3 * sum(M.tri(n) for n in ns)
    tiles_bb = 3 * len(ns) * n_max * n_max
    assert all(m.tiles_launched == psched.steps for m, _ in launches)
    assert 3 * psched.steps == tiles_packed
    print(f"attention tiles per train step (fwd + dq + dkv): "
          f"packed={tiles_packed} padded-bb={tiles_bb} "
          f"({tiles_bb / tiles_packed:.1f}x saved)")
    assert tiles_packed < tiles_bb
    print("packed_train OK — identical losses, "
          f"{1 - tiles_packed / tiles_bb:.0%} of pad-to-max tiles "
          "eliminated")
    return {"losses": losses, "tiles_packed": tiles_packed,
            "tiles_bb": tiles_bb, "launches": counts,
            "member_lens": tuple(docs.member_lens)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels; cpu: their plain versions")
    main(ap.parse_args().device)
