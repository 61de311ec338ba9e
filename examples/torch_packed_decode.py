"""Packed mixed-position decode on the port, and the engine's default
decode_mode="auto" (examples/packed_decode.py on repro_torch).

The lockstep decode pads every slot to the same work: each of B slots
attends the full cache buffer whatever its own position, so a batch that
mixes a long sequence with short ones burns tiles exactly like a
bounding-box grid burns blocks. The packed decode round gives each live
slot only its own valid KV prefix — sum_b ceil(len_b / blk) tiles — while
emitting token-identical streams. "auto" picks per round by the
reference's cost rule: packed only when
PACKED_TILE_COST_RATIO * sum(tiles) < B * max(tiles).

On the card the packed rounds run the tri_attn.packed_decode_fwd kernel
(and admission tri_attn.packed_fwd), which take blocks of 16-128: the
reference's blocks of 8 are raised to 16 there and its prompt lengths and
max_len doubled (both printed). Lockstep rounds are the full-cache
einsum, so the "lockstep" engine runs with decode_impl="torch" on the
card, said so in its line. With --device cpu everything runs the plain
versions at the reference's sizes.

  PYTHONPATH=src python examples/torch_packed_decode.py
  PYTHONPATH=src python examples/torch_packed_decode.py --device cpu
"""

import argparse

import numpy as np

from repro_torch import device as DEV
from repro_torch.configs import registry as REG
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.models import model as MD
from repro_torch.serve import engine as E

LENS, BLOCK, MAX_LEN = (41, 3, 6, 4), 8, 64  # the reference's sizes


def sizes(device):
    """(prompt lengths, block, max_len): the reference's on the CPU; on
    the card the block raised to the smallest the kernels take, the
    lengths by the same factor."""
    if DEV.attn_impl(device) != "cuda":
        return LENS, BLOCK, MAX_LEN
    scale = -(-K.SUPPORTED_BLOCKS[0] // BLOCK)
    lens = tuple(s * scale for s in LENS)
    print(f"the card's kernels take blocks {K.SUPPORTED_BLOCKS}: blocks "
          f"{BLOCK} -> {BLOCK * scale}, prompts {LENS} -> {lens}, max_len "
          f"{MAX_LEN} -> {MAX_LEN * scale} (x{scale})")
    return lens, BLOCK * scale, MAX_LEN * scale


def main(device="cuda", params=None):
    """``params``: the model's weights (default: ``init_params``'s from
    seed 0), e.g. the reference's carried across by
    ``model.params_from_jax``."""
    impl = DEV.attn_impl(device)
    lens, block, max_len = sizes(device)
    cfg = REG.smoke_config("yi-9b")
    if params is None:
        params = MD.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    # heavy position skew: one long prompt, several short ones
    prompts = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
               for s in lens]

    results, stats = {}, {}
    for mode in ("packed", "lockstep", "auto"):
        decode_impl = "torch" if mode == "lockstep" else impl
        eng = E.Engine(params, cfg, slots=4, max_len=max_len,
                       temperature=0.0, prefill_block=block,
                       prefill_impl=impl, decode_mode=mode,
                       decode_block=block, decode_impl=decode_impl,
                       device=device)
        for uid, p in enumerate(prompts):
            eng.submit(p, max_new=8, uid=uid)
        results[mode] = eng.run()
        st = stats[mode] = eng.stats
        print(f"{mode:9s} decode rounds: {st['decode_rounds']:3d}  "
              f"packed launches: {st['decode_packed_launches']:3d}  "
              f"lockstep: {st['decode_lockstep_launches']:3d}  "
              f"tiles packed/padded: {st['decode_tiles_packed']}/"
              f"{st['decode_tiles_padded']}  (decode_impl {decode_impl})")

    assert results["packed"] == results["lockstep"] == results["auto"], \
        "packed, lockstep and auto decode must be token-for-token identical"
    st = stats["packed"]
    assert st["decode_packed_launches"] == st["decode_rounds"]
    assert st["decode_tiles_packed"] < st["decode_tiles_padded"]
    assert stats["lockstep"]["decode_lockstep_launches"] == \
        stats["lockstep"]["decode_rounds"]
    auto = stats["auto"]
    assert auto["decode_packed_launches"] + \
        auto["decode_lockstep_launches"] == auto["decode_rounds"]
    saved = 1 - st["decode_tiles_packed"] / st["decode_tiles_padded"]
    print(f"packed_decode OK — identical tokens, {saved:.0%} of pad-to-max "
          f"decode tiles eliminated "
          f"({st['decode_tiles_packed']} vs {st['decode_tiles_padded']}); "
          f"auto (ratio {E.PACKED_TILE_COST_RATIO}) ran "
          f"{auto['decode_packed_launches']} packed and "
          f"{auto['decode_lockstep_launches']} lockstep rounds")
    keys = ("decode_rounds", "decode_packed_launches",
            "decode_lockstep_launches", "decode_tiles_packed",
            "decode_tiles_padded")
    return {"results": results,
            "stats": {m: {k: s[k] for k in keys} for m, s in stats.items()}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels; cpu: their plain versions")
    main(ap.parse_args().device)
