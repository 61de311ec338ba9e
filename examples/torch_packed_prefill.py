"""Packed ragged prefill on the port: ONE launch per layer admits a whole
mixed-length batch (examples/packed_prefill.py on repro_torch).

The engine gathers every free slot's prompt, concatenates them along the
sequence axis, and prefills them together over the packed schedule —
sum_r tri(n_r) tiles instead of one decode step per prompt token. Outputs
are token-for-token identical to the sequential path; only the launch
count changes.

On the card the packed admission runs the tri_attn.packed_fwd kernel,
which takes blocks of 16-128: the reference's prefill block of 8 is
raised to 16 there and its prompt lengths and max_len doubled (both
printed). The sequential path is the plain version's per-token loop, so
on the card it runs with prefill_impl="torch", said so in its line. With
--device cpu everything runs the plain versions at the reference's
sizes.

  PYTHONPATH=src python examples/torch_packed_prefill.py
  PYTHONPATH=src python examples/torch_packed_prefill.py --device cpu
"""

import argparse

import numpy as np

from repro_torch import device as DEV
from repro_torch.configs import registry as REG
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.models import model as MD
from repro_torch.serve.engine import Engine

LENS, BLOCK, MAX_LEN = (19, 5, 33, 11), 8, 64  # the reference's sizes


def sizes(device):
    """(prompt lengths, block, max_len): the reference's on the CPU; on
    the card the block raised to the smallest the kernels take, the
    lengths by the same factor."""
    if DEV.attn_impl(device) != "cuda":
        return LENS, BLOCK, MAX_LEN
    scale = -(-K.SUPPORTED_BLOCKS[0] // BLOCK)
    lens = tuple(s * scale for s in LENS)
    print(f"the card's kernels take blocks {K.SUPPORTED_BLOCKS}: block "
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
    prompts = [rng.integers(1, cfg.vocab_size, size=s).astype(np.int32)
               for s in lens]

    results, stats = {}, {}
    for mode, prefill_impl in (("packed", impl), ("sequential", "torch")):
        eng = Engine(params, cfg, slots=4, max_len=max_len, temperature=0.0,
                     prefill_mode=mode, prefill_block=block,
                     prefill_impl=prefill_impl, decode_impl=impl,
                     device=device)
        for uid, p in enumerate(prompts):
            eng.submit(p, max_new=8, uid=uid)
        results[mode] = eng.run()
        stats[mode] = eng.stats
        print(f"{mode:10s} prefill launches: "
              f"{eng.stats['prefill_launches']:3d} "
              f"(for {eng.stats['prefill_tokens']} prompt tokens over "
              f"{eng.stats['admit_rounds']} admit round(s); prefill_impl "
              f"{prefill_impl})")

    assert results["packed"] == results["sequential"], \
        "packed prefill must be token-for-token identical"
    assert stats["packed"]["prefill_launches"] == \
        stats["packed"]["admit_rounds"]
    print("packed_prefill OK — identical tokens, "
          f"{stats['sequential']['prefill_launches']}x fewer launches -> "
          f"{stats['packed']['prefill_launches']}")
    return {"results": results,
            "launches": {m: st["prefill_launches"] for m, st in stats.items()},
            "admit_rounds": stats["packed"]["admit_rounds"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels; cpu: their plain versions")
    main(ap.parse_args().device)
