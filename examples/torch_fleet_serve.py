"""Fleet serving with deterministic failover on the port
(examples/fleet_serve.py on repro_torch; see serve/fleet.py).

Two engine replicas behind tri(n) tile-cost routing serve a small request
mix while a seeded FaultPlan kills replica 0 mid-decode; the fleet
migrates its requests and every stream still comes out identical to a
fault-free single-engine run.

On the card the replicas serve through the tri_attn kernels, which take
blocks of 16-128: the reference's prefill block of 4 is raised to 16
there and its prompt lengths and max_len scaled by 4 (both printed).
With --device cpu the plain versions serve the reference's sizes.

  PYTHONPATH=src python examples/torch_fleet_serve.py
  PYTHONPATH=src python examples/torch_fleet_serve.py --device cpu
"""

import argparse

import numpy as np

from repro_torch import device as DEV
from repro_torch.configs import registry as REG
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.models import model as MD
from repro_torch.resilience import faults as F
from repro_torch.serve.engine import Engine
from repro_torch.serve.fleet import Fleet

BLOCK, MAX_LEN = 4, 48  # the reference's sizes


def main(device="cuda", params=None):
    """``params``: the model's weights (default: ``init_params``'s from
    seed 0), e.g. the reference's carried across by
    ``model.params_from_jax``."""
    impl = DEV.attn_impl(device)
    scale = 1 if impl != "cuda" else -(-K.SUPPORTED_BLOCKS[0] // BLOCK)
    cfg = REG.smoke_config("yi-9b")
    if params is None:
        params = MD.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(7)
    lens = [int(n) for n in rng.integers(3, 12, size=6)]
    if scale > 1:
        print(f"the card's kernels take blocks {K.SUPPORTED_BLOCKS}: block "
              f"{BLOCK} -> {BLOCK * scale}, prompts {tuple(lens)} -> "
              f"{tuple(n * scale for n in lens)}, max_len {MAX_LEN} -> "
              f"{MAX_LEN * scale} (x{scale})")
    prompts = [rng.integers(1, 50, size=n * scale).astype(np.int32)
               for n in lens]
    engine_kw = dict(slots=2, max_len=MAX_LEN * scale, temperature=0.0,
                     prefill_block=BLOCK * scale, prefill_impl=impl,
                     decode_impl=impl, device=device)

    eng = Engine(params, cfg, clock=F.VirtualClock(), **engine_kw)
    for uid, p in enumerate(prompts):
        eng.submit(p, max_new=4, uid=uid)
    baseline = eng.run()

    kill = F.FaultPlan([F.Fault("launch_error", "decode", 1, times=99,
                                engine=0)])
    fleet = Fleet(params, cfg, engines=2, fault_plan=kill,
                  engine_kw=engine_kw, heartbeat_timeout_s=5.0,
                  snapshot_every=2)
    for uid, p in enumerate(prompts):
        fleet.submit(p, max_new=4, uid=uid)
    results = fleet.run()

    st = fleet.stats
    print(f"failovers={st['fleet_failovers_total']} "
          f"migrated={st['fleet_requests_migrated_total']} "
          f"restores={st['fleet_engine_restores_total']}")
    assert st["fleet_failovers_total"] >= 1
    assert all(results[u] == baseline[u] for u in baseline), (
        "migrated streams must match the fault-free single engine")
    assert all(r["status"] == "done" for r in fleet.report().values())
    print("fleet_serve OK: replica 0 died, every stream token-identical")
    return {"results": results, "baseline": baseline,
            "failovers": st["fleet_failovers_total"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels; cpu: their plain versions")
    main(ap.parse_args().device)
