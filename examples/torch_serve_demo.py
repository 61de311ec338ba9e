"""Batched serving with continuous slot refill on the port
(examples/serve_demo.py on repro_torch; see serve/engine.py).

Runs the port's serving CLI (``python -m repro_torch.launch.serve``) on
the smoke-size mixtral-8x7b: on the card through the kernels, with
--device cpu through their plain versions.

  PYTHONPATH=src python examples/torch_serve_demo.py
  PYTHONPATH=src python examples/torch_serve_demo.py --device cpu
"""

import argparse

from repro_torch.launch import serve


def main(device="cuda"):
    results, engine = serve.main(["--arch", "mixtral-8x7b", "--requests",
                                  "6", "--slots", "3", "--max-new", "12",
                                  "--max-len", "64", "--device", device])
    assert len(results) == 6
    assert all(len(v) == 12 for v in results.values())
    st = engine.stats
    assert st["decode_packed_launches"] + st["decode_lockstep_launches"] \
        == st["decode_rounds"]
    print("serve_demo OK")
    return {"results": results, "decode_mode": engine.decode_mode,
            "decode_rounds": st["decode_rounds"]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: the kernels; cpu: their plain versions")
    main(ap.parse_args().device)
