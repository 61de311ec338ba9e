"""Tiny cells for the CPU tests: each of the benchmark's cells with its
model cut to a width the CPU runs in seconds and its traffic shortened; the
harness, the reference, the comparison and the limits are the cell's own."""

from __future__ import annotations

from bench import run as RUN  # noqa: F401  (puts src/ on the path)
from bench.core import spec, traffic

TINY_MODEL = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=512)
TINY_MIX = {
    "train_packed": dict(row_tokens=256, block=16,
                         doc_len={"median": 40, "sigma": 1.0, "min": 16,
                                  "max": 256}),
    "train_dense": dict(row_tokens=128),
    "serve_open": dict(rate_per_s=20.0, warmup_s=0.3, horizon_s=30.0,
                       prompt_len={"median": 40, "sigma": 1.0, "min": 8,
                                   "max": 200},
                       output_len={"median": 24, "sigma": 0.8, "min": 4,
                                   "max": 80},
                       sample_tokens=240),
    "serve_closed": dict(clients=4, prompt_len=32, output_len=48,
                         sample_tokens=240),
}


def tiny_cell(name: str, dtype: str = "float32") -> dict:
    c = spec.cell(name)
    c["config"].update(TINY_MODEL, dtype=dtype)
    c["traffic"].update(TINY_MIX[c["traffic"]["kind"]])
    if traffic.kind(c["traffic"]).DRIVER == "train":
        c["config"]["train"]["block"] = 16
    else:
        c["config"]["engine"].update(slots=4, max_len=256, prefill_block=16,
                                     decode_block=16)
    return c


def run_tiny(name: str, seed: int = 11, *, dtype: str = "float32",
             fault=None, trace: bool = False, seconds: float = 0.2) -> dict:
    return RUN.run_cell(tiny_cell(name, dtype), seed, seconds, trace,
                        device="cpu", impl="torch", fault=fault)
