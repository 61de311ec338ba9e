"""Finds a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration (``bench/configs/<config>.json``), its traffic mix
(``bench/traffic/<mix>.json``), its limits (``bench/limits/<cell>.json``),
the reader of each per-layer metric (``bench/metrics/<metric>.py``) and the
plain reference of the configuration's model family
(``bench/reference/<family>.py``). A later change adds a cell, a mix, a
metric or a family as new files and entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(name: str) -> dict:
    """The cell's entry, with its configuration, mix, limits and metric
    entries gathered: {"workload", "config", "traffic", "limits",
    "end_to_end", "per_layer"}."""
    b = benchmark()
    wl = next((w for w in b["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in b["configs"] if c["name"] == wl["config"])

    def ours(metric):
        return name in metric.get("workloads", [name])

    return {
        "workload": wl,
        "config": json.loads((ROOT / conf["file"]).read_text()),
        "traffic": json.loads((BENCH / "traffic" /
                               f"{wl['traffic']}.json").read_text()),
        "limits": json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        "end_to_end": [m for m in b["end_to_end"] if ours(m)],
        "per_layer": [m for m in b["per_layer"] if ours(m)],
    }


def load(rel: str):
    """The module of the file ``bench/<rel>.py``."""
    path = BENCH / f"{rel}.py"
    if not path.is_file():
        raise KeyError(f"no file bench/{rel}.py")
    tag = "bench_" + "".join(ch if ch.isalnum() else "_" for ch in rel)
    s = importlib.util.spec_from_file_location(tag, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def model(config: dict) -> dict:
    """The model's numbers and names in a configuration file: every key at
    its top level but the groups (the engine's or trainer's settings, the
    notes on what was assumed)."""
    return {k: v for k, v in config.items() if not isinstance(v, dict)}


def family(m: dict):
    """The plain reference of ``m``'s family: its leaves, its layer and the
    arithmetic the per-layer metrics take from its shapes."""
    return load(f"reference/{m['family']}")


def program_config(config: dict):
    """The port's ``ModelConfig`` of a configuration: its keys that are the
    ``ModelConfig``'s fields."""
    import dataclasses

    from repro_torch.configs.base import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in config.items() if k in fields})


def reader(metric: str):
    """The ``read(ctx)`` function of ``bench/metrics/<metric>.py``."""
    return load(f"metrics/{metric}").read
