"""Architecture registry of the port (port of ``repro/configs/registry.py``
without the dry-run's input specs): --arch <id> -> ModelConfig, the shape
cells and their support matrix.

All ten of the reference's architectures, in its order: dense GQA
(yi-9b, llama3-405b, nemotron-4-340b, granite-34b), MoE (mixtral-8x7b
with a sliding window, granite-moe-3b-a800m), attention-free rwkv6-1.6b,
the Mamba/attention hybrid jamba-1.5-large-398b, and the stub-frontend
backbones musicgen-large (audio frames) and internvl2-1b (vision
patches)."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, reduced

ARCH_IDS = (
    "mixtral-8x7b",
    "granite-moe-3b-a800m",
    "rwkv6-1.6b",
    "yi-9b",
    "nemotron-4-340b",
    "llama3-405b",
    "granite-34b",
    "musicgen-large",
    "internvl2-1b",
    "jamba-1.5-large-398b",
)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
    ).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether this (arch, shape) cell runs; the reason when skipped."""
    if shape.kind == "long_decode" and cfg.is_pure_full_attention():
        return False, ("pure full-attention arch: 500k decode is quadratic "
                       "with an unbounded KV cache; skipped (sub-quadratic "
                       "archs run it)")
    return True, ""


def runnable_cells():
    """(arch, shape name, runs, reason) for every arch x shape."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, why = supported(cfg, shape)
            out.append((arch, sname, ok, why))
    return out


def smoke_config(arch: str, **kw) -> ModelConfig:
    return reduced(get_config(arch), **kw)
