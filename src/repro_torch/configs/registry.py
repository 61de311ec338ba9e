"""Architecture registry of the port: --arch <id> -> ModelConfig.

Only the dense GQA ``yi-9b`` is ported so far; the other architectures of
``repro/configs`` need MoE, Mamba or RWKV mixers (ROADMAP queue A)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced

ARCH_IDS = ("yi-9b",)


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP queue A); "
                       f"ported: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_")).CONFIG


def smoke_config(arch: str, **kw) -> ModelConfig:
    return reduced(get_config(arch), **kw)
