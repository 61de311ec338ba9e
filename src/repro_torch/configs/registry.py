"""Architecture registry of the port: --arch <id> -> ModelConfig.

Ported: the dense GQA ``yi-9b`` and the attention-free ``rwkv6-1.6b``.
The other architectures of ``repro/configs`` need MoE FFNs or Mamba
mixers (ROADMAP queue A, item 4)."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced

ARCH_IDS = ("yi-9b", "rwkv6-1.6b")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"arch {arch!r} is not ported yet (its MoE FFNs or "
                       f"Mamba mixers wait, ROADMAP queue A item 4); "
                       f"ported: {ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
    ).CONFIG


def smoke_config(arch: str, **kw) -> ModelConfig:
    return reduced(get_config(arch), **kw)
