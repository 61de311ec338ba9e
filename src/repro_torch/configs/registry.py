"""Architecture registry of the port: --arch <id> -> ModelConfig.

Ported: the dense GQA ``yi-9b``, the attention-free ``rwkv6-1.6b`` and
the Mamba/attention hybrid with MoE FFNs ``jamba-1.5-large-398b``."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, reduced

ARCH_IDS = ("yi-9b", "rwkv6-1.6b", "jamba-1.5-large-398b")


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: "
                       f"{ARCH_IDS}")
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_")
    ).CONFIG


def smoke_config(arch: str, **kw) -> ModelConfig:
    return reduced(get_config(arch), **kw)
