"""Architecture registry of the port (port of ``repro/configs/registry.py``):
--arch <id> -> ModelConfig, the shape cells, their support matrix, and the
dry-run's input specs: meta tensors, the port's ``ShapeDtypeStruct``.

All ten of the reference's architectures, in its order: dense GQA
(yi-9b, llama3-405b, nemotron-4-340b, granite-34b), MoE (mixtral-8x7b
with a sliding window, granite-moe-3b-a800m), attention-free rwkv6-1.6b,
the Mamba/attention hybrid jamba-1.5-large-398b, and the stub-frontend
backbones musicgen-large (audio frames) and internvl2-1b (vision
patches)."""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

import torch

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


# ---------------------------------------------------------------------------
# Input specs (meta tensors: shapes and dtypes, no storage)
# ---------------------------------------------------------------------------


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                act_dtype=torch.bfloat16) -> dict:
    """Train/prefill batch: the model inputs for one global step."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_frames":
        # EnCodec frame embeddings precomputed by the stub frontend.
        return {"embeds": _sds((b, s, cfg.d_model), act_dtype),
                "labels": _sds((b, s), torch.int32)}
    if cfg.frontend == "vision_patches":
        p = cfg.n_patches
        return {"embeds": _sds((b, p, cfg.d_model), act_dtype),
                "tokens": _sds((b, s - p), torch.int32),
                "labels": _sds((b, s), torch.int32),
                "mask": _sds((b, s), torch.float32)}
    return {"tokens": _sds((b, s), torch.int32),
            "labels": _sds((b, s), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                cache_dtype=torch.bfloat16) -> dict:
    """Decode-state tree spec (KV cache of seq_len / recurrent states)."""
    from repro_torch.models import model as MD

    return MD.init_cache(cfg, shape.global_batch, shape.seq_len, cache_dtype,
                         device="meta")


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    return {"tokens": _sds((b, 1), torch.int32),
            "pos": _sds((), torch.int32)}


def params_specs(cfg: ModelConfig):
    from repro_torch.models import model as MD

    return MD.init_params(cfg, device="meta")


def input_specs(arch: str, shape_name: str) -> dict:
    """Everything the dry-run needs for one cell, as meta tensors."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    specs = {"params": params_specs(cfg)}
    if shape.is_decode:
        specs["cache"] = cache_specs(cfg, shape)
        specs.update(decode_specs(cfg, shape))
    else:
        specs["batch"] = batch_specs(cfg, shape)
    return specs


def smoke_config(arch: str, **kw) -> ModelConfig:
    return reduced(get_config(arch), **kw)
