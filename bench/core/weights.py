"""Weights from the seed, made on the device in the type they are served in.

One ``torch.Generator`` on the device draws every leaf of the model in the
fixed order its family gives (``bench/reference/<family>.py``), one call a
leaf (a stacked leaf holds all its layers), so the same seed gives the same
weights, and ``leaves`` can make any of them again later (the reference
reads them that way, leaf by leaf, after the program's state is freed). The
tree is laid out as the port keeps its parameters: ``embed``, ``layers/l<k>``
with every leaf stacked on a leading layer axis, ``final_norm`` and
``lm_head``.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

from bench.core import spec

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def leaf_specs(m: dict) -> List[Tuple[tuple, tuple, float]]:
    """(path, shape, scale) of every leaf in draw order, as the model's
    family lays them out; scale 0 marks a norm scale (ones, float32, no
    draw)."""
    return spec.family(m).leaf_specs(m)


def leaves(m: dict, seed: int, device) -> Iterator[Tuple[tuple, torch.Tensor]]:
    """(path, tensor) of every leaf, drawn anew from ``seed`` on ``device``:
    matrices in the model's dtype, norm scales as float32 ones."""
    dtype = DTYPES[m["dtype"]]
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    for path, shape, scale in leaf_specs(m):
        if scale == 0.0:
            yield path, torch.ones(shape, dtype=torch.float32, device=device)
        else:
            t = torch.randn(shape, generator=gen, dtype=dtype, device=device)
            yield path, t.mul_(scale)


def put(tree: dict, path: tuple, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def get(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def make_params(m: dict, seed: int, device) -> dict:
    params: dict = {}
    for path, t in leaves(m, seed, device):
        put(params, path, t)
    return params
