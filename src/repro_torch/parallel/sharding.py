"""Sharding rules: params / batch / cache trees -> partition specs (port of
``repro/parallel/sharding.py``), as pure functions on shapes and an
abstract mesh (``launch/mesh.py``).

A spec is a tuple with one entry a dim: an axis name, a tuple of axis
names (their product shards the dim), or None (replicated). Scheme
(single-pod mesh ("data", "model") = 16 x 16; multi-pod prepends "pod"):

  * batch dim            -> ("pod", "data")
  * TP dims (heads, d_ff,
    vocab, d_inner)      -> "model"
  * FSDP dim (the other
    large param dim)     -> "data"
  * experts              -> "data" when E % |data| == 0 (EP), else FSDP
                            fallback on the next dim
  * decode KV sequence   -> "model", batch on ("pod", "data"); long-context
                            B = 1 shards the sequence over every axis

Every rule degrades to replication where the dimension is not divisible by
the axis size (the divisibility fallback), and on the card's mesh, ("data",)
of 1, every rule is replication. Params keep the reference's tree layout
(``layers`` stacked on a leading superlayer axis), so the rules compare
with the reference's leaf for leaf. ``per_device_bytes`` is what the
dry-run reckons the pod meshes with.
"""

from __future__ import annotations

import math
from typing import Tuple

# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------


def _axis_size(mesh, axis) -> int:
    """Product of mesh-axis sizes; 0 if any axis is absent from the mesh
    (signals fallback() to drop the entry)."""
    if axis is None:
        return 1
    axes = axis if isinstance(axis, tuple) else (axis,)
    if any(a not in mesh.shape for a in axes):
        return 0
    return math.prod(mesh.shape[a] for a in axes)


def dp_axes(mesh):
    """The composite batch axis: ("pod", "data") when a pod axis exists."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def fallback(spec: tuple, shape: Tuple[int, ...], mesh) -> tuple:
    """Drop any spec entry whose axis size does not divide the dim; the
    spec padded with None to the rank."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    fixed = []
    for dim, axis in zip(shape, entries):
        size = _axis_size(mesh, axis) if axis else 1
        fixed.append(axis if axis and size and dim % size == 0 else None)
    return tuple(fixed)


# ---------------------------------------------------------------------------
# Parameter rules (keyed by leaf name; specs are written for the unstacked
# rank and left-padded with None under "layers")
# ---------------------------------------------------------------------------

_PARAM_RULES = {
    # top level
    "embed": ("model", "data"),        # (vocab, d): vocab TP, d FSDP
    "lm_head": ("data", "model"),      # (d, vocab)
    # attention
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    # dense mlp
    "wi": ("data", "model"),
    "wg": ("data", "model"),
    # mamba
    "in_proj": ("data", "model"),
    "conv_w": (None, "model"),
    "x_proj": ("model", None),
    "dt_bias": ("model",),
    "a_log": ("model", None),
    "d_skip": ("model",),
    "out_proj": ("model", "data"),
    # rwkv
    "wr": ("data", "model"),
    "w_lora_a": ("data", None),
    "w_lora_b": (None, "data"),
    "cm_wk": ("data", "model"),
    "cm_wv": ("model", "data"),
    "cm_wr": ("data", "model"),
    # moe (rank 3; the expert dim is resolved in _param_spec)
    "router": ("data", None),
}

_MOE_NAMES = {"wi", "wg", "wo"}


def _param_spec(path: tuple, leaf, mesh) -> tuple:
    """The spec of the leaf at ``path`` (its dict keys, outermost first)."""
    name = path[-1] if path else ""
    stacked = "layers" in path  # leading n_superlayers dim
    base_rank = leaf.ndim - (1 if stacked else 0)

    if name in _MOE_NAMES and base_rank == 3:  # moe expert weights (E, a, b)
        e = leaf.shape[1] if stacked else leaf.shape[0]
        ep_ok = e % _axis_size(mesh, "data") == 0
        if name == "wo":  # (E, f, d)
            spec = ("data", "model", None) if ep_ok else \
                (None, "model", "data")
        else:  # wi/wg (E, d, f)
            spec = ("data", None, "model") if ep_ok else \
                (None, "data", "model")
    elif name in _PARAM_RULES and len(_PARAM_RULES[name]) == base_rank:
        spec = _PARAM_RULES[name]
    else:
        spec = ()  # norms, biases, mu, u, w0, ln_x_*: replicate

    if stacked:
        spec = (None,) + tuple(spec)
    return fallback(spec, tuple(leaf.shape), mesh)


def _map_with_path(f, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(f, v, path + (k,)) for k, v in tree.items()}
    return f(path, tree)


def param_specs_tree(mesh, params_tree, overrides=None):
    """The spec of every leaf of a params tree (tensors or meta tensors).

    overrides: {leaf_name: spec} replacing the rule for that leaf (the
    divisibility fallback still applies)."""

    def spec(path, leaf):
        if overrides and path and path[-1] in overrides:
            return fallback(overrides[path[-1]], tuple(leaf.shape), mesh)
        return _param_spec(path, leaf, mesh)

    return _map_with_path(spec, params_tree)


# ---------------------------------------------------------------------------
# Batch / cache / token rules
# ---------------------------------------------------------------------------


def batch_shardings(mesh, batch_tree):
    """Batch rows over the data-parallel axes."""
    dp = dp_axes(mesh)
    return _map_with_path(
        lambda path, leaf: fallback((dp,) + (None,) * (leaf.ndim - 1),
                                    tuple(leaf.shape), mesh), batch_tree)


def cache_shardings(mesh, cache_tree):
    """Decode state: (n_sl, B, ...) leaves.

    KV caches (rank 5: n_sl, B, S, Hkv, hd): batch over dp and the KV
    sequence over "model" when the batch divides, else (long-context
    B = 1) the sequence over every axis. Recurrent states: batch over dp,
    feature dim over "model"."""
    dp = dp_axes(mesh)
    all_axes = tuple(mesh.axis_names)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if leaf.ndim == 5:  # KV cache
            if shape[1] % _axis_size(mesh, dp) == 0:
                s = (None, dp, "model", None, None)
            else:
                s = (None, None, all_axes, None, None)
        elif leaf.ndim >= 3:  # mamba h / rwkv s / conv
            s = (None, dp, "model") + (None,) * (leaf.ndim - 3)
        else:
            s = (None, dp)
        return fallback(s, shape, mesh)

    return _map_with_path(spec, cache_tree)


def token_shardings(mesh, tree):
    """Decode-step tokens (B, 1) over dp; a scalar position replicated."""
    dp = dp_axes(mesh)

    def spec(path, leaf):
        if leaf.ndim == 0:
            return ()
        return fallback((dp,) + (None,) * (leaf.ndim - 1), tuple(leaf.shape),
                        mesh)

    return _map_with_path(spec, tree)


# ---------------------------------------------------------------------------
# Per-device bytes
# ---------------------------------------------------------------------------


def _leaves_with_specs(tree, specs):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves_with_specs(tree[k], specs[k])
    else:
        yield tree, specs


def shard_factor(spec: tuple, mesh) -> int:
    """How many ways ``spec`` splits a leaf (the product of its axes)."""
    return math.prod(_axis_size(mesh, a) for a in spec if a)


def per_device_bytes(tree, specs, mesh, dtype_bytes=None) -> int:
    """Bytes one device holds of ``tree`` under ``specs`` on ``mesh``:
    each leaf's bytes over its shard factor (``dtype_bytes`` overrides
    every leaf's element size, e.g. 4 for the float32 grads of a bf16
    tree)."""
    total = 0
    for leaf, spec in _leaves_with_specs(tree, specs):
        elt = dtype_bytes or leaf.element_size()
        total += -(-leaf.numel() * elt // shard_factor(spec, mesh))
    return total
