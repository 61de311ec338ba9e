"""KV cache splicing for serving (port of ``repro/serve/kv_cache.py``).

Cache layout per attention pattern slot: k/v (n_superlayers, B, S_slots,
Hkv, hd); S_slots = min(window, max_len) for sliding-window archs (a
rolling buffer, row = pos % W) else max_len. ``splice_slot`` copies one
request's rows out of the packed prefill states into its slot IN PLACE.
"""

from __future__ import annotations


def _kv_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _kv_leaves(v)
    elif tree.ndim == 5:
        yield tree


def validate_splice(cache, slot: int, start: int, length: int, *,
                    rolling: bool = False):
    """Bounds-check a packed-prefill -> slot-cache splice before any
    write; raises ValueError rather than truncating a prompt's KV or
    writing into a neighbouring slot."""
    if length <= 0:
        raise ValueError(f"splice length must be positive, got {length} "
                         f"(empty prompts are rejected at submit)")
    if start < 0:
        raise ValueError(f"splice start must be >= 0, got {start}")
    for leaf in _kv_leaves(cache):
        n_slots, s_slots = leaf.shape[1], leaf.shape[2]
        if not 0 <= slot < n_slots:
            raise ValueError(
                f"splice slot {slot} out of range for a {n_slots}-slot "
                f"cache — writing would corrupt slot {slot % n_slots}'s "
                f"KV rows (a neighboring request)")
        if length > s_slots and not rolling:
            raise ValueError(
                f"splice of {length} KV rows overflows the slot cache "
                f"(S_slots={s_slots}, non-rolling): the request is longer "
                f"than max_len — reject it at submit or raise max_len")


def splice_slot(cache, slot: int, states, start: int, length: int, *,
                rolling: bool = False):
    """Copy rows [start, start + length) of the packed ``states`` (k/v
    (n_sl, 1, S_total, Hkv, hd)) into ``slot`` of ``cache``, validated;
    rolling caches keep the last S_slots rows in decode's row order.
    Returns the (same, updated) cache."""
    validate_splice(cache, slot, start, length, rolling=rolling)
    for leaf in _kv_leaves(states):
        if start + length > leaf.shape[2]:
            raise ValueError(
                f"splice [{start}, {start + length}) reads past the "
                f"packed states (S_total={leaf.shape[2]}): start/length "
                f"disagree with the packing — the rows would belong to "
                f"the NEXT packed request")
    for name, c_layer in cache.items():
        for kv in ("k", "v"):
            c, st = c_layer[kv], states[name][kv]
            s_slots = c.shape[2]
            seg = st[:, 0, start:start + length]
            if length > s_slots:
                keep = seg[:, length - s_slots:].roll(length % s_slots, 1)
                c[:, slot, :s_slots] = keep.to(c.dtype)
            else:
                c[:, slot, :length] = seg.to(c.dtype)
    return cache
