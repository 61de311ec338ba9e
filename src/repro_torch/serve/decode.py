"""Sampling, output guards, and the packed prefill / decode steps.

Port of the split-mode parts of ``repro/serve/decode.py``:

``packed_prefill`` prefills a ragged batch of prompts in ONE packed
forward (one attention launch per layer): prompts are padded to a tile
multiple at their causal tail, concatenated along S, and attended
block-diagonally over the packed schedule.

``decode_step_packed`` advances every live slot one token in one packed
launch per layer, each slot attending only its own valid KV prefix —
sum_r ceil(kv_len_r / blk) tiles instead of the lockstep pad-to-max.

``fused_step`` does both at once: it prefills the newly admitted prompts
and advances every live slot in ONE mixed launch per layer.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import mapping as M
from repro_torch.kernels.tri_attn import ops as attn_ops
from repro_torch.models import model as MD


def sample_logits(logits, *, temperature: float = 0.0, vocab_size: int = 0,
                  generator: Optional[torch.Generator] = None):
    """logits: (B, Vp) f32 -> (B,) int tokens. temperature 0 is greedy
    argmax (first maximum, as the reference); otherwise a draw from
    ``generator`` (its bits differ from the reference's jax.random)."""
    if vocab_size and logits.shape[-1] > vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= vocab_size
        logits = torch.where(pad, torch.finfo(torch.float32).min, logits)
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def poisoned_slots(logits_np: np.ndarray, live: Sequence[int]) -> List[int]:
    """Live rows whose logits contain a non-finite value."""
    return [s for s in live if not bool(np.isfinite(logits_np[s]).all())]


def states_finite(states) -> bool:
    """NaN/Inf guard over the float leaves of packed prefill states."""
    if isinstance(states, dict):
        return all(states_finite(v) for v in states.values())
    if not states.is_floating_point():
        return True
    return bool(torch.isfinite(states).all())


def traced_prefill_ok(lens: Sequence[int], block: int) -> bool:
    """True iff every member's largest lambda, tri(ceil(S_r / block)) - 1,
    stays inside the certified int32 map envelope LTM_TRACED_MAX_LAM."""
    return all(M.tri(-(-int(s) // block)) - 1 <= M.LTM_TRACED_MAX_LAM
               for s in lens)


def round_capacity(needed: int, floor: int = 8) -> int:
    """The reference's bucketed decode grid size (next power of two,
    floored); kept in the DecodeRoundSpec for telemetry parity."""
    return max(floor, 1 << max(0, int(needed) - 1).bit_length())


def _attn_cache_len(cfg, cache):
    """S_cache shared by every attention layer's KV leaves, identified by
    the (n_sl, B, S, Hkv, hd) signature."""
    for layer in cache.values():
        for leaf in layer.values():
            if leaf.ndim == 5 and tuple(leaf.shape[3:]) == (cfg.n_kv_heads,
                                                            cfg.head_dim):
                return leaf.shape[2]
    raise ValueError("no attention KV leaves in cache (recurrent-only "
                     "arch cannot take the packed decode path)")


def decode_block_for(block: int, s_cache: int) -> int:
    """Largest tile edge <= block that divides S_cache (halving)."""
    blk = min(block, s_cache)
    while s_cache % blk:
        blk //= 2
    return blk


def decode_step_packed(params, cfg, cache, tokens, pos, kv_lens, slots, *,
                       block: int = 16, impl: str = "cuda"):
    """One PACKED decode round: every live slot advances one token, one
    launch per attention layer. tokens: (B, 1); pos: (B,) (stale entries
    of retired slots are fine); kv_lens/slots: host lists for the live
    slots. The member table is B + 1 wide (the pad member last). Returns
    (logits, cache, info) with info the round's tile accounting
    {"tiles", "tiles_padded", "capacity", "blk"}."""
    b = tokens.shape[0]
    s_cache = _attn_cache_len(cfg, cache)
    blk = decode_block_for(block, s_cache)
    tbl, needed = attn_ops.make_decode_table(
        kv_lens, slots, blk=blk, n_members=b + 1, n_slots=b,
        s_cache=s_cache)
    capacity = round_capacity(needed)
    spec = attn_ops.DecodeRoundSpec(n_members=b + 1, capacity=capacity,
                                    blk=blk, impl=impl, tiles=needed)
    logits, cache = MD.decode_step(
        params, cfg, cache, tokens, pos,
        decode_tbl=torch.as_tensor(tbl, device=tokens.device),
        decode_spec=spec)
    n_live = len(list(kv_lens))
    tiles_max = int(np.max(tbl[2, :n_live])) if n_live else 0
    info = {"tiles": needed, "tiles_padded": n_live * tiles_max,
            "capacity": capacity, "blk": blk}
    return logits, cache, info


def _pack_prompts(prompts, block: int):
    """Pad each prompt to a multiple of ``block`` at its causal tail and
    concatenate. Returns (lens, pads, starts, tokens (1, S) int64,
    positions (S,) int32 restarting per prompt)."""
    lens = [int(len(p)) for p in prompts]
    pads = [-(-s // block) * block for s in lens]
    starts = [int(x) for x in np.cumsum([0] + pads[:-1])]
    s_total = sum(pads)
    tokens = np.zeros((1, s_total), np.int64)
    positions = np.zeros((s_total,), np.int32)
    for st, pad, p in zip(starts, pads, prompts):
        tokens[0, st:st + len(p)] = np.asarray(p, np.int64)
        positions[st:st + pad] = np.arange(pad)
    return lens, pads, starts, tokens, positions


def packed_prefill(params, cfg, prompts, *, block: int = 16,
                   attn_impl: str = "cuda", device="cuda"):
    """Prefill a ragged prompt batch in ONE packed forward.

    Each prompt is zero-padded to a multiple of ``block`` at its causal
    tail: real rows never attend the pad and pad rows are never spliced
    out.
    Returns (psched, starts, lens, hidden, states); request r's tokens
    occupy packed rows [starts[r], starts[r] + lens[r])."""
    if not all(k == "attn" for k in cfg.layer_kinds):
        raise ValueError("packed_prefill requires attention-only token "
                         "mixers; recurrent state would leak across the "
                         "packed request boundary")
    lens, pads, starts, tokens, positions = _pack_prompts(prompts, block)
    psched = attn_ops.make_packed_sched(pads, block=block,
                                        window=cfg.sliding_window)
    hidden, _, states = MD.forward(
        params, cfg, {"tokens": torch.as_tensor(tokens, device=device)},
        attn_impl=attn_impl, collect_state=True,
        positions=torch.as_tensor(positions, device=device), packed=psched)
    return psched, starts, lens, hidden, states


def fused_step(params, cfg, cache, prompts, tokens, pos, kv_lens, slots, *,
               block: int = 16, impl: str = "cuda"):
    """ONE fused engine round: prefill the newly admitted ``prompts``
    (packed block-diagonal members, padded to the decode tile) and advance
    every live decode slot (row members over its own valid KV prefix) in
    a single mixed launch per layer.

    prompts: >= 1 token feeds to admit (decode-only rounds take
    decode_step_packed); tokens: (B, 1) last tokens; pos: (B,) (stale
    entries of slots being admitted or retired are fine); kv_lens/slots:
    host lists for the live decode slots, as decode_step_packed takes
    them. Returns (logits_admit (A, Vp) f32 from each prompt's last real
    token, logits_dec (B, Vp) f32 (live slots only meaningful), cache
    (decode k/v written in place, admit k/v NOT spliced yet), states (the
    pack's per-layer k/v for kv_cache.splice_slot), psched, starts, lens,
    info) with info["tiles"] the round's live tiles (prefill steps + live
    decode tiles)."""
    if not all(k == "attn" for k in cfg.layer_kinds):
        raise ValueError("fused_step requires attention-only token mixers")
    if not prompts:
        raise ValueError("fused_step needs at least one admit")
    b = tokens.shape[0]
    dev = tokens.device
    s_cache = _attn_cache_len(cfg, cache)
    blk = decode_block_for(block, s_cache)
    lens, pads, starts, pack_tokens, pack_positions = _pack_prompts(prompts,
                                                                    blk)
    psched = attn_ops.make_packed_sched(pads, block=blk,
                                        window=cfg.sliding_window)
    admit_rows = [st + ln - 1 for st, ln in zip(starts, lens)]
    n_members = len(pads) + b + 1
    tbl, needed = attn_ops.make_fused_table(
        psched, kv_lens, slots, blk=blk, n_members=n_members, n_slots=b,
        s_cache=s_cache)
    capacity = psched.steps + (round_capacity(needed - psched.steps)
                               if len(kv_lens) else 0)
    spec = attn_ops.FusedStepSpec(n_members=n_members, capacity=capacity,
                                  blk=blk, impl=impl, tiles=needed)
    logits_admit, logits_dec, cache, states = MD.fused_step(
        params, cfg, cache, torch.as_tensor(pack_tokens, device=dev),
        torch.as_tensor(pack_positions, device=dev), tokens, pos, psched,
        torch.as_tensor(tbl, device=dev), spec,
        torch.as_tensor(admit_rows, device=dev))
    return (logits_admit[0], logits_dec[:, 0], cache, states, psched,
            starts, lens, {"tiles": needed})
