"""Synthetic data pipeline (port of ``repro/train/data.py``: dense text,
the stub frontends' audio and vision batches, and ragged documents
bin-packed for packed training).

Deterministic per (seed, step): resuming from a checkpoint at step k
re-produces batch k + 1 bit for bit with no stored iterator state, the
property the restart tests rely on. Tokens follow a Zipfian unigram draw
with short Markov repeats so the loss curve is non-trivial. The numpy
draws are the reference's, so both packages see the same batches.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import device as DEV


def _zipf_tokens(rng: np.random.Generator, vocab: int, b: int,
                 n: int) -> np.ndarray:
    """(b, n) Zipf-ish unigram draw with short Markov repeats: every 8th
    position copies the token 4 before it."""
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(b, n), p=probs).astype(np.int32)
    if n >= 13:
        toks[:, 8::8] = toks[:, 4:-4:8]
    return toks


def _tensors(arrays: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


class SyntheticLM:
    """Batch factory for one (cfg, shape) cell, tensors on ``device``:
    {"tokens", "labels"} (B, S) int32; for an audio-frames arch
    {"embeds" (B, S, d) in ``act_dtype``, "labels"}; for a vision-patches
    arch {"embeds" (B, P, d), "tokens" (B, S - P), "labels" (B, S) (0 on
    the prefix), "mask" (B, S) (0 on the prefix)}. The draws are the
    reference's, Philox stream and order included."""

    def __init__(self, cfg, shape, *, seed: int = 0,
                 device=DEV.DEFAULT_DEVICE, act_dtype=torch.bfloat16):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = DEV.resolve(device)
        self.act_dtype = act_dtype

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=[self.seed, (0xB10C << 32) | step]))

    def _embeds(self, rng, b: int, n: int) -> torch.Tensor:
        emb = rng.standard_normal((b, n, self.cfg.d_model),
                                  dtype=np.float32) * 0.02
        return torch.as_tensor(emb, device=self.device).to(self.act_dtype)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b, s = self.shape.global_batch, self.shape.seq_len
        rng = self._rng(step)
        if cfg.frontend == "audio_frames":
            toks = _zipf_tokens(rng, cfg.vocab_size, b, s + 1)
            return {"embeds": self._embeds(rng, b, s),
                    **_tensors({"labels": toks[:, 1:]}, self.device)}
        if cfg.frontend == "vision_patches":
            p = cfg.n_patches
            toks = _zipf_tokens(rng, cfg.vocab_size, b, s - p + 1)
            embeds = self._embeds(rng, b, p)
            labels = np.concatenate([np.zeros((b, p), np.int32),
                                     toks[:, 1:]], axis=1)
            mask = np.concatenate([np.zeros((b, p), np.float32),
                                   np.ones((b, s - p), np.float32)], axis=1)
            return {"embeds": embeds, **_tensors(
                {"tokens": toks[:, :-1], "labels": labels, "mask": mask},
                self.device)}
        toks = _zipf_tokens(rng, cfg.vocab_size, b, s + 1)
        return _tensors({"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                        self.device)


def pack_documents(doc_lens, capacity: int, *, block: int):
    """First-fit-decreasing bin packing of documents into packed-row bins.

    doc_lens[i] is document i's raw token count; each occupies
    ceil(len / block) * block packed rows (its member triangle's padded
    edge). Bins hold at most ``capacity`` padded tokens. Returns a list
    of bins, each a list of doc indices in placement order (descending
    padded length)."""
    if not capacity >= block > 0:
        raise ValueError(f"need capacity >= block > 0, got capacity "
                         f"{capacity}, block {block}")
    padded = [-(-int(s) // block) * block for s in doc_lens]
    if not all(0 < p <= capacity for p in padded):
        raise ValueError(f"documents must be 1..{capacity} padded tokens, "
                         f"got {padded}")
    order = sorted(range(len(padded)), key=lambda i: -padded[i])
    bins, fill = [], []
    for i in order:
        for b, used in enumerate(fill):
            if used + padded[i] <= capacity:
                bins[b].append(i)
                fill[b] += padded[i]
                break
        else:
            bins.append([i])
            fill.append(padded[i])
    return bins


class PackedDocsLM:
    """Ragged-document batch factory for packed triangular training.

    ``doc_lens`` fixes the batch geometry; each step re-draws the token
    values per (seed, step), as SyntheticLM does. ``batch`` is one packed
    row: tokens (1, S_total) with the documents concatenated (each
    zero-padded to a ``block`` multiple), labels shifted within each
    document, mask 0 on pad rows, positions restarting per document.
    ``member_lens`` feeds ops.make_packed_sched. ``padded_batch`` is the
    pad-to-max baseline over the same documents, (R, S_max), whose loss
    averages over the same real tokens."""

    def __init__(self, cfg, doc_lens, *, block: int, seed: int = 0,
                 device=DEV.DEFAULT_DEVICE):
        self.cfg, self.seed, self.block = cfg, seed, block
        self.device = DEV.resolve(device)
        self.doc_lens = tuple(int(s) for s in doc_lens)
        if not all(s >= 2 for s in self.doc_lens):
            raise ValueError(f"documents need >= 2 tokens for a next-token "
                             f"target, got {self.doc_lens}")
        self.pads = tuple(-(-s // block) * block for s in self.doc_lens)
        self.starts = tuple(np.cumsum((0,) + self.pads[:-1]).tolist())
        self.s_total = sum(self.pads)

    @property
    def member_lens(self):
        """Padded per-document lengths: feed to ops.make_packed_sched."""
        return self.pads

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=[self.seed, (0xD0C5 << 32) | step]))

    def _docs(self, step: int):
        """Per-document (len + 1)-token draws for one step."""
        rng = self._rng(step)
        return [_zipf_tokens(rng, self.cfg.vocab_size, 1, s + 1)[0]
                for s in self.doc_lens]

    def batch(self, step: int) -> dict:
        toks = np.zeros((1, self.s_total), np.int32)
        labels = np.zeros((1, self.s_total), np.int32)
        mask = np.zeros((1, self.s_total), np.float32)
        positions = np.zeros((1, self.s_total), np.int32)
        for st, pad, s, doc in zip(self.starts, self.pads, self.doc_lens,
                                   self._docs(step)):
            toks[0, st:st + s] = doc[:-1]
            labels[0, st:st + s] = doc[1:]
            mask[0, st:st + s] = 1.0
            positions[0, st:st + pad] = np.arange(pad)
        return _tensors({"tokens": toks, "labels": labels, "mask": mask,
                         "positions": positions}, self.device)

    def padded_batch(self, step: int) -> dict:
        """Pad-to-max baseline: (R, S_max) rows over the same documents."""
        r, s_max = len(self.doc_lens), max(self.pads)
        toks = np.zeros((r, s_max), np.int32)
        labels = np.zeros((r, s_max), np.int32)
        mask = np.zeros((r, s_max), np.float32)
        for row, (s, doc) in enumerate(zip(self.doc_lens, self._docs(step))):
            toks[row, :s] = doc[:-1]
            labels[row, :s] = doc[1:]
            mask[row, :s] = 1.0
        return _tensors({"tokens": toks, "labels": labels, "mask": mask},
                        self.device)
