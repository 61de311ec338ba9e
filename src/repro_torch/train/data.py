"""Synthetic data pipeline (port of ``repro/train/data.py``, dense text).

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


class SyntheticLM:
    """Batch factory for one (cfg, shape) cell: {"tokens", "labels"} (B, S)
    int32 tensors on ``device``."""

    def __init__(self, cfg, shape, *, seed: int = 0,
                 device=DEV.DEFAULT_DEVICE):
        if cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: {cfg.frontend} batches are not ported yet "
                "(ROADMAP queue A, models)")
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = DEV.resolve(device)

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=[self.seed, (0xB10C << 32) | step]))

    def batch(self, step: int) -> dict:
        b, s = self.shape.global_batch, self.shape.seq_len
        toks = _zipf_tokens(self._rng(step), self.cfg.vocab_size, b, s + 1)
        return {"tokens": torch.as_tensor(toks[:, :-1], device=self.device),
                "labels": torch.as_tensor(toks[:, 1:], device=self.device)}
