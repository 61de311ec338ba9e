"""The traffic generator: reads a mix's parameters from
``bench/traffic/<mix>.json`` and makes its inputs from the run's seed.

A mix names its ``kind``, whose file ``bench/traffic/kinds/<kind>.py`` says
which cell driver runs it and how its shapes are laid out, and an open
loop names its arrival law, ``bench/traffic/arrivals/<law>.py``. So a new
mix of a known kind and law is a data file alone, and a new kind or law is
a new file beside the others. Every mix fixes its sizes and arrival gaps
from its own ``shape_seed``, so every run seed gets the same work; the run
seed orders the training rows and draws every token value.

Training tokens follow a Zipf unigram draw with short Markov repeats (every
8th position copies the token 4 before it), as the port's synthetic data
does; served prompts draw tokens uniformly over the vocabulary.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import List

import numpy as np

from bench.core import spec

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def kind(mix: dict):
    """The module of the mix's kind: ``DRIVER`` ("train" or "serve", the
    cell driver ``bench/core/<DRIVER>_cell.py``) and its generator."""
    return spec.load(f"traffic/kinds/{mix['kind']}")


def arrivals(law: dict):
    """The module of an arrival law, whose ``gaps(rng, rate, n, law)``
    draws ``n`` gaps in seconds at the mean ``rate`` a second."""
    return spec.load(f"traffic/arrivals/{law['law']}")


def stream_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def lognormal_lengths(rng, dist: dict, n: int) -> np.ndarray:
    """``n`` lengths lognormal around ``median`` with ``sigma``, rounded and
    clipped to [min, max]."""
    x = rng.lognormal(math.log(dist["median"]), dist["sigma"], size=n)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def zipf_tokens(rng, vocab: int, n: int) -> np.ndarray:
    """(n,) Zipf-ish unigram draw; every 8th position copies the token 4
    before it."""
    probs = 1.0 / np.arange(1, vocab + 1, dtype=np.float64)
    probs /= probs.sum()
    toks = rng.choice(vocab, size=n, p=probs).astype(np.int64)
    if n >= 13:
        toks[8::8] = toks[4:-4:8]
    return toks


def pack_ffd(doc_lens, capacity: int, block: int) -> List[List[int]]:
    """First-fit-decreasing bins of documents, each taking its length padded
    to ``block``; each bin lists its document indices in placement order."""
    padded = [-(-int(s) // block) * block for s in doc_lens]
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


@dataclasses.dataclass
class TrainRow:
    """One training row: documents of ``doc_lens`` real tokens, each padded
    to ``block``. tokens, labels, positions: (S,) int64; mask (S,) float32."""
    doc_lens: List[int]
    pads: List[int]
    tokens: np.ndarray
    labels: np.ndarray
    mask: np.ndarray
    positions: np.ndarray

    @property
    def loss_tokens(self) -> int:
        return int(self.mask.sum())


def train_rows(mix: dict, seed: int, vocab: int) -> List[TrainRow]:
    """The mix's pool of rows for run ``seed``: the rows' order and every
    token value come from the seed, their geometry (each row's document
    lengths, each padded to the block) from the mix's kind."""
    rng = stream_rng(seed, 1)
    geometry, blk = kind(mix).geometry(mix)
    out = []
    for g in rng.permutation(len(geometry)):
        lens = geometry[g]
        pads = [-(-n // blk) * blk for n in lens]
        s = sum(pads)
        toks, labels = np.zeros(s, np.int64), np.zeros(s, np.int64)
        mask, pos = np.zeros(s, np.float32), np.zeros(s, np.int64)
        at = 0
        for n, pad in zip(lens, pads):
            doc = zipf_tokens(rng, vocab, n + 1)
            toks[at:at + n], labels[at:at + n] = doc[:-1], doc[1:]
            mask[at:at + n] = 1.0
            pos[at:at + pad] = np.arange(pad)
            at += pad
        out.append(TrainRow(list(lens), pads, toks, labels, mask, pos))
    return out


@dataclasses.dataclass
class ServeRequest:
    uid: int
    due: float        # seconds after the traffic starts (open loop)
    client: int       # the closed loop's client, -1 in an open loop
    prompt: np.ndarray
    max_new: int
