"""Crash-safe engine snapshot / restore (port of
``repro/resilience/snapshot.py``).

``snapshot(engine)`` captures what the serving loop's determinism depends
on: the slot table (per-slot request, position, last token, remaining
budget), the KV cache, the queue and finished lists, the round indices,
the quarantine table, the clock reading, the step mode and the sampling
generator's state (``torch.Generator.get_state()``). The cache is copied
to host memory; the params are NOT: the snapshot holds a reference to the
engine's device params, which serving never mutates (at yi-9b's full
width a host copy would be 17.7 GB a snapshot). ``restore(snap)``
rebuilds an Engine from the recorded constructor arguments and overwrites
its state, so ``restore(snap).run()`` resumes token-identically, sampled
streams included. Request ages survive a move between clocks: each
request's ``submitted_at`` is rebased by the new clock's reading minus
the captured one, so deadlines keep measuring elapsed age. A request
written before requests carried a deadline restores with none, its age
counted from the capture.

``to_dir`` / ``from_dir`` persist a snapshot, params included: everything
is written into ``<dir>.tmp`` and ``os.replace``d into place, so a crash
mid-save leaves only a .tmp the loader never reads. Tensors land in one
flat .npz (dot-joined tree paths); bfloat16 is stored as its exact
float32 widening and cast back on load. No pickle.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

SNAPSHOT_VERSION = "repro_torch.resilience.snapshot/v1"

_DTYPES = {str(d): d for d in (torch.float32, torch.bfloat16, torch.float16,
                               torch.int64, torch.int32, torch.uint8)}


@dataclasses.dataclass
class EngineSnapshot:
    """Image of a serving engine (see the module docstring)."""

    cfg: ModelConfig
    params: dict           # the engine's params, by reference
    cache: dict            # host copy
    init_kw: dict
    pos: np.ndarray
    last_tok: np.ndarray
    remaining: np.ndarray
    rng_state: torch.Tensor
    clock_now: float
    admit_round_idx: int
    decode_round_idx: int
    quarantined: Dict[int, int]
    slot_req: List[Optional[dict]]
    queue: List[dict]
    finished: List[dict]
    step_mode: str


def _req_to_dict(req) -> dict:
    return {"uid": int(req.uid), "prompt": [int(t) for t in req.prompt],
            "max_new": int(req.max_new), "out": [int(t) for t in req.out],
            "done": bool(req.done), "status": req.status,
            "deadline_s": req.deadline_s,
            "submitted_at": float(req.submitted_at),
            "replays": int(req.replays), "error": req.error}


def _req_from_dict(d: dict, shift: float, captured_at: float):
    """The request of ``d``, its submit time moved by ``shift`` seconds
    onto another clock. A dict without ``deadline_s`` / ``submitted_at``
    (written before requests carried them) has no deadline and counts
    its age from ``captured_at``, the capture's clock reading."""
    from repro_torch.serve.engine import Request

    return Request(uid=d["uid"], prompt=np.asarray(d["prompt"], np.int32),
                   max_new=d["max_new"], out=list(d["out"]), done=d["done"],
                   status=d["status"], deadline_s=d.get("deadline_s"),
                   submitted_at=d.get("submitted_at", captured_at) + shift,
                   replays=d["replays"], error=d["error"])


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def snapshot(engine) -> EngineSnapshot:
    """Capture ``engine`` (it keeps running)."""
    return EngineSnapshot(
        cfg=engine.cfg,
        params=engine.params,
        cache=_map(engine.cache, lambda t: t.detach().to("cpu", copy=True)),
        init_kw=dict(engine._init_kw),
        pos=engine.pos.cpu().numpy().copy(),
        last_tok=engine.last_tok.cpu().numpy().copy(),
        remaining=engine.remaining.copy(),
        rng_state=engine.generator.get_state(),
        clock_now=float(engine.clock()),
        admit_round_idx=engine._admit_round_idx,
        decode_round_idx=engine._decode_round_idx,
        quarantined=dict(engine.quarantined),
        slot_req=[None if r is None else _req_to_dict(r)
                  for r in engine.slot_req],
        queue=[_req_to_dict(r) for r in engine.queue],
        finished=[_req_to_dict(r) for r in engine.finished],
        step_mode=engine.step_mode)


def restore(snap: EngineSnapshot, *, params=None, fault_plan=None,
            clock=None, retry=None, escalate_step_errors: bool = False):
    """Rebuild an Engine from ``snap``; run() resumes token-identically.

    ``params`` overrides the snapshot's (a fleet passes its shared device
    params); fault_plan/clock/retry/escalate_step_errors are the runtime
    harness of the new engine. Raises ValueError when the rebuilt engine's
    step mode or cache geometry differs from the captured one (the config
    drifted between capture and restore)."""
    from repro_torch.serve.engine import Engine

    kw = dict(snap.init_kw)
    if params is None:
        dev = torch.device(kw["device"])
        params = _map(snap.params, lambda t: t.to(dev))
    eng = Engine(params, snap.cfg, fault_plan=fault_plan, clock=clock,
                 retry=retry, escalate_step_errors=escalate_step_errors, **kw)
    if snap.step_mode != eng.step_mode:
        raise ValueError(
            f"snapshot captured step_mode={snap.step_mode!r} but the rebuilt "
            f"engine runs {eng.step_mode!r}: the config drifted between "
            "capture and restore")
    for name, layer in eng.cache.items():
        for kv, leaf in layer.items():
            src = snap.cache.get(name, {}).get(kv)
            if src is None or src.shape != leaf.shape or \
                    src.dtype != leaf.dtype:
                raise ValueError(
                    f"snapshot cache {name}.{kv} "
                    f"{None if src is None else (tuple(src.shape), src.dtype)}"
                    f" != the rebuilt engine's {(tuple(leaf.shape), leaf.dtype)}"
                    ": the config drifted between capture and restore")
            leaf.copy_(src)
    eng.pos = torch.tensor(snap.pos, device=eng.device)
    eng.last_tok = torch.tensor(snap.last_tok, device=eng.device)
    eng.remaining = np.asarray(snap.remaining).copy()
    eng.generator.set_state(snap.rng_state)
    eng.quarantined = dict(snap.quarantined)
    eng._admit_round_idx = snap.admit_round_idx
    eng._decode_round_idx = snap.decode_round_idx
    # rebase request ages onto the new clock: the elapsed age deadlines
    # measure is kept across the restore
    shift = float(eng.clock()) - snap.clock_now
    eng.slot_req = [None if d is None
                    else _req_from_dict(d, shift, snap.clock_now)
                    for d in snap.slot_req]
    eng.queue = [_req_from_dict(d, shift, snap.clock_now)
                 for d in snap.queue]
    eng.finished = [_req_from_dict(d, shift, snap.clock_now)
                    for d in snap.finished]
    return eng


def strip_for_restart(snap: EngineSnapshot) -> EngineSnapshot:
    """A copy for a fleet replica's restart: its requests migrate to a
    peer, so the restored engine starts EMPTY, but keeps its round indices
    (round-addressed faults it already struck never re-fire), generator
    and clock reading."""
    return dataclasses.replace(
        snap, slot_req=[None] * len(snap.slot_req), queue=[], finished=[],
        quarantined={}, remaining=np.zeros_like(snap.remaining))


# ---------------------------------------------------------------------------
# Atomic on-disk persistence
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str) -> Dict[str, torch.Tensor]:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        if "." in str(k):
            raise ValueError(f"tree key {k!r} would break the npz paths")
        out.update(_flatten(v, f"{prefix}.{k}"))
    return out


def _unflatten(flat: Dict[str, torch.Tensor], prefix: str) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        parts = path.split(".")
        if parts[0] != prefix:
            continue
        node = tree
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def to_dir(snap: EngineSnapshot, path: str) -> str:
    """Persist ``snap`` at ``path`` (a directory), atomically."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(snap.params, "params")
    flat.update(_flatten(snap.cache, "cache"))
    flat.update({"pos": torch.as_tensor(snap.pos),
                 "last_tok": torch.as_tensor(snap.last_tok),
                 "remaining": torch.as_tensor(snap.remaining),
                 "rng_state": snap.rng_state})
    arrays, dtypes = {}, {}
    for key, t in flat.items():
        t = t.detach().cpu()
        dtypes[key] = str(t.dtype)
        arrays[key] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    kw = dict(snap.init_kw, cache_dtype=str(snap.init_kw["cache_dtype"]))
    meta = {
        "schema": SNAPSHOT_VERSION, "cfg": dataclasses.asdict(snap.cfg),
        "init_kw": kw, "dtypes": dtypes, "clock_now": snap.clock_now,
        "admit_round_idx": snap.admit_round_idx,
        "decode_round_idx": snap.decode_round_idx,
        "quarantined": {str(k): v for k, v in snap.quarantined.items()},
        "slot_req": snap.slot_req, "queue": snap.queue,
        "finished": snap.finished, "step_mode": snap.step_mode,
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def from_dir(path: str) -> EngineSnapshot:
    """Load a snapshot persisted by to_dir (params and cache as CPU
    tensors). A sibling .tmp is never read."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("schema") != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot at {path}: schema "
                         f"{meta.get('schema')!r} != {SNAPSHOT_VERSION}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        flat = {k: torch.as_tensor(z[k]).to(_DTYPES[meta["dtypes"][k]])
                for k in z.files}
    cfg_d = dict(meta["cfg"], layer_pattern=tuple(meta["cfg"]["layer_pattern"]))
    kw = dict(meta["init_kw"], cache_dtype=_DTYPES[meta["init_kw"]["cache_dtype"]])
    return EngineSnapshot(
        cfg=ModelConfig(**cfg_d), params=_unflatten(flat, "params"),
        cache=_unflatten(flat, "cache"), init_kw=kw,
        pos=flat["pos"].numpy(), last_tok=flat["last_tok"].numpy(),
        remaining=flat["remaining"].numpy(), rng_state=flat["rng_state"],
        clock_now=meta["clock_now"],
        admit_round_idx=meta["admit_round_idx"],
        decode_round_idx=meta["decode_round_idx"],
        quarantined={int(k): v for k, v in meta["quarantined"].items()},
        slot_req=meta["slot_req"], queue=meta["queue"],
        finished=meta["finished"], step_mode=meta["step_mode"])
