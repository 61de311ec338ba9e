"""Atomic checkpoints of a TrainState (port of ``repro/train/checkpoint.py``).

Layout (one directory per step), as the reference's:

    <dir>/step_00000420.tmp/        # written first
        manifest.json               # step, extra, {key: {file, shape, dtype}}
        <flat.key.path>.npy         # one file per leaf
    <dir>/step_00000420/            # atomic os.replace of the .tmp dir
    <dir>/LATEST                    # atomic pointer file, written LAST

A checkpoint is visible iff the directory rename and the LATEST pointer
write (os.replace of a tmp file) both completed; a crash mid-save leaves a
.tmp directory that restore ignores and the next save overwrites.
bfloat16 leaves, which numpy cannot hold, are stored as their uint16 bit
patterns and the manifest's dtype says "bfloat16": a round trip is
bitwise. A state's ``err_state`` (the int8 compression's error feedback)
is saved beside its params and optimizer state; a state without one
saves and restores as before.

Elastic restore: every rank holds the whole model, so any one process's
checkpoint restores on every rank of a data-parallel group, of any size,
each onto its own device. ``CheckpointManager.save_async`` copies the
state to the host on the caller's thread and leaves only the file IO to
a background thread; ``wait`` joins it.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import device as DEV
from repro_torch.train.train_step import TrainState


def _flatten(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {prefix or "_root": tree}


def _unflatten(flat: dict, like):
    def build(t, prefix):
        if isinstance(t, dict):
            return {k: build(v, f"{prefix}.{k}" if prefix else str(k))
                    for k, v in t.items()}
        return flat[prefix]
    return build(like, "")


def _state_tree(state: TrainState) -> dict:
    tree = {"params": state.params, "opt_state": state.opt_state,
            "step": torch.tensor(state.step, dtype=torch.int32)}
    if state.err_state is not None:
        tree["err_state"] = state.err_state
    return tree


def _host_leaves(state: TrainState) -> dict:
    """{key: (numpy array, dtype name)} of ``state``, copied to the host
    (a copy even of a CPU leaf, which the next step updates in place)."""
    out = {}
    for key, leaf in _flatten(_state_tree(state)).items():
        t = leaf.detach().to("cpu", copy=True)
        dtype = str(t.dtype).replace("torch.", "")
        out[key] = (t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16
                    else t.numpy(), dtype)
    return out


def save(ckpt_dir: str, state: TrainState, step: int, *,
         extra: Optional[dict] = None) -> str:
    """Blocking atomic save of ``state`` as step ``step``; ``extra`` (a
    JSON-able dict) goes into the manifest."""
    return _write(ckpt_dir, _host_leaves(state), step, extra)


def _write(ckpt_dir: str, leaves: dict, step: int, extra) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for key, (arr, dtype) in leaves.items():
        fname = key + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape),
                                   "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    ptr_tmp = os.path.join(ckpt_dir, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(str(step))
    os.replace(ptr_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def _steps_on_disk(ckpt_dir: str) -> list:
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(ckpt_dir: str) -> Optional[int]:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        step = int(f.read().strip())
    if os.path.isdir(os.path.join(ckpt_dir, f"step_{step:08d}")):
        return step
    steps = _steps_on_disk(ckpt_dir)  # pointer ahead of a wiped dir
    return steps[-1] if steps else None


def restore(ckpt_dir: str, target: TrainState, device=DEV.DEFAULT_DEVICE,
            step: Optional[int] = None):
    """Load ``step`` (default: the latest) into a new TrainState with
    ``target``'s structure, shapes and dtypes, on ``device`` (its
    err_state too where ``target`` has one). Returns (state,
    manifest)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    dev = DEV.resolve(device)
    loaded = {}
    for key, like in _flatten(_state_tree(target)).items():
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint at step {step} misses leaf {key}")
        arr = np.load(os.path.join(d, meta["file"]))
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} != "
                             f"target {tuple(like.shape)}")
        t = torch.from_numpy(arr)
        if meta["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        loaded[key] = t.to(device=dev, dtype=like.dtype)
    tree = _unflatten(loaded, _state_tree(target))
    return TrainState(params=tree["params"], opt_state=tree["opt_state"],
                      step=int(tree["step"]),
                      err_state=tree.get("err_state")), manifest


class CheckpointManager:
    """Cadenced saves with retention of the last ``keep`` steps; one
    writer at a time (a save waits for the save before it)."""

    def __init__(self, ckpt_dir: str, *, every: int = 100, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.every = every
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every == 0

    def save_async(self, state: TrainState, step: int, *,
                   extra: Optional[dict] = None):
        """Copy ``state`` to the host here, then write it on a background
        thread (``wait`` joins it)."""
        leaves = _host_leaves(state)
        self.wait()

        def work():
            _write(self.ckpt_dir, leaves, step, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save_sync(self, state: TrainState, step: int, *,
                  extra: Optional[dict] = None) -> str:
        self.wait()
        path = save(self.ckpt_dir, state, step, extra=extra)
        self._gc()
        return path

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        for s in _steps_on_disk(self.ckpt_dir)[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
