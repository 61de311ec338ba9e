"""repro_torch engine snapshot / restore: crash-safe, token-identical.

A snapshot cut after any round of a fused or a split run restores into an
engine whose run emits the uninterrupted run's tokens, greedy and sampled
(port against port: the JAX and torch generators differ). The on-disk
form round-trips exactly and ignores a leftover .tmp; a restore whose
configuration drifted from the capture raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as REG
from repro_torch.models import model as MD
from repro_torch.resilience import snapshot as SNAP
from repro_torch.serve.engine import Engine

torch.set_num_threads(2)

PROMPTS = [np.array([3, 1, 4, 1, 5, 9], np.int32),
           np.array([2, 7, 1], np.int32),
           np.array([9, 8, 2, 6, 5, 3, 5, 8, 9, 7, 9], np.int32),
           np.array([5, 5, 2], np.int32)]
MAX_NEW = [3, 5, 2, 4]


@pytest.fixture(scope="module")
def ctx():
    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device="cpu")

    def make(**kw):
        eng = Engine(params, cfg, slots=2, max_len=32, prefill_block=4,
                     decode_block=8, prefill_impl="torch",
                     decode_impl="torch", device="cpu", **kw)
        for uid, (p, m) in enumerate(zip(PROMPTS, MAX_NEW)):
            eng.submit(p, max_new=m, uid=uid)
        return eng

    baselines = {mode: make(step_mode=mode).run()
                 for mode in ("split", "fused")}
    return {"cfg": cfg, "params": params, "make": make,
            "baselines": baselines}


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_restore_at_every_round_is_token_identical(ctx, step_mode):
    base = ctx["baselines"][step_mode]
    n_rounds = 0
    eng = ctx["make"](step_mode=step_mode)
    while not eng.idle():
        eng.round()
        n_rounds += 1
    for cut in range(n_rounds):
        eng = ctx["make"](step_mode=step_mode)
        for _ in range(cut):
            eng.round()
        snap = SNAP.snapshot(eng)
        assert Engine.restore(snap).run() == base, cut
        # the snapshot is a value, not a handle: restoring twice agrees
        assert SNAP.restore(snap).run() == base, cut
        assert eng.run() == base, cut  # the captured engine runs on


def test_fused_and_split_runs_agree(ctx):
    assert ctx["baselines"]["fused"] == ctx["baselines"]["split"]


def test_snapshot_holds_params_by_reference_and_cache_by_copy(ctx):
    eng = ctx["make"](step_mode="fused")
    eng.round()
    snap = SNAP.snapshot(eng)
    assert snap.params is eng.params
    k = eng.cache["l0"]["k"]
    assert torch.equal(snap.cache["l0"]["k"], k)
    assert snap.cache["l0"]["k"].data_ptr() != k.data_ptr()
    eng.round()
    assert not torch.equal(snap.cache["l0"]["k"], eng.cache["l0"]["k"])


def _tensors_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tensors_equal(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dir_round_trip_is_exact_and_ignores_tmp(ctx, tmp_path, dtype):
    cfg = dataclasses.replace(ctx["cfg"], dtype=dtype)
    params = MD.init_params(cfg, seed=1, device="cpu")
    eng = Engine(params, cfg, slots=2, max_len=32, prefill_block=4,
                 decode_block=8, prefill_impl="torch", decode_impl="torch",
                 step_mode="fused", temperature=0.7, seed=3,
                 cache_dtype=torch.bfloat16, device="cpu")
    for uid, (p, m) in enumerate(zip(PROMPTS, MAX_NEW)):
        eng.submit(p, max_new=m, uid=uid)
    for _ in range(3):
        eng.round()
    snap = SNAP.snapshot(eng)
    path = str(tmp_path / "snap")
    (tmp_path / "snap.tmp").mkdir()  # a crash mid-save left this behind
    (tmp_path / "snap.tmp" / "meta.json").write_text("{garbage")
    SNAP.to_dir(snap, path)
    assert not (tmp_path / "snap.tmp").exists()
    (tmp_path / "snap.tmp").mkdir()
    (tmp_path / "snap.tmp" / "meta.json").write_text("{garbage")
    loaded = SNAP.from_dir(path)
    assert _tensors_equal(loaded.params, snap.params)
    assert _tensors_equal(loaded.cache, snap.cache)
    assert torch.equal(loaded.rng_state, snap.rng_state)
    for f in dataclasses.fields(SNAP.EngineSnapshot):
        if f.name in ("params", "cache", "rng_state"):
            continue
        a, b = getattr(loaded, f.name), getattr(snap, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    assert SNAP.restore(loaded).run() == SNAP.restore(snap).run() == \
        eng.run()


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_sampled_stream_resumes(ctx, step_mode):
    """temperature > 0: the generator's state rides the snapshot, so the
    restored engine draws the uninterrupted engine's tokens."""
    want = ctx["make"](step_mode=step_mode, temperature=0.9, seed=7).run()
    eng = ctx["make"](step_mode=step_mode, temperature=0.9, seed=7)
    for _ in range(3):
        eng.round()
    assert Engine.restore(SNAP.snapshot(eng)).run() == want
    other = ctx["make"](step_mode=step_mode, temperature=0.9, seed=8).run()
    assert other != want  # the draws really depend on the generator


def test_config_drift_raises(ctx):
    eng = ctx["make"](step_mode="fused")
    eng.round()
    snap = SNAP.snapshot(eng)
    with pytest.raises(ValueError, match="step_mode"):
        Engine.restore(dataclasses.replace(snap, step_mode="split"))
    with pytest.raises(ValueError, match="cache"):
        SNAP.restore(dataclasses.replace(
            snap, init_kw=dict(snap.init_kw, max_len=64)))
    with pytest.raises(ValueError, match="cache"):
        SNAP.restore(dataclasses.replace(
            snap, cfg=dataclasses.replace(snap.cfg, n_kv_heads=2)),
            params=MD.init_params(dataclasses.replace(snap.cfg,
                                                      n_kv_heads=2),
                                  device="cpu"))
