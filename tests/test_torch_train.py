"""repro_torch training == the JAX package, and the port's own training
properties.

Against the reference (smoke_config("yi-9b"), reference state carried
over with ``state_from_jax``): SyntheticLM batches bit for bit, the LR
schedule, the global-norm clip, AdamW on a quadratic, ``loss_fn`` value
and grads (float32 at the attn_grad tolerance; bfloat16 relative to the
grads' magnitude), three train steps, and microbatch accumulation. The
port runs its plain attention ('torch'), the reference its scan impl,
both at tile edge 16 so the triangular path (not the one-tile oracle)
runs. Port only: the loss falls over 20 steps, checkpoints round-trip
and ignore a partial save, a crashed run resumes bitwise, the
preemption guard saves and stops, and the CLI trains on the CPU.
"""

import copy
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.configs import registry as JREG
from repro.configs.base import ShapeConfig as JShape
from repro.models import model as JMD
from repro.train import data as JDATA
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch.configs import registry as REG
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import train as LAUNCH
from repro_torch.models import model as MD
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import data as DATA
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

torch.set_num_threads(2)

BLOCK = 16


def _cfgs(dtype="float32"):
    return (dataclasses.replace(JREG.smoke_config("yi-9b"), dtype=dtype),
            dataclasses.replace(REG.smoke_config("yi-9b"), dtype=dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    else:
        yield prefix, tree


def _jbatch(jcfg, seq, b, step=0, seed=0):
    return JDATA.SyntheticLM(jcfg, JShape("t", seq, b, "train"), seed=seed,
                             act_dtype=jnp.float32).batch(step)


def _tbatch(tcfg, seq, b, step=0, seed=0):
    return DATA.SyntheticLM(tcfg, ShapeConfig("t", seq, b, "train"),
                            seed=seed, device="cpu").batch(step)


def _jstate(jcfg, opt, seed=0):
    return JTS.init_state(jax.random.key(seed), jcfg, opt)


def _to_torch(jcfg, tcfg, jstate):
    return TS.state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                             device="cpu")


def _assert_params_close(tparams, jparams, **tol):
    jl = dict(_leaves(jparams))
    tl = dict(_leaves(tparams))
    assert jl.keys() == tl.keys()
    for key in jl:
        np.testing.assert_allclose(_np(tl[key]), _np(jl[key]), err_msg=key,
                                   **tol)


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (5, 1000)])
def test_synthetic_batches_bitwise(seed, step):
    jcfg, tcfg = _cfgs()
    want = _jbatch(jcfg, 64, 4, step, seed)
    got = _tbatch(tcfg, 64, 4, step, seed)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_schedule_matches_reference():
    for opt in (OPT.OptConfig(), OPT.OptConfig(lr=1e-3, warmup_steps=7,
                                               total_steps=50,
                                               min_lr_frac=0.3)):
        jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
        for step in list(range(0, 120, 3)) + [9_999, 10_000, 12_000]:
            np.testing.assert_allclose(
                OPT.schedule(opt, step),
                float(JOPT.schedule(jopt, jnp.int32(step))), rtol=1e-6)


@pytest.mark.parametrize("scale_up", [1e-3, 1e3])
def test_clip_by_global_norm_matches_reference(scale_up):
    """The global norm over per-layer grad slices equals the reference's
    over the stacked tree; scale * g equals its clipped grads."""
    rng = np.random.default_rng(0)
    tree = {"embed": rng.standard_normal((8, 4)),
            "layers": {"w": rng.standard_normal((3, 4, 5)),
                       "norm1": rng.standard_normal((3, 4))},
            "final_norm": rng.standard_normal((4,))}
    tree = jax.tree.map(lambda x: (x * scale_up).astype(np.float32), tree)
    jclip, jnorm = JOPT.clip_by_global_norm(
        jax.tree.map(jnp.asarray, tree), 1.0)
    per_layer = [torch.as_tensor(tree["embed"])] + \
        [torch.as_tensor(x) for x in tree["layers"]["w"]] + \
        [torch.as_tensor(x) for x in tree["layers"]["norm1"]] + \
        [torch.as_tensor(tree["final_norm"])]
    scale, norm = OPT.clip_by_global_norm(iter(per_layer), 1.0)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(
        (torch.as_tensor(tree["layers"]["w"]) * scale).numpy(),
        np.asarray(jclip["layers"]["w"]), rtol=1e-6)


def test_adamw_minimises_a_quadratic_as_the_reference():
    """The reference's quadratic test, both packages step for step."""
    opt = OPT.OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                        total_steps=200, min_lr_frac=1.0)
    jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
    w0 = np.array([[3.0, -2.0], [1.5, 4.0]], np.float32)
    jp = {"w": jnp.asarray(w0)}
    js = JOPT.init_opt_state(jopt, jp)
    tp = {"w": torch.as_tensor(w0.copy())}
    ts = OPT.init_opt_state(tp)
    for i in range(150):
        jp, js, _ = JOPT.apply_updates(jopt, jp, jax.tree.map(
            lambda p: 2 * p, jp), js, jnp.int32(i))
        OPT.apply_updates(opt, tp, {"w": 2 * tp["w"]}, ts, i)
    assert float(tp["w"].abs().max()) < 0.1
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jparams = JMD.init_params(jax.random.key(1), jcfg)
    jb = _jbatch(jcfg, 64, 2)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, jb, attn_impl="scan", remat=True,
                              block=BLOCK), has_aux=True)(jparams)
    tparams = MD.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    views = TS.trainable(tparams)
    loss, met = MD.loss_fn(views, tcfg, _tbatch(tcfg, 64, 2),
                           attn_impl="torch", block=BLOCK)
    loss.backward()
    rtol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=rtol)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]),
                               rtol=rtol)
    _assert_grads_close(TS.grads_of(views), jgrads, tparams, dtype)


def _stack_layers(t):
    if isinstance(t, dict):
        return {k: _stack_layers(v) for k, v in t.items()}
    return torch.stack(t) if isinstance(t, list) else t


def _assert_grads_close(tgrads, jgrads, tparams, dtype, grad_dtype=None):
    """Port grads (per-layer lists) against the reference's at the
    attn_grad tolerance in float32, and in bfloat16 relative to each
    leaf's largest grad; every grad has its param's shape and
    ``grad_dtype`` (default: the param's dtype)."""
    jl, tl = dict(_leaves(jgrads)), dict(_leaves(tparams))
    for key, g in _leaves(_stack_layers(tgrads)):
        want = _np(jl[key])
        assert g.dtype == (grad_dtype or tl[key].dtype), key
        assert g.shape == tl[key].shape, key
        if dtype == "float32":
            tol = O.tol("attn_grad", jnp.float32)
        else:  # relative to the leaf's largest grad (bf16 grads)
            tol = O.tol("attn", jnp.bfloat16)
            tol["atol"] *= float(np.abs(want).max())
        np.testing.assert_allclose(_np(g), want, err_msg=key, **tol)


def test_three_train_steps_match_reference():
    jcfg, tcfg = _cfgs()
    opt = OPT.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
    jstate = _jstate(jcfg, jopt)
    tstate = _to_torch(jcfg, tcfg, jstate)
    jstep = jax.jit(JTS.make_train_step(jcfg, jopt, attn_impl="scan",
                                        block=BLOCK))
    tstep = TS.make_train_step(tcfg, opt, attn_impl="torch", block=BLOCK)
    for i in range(3):
        jstate, jm = jstep(jstate, _jbatch(jcfg, 64, 2, i))
        tstate, tm = tstep(tstate, _tbatch(tcfg, 64, 2, i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    assert tstate.step == int(jstate.step) == 3
    _assert_params_close(tstate.params, jstate.params, atol=2e-5, rtol=2e-4)
    _assert_params_close(tstate.opt_state, jstate.opt_state, atol=1e-6,
                         rtol=2e-3)


def test_microbatch_accumulation_matches():
    """microbatches=4 against microbatches=1 in the port, and against the
    reference's microbatches=4 (the reference test's tolerances)."""
    jcfg, tcfg = _cfgs()
    opt = OPT.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
    jstate = _jstate(jcfg, jopt)
    t1 = _to_torch(jcfg, tcfg, jstate)
    t4 = copy.deepcopy(t1)
    batch = _tbatch(tcfg, 32, 8)
    t1, m1 = TS.make_train_step(tcfg, opt, attn_impl="torch",
                                block=BLOCK)(t1, batch)
    t4, m4 = TS.make_train_step(tcfg, opt, microbatches=4,
                                attn_impl="torch", block=BLOCK)(t4, batch)
    j4, jm4 = JTS.make_train_step(jcfg, jopt, microbatches=4,
                                  attn_impl="scan", block=BLOCK)(
        jstate, _jbatch(jcfg, 32, 8))
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m4["loss"]), float(jm4["loss"]),
                               rtol=1e-5)
    for a, b in zip(_leaves(t1.params), _leaves(t4.params)):
        np.testing.assert_allclose(_np(a[1]), _np(b[1]), rtol=2e-3,
                                   atol=2e-5)
    _assert_params_close(t4.params, j4.params, rtol=2e-3, atol=2e-5)


def test_bf16_microbatch_grads_sum_in_float32_as_the_reference(
        monkeypatch):
    """bfloat16 params, microbatches=4: both packages hand AdamW the
    float32 mean of the microbatches' grads, and the two agree at the
    bfloat16 grad tolerance of test_loss_and_grads_match_reference."""
    jcfg, tcfg = _cfgs("bfloat16")
    opt = OPT.OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
    jstate = _jstate(jcfg, jopt)
    tstate = _to_torch(jcfg, tcfg, jstate)
    seen = {}
    for key, mod in (("torch", OPT), ("jax", JOPT)):
        def spy(opt, params, grads, *rest, _key=key, _real=mod.apply_updates):
            seen[_key] = grads
            return _real(opt, params, grads, *rest)
        monkeypatch.setattr(mod, "apply_updates", spy)
    _, tm = TS.make_train_step(tcfg, opt, microbatches=4, attn_impl="torch",
                               block=BLOCK)(tstate, _tbatch(tcfg, 32, 8))
    _, jm = JTS.make_train_step(jcfg, jopt, microbatches=4,
                                attn_impl="scan", block=BLOCK)(
        jstate, _jbatch(jcfg, 32, 8))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2e-2)
    _assert_grads_close(seen["torch"], seen["jax"], tstate.params,
                        "bfloat16", grad_dtype=torch.float32)
    for _, g in _leaves(seen["jax"]):
        assert g.dtype == jnp.float32


# ---------------------------------------------------------------------------
# Port only
# ---------------------------------------------------------------------------


def _tiny(seed=0):
    cfg = REG.smoke_config("yi-9b")
    opt = OPT.OptConfig(lr=1e-3, warmup_steps=1, total_steps=50)
    state = TS.init_state(cfg, opt, seed=seed, device="cpu")
    ds = DATA.SyntheticLM(cfg, ShapeConfig("t", 32, 4, "train"), seed=seed,
                          device="cpu")
    step = TS.make_train_step(cfg, opt, attn_impl="torch", block=BLOCK)
    return cfg, state, ds, step


def _assert_state_equal(a, b):
    assert a.step == b.step
    for (ka, x), (kb, y) in zip(_leaves({"p": a.params, "o": a.opt_state}),
                                _leaves({"p": b.params, "o": b.opt_state})):
        assert ka == kb and x.dtype == y.dtype
        assert torch.equal(x, y), ka


def test_loss_decreases_over_20_steps():
    cfg = REG.smoke_config("yi-9b")
    opt = OPT.OptConfig(lr=3e-3, warmup_steps=2, total_steps=20)
    state = TS.init_state(cfg, opt, device="cpu")
    ds = DATA.SyntheticLM(cfg, ShapeConfig("t", 64, 4, "train"),
                          device="cpu")
    step = TS.make_train_step(cfg, opt, attn_impl="torch", block=BLOCK)
    _, log = FT.run_training(state, step, ds.batch, 20)
    losses = [m["loss"] for m in log]
    assert losses[-1] < losses[0] - 0.5, losses


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_ignores_partial_tmp(tmp_path, dtype):
    cfg = dataclasses.replace(REG.smoke_config("yi-9b"), dtype=dtype)
    state = TS.init_state(cfg, OPT.OptConfig(), seed=2, device="cpu")
    state.step = 7
    CKPT.save(str(tmp_path), state, 7)
    os.makedirs(tmp_path / "step_00000009.tmp")  # a crash mid-save
    assert CKPT.latest_step(str(tmp_path)) == 7
    restored, manifest = CKPT.restore(str(tmp_path), state, device="cpu")
    assert manifest["step"] == 7
    _assert_state_equal(state, restored)
    mgr = CKPT.CheckpointManager(str(tmp_path), every=1, keep=2)
    for s in (8, 10, 11):
        mgr.save_sync(state, s)
    assert sorted(d for d in os.listdir(tmp_path)
                  if d.startswith("step_") and not d.endswith(".tmp")) == \
        ["step_00000010", "step_00000011"]


def test_crash_resume_is_bitwise(tmp_path):
    cfg, state0, ds, step = _tiny()
    mgr = CKPT.CheckpointManager(str(tmp_path), every=3, keep=5)
    ref_state, _ = FT.run_training(copy.deepcopy(state0), step, ds.batch, 6)
    with pytest.raises(FT.SimulatedFailure):
        FT.run_training(copy.deepcopy(state0), step, ds.batch, 6,
                        manager=mgr, fail_at=5)
    resumed, _ = CKPT.restore(str(tmp_path), state0, device="cpu")
    assert resumed.step == 3
    final, _ = FT.run_training(resumed, step, ds.batch, 6, manager=mgr)
    _assert_state_equal(ref_state, final)


def test_preemption_guard_saves_and_stops(tmp_path):
    cfg, state0, ds, step = _tiny()
    mgr = CKPT.CheckpointManager(str(tmp_path), every=100, keep=2)
    with FT.PreemptionGuard(signals=(signal.SIGUSR1,)) as guard:
        def step_fn(state, batch):
            new_state, m = step(state, batch)
            if new_state.step == 4:
                os.kill(os.getpid(), signal.SIGUSR1)
            return new_state, m

        final, log = FT.run_training(state0, step_fn, ds.batch, 20,
                                     manager=mgr, guard=guard)
    assert guard.preempted
    assert final.step == len(log) == 4
    assert CKPT.latest_step(str(tmp_path)) == 4


def test_launch_train_runs_on_cpu(tmp_path, capsys):
    state, log = LAUNCH.main(["--device", "cpu", "--steps", "4", "--batch",
                              "2", "--seq", "32", "--log-every", "2",
                              "--ckpt-dir", str(tmp_path)])
    assert state.step == 4 and len(log) == 4
    assert all(np.isfinite(m["loss"]) and m["loss"] > 0 for m in log)
    assert CKPT.latest_step(str(tmp_path)) == 4
    out = capsys.readouterr().out
    assert "attention=torch" in out and "done: 4 steps" in out


def test_entry_points_default_to_the_card():
    cfg = REG.smoke_config("yi-9b")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        TS.init_state(cfg, OPT.OptConfig())
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        LAUNCH.main(["--steps", "1"])
    state = TS.init_state(cfg, OPT.OptConfig(), device="cpu")
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        TS.make_train_step(cfg, OPT.OptConfig())(state,
                                                 _tbatch(cfg, 32, 2))
