"""repro_torch.parallel.compression == the JAX package's int8 error-feedback
compression, and the compressed train step against the reference's.

The codec on seeded float32 inputs: q and scale bitwise equal to the
reference's (division by the scale, round half to even, the 1e-30 floor),
the new error too; the bounds property under ``@given`` (no fixture);
error-feedback telescoping and EF-SGD convergence as the reference's own
tests hold them; a stacked leaf given as per-layer parts coded with one
scale, the reference's over the stacked leaf; the chunked two-pass code
bitwise equal to the one-shot one (``optimizer.CHUNK`` patched small);
three compressed train steps of the smoke yi-9b in float32 against the
reference's ``make_train_step(compressed_allreduce=...)`` from the same
carried-across state (losses, params and err_state); a one-rank gloo
group bitwise equal to no group; the dry-run's count of err_state; the
trainer CLI with ``--compress-grads``.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import oracles as O
import torch_dp_worker as W

from repro.configs import registry as JREG
from repro.configs.base import ShapeConfig as JShape
from repro.launch.compat import make_mesh
from repro.parallel import compression as JC
from repro.train import data as JDATA
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch.configs import registry as REG
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as DRY
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train as LAUNCH
from repro_torch.parallel import compression as C
from repro_torch.train import data as DATA
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

torch.set_num_threads(2)

BLOCK = 16


def _inputs(kind: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal((37, 19)).astype(np.float32)
    if kind == "wide":  # magnitudes over 12 decades
        x = rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)
        return x.astype(np.float32)
    if kind == "halves":  # scale 1: x / scale lands on .5 (half to even)
        return np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, -126.5],
                        np.float32)
    if kind == "zeros":  # the 1e-30 floor
        return np.zeros((5, 3), np.float32)
    if kind == "tiny":
        return (rng.standard_normal(64) * 1e-35).astype(np.float32)
    raise ValueError(kind)


KINDS = ["normal", "wide", "halves", "zeros", "tiny"]


@pytest.mark.parametrize("kind", KINDS)
def test_quantize_matches_reference_bitwise(kind):
    x = _inputs(kind)
    jq, js = JC.quantize_int8(jnp.asarray(x))
    q, s = C.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(
        C.dequantize_int8(q, s).numpy(),
        np.asarray(JC.dequantize_int8(jq, js)))


@pytest.mark.parametrize("kind", KINDS)
def test_ef_compress_matches_reference_bitwise(kind):
    g = _inputs(kind, seed=1)
    e = (np.random.default_rng(2).standard_normal(g.shape)
         * 0.01 * max(1.0, float(np.abs(g).max()))).astype(np.float32)
    jq, js, je = JC.ef_compress(jnp.asarray(g), jnp.asarray(e))
    q, s, ne = C.ef_compress(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js, np.float32).tobytes()
    assert ne.numpy().tobytes() == np.asarray(je, np.float32).tobytes()


@settings(max_examples=60, deadline=None)
@given(st.lists(st.floats(-1e4, 1e4, allow_nan=False, width=32),
                min_size=1, max_size=64))
def test_quantize_bounds(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    q, scale = C.quantize_int8(x)
    err = torch.abs(C.dequantize_int8(q, scale) - x)
    # symmetric per-tensor int8: |err| <= scale / 2 = max|x| / 254
    assert float(err.max()) <= float(scale) / 2 + 1e-6
    assert int(q.abs().max()) <= 127


def test_error_feedback_telescopes():
    """Over T steps, sum(dequantized) + final err == sum(grads) (the EF
    invariant that makes the scheme unbiased over time)."""
    gen = torch.Generator().manual_seed(0)
    g_sum, q_sum, err = (torch.zeros(32) for _ in range(3))
    for t in range(20):
        g = torch.randn(32, generator=gen) * (10.0 ** (t % 3))
        q, scale, err = C.ef_compress(g, err)
        g_sum += g
        q_sum += C.dequantize_int8(q, scale)
    np.testing.assert_allclose((q_sum + err).numpy(), g_sum.numpy(),
                               rtol=1e-4, atol=1e-3)


def test_ef_sgd_converges_like_fp32():
    w_fp = torch.tensor([5.0, -3.0, 2.0, -7.0])
    w_q = w_fp.clone()
    err = torch.zeros_like(w_fp)
    lr = 0.05
    for _ in range(300):
        w_fp = w_fp - lr * 2 * w_fp
        q, scale, err = C.ef_compress(2 * w_q, err)
        w_q = w_q - lr * C.dequantize_int8(q, scale)
    assert float(w_q.abs().max()) < 0.05
    assert float(w_fp.abs().max()) < 1e-3


def _tree(seed: int):
    """A grads tree in the reference's layout (a stacked (3, 6, 5) leaf
    whose layers' magnitudes differ by 10x, so per-layer scales would
    differ) and a nonzero error state."""
    rng = np.random.default_rng(seed)
    g = {"embed": rng.standard_normal((8, 4)),
         "layers": {"w": rng.standard_normal((3, 6, 5))
                    * np.array([1.0, 10.0, 0.1])[:, None, None],
                    "norm1": rng.standard_normal((3, 6))},
         "final_norm": rng.standard_normal((4,))}
    g = jax.tree.map(lambda x: x.astype(np.float32), g)
    e = jax.tree.map(lambda x: (rng.standard_normal(x.shape) * 1e-3)
                     .astype(np.float32), g)
    return g, e


def _port_tree(tree, per_layer: bool):
    """numpy tree -> torch, the layers' leaves as per-layer parts."""
    def conv(x, stacked):
        if isinstance(x, dict):
            return {k: conv(v, stacked) for k, v in x.items()}
        t = torch.from_numpy(np.array(x))
        return [t[l].clone() for l in range(len(t))] if stacked else t
    return {k: conv(v, per_layer and k == "layers") for k, v in tree.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        yield prefix, torch.stack(tree).numpy()
    else:
        yield prefix, np.asarray(tree)


def _reference_psum(g, e):
    ar = JC.make_compressed_allreduce(make_mesh((1,), ("data",)), "data")
    return ar(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e))


def test_compressed_psum_single_rank_identity():
    """On one rank the mean is the dequantized grads: out + err == g."""
    grads = {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor([0.5])}
    want = copy.deepcopy(grads)
    err = C.init_error_state(grads)
    out, err2 = C.make_compressed_allreduce()(grads, err)
    assert err2 is err
    for k in grads:
        np.testing.assert_allclose((out[k] + err2[k]).numpy(),
                                   want[k].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_stacked_leaf_as_layer_parts_has_the_reference_scale(seed):
    """A stacked leaf handed as per-layer parts is coded with ONE scale,
    max|g + err| over the whole stack: the means and the new error equal
    the reference's on the stacked leaf bit for bit, and the error state
    stays stacked, updated through its layers' views."""
    g, e = _tree(seed)
    jmean, jerr = _reference_psum(g, e)
    grads, err = _port_tree(g, True), _port_tree(e, False)
    err_w = err["layers"]["w"]
    mean, err2 = C.compressed_psum(grads, err)
    assert err2["layers"]["w"] is err_w
    assert isinstance(mean["layers"]["w"], list)
    for (k, got), (_, want) in zip(_flat(mean), _flat(jmean)):
        assert got.tobytes() == np.asarray(want).tobytes(), k
    for (k, got), (_, want) in zip(_flat(err2), _flat(jerr)):
        assert got.tobytes() == np.asarray(want).tobytes(), k
    target = g["layers"]["w"] + e["layers"]["w"]
    want_scale = np.float32(np.abs(target).max()) / np.float32(127.0)
    # the largest code is 127 x the stack's scale
    got_w = torch.stack(mean["layers"]["w"]).numpy()
    assert np.abs(got_w).max().tobytes() == \
        (np.float32(127.0) * want_scale).tobytes()
    # a per-layer scale would give other codes for the small layer
    q, layer_scale = C.quantize_int8(torch.from_numpy(target[2]))
    assert not torch.equal(C.dequantize_int8(q, layer_scale),
                           torch.from_numpy(np.asarray(jmean["layers"]["w"][2])))


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_chunked_code_equals_the_one_shot_code(monkeypatch, chunk):
    g, e = _tree(3)
    whole_mean, whole_err = C.compressed_psum(_port_tree(g, True),
                                              _port_tree(e, False))
    monkeypatch.setattr(OPT, "CHUNK", chunk)
    mean, err = C.compressed_psum(_port_tree(g, True), _port_tree(e, False))
    for (k, a), (_, b) in zip(_flat(mean), _flat(whole_mean)):
        assert a.tobytes() == b.tobytes(), k
    for (k, a), (_, b) in zip(_flat(err), _flat(whole_err)):
        assert a.tobytes() == b.tobytes(), k


def _cfgs():
    return (dataclasses.replace(JREG.smoke_config("yi-9b"), dtype="float32"),
            dataclasses.replace(REG.smoke_config("yi-9b"), dtype="float32"))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# the f32 grad policy's absolute part (tests/oracles.py "attn_grad"), taken
# relative to a leaf's largest code target max|g + err| = 127 x its scale
ERR_ATOL = O.tol("attn_grad")["atol"] * 127.0
# a code that rounds the other way in the two runs (a target within f32
# noise of a half step) is one quantization step apart; at most this share
# of a leaf's elements may sit at such flips
FLIP_SHARE = 1e-2


def test_three_compressed_train_steps_match_reference():
    """The reference's step with its compressed all-reduce over a (1,)
    data mesh, and the port's with its hook over one rank, from the same
    carried-across state (err_state included), three steps: losses and
    grad norms at the f32 policy of the uncompressed steps
    (tests/test_torch_train.py). The code is a rounding, so a target
    within f32 noise of a half step rounds either way: such a flip moves
    that element's dequantized grad and error by one step, and the
    optimizer's update of it. So, per leaf: on the first step (same state
    on both sides) every element's new error is within ERR_ATOL of the
    reference's or exactly one step off; over the three steps the
    elements ever off by more than ERR_ATOL are at most FLIP_SHARE of the
    leaf; every other element's error and param is held at the f32
    policy."""
    jcfg, tcfg = _cfgs()
    opt = OPT.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
    jstate = JTS.init_state(jax.random.key(0), jcfg, jopt, compression=True)
    tstate = TS.state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                               device="cpu")
    assert tstate.err_state is not None
    jstep = jax.jit(JTS.make_train_step(
        jcfg, jopt, attn_impl="scan", block=BLOCK,
        compressed_allreduce=JC.make_compressed_allreduce(
            make_mesh((1,), ("data",)), "data")))
    scales = {}
    tstep = TS.make_train_step(
        tcfg, opt, attn_impl="torch", block=BLOCK,
        compressed_allreduce=W.noting_scales(C.make_compressed_allreduce(),
                                             scales))
    shape = ("t", 64, 2, "train")
    flips = {}
    for i in range(3):
        jstate, jm = jstep(jstate, JDATA.SyntheticLM(
            jcfg, JShape(*shape), act_dtype=jnp.float32).batch(i))
        tstate, tm = tstep(tstate, DATA.SyntheticLM(
            tcfg, ShapeConfig(*shape), device="cpu").batch(i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        for (k, got), (_, want) in zip(_flat(tstate.err_state),
                                       _flat(jstate.err_state)):
            steps = np.abs(got - _np(want)) / float(scales[k])
            off = steps > ERR_ATOL
            if i == 0:
                assert np.all(np.abs(steps[off] - 1.0) <= ERR_ATOL), k
            flips[k] = flips.get(k, False) | off
    assert tstate.step == int(jstate.step) == 3
    assert len(flips) == len(list(_flat(tstate.params)))
    for (k, got), (_, want) in zip(_flat(tstate.params),
                                   _flat(jstate.params)):
        held = ~flips[k]
        assert held.mean() >= 1 - FLIP_SHARE, (k, int((~held).sum()))
        np.testing.assert_allclose(got[held], _np(want)[held], atol=2e-5,
                                   rtol=2e-4, err_msg=k)
    assert any(float(np.abs(got).max()) > 0
               for _, got in _flat(tstate.err_state))


def test_one_rank_gloo_group_equals_no_group():
    """Three compressed steps over a one-rank gloo group end bitwise equal
    to three over no group; the group's mesh reports one rank."""
    import torch.distributed as dist

    cfg = REG.smoke_config("yi-9b")
    opt = OPT.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    base = TS.init_state(cfg, opt, seed=1, device="cpu", compression=True)
    ds = DATA.SyntheticLM(cfg, ShapeConfig("t", 32, 2, "train"),
                          device="cpu")
    runs = {}
    for name in ("none", "gloo"):
        group = MESH.init_data_group("cpu") if name == "gloo" else None
        try:
            if group is not None:
                assert MESH.make_local_mesh().shape == {"data": 1}
            step = TS.make_train_step(
                cfg, opt, attn_impl="torch", block=BLOCK,
                compressed_allreduce=C.make_compressed_allreduce(group))
            runs[name], _ = FT.run_training(copy.deepcopy(base), step,
                                            ds.batch, 3)
        finally:
            if group is not None:
                dist.destroy_process_group()
    a, b = runs["none"], runs["gloo"]
    for tree in ("params", "opt_state", "err_state"):
        for (k, x), (_, y) in zip(_flat(getattr(a, tree)),
                                  _flat(getattr(b, tree))):
            assert x.tobytes() == y.tobytes(), (tree, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dryrun_counts_the_error_state(dtype):
    """A compressed train cell counts err_state: float32, one element a
    parameter, and the float32 grads the hook takes (a bf16 model's grads
    leave autograd as float32 copies)."""
    cfg = dataclasses.replace(REG.smoke_config("yi-9b"), dtype=dtype)
    shape = ShapeConfig("t", 64, 1, "train")
    n = sum(t.numel() for _, t in _flat_t(REG.params_specs(cfg)))
    plain = DRY.count_cell(cfg, shape)["analysis"]["memory"]
    comp = DRY.count_cell(cfg, shape, compression=True)["analysis"]["memory"]
    assert plain["peak_split"]["err_state"] == 0
    assert comp["peak_split"]["err_state"] == 4 * n
    assert comp["peak_split"]["grads"] == 4 * n
    assert sum(comp["peak_split"].values()) == comp["peak_bytes_per_device"]
    assert comp["peak_bytes_per_device"] == plain["peak_bytes_per_device"] \
        + 4 * n + (4 * n - plain["peak_split"]["grads"])


def _flat_t(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat_t(tree[k], f"{prefix}.{k}")
    else:
        yield prefix, tree


def test_cli_trains_with_compressed_grads(capsys):
    import torch.distributed as dist

    state, log = LAUNCH.main(["--device", "cpu", "--steps", "4", "--batch",
                              "2", "--seq", "32", "--compress-grads"])
    out = capsys.readouterr().out
    assert "[int8-EF grad AR]" in out and "done: 4 steps" in out
    assert state.step == 4 and len(log) == 4
    assert all(np.isfinite(m["loss"]) for m in log)
    assert state.err_state is not None and any(
        float(t.abs().max()) > 0 for _, t in _flat_t(state.err_state))
    assert not dist.is_initialized()
