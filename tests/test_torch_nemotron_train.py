"""nemotron-4-340b's training on the port's side of the D 192 backward,
against the reference, on the CPU.

- The plain versions of ``bwd`` and ``packed_bwd`` (what the wrappers run
  on a CPU tensor, and what the card's kernels are held to) against the
  reference's interpret-mode kernels at head dim 192 and nemotron's group
  (g 12), float32, at the attention-grad tolerance of tests/oracles.py;
  autograd through ``triangular_attention`` and
  ``packed_prefill_attention`` with impl "cuda" on CPU tensors against
  impl "ref".
- A narrow D 192 model (2 layers, 2 heads of 192 over 1 kv head, the
  rest nemotron's smoke config) carried across by ``state_from_jax`` with
  the reference's Adafactor state, trained 3 steps by the port
  (``make_train_step``, the plain attention at tile edge 16, which is
  what the card's kernels are held to) and by the
  reference's ``make_train_step`` (its scan impl), float32: losses, grad
  norms, params and the factored statistics at the tolerances of
  tests/test_torch_train.py's three-step test; a run resumed from a
  checkpoint bitwise equal to an unbroken one.

About 40 s on one worker.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.configs import registry as JREG
from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch.configs import registry as REG
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import fault_tolerance as FT
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS
from test_torch_train import _assert_params_close, _assert_state_equal, \
    _jbatch, _np, _tbatch

torch.set_num_threads(2)

D = 192
BLOCK = 16
NARROW = dict(n_layers=2, n_heads=2, n_kv_heads=1, head_dim=D)
KINDS = {"ltm": (None, 0), "band": (BLOCK + 5, 0), "prefix": (None, BLOCK + 3)}


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_d192_plain_backward_matches_reference(kind):
    """bwd's plain version (dq, dk, dv) against the reference's
    interpret-mode ``bwd`` at D 192, g 12."""
    g, hkv, n = 12, 1, 3
    h, s = g * hkv, n * BLOCK
    window, prefix = KINDS[kind]
    q, k, v, do = _inputs(((1, h, s, D), (1, hkv, s, D), (1, hkv, s, D),
                           (1, h, s, D)), 11)
    jsched = JOPS.make_sched(s, block_q=BLOCK, block_k=BLOCK, window=window,
                             prefix=prefix)
    sched = OPS.make_sched(s, block=BLOCK, window=window, prefix=prefix)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jout, jlse = JK.fwd(jq, jk, jv, jsched, interpret=True)
    want = JK.bwd(jq, jk, jv, jout, jlse, jdo, jsched, interpret=True)
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    out, lse = K.fwd(tq, tk, tv, sched)
    got = K.bwd(tq, tk, tv, out, lse, tdo, sched)
    for x, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert tuple(x.shape) == w.shape, name
        O.assert_close(_np(x), np.asarray(w), "attn_grad", jnp.float32, name)


def test_d192_plain_packed_backward_matches_reference():
    """packed_bwd's plain version against the reference's interpret-mode
    ``packed_bwd`` at D 192, g 12, on ltm, band and prefix members."""
    g, hkv = 12, 1
    kw = dict(block=BLOCK, window=[None, 3, None], prefix=[0, 0, BLOCK + 1])
    lens = [3 * BLOCK, BLOCK, 2 * BLOCK]
    jps = JOPS.make_packed_sched(lens, **kw)
    tps = OPS.make_packed_sched(lens, **kw)
    h, s = g * hkv, tps.s_total
    q, k, v, do = _inputs(((1, h, s, D), (1, hkv, s, D), (1, hkv, s, D),
                           (1, h, s, D)), 12)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    jout, jlse = JK.packed_fwd(jq, jk, jv, jps, interpret=True)
    want = JK.packed_bwd(jq, jk, jv, jout, jlse, jdo, jps, interpret=True)
    tq, tk, tv, tdo = (torch.as_tensor(x) for x in (q, k, v, do))
    out, lse = K.packed_fwd(tq, tk, tv, tps)
    got = K.packed_bwd(tq, tk, tv, out, lse, tdo, tps)
    for x, w, name in zip(got, want, ("dq", "dk", "dv")):
        O.assert_close(_np(x), np.asarray(w), "attn_grad", jnp.float32, name)


@pytest.mark.parametrize("op", ["triangular_attention",
                                "packed_prefill_attention"])
def test_d192_autograd_on_the_kernel_impl(op):
    """The autograd Functions differentiate a D 192 operand with impl
    "cuda" (on a CPU tensor the wrappers run the plain versions): their
    grads equal the op's through impl "ref" (the masked full-matrix
    oracle) at the attention-grad tolerance."""
    q, k, v, do = (torch.as_tensor(x) for x in _inputs(
        ((1, 12, 64, D), (1, 1, 64, D), (1, 1, 64, D), (1, 12, 64, D)), 13))
    sched = OPS.make_sched(64, block=BLOCK)
    psched = OPS.make_packed_sched([32, 16, 16], block=BLOCK)
    fn, sc = (OPS._TriAttention, sched) if op == "triangular_attention" \
        else (OPS._PackedTriAttention, psched)
    grads = {}
    for impl in ("cuda", "ref"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        if impl == "ref":
            out = getattr(OPS, op)(*leaves, *((psched,) if fn is
                                              OPS._PackedTriAttention
                                              else ()), impl="ref",
                                   **({"block": BLOCK} if fn is
                                      OPS._TriAttention else {}))
        else:
            out = fn.apply(*leaves, sc, D ** -0.5, impl)
        out.backward(do)
        grads[impl] = [x.grad for x in leaves]
    for got, want, name in zip(grads["cuda"], grads["ref"], "qkv"):
        O.assert_close(got.numpy(), want.numpy(), "attn_grad", jnp.float32,
                       f"d{name}")


def _narrow():
    jcfg = dataclasses.replace(JREG.smoke_config("nemotron-4-340b"),
                               **NARROW)
    tcfg = dataclasses.replace(REG.smoke_config("nemotron-4-340b"),
                               **NARROW)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _adafactor():
    return OPT.OptConfig(kind="adafactor", lr=1e-3, warmup_steps=2,
                         total_steps=10)


def test_narrow_d192_adafactor_steps_match_reference():
    jcfg, tcfg = _narrow()
    opt = _adafactor()
    jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
    jstate = JTS.init_state(jax.random.key(0), jcfg, jopt)
    assert set(jstate.opt_state) == {"vr", "vc"}
    tstate = TS.state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                               device="cpu")
    assert set(tstate.opt_state) == {"vr", "vc"}
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
    assert tstate.step == int(jstate.step) == 3
    _assert_params_close(tstate.params, jstate.params, atol=2e-5, rtol=2e-4)
    _assert_params_close(tstate.opt_state, jstate.opt_state, atol=1e-6,
                         rtol=2e-3)


def test_narrow_d192_adafactor_resume_is_bitwise(tmp_path):
    """6 steps straight against 3, a checkpoint, a restore and 3 more:
    the same params and Adafactor statistics, bit for bit."""
    _, cfg = _narrow()
    opt = _adafactor()
    step = TS.make_train_step(cfg, opt, attn_impl="torch", block=BLOCK)
    batch = lambda i: _tbatch(cfg, 32, 2, i)
    base = TS.init_state(cfg, opt, seed=1, device="cpu")
    assert set(base.opt_state) == {"vr", "vc"}
    straight, log = FT.run_training(copy.deepcopy(base), step, batch, 6)
    assert all(np.isfinite(m["loss"]) for m in log)
    half, _ = FT.run_training(copy.deepcopy(base), step, batch, 3)
    CKPT.save(str(tmp_path), half, 3)
    restored, _ = CKPT.restore(str(tmp_path), base, device="cpu")
    resumed, _ = FT.run_training(restored, step, batch, 6)
    _assert_state_equal(straight, resumed)
