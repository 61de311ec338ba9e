"""repro_torch model == the JAX reference at smoke_config("yi-9b").

Reference weights carry over with ``params_from_jax``; the packed prefill
forward (hidden + per-layer k/v states) and decode_step logits (lockstep
and packed) are compared at float32 and bfloat16 within the attention
tolerance of tests/oracles.py. The reference forward runs its scan impl
(its default serving path); GQA is exercised with n_kv_heads = 2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.configs import registry as JREG
from repro.kernels.tri_attn import ops as JOPS
from repro.models import model as JMD
from repro_torch.configs import registry as REG
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.models import model as MD
from repro_torch.serve import decode as D

torch.set_num_threads(2)


def _setup(dtype="float32", n_kv_heads=2, seed=0):
    jcfg = dataclasses.replace(JREG.smoke_config("yi-9b"), dtype=dtype,
                               n_kv_heads=n_kv_heads)
    tcfg = dataclasses.replace(REG.smoke_config("yi-9b"), dtype=dtype,
                               n_kv_heads=n_kv_heads)
    jparams = JMD.init_params(jax.random.key(seed), jcfg)
    tparams = MD.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    """Attention tolerance of tests/oracles.py. In bfloat16 the absolute
    part is taken relative to the output's largest magnitude: XLA fuses
    the reference's elementwise chains and may skip intermediate bf16
    roundings that eager PyTorch performs, so single elements of a
    multi-layer output drift by a few bf16 ulps of the output's scale
    (ROADMAP queue C)."""
    got, want = _np(got), _np(want)
    tol = O.tol("attn", jnp.dtype(dtype))
    if dtype == "bfloat16":
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol)


def test_config_fields_match_reference():
    assert dataclasses.asdict(REG.get_config("yi-9b")) == \
        dataclasses.asdict(JREG.get_config("yi-9b"))
    assert dataclasses.asdict(REG.smoke_config("yi-9b")) == \
        dataclasses.asdict(JREG.smoke_config("yi-9b"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips(dtype):
    jcfg, tcfg, jparams, tparams = _setup(dtype)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in jflat:
        node = tparams
        for k in path:
            node = node[k.key]
        assert str(node.dtype).endswith(str(leaf.dtype)), (path, node.dtype)
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(_np(node), _np(leaf))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_forward_states_match(dtype):
    jcfg, tcfg, jparams, tparams = _setup(dtype)
    blk = 8
    rng = np.random.default_rng(1)
    lens = [13, 4, 21]
    pads = [-(-s // blk) * blk for s in lens]
    tokens = np.zeros((1, sum(pads)), np.int32)
    positions = np.zeros((sum(pads),), np.int32)
    st = 0
    for s, p in zip(lens, pads):
        tokens[0, st:st + s] = rng.integers(1, jcfg.vocab_size, size=s)
        positions[st:st + p] = np.arange(p)
        st += p
    jh, _, jst = JMD.forward(
        jparams, jcfg, {"tokens": jnp.asarray(tokens)}, attn_impl="scan",
        remat=False, collect_state=True, positions=jnp.asarray(positions),
        packed=JOPS.make_packed_sched(pads, block=blk))
    th, _, tst = MD.forward(
        tparams, tcfg, {"tokens": torch.as_tensor(tokens)},
        attn_impl="torch", collect_state=True,
        positions=torch.as_tensor(positions),
        packed=OPS.make_packed_sched(pads, block=blk))
    _close(th, jh, dtype)
    for kv in ("k", "v"):
        assert tuple(tst["l0"][kv].shape) == jst["l0"][kv].shape
        _close(tst["l0"][kv], jst["l0"][kv], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_logits_match(dtype):
    """Lockstep and packed decode logits over a skewed batch whose cache
    was filled by earlier decode steps."""
    jcfg, tcfg, jparams, tparams = _setup(dtype)
    b, max_len, blk = 3, 32, 8
    rng = np.random.default_rng(2)
    jcache = JMD.init_cache(jcfg, b, max_len, jnp.float32)
    tcache = MD.init_cache(tcfg, b, max_len, torch.float32, device="cpu")
    fill = [9, 2, 17]  # tokens already in each slot's cache
    jdecode = jax.jit(lambda c, t, pos: JMD.decode_step(jparams, jcfg, c, t,
                                                        pos))
    for t in range(max(fill)):
        toks = rng.integers(1, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        pos = np.minimum(t, np.asarray(fill) - 1).astype(np.int32)
        _, jcache = jdecode(jcache, jnp.asarray(toks), jnp.asarray(pos))
        MD.decode_step(tparams, tcfg, tcache, torch.as_tensor(toks).long(),
                       torch.as_tensor(pos))
    toks = rng.integers(1, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
    pos = np.asarray(fill, np.int32)
    jl, _ = jdecode(jcache, jnp.asarray(toks), jnp.asarray(pos))
    tl, _ = MD.decode_step(tparams, tcfg, tcache,
                           torch.as_tensor(toks).long(),
                           torch.as_tensor(pos))
    _close(tl, jl, dtype)
    kv_lens = [int(p) + 1 for p in pos]
    tpl, _, info = D.decode_step_packed(
        tparams, tcfg, tcache, torch.as_tensor(toks).long(),
        torch.as_tensor(pos), kv_lens, list(range(b)), block=blk,
        impl="torch")
    _close(tpl, jl, dtype)
    assert info["tiles"] == sum(-(-k // blk) for k in kv_lens)
