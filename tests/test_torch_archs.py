"""The registry's other seven architectures (configs/, models/layers.py's
gelu and relu2 MLPs, models/model.py's stub frontends, train/data.py's
audio and VLM batches) held to the JAX reference at smoke_config size,
float32, on the same numpy weights (params_from_jax).

Per arch, against ONE module-scoped JAX forward at S 32 (B 2): the
forward's hidden states, logits and loss (ce + 0.01 aux, the mask of a
vision prefix included), the prefill cache seeded from an "embeds" batch
against the forward's collected k/v, and one decode step from a random
cache at per-slot positions (past the cache's rows for mixtral's rolling
window) with its cache. Besides: the config fields, ``param_counts`` of
all ten archs, the shape cells and their support matrix, the audio and
VLM batches bit for bit, and the gelu (tanh form, rounded per op) and
relu2 MLPs in bfloat16. Engine, training and CLI checks are in
tests/test_torch_archs_serve.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JBASE
from repro.configs import registry as JREG
from repro.models import layers as JL
from repro.models import model as JMD
from repro.train import data as JDATA
from repro_torch.configs import base as BASE
from repro_torch.configs import registry as REG
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.train import data as DATA

torch.set_num_threads(2)

NEW_ARCHS = ("granite-moe-3b-a800m", "mixtral-8x7b", "granite-34b",
             "llama3-405b", "musicgen-large", "internvl2-1b",
             "nemotron-4-340b")
TOL = dict(atol=2e-5, rtol=2e-5)  # tests/oracles.py's f32 policy
B, S, MAX_LEN = 2, 32, 32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


_CTX = {}


def _ctx(arch):
    """The arch's smoke configs, weights in both packages, a batch of
    each, and the reference's forward (states collected), once."""
    if arch in _CTX:
        return _CTX[arch]
    jcfg, tcfg = JREG.smoke_config(arch), REG.smoke_config(arch)
    np_params = jax.tree.map(np.asarray,
                             JMD.init_params(jax.random.key(0), jcfg))
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = MD.params_from_jax(np_params, tcfg, device="cpu")
    shape = BASE.ShapeConfig("smoke", S, B, "train")
    jbatch = JDATA.SyntheticLM(jcfg, JBASE.ShapeConfig("smoke", S, B,
                                                       "train"),
                               act_dtype=jnp.float32).batch(0)
    tbatch = DATA.SyntheticLM(tcfg, shape, device="cpu",
                              act_dtype=torch.float32).batch(0)
    hidden, aux, states = JMD.forward(jparams, jcfg, jbatch,
                                      attn_impl="scan", block=16,
                                      collect_state=True)
    _CTX[arch] = dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                      tparams=tparams, jbatch=jbatch, tbatch=tbatch,
                      hidden=hidden, aux=aux, states=states)
    return _CTX[arch]


# ---------------------------------------------------------------------------
# configs and the registry
# ---------------------------------------------------------------------------


def test_registry_lists_the_reference_archs():
    assert REG.ARCH_IDS == JREG.ARCH_IDS
    assert list(REG.all_configs()) == list(JREG.all_configs())
    for arch in NEW_ARCHS:
        assert dataclasses.asdict(REG.get_config(arch)) == \
            dataclasses.asdict(JREG.get_config(arch)), arch
        assert dataclasses.asdict(REG.smoke_config(arch)) == \
            dataclasses.asdict(JREG.smoke_config(arch)), arch
    with pytest.raises(KeyError, match="unknown arch"):
        REG.get_config("xlstm-7b")


def test_param_counts_equal_the_reference_for_all_ten():
    for arch in REG.ARCH_IDS:
        t, j = REG.get_config(arch), JREG.get_config(arch)
        assert t.param_counts() == j.param_counts(), arch
        assert t.is_pure_full_attention() == j.is_pure_full_attention()
        s = REG.smoke_config(arch)
        assert s.param_counts() == JREG.smoke_config(arch).param_counts()


def test_shapes_and_runnable_cells():
    """40 cells; long_500k runs only for the sub-quadratic archs."""
    assert list(BASE.SHAPES) == list(JBASE.SHAPES)
    for name, shape in BASE.SHAPES.items():
        ref = JBASE.SHAPES[name]
        assert dataclasses.asdict(shape) == dataclasses.asdict(ref)
        assert REG.get_shape(name) == shape
        assert (shape.is_decode, shape.tokens_per_step) == \
            (ref.is_decode, ref.tokens_per_step)
    cells = REG.runnable_cells()
    assert len(cells) == 40
    assert [c[:3] for c in cells] == [c[:3] for c in JREG.runnable_cells()]
    assert all(s == "long_500k" for _, s, ok, _ in cells if not ok)
    assert {a for a, s, ok, _ in cells if s == "long_500k" and ok} == \
        {"rwkv6-1.6b", "jamba-1.5-large-398b", "mixtral-8x7b"}


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-1b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_frontend_batches_are_the_references_bitwise(arch, dtype):
    """The audio and VLM batches of SyntheticLM: the same Philox stream,
    the embeds rounded to the activation dtype alike."""
    jcfg, tcfg = JREG.smoke_config(arch), REG.smoke_config(arch)
    for step in (0, 3):
        want = JDATA.SyntheticLM(jcfg, JBASE.ShapeConfig("x", 48, 3,
                                                         "train"),
                                 seed=5, act_dtype=jnp.dtype(dtype)
                                 ).batch(step)
        got = DATA.SyntheticLM(tcfg, BASE.ShapeConfig("x", 48, 3, "train"),
                               seed=5, device="cpu",
                               act_dtype=getattr(torch, dtype)).batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            w = np.asarray(want[k])
            assert str(got[k].dtype).endswith(str(w.dtype)), k
            np.testing.assert_array_equal(_np(got[k]), _np(want[k]), k)


# ---------------------------------------------------------------------------
# the two-matrix MLPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ["gelu", "relu2"])
def test_two_matrix_mlps_in_bf16(act):
    """The activation bit for bit on the same bf16 pre-activations (gelu:
    jax.nn.gelu's tanh form, each op rounded to bf16 as XLA lowers it;
    in float32 within the f32 policy);
    the whole MLP within the bf16 policy (the matmuls accumulate in
    another order)."""
    cfg = dataclasses.replace(REG.smoke_config("granite-34b"),
                              mlp_activation=act, dtype="bfloat16")
    jcfg = dataclasses.replace(JREG.smoke_config("granite-34b"),
                               mlp_activation=act, dtype="bfloat16")
    jp = JL.init_mlp(jax.random.key(3), jcfg, jnp.bfloat16)
    assert sorted(jp) == ["wi", "wo"]
    tp = {k: torch.as_tensor(np.asarray(v, np.float32)).to(torch.bfloat16)
          for k, v in jp.items()}
    x = np.random.default_rng(0).standard_normal((2, 16, cfg.d_model))
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16)
    h = np.random.default_rng(1).standard_normal(4096).astype(np.float32) * 4
    jh, th = jnp.asarray(h, jnp.bfloat16), torch.as_tensor(h).bfloat16()
    if act == "gelu":
        np.testing.assert_array_equal(_np(L._gelu(th)), _np(jax.nn.gelu(jh)))
        # float32: XLA's tanh is its own approximation, not bitwise
        _close(L._gelu(th.float()), jax.nn.gelu(jh.astype(jnp.float32)))
    got, want = L.mlp(tp, tx, cfg), JL.mlp(jp, jx, jcfg)
    assert got.dtype == torch.bfloat16
    tol = dict(atol=2e-2 * max(1.0, float(np.abs(_np(want)).max())),
               rtol=2e-2)
    _close(got, want, **tol)
    own = MD.init_params(cfg, seed=0, device="cpu")["layers"]["l0"]["ffn"]
    assert sorted(own) == ["wi", "wo"]


# ---------------------------------------------------------------------------
# each new arch against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_logits_and_loss_match_reference(arch):
    """Hidden states, logits and loss (the loss_fn's ce + aux_weight x aux,
    a vision prefix's mask included) of the port's forward on the
    reference's weights and batch."""
    c = _ctx(arch)
    hidden, aux, _ = MD.forward(c["tparams"], c["tcfg"], c["tbatch"],
                                attn_impl="torch", block=16)
    _close(hidden, c["hidden"])
    logits = MD.logits_from_hidden(c["tparams"], c["tcfg"], hidden)
    jlogits = JMD.logits_from_hidden(c["jparams"], c["jcfg"], c["hidden"])
    _close(logits, jlogits)
    mask = c["jbatch"].get("mask", jnp.ones(c["jbatch"]["labels"].shape,
                                            jnp.float32))
    ce = JMD.cross_entropy(jlogits, c["jbatch"]["labels"], mask,
                           c["jcfg"].vocab_size)
    loss, met = MD.loss_fn(c["tparams"], c["tcfg"], c["tbatch"],
                           attn_impl="torch", block=16, remat=False)
    _close(met["ce"], ce)
    _close(met["aux"], c["aux"])
    _close(loss, ce + 0.01 * c["aux"])
    if c["tcfg"].frontend == "vision_patches":  # the prefix weighs nothing
        assert float(c["tbatch"]["mask"][:, :c["tcfg"].n_patches].sum()) \
            == 0.0


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_cache_holds_the_forward_states(arch):
    """prefill_cache over the arch's batch ("embeds" included) fills each
    attention layer's k/v with the reference forward's rotated k/v."""
    c = _ctx(arch)
    hidden, cache = MD.prefill_cache(c["tparams"], c["tcfg"], c["tbatch"],
                                     S, attn_impl="torch", block=16,
                                     cache_dtype=torch.float32)
    _close(hidden, c["hidden"])
    for slot, leaves in cache.items():
        for name in ("k", "v"):
            _close(leaves[name], c["states"][slot][name])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_decode_step_and_cache_match_reference(arch):
    """One decode step from a random cache at per-slot positions: for
    mixtral's rolling window (S_cache = min(64, 32)) one slot past the
    cache's rows, so its write wraps."""
    c = _ctx(arch)
    jcfg, tcfg = c["jcfg"], c["tcfg"]
    jcache = JMD.init_cache(jcfg, B, MAX_LEN, jnp.float32)
    rng = np.random.default_rng(11)
    np_cache = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), jcache)
    pos = np.array([5, 40 if tcfg.sliding_window else 29], np.int32)
    toks = np.array([[7], [300]], np.int32)
    jlogits, jnew = JMD.decode_step(c["jparams"], jcfg,
                                    jax.tree.map(jnp.asarray, np_cache),
                                    jnp.asarray(toks), jnp.asarray(pos))
    tcache = MD.init_cache(tcfg, B, MAX_LEN, torch.float32, "cpu")
    for slot, leaves in tcache.items():
        for name, t in leaves.items():
            t.copy_(torch.as_tensor(np_cache[slot][name]))
    logits, tcache = MD.decode_step(c["tparams"], tcfg, tcache,
                                    torch.as_tensor(toks, dtype=torch.int64),
                                    torch.as_tensor(pos), attn_impl="torch")
    _close(logits, jlogits)
    for slot, leaves in tcache.items():
        for name, t in leaves.items():
            _close(t, jnew[slot][name])
