"""The port's optimizers against the reference's (repro/train/optimizer.py)
on the CPU, with the update's float32 temporaries bounded to a chunk.

Adafactor: the state's layout (``init_opt_state``), and three steps of
``apply_updates`` on a tree that holds a factored 2-D leaf, a 1-D leaf,
stacked (L, d) norms at L 3 (factored across the layers) and L 1 (not
factored), stacked 3-D matrices, a stacked 4-D expert leaf and a stacked
leaf whose next-to-last dim is 1 (not factored), with the grads stacked
or per layer (as ``train_step.trainable`` hands them), at the whole-leaf
chunk and at chunks that split leaves into several row blocks; bf16
params; two runs bitwise equal. AdamW: its chunked update gives the same
bits at any chunk where the clip does not bind. The chunked sums (column means, the RMS clip, the
global norm) reassociate the reference's one-shot sums, so they are held
at the float32 tolerance below, not bitwise.
"""

import dataclasses
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as JOPT
from repro_torch.train import optimizer as OPT

torch.set_num_threads(2)

# float32 reassociation of sums over at most a few hundred terms
F32 = dict(rtol=1e-5, atol=1e-6)
SHAPES = {"embed": (40, 6), "final_norm": (6,),
          "layers": {"norm1": (3, 6), "wq": (3, 6, 5), "wi": (3, 2, 7, 4),
                     "u": (3, 1, 5)},
          "one": {"norm2": (1, 6)}}


def _map(f, t):
    return {k: _map(f, v) for k, v in t.items()} if isinstance(t, dict) \
        else f(t)


def _leaves(t, prefix=""):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k], f"{prefix}.{k}")
    else:
        yield prefix, t


def _draw(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return _map(lambda s: rng.standard_normal(s).astype(dtype), SHAPES)


def _torch(tree, dtype=torch.float32):
    return _map(lambda x: torch.tensor(np.array(x)).to(dtype), tree)


def _per_layer(grads):
    """Stacked leaves under "layers" and "one" as lists of layer slices."""
    return {k: ({kk: [x[l] for l in range(x.shape[0])]
                 for kk, x in v.items()} if k in ("layers", "one") else v)
            for k, v in grads.items()}


def _opt(**kw):
    return OPT.OptConfig(**dict(dict(kind="adafactor", lr=1e-2,
                                     warmup_steps=1, total_steps=10), **kw))


def _run_reference(opt, steps, dtype=jnp.float32):
    jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
    params = _map(lambda x: jnp.asarray(x, dtype), _draw(0))
    state = JOPT.init_opt_state(jopt, params)
    norms = []
    for i in range(steps):
        grads = _map(jnp.asarray, _draw(10 + i))
        params, state, m = JOPT.apply_updates(jopt, params, grads, state,
                                              jnp.int32(i))
        norms.append(float(m["grad_norm"]))
    return params, state, norms


def _run_port(opt, steps, *, per_layer, chunk, dtype=torch.float32):
    """``steps`` updates with the optimizer's CHUNK set to ``chunk`` (None:
    the module's own, which holds every leaf here whole)."""
    params = _torch(_draw(0), dtype)
    state = OPT.init_opt_state(params, opt)
    norms = []
    with mock.patch.object(OPT, "CHUNK", chunk or OPT.CHUNK):
        for i in range(steps):
            grads = _torch(_draw(10 + i))
            if per_layer:
                grads = _per_layer(grads)
            m = OPT.apply_updates(opt, params, grads, state, i)
            norms.append(float(m["grad_norm"]))
    return params, state, norms


def _assert_close(got, want, **tol):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for key in w:
        np.testing.assert_allclose(g[key].float().numpy(),
                                   np.asarray(w[key], np.float32),
                                   err_msg=key, **tol)


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_init_opt_state_matches_reference_layout(kind):
    """The state's keys and every leaf's shape are the reference's: a
    stacked (L, d) norm is factored at L 3 (vr (L,), vc (d,)) and not at
    L 1 (vr (1, d), vc (1,)); nothing is factored across a dim of 1."""
    opt = OPT.OptConfig(kind=kind)
    want = JOPT.init_opt_state(JOPT.OptConfig(kind=kind),
                               _map(jnp.asarray, _draw(0)))
    got = OPT.init_opt_state(_torch(_draw(0)), opt)
    assert got.keys() == want.keys()
    for key in want:
        g, w = dict(_leaves(got[key])), dict(_leaves(want[key]))
        assert g.keys() == w.keys()
        for leaf in w:
            assert tuple(g[leaf].shape) == w[leaf].shape, (key, leaf)
            assert g[leaf].dtype == torch.float32 and not g[leaf].any()
    if kind == "adafactor":
        assert got["vr"]["layers"]["norm1"].shape == (3,)
        assert got["vc"]["layers"]["norm1"].shape == (6,)
        assert got["vr"]["one"]["norm2"].shape == (1, 6)
        assert got["vc"]["one"]["norm2"].shape == (1,)
    else:  # today's call form stays AdamW
        plain = OPT.init_opt_state(_torch(_draw(0)))
        assert plain.keys() == {"m", "v"}


def test_optconfig_carries_every_field_to_the_reference():
    opt = _opt(decay_exp=0.7, clip_threshold=0.5)
    jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
    assert dataclasses.asdict(jopt) == dataclasses.asdict(opt)
    assert OPT.OptConfig().kind == "adamw"


# chunk None: every leaf whole; 7 and 13 split embed, wq and wi into row
# blocks (single rows where a row is longer than the chunk); 64 takes
# whole matrices of wq and wi a block, several at a time
@pytest.mark.parametrize("chunk", [None, 7, 13, 64])
@pytest.mark.parametrize("per_layer", [False, True])
def test_adafactor_matches_reference(per_layer, chunk):
    opt = _opt()
    params, state, norms = _run_port(opt, 3, per_layer=per_layer,
                                     chunk=chunk)
    jparams, jstate, jnorms = _run_reference(opt, 3)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-6)
    _assert_close(params, jparams, **F32)
    _assert_close(state["vr"], jstate["vr"], **F32)
    _assert_close(state["vc"], jstate["vc"], **F32)


def test_adafactor_clips_the_rms_over_the_whole_stacked_leaf():
    """A clip threshold every leaf's update RMS passes: the port divides
    each stacked leaf's u by the RMS of the whole leaf, as the reference
    does, whether its grads come stacked or per layer, whole or chunked."""
    opt = _opt(clip_threshold=0.05)
    jparams, _, _ = _run_reference(opt, 2)
    for per_layer, chunk in ((False, None), (True, 5)):
        params, _, _ = _run_port(opt, 2, per_layer=per_layer, chunk=chunk)
        _assert_close(params, jparams, **F32)


def test_adafactor_bf16_params_match_reference():
    """bf16 params (the card's training): each update in float32, rounded
    to bf16 as the reference rounds it; a chunked sum may move a value
    across a rounding edge, so one bf16 step apart at most."""
    opt = _opt()
    params, _, _ = _run_port(opt, 2, per_layer=True, chunk=13,
                             dtype=torch.bfloat16)
    jparams, _, _ = _run_reference(opt, 2, dtype=jnp.bfloat16)
    for key, x in _leaves(params):
        assert x.dtype == torch.bfloat16, key
    _assert_close(params, jparams, rtol=2 ** -7, atol=0)


def test_two_adafactor_runs_are_bitwise_equal():
    opt = _opt()
    runs = [_run_port(opt, 3, per_layer=True, chunk=7) for _ in range(2)]
    trees = [{"params": p, "state": st} for p, st, _ in runs]
    for (ka, a), (kb, b) in zip(_leaves(trees[0]), _leaves(trees[1])):
        assert ka == kb and torch.equal(a, b), ka
    assert runs[0][2] == runs[1][2]


def test_adamw_update_is_the_same_bits_at_any_chunk():
    """AdamW is elementwise: chunked views update every element as the
    whole leaf does (a clip that never binds keeps the norm's chunked sum
    out of the update)."""
    opt = OPT.OptConfig(lr=1e-2, warmup_steps=1, grad_clip=1e9)
    whole, _, _ = _run_port(opt, 2, per_layer=True, chunk=None)
    for chunk in (5, 13):
        chunked, _, _ = _run_port(opt, 2, per_layer=True, chunk=chunk)
        for (ka, a), (_, b) in zip(_leaves(whole), _leaves(chunked)):
            assert torch.equal(a, b), (chunk, ka)


def test_adamw_matches_reference_with_chunks():
    opt = OPT.OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    params, state, norms = _run_port(opt, 3, per_layer=True, chunk=7)
    jparams, jstate, jnorms = _run_reference(opt, 3)
    np.testing.assert_allclose(norms, jnorms, rtol=1e-6)
    _assert_close(params, jparams, **F32)
    _assert_close(state["m"], jstate["m"], **F32)
    _assert_close(state["v"], jstate["v"], **F32)


def test_global_norm_in_chunks(monkeypatch):
    grads = [torch.as_tensor(x) for _, x in _leaves(_draw(3))]
    whole = OPT.global_norm(grads)
    for chunk in (1, 7, 64):
        monkeypatch.setattr(OPT, "CHUNK", chunk)
        np.testing.assert_allclose(float(OPT.global_norm(grads)),
                                   float(whole), rtol=1e-6)


def test_unknown_kind_raises():
    params = _torch(_draw(0))
    with pytest.raises(ValueError, match="unknown optimizer kind"):
        OPT.init_opt_state(params, OPT.OptConfig(kind="lion"))
    with pytest.raises(ValueError, match="unknown optimizer kind"):
        OPT.apply_updates(OPT.OptConfig(kind="lion"), params,
                          _torch(_draw(1)), {}, 0)
