"""repro_torch jamba (models/mamba.py, models/moe.py and the hybrid
serving path) == the JAX reference at smoke_config("jamba-1.5-large-398b")
(16 layers, d_model 128, d_inner 256, d_state 8, 4 experts top-2,
float32).

Every f32 leaf of the Mamba layers (dt_bias, a_log, d_skip) and the
norms is drawn at random from a numpy seed and carried into both
packages (the reference's inits set dt_bias = 0, d_skip = 1 and a_log
the same in every channel, which would hide an indexing error). Held to
the reference: the Mamba mixer, full-sequence (chunked) and stepwise;
the MoE FFN with drops at capacity_factor 1.25 (the same tokens kept),
drop-free, with its aux loss and with two dispatch groups; the model's
logits (1e-4) and greedy tokens; prefill_cache + decode_step; generate
with an inactive slot. THE REPAIR: at capacity_factor 1.25 the port's
prefill + decode equals its drop-free forward, where the reference's is
off by O(1) (its prefill drops tokens; ROADMAP C). The engine's greedy
tokens equal the JAX MODEL's per-request greedy decode (slot reuse, a
1-token prompt, snapshot/restore and fleet failover included), while
the JAX ENGINE's do not; an admission moves no other slot's k/v, h or
conv.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import mamba as JMB
from repro.models import model as JMD
from repro.models import moe as JMOE
from repro.parallel import hints as JH
from repro.serve import decode as JD
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import registry as REG
from repro_torch.launch import serve as SERVE
from repro_torch.models import mamba as MB
from repro_torch.models import model as MD
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.parallel import hints as H
from repro_torch.resilience import faults as F
from repro_torch.resilience import snapshot as SNAP
from repro_torch.serve import decode as D
from repro_torch.serve.engine import Engine
from repro_torch.serve.fleet import Fleet
from repro_torch.train import train_step as TS

torch.set_num_threads(2)

ARCH = "jamba-1.5-large-398b"
TOL = dict(atol=2e-5, rtol=2e-5)  # tests/oracles.py's f32 policy
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5], [4, 4, 2], [7]]
MAX_NEW, MAX_LEN = 6, 48
ENGINE_KW = dict(slots=2, max_len=MAX_LEN, prefill_impl="torch",
                 decode_impl="torch", device="cpu")
D_MODEL = 128


def _randomize(np_params, seed):
    """The Mamba layers' f32 vectors and every norm at random, in place."""
    rng = np.random.default_rng(seed)
    draw = {
        "norm1": lambda s: 1.0 + 0.2 * rng.standard_normal(s),
        "norm2": lambda s: 1.0 + 0.2 * rng.standard_normal(s),
        "dt_bias": lambda s: rng.uniform(-3.0, 0.5, s),
        "a_log": lambda s: np.log(rng.uniform(0.3, 12.0, s)),
        "d_skip": lambda s: 1.0 + 0.5 * rng.standard_normal(s),
    }

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key in draw:
                tree[key] = draw[key](val.shape).astype(np.float32)

    walk(np_params["layers"])
    return np_params


def _to_dict(tree):
    return {k: _to_dict(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def ctx():
    jcfg, tcfg = JREG.smoke_config(ARCH), REG.smoke_config(ARCH)
    np_params = _randomize(
        _to_dict(JMD.init_params(jax.random.key(0), jcfg)), seed=1)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = MD.params_from_jax(np_params, tcfg, device="cpu")
    jdecode = jax.jit(lambda c, t, p: JMD.decode_step(jparams, jcfg, c, t, p))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jdecode=jdecode)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


def _greedy_reference(ctx, prompt, max_new=MAX_NEW):
    """The JAX model's single-sequence greedy decode, token by token (the
    semantics of tests/test_serve.py::_greedy_reference)."""
    cache = JMD.init_cache(ctx["jcfg"], 1, MAX_LEN, jnp.float32)
    for t, p in enumerate(prompt):
        logits, cache = ctx["jdecode"](cache, jnp.array([[p]], jnp.int32),
                                       jnp.int32(t))
    out, pos = [], len(prompt) - 1
    nxt = int(jnp.argmax(logits[0, 0, :ctx["jcfg"].vocab_size]))
    for _ in range(max_new):
        out.append(nxt)
        pos += 1
        logits, cache = ctx["jdecode"](cache, jnp.array([[nxt]], jnp.int32),
                                       jnp.int32(pos))
        nxt = int(jnp.argmax(logits[0, 0, :ctx["jcfg"].vocab_size]))
    return out


@pytest.fixture(scope="module")
def greedy(ctx):
    return {uid: _greedy_reference(ctx, p) for uid, p in enumerate(PROMPTS)}


def _layer(ctx, slot, l=0):
    return (jax.tree.map(lambda x: x[l], ctx["jparams"]["layers"][slot]),
            T.layer_params(ctx["tparams"]["layers"], l)[slot])


def _run(eng, prompts=PROMPTS):
    for uid, p in enumerate(prompts):
        eng.submit(np.asarray(p, np.int32), max_new=MAX_NEW, uid=uid)
    return eng.run()


def _x(b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D_MODEL)).astype(np.float32)


def _skewed(b, s, seed):
    """Tokens sharing one random direction (2x their own spread), so the
    router sends most of them to the same experts, as a trained router's
    hot experts do: at capacity 1.25 some slots drop and most stay."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, D_MODEL)) \
        + 2.0 * rng.standard_normal(D_MODEL)
    return x.astype(np.float32)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 512, (b, s))


# ---------------------------------------------------------------------------
# configs, params, caches
# ---------------------------------------------------------------------------


def test_config_fields_and_sizes_match_reference():
    full, smoke = REG.get_config(ARCH), REG.smoke_config(ARCH)
    assert dataclasses.asdict(full) == \
        dataclasses.asdict(JREG.get_config(ARCH))
    assert dataclasses.asdict(smoke) == \
        dataclasses.asdict(JREG.smoke_config(ARCH))
    for arch in REG.ARCH_IDS:
        t, j = REG.get_config(arch), JREG.get_config(arch)
        assert t.d_inner == j.d_inner
        assert t.param_counts() == j.param_counts(), arch
    # the slice's cut (one superlayer, 4 experts): the reference's count
    cut = dict(n_layers=8, n_experts=4)
    assert dataclasses.replace(full, **cut).param_counts() == \
        dataclasses.replace(JREG.get_config(ARCH), **cut).param_counts() \
        == {"total": 16_129_482_752, "active": 11_297_644_544}


def test_params_and_caches_match_reference_layout(ctx):
    """params_from_jax carries every leaf exactly; init_params and
    init_cache have the reference's tree, shapes and dtypes (mamba h in
    f32, conv in the cache dtype, MoE expert leaves with their E dim)."""
    own = MD.init_params(ctx["tcfg"], seed=0, device="cpu")
    jcache = JMD.init_cache(ctx["jcfg"], 3, MAX_LEN, jnp.bfloat16)
    tcache = MD.init_cache(ctx["tcfg"], 3, MAX_LEN, torch.bfloat16, "cpu")
    for tree, jtree, exact in ((ctx["tparams"], ctx["jparams"], True),
                               (own, ctx["jparams"], False),
                               (tcache, jcache, False)):
        for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
            node = tree
            for k in path:
                node = node[k.key]
            assert tuple(node.shape) == leaf.shape, path
            assert str(node.dtype).endswith(str(leaf.dtype)), path
            if exact:
                np.testing.assert_array_equal(_np(node), _np(leaf))
        assert len(jax.tree_util.tree_leaves(jtree)) == _n_leaves(tree)
    assert tuple(own["layers"]["l1"]["ffn"]["wi"].shape) == (2, 4, 128, 64)
    _close(own["layers"]["l0"]["mixer"]["a_log"],
           JMD.init_params(jax.random.key(0),
                           ctx["jcfg"])["layers"]["l0"]["mixer"]["a_log"])


def _n_leaves(tree):
    return sum(_n_leaves(v) if isinstance(v, dict) else 1
               for v in tree.values())


# ---------------------------------------------------------------------------
# the Mamba mixer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 37, 64, 256])
def test_mamba_full_sequence_and_continued(ctx, s):
    """From no state, then continued from the state it left (s = 37: a
    chunk of 1 after halving; 256: two chunks of 128; s = 1: the decode
    fast path)."""
    jp, tp = _layer(ctx, "l0")
    cfg_j, cfg_t = ctx["jcfg"], ctx["tcfg"]
    x1, x2 = _x(2, s, s), _x(2, s, s + 1)
    jo1, jst = JMB.mamba_mix(jp["mixer"], jnp.asarray(x1), cfg_j)
    to1, tst = MB.mamba_mix(tp["mixer"], torch.as_tensor(x1), cfg_t)
    _close(to1, jo1)
    for name in ("h", "conv"):
        _close(tst[name], jst[name])
    jo2, jst2 = JMB.mamba_mix(jp["mixer"], jnp.asarray(x2), cfg_j,
                              state=jst)
    to2, tst2 = MB.mamba_mix(tp["mixer"], torch.as_tensor(x2), cfg_t,
                             state=tst)
    _close(to2, jo2)
    for name in ("h", "conv"):
        _close(tst2[name], jst2[name])


def test_mamba_stepwise_equals_reference_and_chunked(ctx):
    """Eight single-token steps, each from the state the last left, equal
    the reference's steps and the port's own full-sequence pass."""
    jp, tp = _layer(ctx, "l2")
    cfg_j, cfg_t = ctx["jcfg"], ctx["tcfg"]
    x = _x(3, 8, 9)
    jst = tst = None
    outs = []
    for t in range(8):
        xt = x[:, t:t + 1]
        jo, jst = JMB.mamba_mix(jp["mixer"], jnp.asarray(xt), cfg_j,
                                state=jst)
        to, tst = MB.mamba_mix(tp["mixer"], torch.as_tensor(xt), cfg_t,
                               state=tst)
        _close(to, jo)
        outs.append(to)
    _close(tst["h"], jst["h"])
    full, fst = MB.mamba_mix(tp["mixer"], torch.as_tensor(x), cfg_t)
    _close(torch.cat(outs, 1), full)
    _close(tst["h"], fst["h"])


# ---------------------------------------------------------------------------
# the MoE FFN
# ---------------------------------------------------------------------------


def _moe(ctx, x, cfg_kw=None, **kw):
    jp, tp = _layer(ctx, "l1")
    jcfg = dataclasses.replace(ctx["jcfg"], **(cfg_kw or {}))
    tcfg = dataclasses.replace(ctx["tcfg"], **(cfg_kw or {}))
    jo, jaux = JMOE.moe_mlp(jp["ffn"], jnp.asarray(x), jcfg, **kw)
    to, taux = MOE.moe_mlp(tp["ffn"], torch.as_tensor(x), tcfg, **kw)
    return jo, jaux, to, taux, tp, tcfg


def test_moe_drops_the_same_tokens_at_capacity_1_25(ctx):
    """B 2, S 48, 4 experts top-2, C = int(2 * 96 / 4 * 1.25) = 60: the
    port's routing drops slots; the outputs and aux equal the
    reference's, and the reference's drop-free output differs from its
    capped one exactly on the rows the port drops."""
    x = _skewed(2, 48, 21)
    cf = dict(capacity_factor=1.25)
    jo, jaux, to, taux, tp, tcfg = _moe(ctx, x, cf)
    _close(to, jo)
    _close(taux, jaux)
    _, _, keep, _ = MOE.route(tp["ffn"], torch.as_tensor(x).reshape(96, -1),
                              tcfg)
    dropped = ~keep.all(-1)
    assert 0 < int(dropped.sum()) < 96
    jfull, _ = JMOE.moe_mlp(_layer(ctx, "l1")[0]["ffn"], jnp.asarray(x),
                            dataclasses.replace(ctx["jcfg"], **cf),
                            full_capacity=True)
    moved = np.abs(_np(jfull) - _np(jo)).reshape(96, -1).max(-1) > 1e-6
    np.testing.assert_array_equal(moved, dropped.numpy())


def test_moe_full_capacity_and_aux_match_reference(ctx):
    x = _skewed(2, 48, 22)
    jo, jaux, to, taux, _, _ = _moe(ctx, x, dict(capacity_factor=1.25),
                                    full_capacity=True)
    _close(to, jo)
    _close(taux, jaux)
    assert float(taux) > 0


def test_moe_two_dispatch_groups_match_reference(ctx):
    """moe_groups 2 ranks each half of the tokens on its own: at C 1.25
    the drops move, and both packages move them alike."""
    x = _skewed(2, 48, 23)
    with JH.hints(moe_groups=2), H.hints(moe_groups=2):
        assert H.get("moe_groups") == 2
        jo, jaux, to, taux, _, _ = _moe(ctx, x, dict(capacity_factor=1.25))
    assert H.get("moe_groups") is None
    _close(to, jo)
    _close(taux, jaux)
    jo1, _, _, _, _, _ = _moe(ctx, x, dict(capacity_factor=1.25))
    assert np.abs(_np(jo1) - _np(jo)).max() > 1e-3


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_logits_and_states_match_reference(ctx):
    toks = _tokens(2, 40, 11)
    jh, jaux, jst = JMD.forward(ctx["jparams"], ctx["jcfg"],
                                {"tokens": jnp.asarray(toks)}, remat=False,
                                collect_state=True, attn_impl="ref")
    th, taux, tst = MD.forward(ctx["tparams"], ctx["tcfg"],
                               {"tokens": torch.as_tensor(toks)},
                               attn_impl="torch", collect_state=True)
    _close(MD.logits_from_hidden(ctx["tparams"], ctx["tcfg"], th),
           JMD.logits_from_hidden(ctx["jparams"], ctx["jcfg"], jh),
           **MODEL_TOL)
    _close(taux, jaux, **MODEL_TOL)
    for slot, names in (("l0", ("h", "conv")), ("l3", ("k", "v"))):
        for name in names:
            assert tuple(tst[slot][name].shape) == jst[slot][name].shape
            _close(tst[slot][name], jst[slot][name], **MODEL_TOL)


def test_prefill_cache_then_decode_matches_reference(ctx):
    """prefill_cache on s - 1 tokens, one decode step: logits and every
    cache leaf equal the reference's (at the smoke capacity factor 8 its
    prefill drops nothing), and the logits the forward's last."""
    b, s = 2, 32
    toks = _tokens(b, s, 12)
    _, jcache = JMD.prefill_cache(ctx["jparams"], ctx["jcfg"],
                                  {"tokens": jnp.asarray(toks[:, :-1])},
                                  max_len=s, cache_dtype=jnp.float32,
                                  attn_impl="ref")
    _, tcache = MD.prefill_cache(ctx["tparams"], ctx["tcfg"],
                                 {"tokens": torch.as_tensor(toks[:, :-1])},
                                 s, attn_impl="torch",
                                 cache_dtype=torch.float32)
    for slot, leaves in tcache.items():
        for name, leaf in leaves.items():
            _close(leaf, jcache[slot][name], **MODEL_TOL)
    jl, jcache = JMD.decode_step(ctx["jparams"], ctx["jcfg"], jcache,
                                 jnp.asarray(toks[:, -1:]), jnp.int32(s - 1))
    tl, tcache = MD.decode_step(ctx["tparams"], ctx["tcfg"], tcache,
                                torch.as_tensor(toks[:, -1:]), s - 1,
                                attn_impl="torch")
    _close(tl, jl, **MODEL_TOL)
    _close(tcache["l5"]["h"], jcache["l5"]["h"], **MODEL_TOL)
    th, _, _ = MD.forward(ctx["tparams"], ctx["tcfg"],
                          {"tokens": torch.as_tensor(toks)},
                          attn_impl="torch")
    _close(tl[:, 0], MD.logits_from_hidden(ctx["tparams"], ctx["tcfg"],
                                           th)[:, -1], **MODEL_TOL)


def _prefill_decode_gap(md, params, cfg, toks, impl, new_cache):
    """max |forward(full_capacity)[-1] - (prefill_cache(S-1) + decode)|
    of one package."""
    s = toks.shape[1]
    head, tail = toks[:, :-1], toks[:, -1:]
    h, _, _ = md.forward(params, cfg, {"tokens": toks}, attn_impl=impl,
                         full_capacity=True,
                         **({"remat": False} if md is JMD else {}))
    _, cache = md.prefill_cache(params, cfg, {"tokens": head}, s,
                                attn_impl=impl, cache_dtype=new_cache)
    logits, _ = md.decode_step(params, cfg, cache, tail, s - 1,
                               **({} if md is JMD else {"attn_impl": impl}))
    want = md.logits_from_hidden(params, cfg, h)[:, -1]
    return float(np.abs(_np(logits[:, 0]) - _np(want)).max()), _np(want)


def test_prefill_never_drops_what_decode_keeps(ctx):
    """THE REPAIR. At the published capacity factor 1.25 (B 2, S 32): the
    port's prefill_cache + decode_step equals its drop-free forward; the
    reference's differs by O(1), because its prefill drops tokens at
    capacity while every decode step serves drop-free. Both packages'
    drop-free forwards agree. (These tokens make the reference's prefill
    drop slots in some MoE layer: its gap reads 0.43.)"""
    cf = dict(capacity_factor=1.25)
    toks = _tokens(2, 32, 16)
    jgap, jwant = _prefill_decode_gap(
        JMD, ctx["jparams"], dataclasses.replace(ctx["jcfg"], **cf),
        jnp.asarray(toks), "ref", jnp.float32)
    tgap, twant = _prefill_decode_gap(
        MD, ctx["tparams"], dataclasses.replace(ctx["tcfg"], **cf),
        torch.as_tensor(toks), "torch", torch.float32)
    _close(twant, jwant, **MODEL_TOL)
    assert tgap < 1e-4, tgap
    assert jgap > 0.1, jgap


def test_prefill_and_serve_steps(ctx):
    """The offline entry points: the prefill step's last logits equal the
    reference's, its cache has room for ``max_len`` positions (the
    reference sizes it at S, where the next decode would wrap onto row 0
    of the attention k/v), and serve steps past S equal the reference's
    decode from a cache of the same size."""
    toks = _tokens(3, 17, 13)
    prefill = TS.make_prefill_step(ctx["tcfg"], attn_impl="torch",
                                   cache_dtype=torch.float32, max_len=24)
    serve = TS.make_serve_step(ctx["tcfg"], attn_impl="torch")
    logits, cache = prefill(ctx["tparams"],
                            {"tokens": torch.as_tensor(toks[:, :-1])})
    assert tuple(cache["l3"]["k"].shape)[2] == 24
    jlast, jcache = JMD.prefill_cache(ctx["jparams"], ctx["jcfg"],
                                      {"tokens": jnp.asarray(toks[:, :-1])},
                                      max_len=24, cache_dtype=jnp.float32,
                                      attn_impl="ref")
    _close(logits, JMD.logits_from_hidden(ctx["jparams"], ctx["jcfg"],
                                          jlast)[:, -1], **MODEL_TOL)
    tok = toks[:, -1:]
    for pos in range(16, 20):
        nxt, cache = serve(ctx["tparams"], cache, torch.as_tensor(tok),
                           torch.full((3,), pos, dtype=torch.int32))
        jl, jcache = JMD.decode_step(ctx["jparams"], ctx["jcfg"], jcache,
                                     jnp.asarray(tok), jnp.int32(pos))
        _close(nxt, jl[:, 0], **MODEL_TOL)
        tok = np.array(jnp.argmax(jl[:, 0, :512], -1))[:, None]


def test_generate_matches_reference_and_leaves_inactive_slot(ctx):
    """generate from a prefilled cache with slot 1 inactive: the greedy
    tokens and final cache equal the reference's generate, and slot 1's
    k/v, h and conv are bitwise the ones it started with."""
    toks = _tokens(3, 9, 14)
    _, jcache = JMD.prefill_cache(ctx["jparams"], ctx["jcfg"],
                                  {"tokens": jnp.asarray(toks[:, :-1])},
                                  max_len=32, cache_dtype=jnp.float32,
                                  attn_impl="ref")
    _, tcache = MD.prefill_cache(ctx["tparams"], ctx["tcfg"],
                                 {"tokens": torch.as_tensor(toks[:, :-1])},
                                 32, attn_impl="torch",
                                 cache_dtype=torch.float32)
    before = {(s, n): t[:, 1].clone() for s, lv in tcache.items()
              for n, t in lv.items()}
    active = np.array([True, False, True])
    jt, jcache, jpos = JD.generate(
        ctx["jparams"], ctx["jcfg"], jcache, jnp.asarray(toks[:, -1:]),
        jnp.full((3,), 8, jnp.int32), 5, active=jnp.asarray(active))
    tt, tcache, tpos = D.generate(
        ctx["tparams"], ctx["tcfg"], tcache, torch.as_tensor(toks[:, -1:]),
        8, 5, active=torch.as_tensor(active), attn_impl="torch")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert (tt[1] == 0).all()
    for (slot, name), rows in before.items():
        leaf = tcache[slot][name]
        assert torch.equal(leaf[:, 1], rows), (slot, name)
        _close(leaf, jcache[slot][name], **MODEL_TOL)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_engine_tokens_equal_the_models_greedy_decode(ctx, greedy):
    """2 slots, 5 requests: slots are reused, the last prompt has one
    token. Sequential admission and lockstep decode are picked for the
    hybrid arch."""
    eng = Engine(ctx["tparams"], ctx["tcfg"], **ENGINE_KW)
    assert (eng.prefill_mode, eng.decode_mode, eng.step_mode) == \
        ("sequential", "lockstep", "split")
    assert _run(eng) == greedy
    assert all(r["status"] == "done" for r in eng.report().values())
    st = eng.stats
    assert st["prefill_requests"] == 5
    assert st["prefill_launches"] == sum(len(p) - 1 for p in PROMPTS)


def test_engine_admission_moves_no_other_slot(ctx):
    """An admit zeroes its slot and prefills it alone: a live slot's
    attention k/v and Mamba h and conv are bitwise unchanged across
    another slot's admission."""
    eng = Engine(ctx["tparams"], ctx["tcfg"], **ENGINE_KW)
    eng.submit(np.array(PROMPTS[0], np.int32), max_new=MAX_NEW, uid=0)
    eng.round()
    live = {(s, n): t[:, 0].clone() for s, lv in eng.cache.items()
            for n, t in lv.items()}
    assert {n for _, n in live} == {"k", "v", "h", "conv"}
    eng.submit(np.array(PROMPTS[2], np.int32), max_new=MAX_NEW, uid=1)
    eng._admit()
    assert eng.slot_req[1] is not None
    for (slot, name), rows in live.items():
        assert torch.equal(eng.cache[slot][name][:, 0], rows), (slot, name)
    assert int(eng.pos[1]) == len(PROMPTS[2]) - 1
    assert int(eng.last_tok[1, 0]) == PROMPTS[2][-1]


def test_reference_engine_diverges_on_the_same_prompts(ctx, greedy):
    """The fault this port repairs, on the hybrid: the JAX engine applies
    each prompt's last token twice (its Mamba state moves a second time)
    and never resets a reused slot, so its tokens differ from its own
    model's greedy decode."""
    eng = JEngine(ctx["jparams"], ctx["jcfg"], slots=2, max_len=MAX_LEN,
                  temperature=0.0)
    res = _run(eng, PROMPTS[:4])
    assert all(res[uid] != greedy[uid] for uid in range(4)), res


@pytest.mark.parametrize("cut", [0, 3, 9])
def test_snapshot_restore_is_token_identical(ctx, greedy, cut, tmp_path):
    eng = Engine(ctx["tparams"], ctx["tcfg"], **ENGINE_KW)
    for uid, p in enumerate(PROMPTS):
        eng.submit(np.asarray(p, np.int32), max_new=MAX_NEW, uid=uid)
    for _ in range(cut):
        eng.round()
    snap = SNAP.snapshot(eng)
    assert Engine.restore(snap).run() == greedy
    loaded = SNAP.from_dir(SNAP.to_dir(snap, str(tmp_path / "snap")))
    assert SNAP.restore(loaded).run() == greedy
    assert eng.run() == greedy


@pytest.mark.parametrize("kind", ["launch_error", "poison"])
def test_fleet_failover_is_token_identical(ctx, greedy, kind):
    """Replica 0 dies in its second decode round; its requests migrate
    (re-prefilled on prompt + emitted tokens) and every stream equals
    the model's greedy decode."""
    plan = F.FaultPlan([F.Fault(kind, "decode", 1,
                                times=99 if kind == "launch_error" else 1,
                                engine=0)])
    fleet = Fleet(ctx["tparams"], ctx["tcfg"], engines=2, fault_plan=plan,
                  heartbeat_timeout_s=5.0, engine_kw=ENGINE_KW)
    for uid, p in enumerate(PROMPTS):
        fleet.submit(np.asarray(p, np.int32), max_new=MAX_NEW, uid=uid)
    res = fleet.run()
    assert fleet.stats["fleet_failovers_total"] >= 1
    assert res == greedy
    assert all(r["status"] == "done" for r in fleet.report().values())


def test_serve_cli_jamba_on_cpu(capsys):
    results, engine = SERVE.main(["--arch", ARCH, "--device", "cpu",
                                  "--requests", "3", "--slots", "2",
                                  "--max-new", "3", "--prompt-len", "6",
                                  "--max-len", "32"])
    report = engine.report()
    assert sorted(results) == sorted(report) == list(range(3))
    assert all(r["status"] == "done" and r["tokens"] == 3
               for r in report.values())
    out = capsys.readouterr().out
    assert "3/3 requests, 9 tokens" in out
    assert "prefill[sequential]" in out and "decode[lockstep]" in out


def test_jamba_slice_imports_with_jax_blocked():
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.models.mamba, repro_torch.models.moe, "
            "repro_torch.parallel.hints, "
            "repro_torch.kernels.ssm_scan.ops, "
            "repro_torch.kernels.ssm_scan.kernel, "
            "repro_torch.configs.jamba_1_5_large_398b, "
            "repro_torch.train.train_step; print('ok')")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(src)),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
