"""repro_torch rwkv6 (models/rwkv6.py and its serving path) == the JAX
reference at smoke_config("rwkv6-1.6b") (2 layers, d_model 128, 8 WKV
heads of 16, float32).

Every rwkv leaf is drawn at random from a numpy seed (mu, w0, w_lora_b,
u, the group-norm and layer norms included; the reference's inits set
w_lora_b = 0, u = 0.5 and mu = 0.5, which would hide an indexing error)
and carried into both packages. Held to the reference: the time and
channel mix, full-sequence and stepwise; the model's logits (1e-4);
prefill_cache + decode_step; generate with an inactive slot. The
engine's greedy tokens equal the JAX MODEL's per-request greedy decode
(``tests/test_serve.py::_greedy_reference``), slot reuse, a 1-token
prompt, snapshot/restore and fleet failover included, while the JAX
ENGINE's tokens on the same prompts do not (it applies each prompt's
last token twice and never resets a reused slot's state: ROADMAP C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import layers as JL
from repro.models import model as JMD
from repro.models import rwkv6 as JRW
from repro.serve import decode as JD
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import registry as REG
from repro_torch.launch import serve as SERVE
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models import rwkv6 as RW
from repro_torch.models import transformer as T
from repro_torch.resilience import faults as F
from repro_torch.resilience import snapshot as SNAP
from repro_torch.serve import decode as D
from repro_torch.serve.engine import Engine
from repro_torch.serve.fleet import Fleet
from repro_torch.train import train_step as TS

torch.set_num_threads(2)

ARCH = "rwkv6-1.6b"
TOL = dict(atol=2e-5, rtol=2e-5)  # tests/oracles.py's f32 policy
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5], [4, 4, 2], [7]]
MAX_NEW, MAX_LEN = 6, 48
ENGINE_KW = dict(slots=2, max_len=MAX_LEN, prefill_impl="torch",
                 decode_impl="torch", device="cpu")


# drawn at random by the reference's init already
MATRICES = {"wr", "wk", "wv", "wg", "wo", "cm_wk", "cm_wv", "cm_wr",
            "w_lora_a"}


def _randomize(np_params, seed):
    """Every f32 leaf of the layers at random, in place: mu in (0, 1),
    the rest around the reference's init."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1]
        if path[-2] == "mu":
            return rng.uniform(0.0, 1.0, x.shape)
        if name in ("norm1", "norm2", "ln_x_scale"):
            return 1.0 + 0.2 * rng.standard_normal(x.shape)
        if name == "w0":
            return rng.uniform(-3.0, 1.0, x.shape)
        if name == "w_lora_b":
            return 0.3 * rng.standard_normal(x.shape)
        return 0.5 * rng.standard_normal(x.shape)  # u, ln_x_bias

    def walk(tree, path):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val, path + (key,))
            elif val.dtype == np.float32 and key not in MATRICES:
                tree[key] = draw(path + (key,), val).astype(np.float32)

    walk(np_params["layers"], ())
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


def _greedy_reference(ctx, prompt, max_new=MAX_NEW, feed=None):
    """The JAX model's single-sequence greedy decode, token by token (the
    semantics of tests/test_serve.py::_greedy_reference); ``feed``
    overrides the tokens fed (the doubled-last-token variant)."""
    feed = list(prompt) if feed is None else feed
    cache = JMD.init_cache(ctx["jcfg"], 1, MAX_LEN, jnp.float32)
    for t, p in enumerate(feed):
        logits, cache = ctx["jdecode"](cache, jnp.array([[p]], jnp.int32),
                                       jnp.int32(t))
    out, pos = [], len(feed) - 1
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


def _layer(tree, l=0):
    return jax.tree.map(lambda x: x[l], tree["layers"]["l0"])


def _run(eng, prompts=PROMPTS):
    for uid, p in enumerate(prompts):
        eng.submit(np.asarray(p, np.int32), max_new=MAX_NEW, uid=uid)
    return eng.run()


# ---------------------------------------------------------------------------
# configs, params, layers
# ---------------------------------------------------------------------------


def test_config_fields_match_reference():
    assert dataclasses.asdict(REG.get_config(ARCH)) == \
        dataclasses.asdict(JREG.get_config(ARCH))
    assert dataclasses.asdict(REG.smoke_config(ARCH)) == \
        dataclasses.asdict(JREG.smoke_config(ARCH))
    for arch in (ARCH, "yi-9b"):
        assert REG.get_config(arch).n_rwkv_heads == \
            JREG.get_config(arch).n_rwkv_heads


def test_unported_mixers_still_raise():
    """Mamba mixers and MoE FFNs are ported (tests/test_torch_jamba.py);
    a mixer kind the reference does not have and an unregistered arch
    still raise."""
    cfg = REG.smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="'xlstm' mixers"):
        T.check_supported(dataclasses.replace(cfg,
                                              layer_pattern=("xlstm",)))
    for pattern in (("mamba",), ("attn",), ("rwkv",)):
        T.check_supported(dataclasses.replace(cfg, layer_pattern=pattern))
    T.check_supported(dataclasses.replace(
        REG.smoke_config("yi-9b"), n_experts=4, experts_per_token=2))
    with pytest.raises(KeyError, match="unknown arch"):
        REG.get_config("xlstm-7b")


def test_params_and_init_match_reference_layout(ctx):
    """params_from_jax carries every leaf (the nested mu dict, f32 and
    matrix leaves) exactly; init_params and init_cache have the
    reference's tree, shapes and dtypes."""
    jflat = jax.tree_util.tree_flatten_with_path(ctx["jparams"])[0]
    own = MD.init_params(ctx["tcfg"], seed=0, device="cpu")
    jcache = JMD.init_cache(ctx["jcfg"], 3, MAX_LEN, jnp.float32)
    tcache = MD.init_cache(ctx["tcfg"], 3, MAX_LEN, torch.float32, "cpu")
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
    assert len(jflat) > 20


def _n_leaves(tree):
    return sum(_n_leaves(v) if isinstance(v, dict) else 1
               for v in tree.values())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.default_rng(3)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    want = JL.layer_norm(jnp.asarray(x, dtype), jnp.asarray(scale),
                         jnp.asarray(bias))
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = L.layer_norm(torch.as_tensor(x).to(tdt), torch.as_tensor(scale),
                       torch.as_tensor(bias))
    assert got.dtype == tdt
    if dtype == jnp.float32:
        _close(got, want)
    else:  # one bf16 rounding of the same f32 value
        _close(got, want, atol=2e-2, rtol=1e-2)


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 37, 64])
def test_time_mix_full_sequence_and_continued(ctx, s):
    """From no state, then continued from the state it left (s = 37: a
    chunk of 1 after halving; s = 64: two chunks of 32; s = 1: the
    decode fast path)."""
    jp, tp = _layer(ctx["jparams"]), T.layer_params(ctx["tparams"]["layers"],
                                                    0)["l0"]
    cfg_j, cfg_t = ctx["jcfg"], ctx["tcfg"]
    x1, x2 = _x(2, s, 128, s), _x(2, s, 128, s + 1)
    jo1, jst = JRW.rwkv_time_mix(jp["mixer"], jnp.asarray(x1), cfg_j)
    to1, tst = RW.rwkv_time_mix(tp["mixer"], torch.as_tensor(x1), cfg_t)
    _close(to1, jo1)
    for name in ("shift", "s"):
        _close(tst[name], jst[name])
    jo2, jst2 = JRW.rwkv_time_mix(jp["mixer"], jnp.asarray(x2), cfg_j,
                                  state=jst)
    to2, tst2 = RW.rwkv_time_mix(tp["mixer"], torch.as_tensor(x2), cfg_t,
                                 state=tst)
    _close(to2, jo2)
    _close(tst2["s"], jst2["s"])


def test_time_and_channel_mix_stepwise(ctx):
    """Eight single-token steps, each from the state the last left."""
    jp, tp = _layer(ctx["jparams"]), T.layer_params(ctx["tparams"]["layers"],
                                                    0)["l0"]
    cfg_j, cfg_t = ctx["jcfg"], ctx["tcfg"]
    x = _x(3, 8, 128, 9)
    jst = tst = jsc = tsc = None
    for t in range(8):
        xt = x[:, t:t + 1]
        jo, jst = JRW.rwkv_time_mix(jp["mixer"], jnp.asarray(xt), cfg_j,
                                    state=jst)
        to, tst = RW.rwkv_time_mix(tp["mixer"], torch.as_tensor(xt), cfg_t,
                                   state=tst)
        _close(to, jo)
        jc, jsc = JRW.rwkv_channel_mix(jp["mixer"], jnp.asarray(xt), cfg_j,
                                       state=jsc)
        tc, tsc = RW.rwkv_channel_mix(tp["mixer"], torch.as_tensor(xt),
                                      cfg_t, state=tsc)
        _close(tc, jc)
        _close(tsc, jsc)
    _close(tst["s"], jst["s"])


def test_channel_mix_full_sequence(ctx):
    jp, tp = _layer(ctx["jparams"], 1), T.layer_params(
        ctx["tparams"]["layers"], 1)["l0"]
    x, prev = _x(2, 19, 128, 4), _x(2, 1, 128, 5)[:, 0]
    jo, js = JRW.rwkv_channel_mix(jp["mixer"], jnp.asarray(x), ctx["jcfg"],
                                  state=jnp.asarray(prev))
    to, ts = RW.rwkv_channel_mix(tp["mixer"], torch.as_tensor(x),
                                 ctx["tcfg"], state=torch.as_tensor(prev))
    _close(to, jo)
    _close(ts, js)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 512, (b, s))


def test_forward_logits_match_reference(ctx):
    toks = _tokens(2, 40, 11)
    jh, _, jst = JMD.forward(ctx["jparams"], ctx["jcfg"],
                             {"tokens": jnp.asarray(toks)}, remat=False,
                             collect_state=True)
    th, _, tst = MD.forward(ctx["tparams"], ctx["tcfg"],
                            {"tokens": torch.as_tensor(toks)},
                            attn_impl="torch", collect_state=True)
    _close(MD.logits_from_hidden(ctx["tparams"], ctx["tcfg"], th),
           JMD.logits_from_hidden(ctx["jparams"], ctx["jcfg"], jh),
           atol=1e-4, rtol=1e-4)
    for name in ("shift", "s", "shift_c"):
        assert tuple(tst["l0"][name].shape) == jst["l0"][name].shape
        _close(tst["l0"][name], jst["l0"][name], atol=1e-4, rtol=1e-4)


def test_prefill_cache_then_decode_matches_reference(ctx):
    """prefill_cache on s - 1 tokens, one decode step: logits and every
    cache leaf equal the reference's, and the logits equal the full
    forward's last (the reference's own invariant)."""
    b, s = 2, 32
    toks = _tokens(b, s, 12)
    _, jcache = JMD.prefill_cache(ctx["jparams"], ctx["jcfg"],
                                  {"tokens": jnp.asarray(toks[:, :-1])},
                                  max_len=s, cache_dtype=jnp.float32)
    _, tcache = MD.prefill_cache(ctx["tparams"], ctx["tcfg"],
                                 {"tokens": torch.as_tensor(toks[:, :-1])},
                                 s, attn_impl="torch",
                                 cache_dtype=torch.float32)
    for name in ("shift", "s", "shift_c"):
        _close(tcache["l0"][name], jcache["l0"][name], atol=1e-4, rtol=1e-4)
    jl, jcache = JMD.decode_step(ctx["jparams"], ctx["jcfg"], jcache,
                                 jnp.asarray(toks[:, -1:]), jnp.int32(s - 1))
    tl, tcache = MD.decode_step(ctx["tparams"], ctx["tcfg"], tcache,
                                torch.as_tensor(toks[:, -1:]), s - 1,
                                attn_impl="torch")
    _close(tl, jl, atol=1e-4, rtol=1e-4)
    _close(tcache["l0"]["s"], jcache["l0"]["s"], atol=1e-4, rtol=1e-4)
    th, _, _ = MD.forward(ctx["tparams"], ctx["tcfg"],
                          {"tokens": torch.as_tensor(toks)},
                          attn_impl="torch")
    _close(tl[:, 0], MD.logits_from_hidden(ctx["tparams"], ctx["tcfg"],
                                           th)[:, -1], atol=1e-4, rtol=1e-4)


def test_prefill_and_serve_steps(ctx):
    """The offline entry points: the prefill step's last logits equal the
    forward's, and a serve step after it the reference's decode."""
    toks = _tokens(3, 17, 13)
    prefill = TS.make_prefill_step(ctx["tcfg"], attn_impl="torch",
                                   cache_dtype=torch.float32)
    serve = TS.make_serve_step(ctx["tcfg"], attn_impl="torch")
    logits, cache = prefill(ctx["tparams"], {"tokens": torch.as_tensor(
        toks[:, :-1])})
    jlast, jcache = JMD.prefill_cache(ctx["jparams"], ctx["jcfg"],
                                      {"tokens": jnp.asarray(toks[:, :-1])},
                                      max_len=16, cache_dtype=jnp.float32)
    _close(logits, JMD.logits_from_hidden(ctx["jparams"], ctx["jcfg"],
                                          jlast)[:, -1], atol=1e-4,
           rtol=1e-4)
    nxt, cache = serve(ctx["tparams"], cache, torch.as_tensor(toks[:, -1:]),
                       torch.full((3,), 16, dtype=torch.int32))
    jl, _ = JMD.decode_step(ctx["jparams"], ctx["jcfg"], jcache,
                            jnp.asarray(toks[:, -1:]), jnp.int32(16))
    _close(nxt, jl[:, 0], atol=1e-4, rtol=1e-4)


def test_generate_matches_reference_and_leaves_inactive_slot(ctx):
    """generate from a prefilled cache with slot 1 inactive: the tokens
    and final cache equal the reference's generate, and slot 1's state
    is bitwise the one it started with."""
    toks = _tokens(3, 9, 14)
    _, jcache = JMD.prefill_cache(ctx["jparams"], ctx["jcfg"],
                                  {"tokens": jnp.asarray(toks[:, :-1])},
                                  max_len=32, cache_dtype=jnp.float32)
    _, tcache = MD.prefill_cache(ctx["tparams"], ctx["tcfg"],
                                 {"tokens": torch.as_tensor(toks[:, :-1])},
                                 32, attn_impl="torch",
                                 cache_dtype=torch.float32)
    before = {n: t[:, 1].clone() for n, t in tcache["l0"].items()}
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
    for name, leaf in tcache["l0"].items():
        assert torch.equal(leaf[:, 1], before[name]), name
        _close(leaf, jcache["l0"][name], atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_engine_tokens_equal_the_models_greedy_decode(ctx, greedy):
    """2 slots, 5 requests: slots are reused, the last prompt has one
    token. Sequential admission and lockstep decode are picked for the
    recurrent arch."""
    eng = Engine(ctx["tparams"], ctx["tcfg"], **ENGINE_KW)
    assert (eng.prefill_mode, eng.decode_mode, eng.step_mode) == \
        ("sequential", "lockstep", "split")
    res = _run(eng)
    assert res == greedy
    assert all(r["status"] == "done" for r in eng.report().values())
    st = eng.stats
    assert st["prefill_requests"] == 5
    assert st["prefill_launches"] == sum(len(p) - 1 for p in PROMPTS)


def test_engine_admission_moves_no_other_slot(ctx):
    """An admit zeroes its slot and prefills it alone: a live slot's
    state is bitwise unchanged across another slot's admission."""
    eng = Engine(ctx["tparams"], ctx["tcfg"], **ENGINE_KW)
    eng.submit(np.array(PROMPTS[0], np.int32), max_new=MAX_NEW, uid=0)
    eng.round()
    live = {n: t[:, 0].clone() for n, t in eng.cache["l0"].items()}
    eng.submit(np.array(PROMPTS[2], np.int32), max_new=MAX_NEW, uid=1)
    eng._admit()
    assert eng.slot_req[1] is not None
    for name, leaf in eng.cache["l0"].items():
        assert torch.equal(leaf[:, 0], live[name]), name
    assert int(eng.pos[1]) == len(PROMPTS[2]) - 1
    assert int(eng.last_tok[1, 0]) == PROMPTS[2][-1]


def test_reference_engine_diverges_on_the_same_prompts(ctx, greedy):
    """The fault this port repairs: the JAX engine's tokens differ from
    its own model's greedy decode on every request. The first two
    (fresh slots) equal the greedy decode of the prompt with its last
    token fed twice; the later two, in reused slots, not even that."""
    eng = JEngine(ctx["jparams"], ctx["jcfg"], slots=2, max_len=MAX_LEN,
                  temperature=0.0)
    res = _run(eng, PROMPTS[:4])
    doubled = {uid: _greedy_reference(ctx, p, feed=list(p) + [p[-1]])
               for uid, p in enumerate(PROMPTS[:4])}
    assert all(res[uid] != greedy[uid] for uid in range(4)), res
    assert [res[0], res[1]] == [doubled[0], doubled[1]]
    assert [res[2], res[3]] != [doubled[2], doubled[3]]


@pytest.mark.parametrize("cut", [0, 2, 5, 9])
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


def test_serve_cli_rwkv_on_cpu(capsys):
    results, engine = SERVE.main(["--arch", ARCH, "--device", "cpu",
                                  "--requests", "5", "--slots", "2",
                                  "--max-new", "4", "--max-len", "48"])
    report = engine.report()
    assert sorted(results) == sorted(report) == list(range(5))
    assert all(r["status"] == "done" and r["tokens"] == 4
               for r in report.values())
    out = capsys.readouterr().out
    assert "5/5 requests, 20 tokens" in out
    assert "prefill[sequential]" in out and "decode[lockstep]" in out


def test_rwkv_slice_imports_with_jax_blocked():
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.models.rwkv6, "
            "repro_torch.kernels.wkv_scan.ops, "
            "repro_torch.kernels.wkv_scan.kernel, "
            "repro_torch.configs.rwkv6_1_6b, repro_torch.train.train_step; "
            "from repro_torch.serve.decode import generate; print('ok')")
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(src)),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
