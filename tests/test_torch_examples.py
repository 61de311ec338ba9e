"""The nine port examples (examples/torch_*.py) on the CPU, against the
reference's modules.

Each example's ``main(device="cpu")`` runs at the reference example's
sizes on the plain PyTorch versions and passes its own assertions (the
reference example's: identical tokens, losses within 1e-5, tile and
launch counts). The numbers that do not depend on the weights equal the
reference's on the same inputs: the attention tiles of each schedule,
``strategy_stats``, the tet and BB-3D launch counts and maps, the packed
against padded tiles of training, and the reference engine's prefill and
decode counters (auto's packed and lockstep rounds included). The ones
that do are held to the reference example's own computation on the
reference's weights carried across (``params_from_jax``,
``state_from_jax``) at the float32 policy: quickstart's 30 losses and
generated tokens, packed_train's packed and padded losses, and the
streams of packed_prefill, packed_decode (each mode), serve_demo and
fleet_serve.
serve_demo runs the serving CLI, which is given the reference CLI's
mixtral weights in place of its own seeded init and must serve the
reference CLI's streams.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.configs.base import ShapeConfig as JShape
from repro.core import analysis as JA
from repro.core import mapping as JM
from repro.core import schedule as JS
from repro.kernels.tri_attn import ops as JOPS
from repro.models import model as JMD
from repro.resilience import faults as JF
from repro.serve import decode as JD
from repro.serve.engine import Engine as JEngine
from repro.train import data as JDATA
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch.configs import registry as REG
from repro_torch.models import model as MD
from repro_torch.train import train_step as TS

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "yi-9b"
LOSS_RTOL = 1e-5  # the float32 policy of a train step's loss


def _example(name):
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def weights():
    """The reference examples' weights (init_params from key 0) and the
    same carried across to the port."""
    jcfg = JREG.smoke_config(ARCH)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = MD.params_from_jax(jax.tree.map(np.asarray, jparams),
                                 REG.smoke_config(ARCH), device="cpu")
    return jparams, tparams


def _ref_engine(jparams, prompts, max_new, **kw):
    """The reference engine's streams and counters on the example's
    prompts."""
    cfg = JREG.smoke_config(ARCH)
    eng = JEngine(jparams, cfg, temperature=0.0, **kw)
    for uid, p in enumerate(prompts):
        eng.submit(p, max_new=max_new, uid=uid)
    return eng.run(), eng.stats


def _ref_prompts(lens, seed):
    rng = np.random.default_rng(seed)
    vocab = JREG.smoke_config(ARCH).vocab_size
    return [rng.integers(1, vocab, size=s).astype(np.int32) for s in lens]


def _ref_state(jopt):
    return JTS.init_state(jax.random.key(0), JREG.smoke_config(ARCH), jopt)


def _carried_state(jstate):
    return TS.state_from_jax(jax.tree.map(np.asarray, jstate),
                             REG.smoke_config(ARCH), device="cpu")


def test_quickstart():
    """examples/quickstart.py's 30 steps and greedy generation on the
    reference, from the state the port's example is given: every loss
    within the float32 policy, the generated tokens equal."""
    jcfg = JREG.smoke_config(ARCH)
    jopt = JOPT.OptConfig(lr=3e-3, warmup_steps=5, total_steps=30)
    jstate = _ref_state(jopt)
    out = _example("quickstart").main("cpu", state=_carried_state(jstate))
    assert out["losses"][-1] < out["losses"][0]
    ds = JDATA.SyntheticLM(jcfg, JShape("quickstart", seq_len=128,
                                        global_batch=8, kind="train"),
                           seed=0, act_dtype=jnp.float32)
    step = jax.jit(JTS.make_train_step(jcfg, jopt))
    want = []
    for i in range(30):
        jstate, metrics = step(jstate, ds.batch(i))
        want.append(float(metrics["loss"]))
    np.testing.assert_allclose(out["losses"], want, rtol=LOSS_RTOL)
    toks, _, _ = JD.generate(
        jstate.params, jcfg, JMD.init_cache(jcfg, 2, 64, jnp.float32),
        first_tokens=jnp.array([[1], [2]], jnp.int32),
        start_pos=jnp.zeros((2,), jnp.int32), n_tokens=12)
    assert out["tokens"] == np.asarray(toks).tolist()


def test_triangular_attention():
    mod = _example("triangular_attention")
    out = mod.main("cpu")
    n = mod.S // mod.BLK
    assert out["tiles"] == {
        "causal (LTM)": JM.tri(n),
        "sliding-window 128 (Band)": JM.band_blocks(n, 2),
        "prefix-causal 128 (Prefix, VLM)": JM.prefix_full_blocks(n, 1)}
    assert out["bb"] == n * n


def test_edm_pairwise():
    mod = _example("edm_pairwise")
    out = mod.main("cpu")
    n = mod.N // mod.BLOCK
    want = JA.strategy_stats(n)
    assert set(out["stats"]) == set(want)
    for key, (launched, wasted, ratio) in out["stats"].items():
        assert (launched, wasted) == (want[key].launched, want[key].wasted)
        assert ratio == pytest.approx(want[key].block_ratio_vs_bb)
    assert out["launched"] == JM.tri(n) == want["ltm"].launched
    assert out["shape"] == (JM.tri(n), mod.BLOCK, mod.BLOCK)
    assert out["last"] == tuple(JM.ltm_map(JM.tri(n) - 1))


def test_tet_3body():
    mod = _example("tet_3body")
    out = mod.main("cpu")
    n = mod.N_ROWS // mod.BLOCK
    assert (out["n"], out["block"]) == (n, mod.BLOCK)
    assert out["tet"] == out["launched"] == \
        JS.TetrahedralSchedule(n=n).num_blocks
    assert out["bb3"] == JS.Dense3DSchedule(n=n).num_blocks
    assert out["maps"] == [tuple(int(c) for c in JM.tet_map(lam))
                           for lam in range(4)]


def test_packed_prefill(weights):
    jparams, tparams = weights
    mod = _example("packed_prefill")
    out = mod.main("cpu", params=tparams)
    want, st = _ref_engine(jparams, _ref_prompts(mod.LENS, 0), 8, slots=4,
                           max_len=mod.MAX_LEN, prefill_block=mod.BLOCK)
    assert out["launches"]["packed"] == st["prefill_launches"] == \
        out["admit_rounds"] == st["admit_rounds"]
    assert out["launches"]["sequential"] == sum(mod.LENS)
    assert out["results"]["packed"] == out["results"]["sequential"] == want


def test_packed_decode(weights):
    """Each mode's streams and counters equal the reference engine's in
    the same mode on the same weights."""
    jparams, tparams = weights
    mod = _example("packed_decode")
    out = mod.main("cpu", params=tparams)
    prompts = _ref_prompts(mod.LENS, 0)
    for mode in ("packed", "lockstep", "auto"):
        want, st = _ref_engine(jparams, prompts, 8, slots=4,
                               max_len=mod.MAX_LEN, prefill_block=mod.BLOCK,
                               decode_mode=mode, decode_block=mod.BLOCK)
        assert out["results"][mode] == want, mode
        for name, got in out["stats"][mode].items():
            assert got == st[name], (mode, name)
        if mode == "auto":
            assert st["decode_packed_launches"] > 0
            assert st["decode_lockstep_launches"] > 0


def test_packed_train():
    """examples/packed_train.py's three packed and padded steps on the
    reference from the state the port's example is given: each loss
    within the float32 policy, the schedule's tiles equal."""
    mod = _example("packed_train")
    jcfg = JREG.smoke_config(ARCH)
    jopt = JOPT.OptConfig()
    jstate = _ref_state(jopt)
    out = mod.main("cpu", state=_carried_state(jstate))
    docs = JDATA.PackedDocsLM(jcfg, mod.DOC_LENS, block=mod.BLOCK, seed=0)
    assert out["member_lens"] == tuple(docs.member_lens)
    psched = JOPS.make_packed_sched(docs.member_lens, block=mod.BLOCK,
                                    window=jcfg.sliding_window)
    assert out["tiles_packed"] == 3 * psched.steps
    ns = [s // mod.BLOCK for s in docs.member_lens]
    assert out["tiles_bb"] == 3 * len(ns) * max(ns) ** 2
    packed_step = jax.jit(JTS.make_train_step(
        jcfg, jopt, packed=psched, block=mod.BLOCK, aux_weight=0.0))
    padded_step = jax.jit(JTS.make_train_step(jcfg, jopt, block=mod.BLOCK,
                                              aux_weight=0.0))
    state_p = state_d = jstate
    for step, (lp, ld) in enumerate(out["losses"]):
        state_p, met_p = packed_step(state_p, docs.batch(step))
        state_d, met_d = padded_step(state_d, docs.padded_batch(step))
        np.testing.assert_allclose(lp, float(met_p["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(ld, float(met_d["loss"]), rtol=LOSS_RTOL)
        assert lp == pytest.approx(ld, rel=1e-5)


def test_serve_demo(monkeypatch):
    """The port's serving CLI on the reference CLI's mixtral weights
    (init_params from key 0, carried across in place of the port's own
    seeded init): its streams equal examples/serve_demo.py's, the
    reference CLI on the same arguments and prompts."""
    from repro.launch import serve as JSERVE
    from repro_torch.launch import serve as SERVE

    arch = "mixtral-8x7b"
    jcfg = JREG.smoke_config(arch)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    carried = MD.params_from_jax(jax.tree.map(np.asarray, jparams),
                                 REG.smoke_config(arch), device="cpu")
    monkeypatch.setattr(SERVE.MD, "init_params",
                        lambda cfg, seed, device: carried)
    out = _example("serve_demo").main("cpu")
    assert sorted(out["results"]) == list(range(6))
    assert all(len(v) == 12 for v in out["results"].values())
    assert out["decode_mode"] == "auto"
    want = JSERVE.main(["--arch", arch, "--requests", "6", "--slots", "3",
                        "--max-new", "12", "--max-len", "64"])
    assert out["results"] == want


def test_fleet_serve(weights):
    """The fleet's streams (a replica killed mid-decode) and the port's
    single-engine baseline both equal the reference engine's baseline on
    the same weights."""
    jparams, tparams = weights
    out = _example("fleet_serve").main("cpu", params=tparams)
    assert out["failovers"] >= 1
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 50, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 12, size=6)]
    want, _ = _ref_engine(jparams, prompts, 4, slots=2, max_len=48,
                          prefill_block=4, clock=JF.VirtualClock())
    assert out["results"] == out["baseline"] == want
