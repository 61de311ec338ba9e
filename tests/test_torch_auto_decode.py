"""The port's decode_mode="auto" == the reference engine's, round for round.

The cost rule (packed only when PACKED_TILE_COST_RATIO * sum(tiles) <
B * max(tiles)) is read off both engines' own step(): over a seeded sweep
of live kv lengths at B 2, 3 and 4 and decode blocks 4, 8 and 16, each
engine's round goes the same way. The reference's three engine cases (a
uniform batch all lockstep, tiles [1, 2] at B 2 never packed, [3, 3, 3,
37] with packed rounds) give equal per-round modes, launch and tile
counters and greedy tokens on carried-across float32 weights. A packed
round that fails raises EngineStepError (the reference's packed ->
lockstep rung is not ported), and an auto engine keeps its mode and its
tokens through snapshot -> to_dir -> from_dir -> restore and a fleet's
migration.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import model as JMD
from repro.serve import engine as JE
from repro_torch.configs import registry as REG
from repro_torch.models import model as MD
from repro_torch.obs import launch as OBS
from repro_torch.kernels.tri_attn import scan_impl as SC
from repro_torch.obs import sinks as SK
from repro_torch.resilience import faults as F
from repro_torch.resilience import snapshot as SNAP
from repro_torch.serve import engine as E
from repro_torch.serve import fleet as FL

torch.set_num_threads(2)

PORT = dict(prefill_impl="torch", decode_impl="torch", device="cpu")
REF = dict(prefill_impl="scan", decode_impl="scan")
# the reference test's engine (tests/test_decode_packed.py::_run_engine)
SMALL = dict(slots=2, max_len=48, temperature=0.0, prefill_block=4,
             decode_mode="auto", decode_block=8)
COUNTERS = ("decode_rounds", "decode_packed_launches",
            "decode_lockstep_launches", "decode_tiles_packed",
            "decode_tiles_padded", "prefill_launches", "admit_rounds")


@pytest.fixture(scope="module")
def pair():
    jcfg = JREG.smoke_config("yi-9b")
    tcfg = REG.smoke_config("yi-9b")
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = MD.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


class _Picked(Exception):
    pass


def _ref_pick(jeng, kv_lens):
    """The stages the reference's step() hands its ladder for live slots
    at these kv lengths (the round is not run)."""
    def ladder(phase, rnd, stages, runner, n_affected):
        raise _Picked(stages[0])

    jeng.slot_req = [None] * jeng.B
    pos = np.zeros(jeng.B, np.int32)
    for s, kl in enumerate(kv_lens):
        if kl:
            jeng.slot_req[s] = JE.Request(s, np.ones(1, np.int32), 4)
            pos[s] = kl - 1
    jeng.pos = jnp.asarray(pos)
    jeng._run_ladder = ladder
    with pytest.raises(_Picked) as got:
        jeng.step()
    return str(got.value)


def _port_pick(teng, kv_lens):
    """The mode the port's step() runs its round in (not run)."""
    def round_(live, kls, rnd, mode):
        raise _Picked(mode)

    teng.slot_req = [None] * teng.B
    pos = np.zeros(teng.B, np.int32)
    for s, kl in enumerate(kv_lens):
        if kl:
            teng.slot_req[s] = E.Request(s, np.ones(1, np.int32), 4)
            pos[s] = kl - 1
    teng.pos = torch.as_tensor(pos)
    teng._decode_round = round_
    with pytest.raises(E.EngineStepError) as got:
        teng.step()
    assert isinstance(got.value.cause, _Picked)
    return str(got.value.cause)


@pytest.mark.parametrize("slots", [2, 3, 4])
@pytest.mark.parametrize("block", [4, 8, 16])
def test_decision_rule_equals_the_reference(pair, slots, block):
    """Seeded kv lengths (some slots retired) at B 2 / 3 / 4 and decode
    blocks 4 / 8 / 16: the port's round mode equals the stage the
    reference's step() picks."""
    jcfg, tcfg, jparams, tparams = pair
    kw = dict(SMALL, slots=slots, max_len=64, decode_block=block)
    jeng = JE.Engine(jparams, jcfg, **REF, **kw)
    teng = E.Engine(tparams, tcfg, **PORT, **kw)
    rng = np.random.default_rng(slots * 100 + block)
    seen = set()
    for _ in range(60):
        kv = rng.integers(1, 65, size=slots) * (rng.random(slots) < 0.7)
        if not kv.any():
            kv[rng.integers(slots)] = rng.integers(1, 65)
        want = _ref_pick(jeng, list(kv))
        assert _port_pick(teng, list(kv)) == want, (list(kv), block)
        seen.add(want)
    # a lone live slot goes packed iff the ratio < B: at 2.3 and B 2
    # never, and B 2 is never packed at all (2.3 * sum >= 2 * max)
    if slots == 2:
        assert seen == {"lockstep"}
    else:
        assert seen == {"packed", "lockstep"}
    for name in ("decode_rounds", "decode_tiles_packed",
                 "decode_tiles_padded"):
        assert teng.stats[name] == jeng.stats[name], name


def _run_pair(pair, prompts, max_news, **kw):
    """Both engines on the same prompts; each round's mode recorded."""
    jcfg, tcfg, jparams, tparams = pair
    jeng = JE.Engine(jparams, jcfg, **REF, **dict(SMALL, **kw))
    teng = E.Engine(tparams, tcfg, **PORT, **dict(SMALL, **kw))
    modes = {"ref": [], "port": []}
    j_stage, t_round = jeng._decode_stage, teng._decode_round

    def j_rec(stage, rnd, live, kv_lens):
        modes["ref"].append(stage)
        return j_stage(stage, rnd, live, kv_lens)

    def t_rec(live, kv_lens, rnd, mode):
        modes["port"].append(mode)
        return t_round(live, kv_lens, rnd, mode)

    jeng._decode_stage, teng._decode_round = j_rec, t_rec
    for eng in (jeng, teng):
        for uid, (p, mn) in enumerate(zip(prompts, max_news)):
            eng.submit(p, max_new=mn, uid=uid)
    with OBS.capture() as launches:
        got = teng.run()
    want = jeng.run()
    assert got == want
    assert modes["port"] == modes["ref"]
    for name in COUNTERS:
        assert teng.stats[name] == jeng.stats[name], name
    st = teng.stats
    assert st["decode_packed_launches"] + st["decode_lockstep_launches"] \
        == st["decode_rounds"] == len(modes["port"])
    # a lockstep round runs the full-cache einsum: no packed decode launch
    decode = [m for m, _ in launches if m.name == "tri_attn.packed_decode_fwd"]
    assert len(decode) == tcfg.n_layers * st["decode_packed_launches"]
    return teng, modes["port"]


def test_reference_auto_cases(pair):
    """tests/test_decode_packed.py::test_engine_auto_mode_prefers_lockstep_
    when_uniform on both engines: same prompts (its rng), same rounds."""
    jcfg = pair[0]
    rng = np.random.default_rng(5)
    uniform = [rng.integers(1, jcfg.vocab_size, size=7).astype(np.int32)
               for _ in range(2)]
    eng, modes = _run_pair(pair, uniform, [4, 4])
    assert eng.stats["decode_packed_launches"] == 0 and modes
    mild = [rng.integers(1, jcfg.vocab_size, size=s).astype(np.int32)
            for s in (3, 13)]
    eng, modes = _run_pair(pair, mild, [4, 4])
    assert eng.stats["decode_packed_launches"] == 0
    assert E.PACKED_TILE_COST_RATIO == JE.PACKED_TILE_COST_RATIO == 2.3
    straggler = [rng.integers(1, jcfg.vocab_size, size=s).astype(np.int32)
                 for s in (3, 3, 3, 37)]
    eng, modes = _run_pair(pair, straggler, [4] * 4, slots=4)
    assert eng.stats["decode_packed_launches"] > 0


def test_explicit_modes_match_the_reference(pair):
    """"packed" and "lockstep" stay what they were: every round the one
    mode, tokens equal to the reference's and to auto's."""
    jcfg = pair[0]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, jcfg.vocab_size, size=s).astype(np.int32)
               for s in (21, 3, 9, 30)]
    out = {}
    for mode in ("packed", "lockstep", "auto"):
        eng, modes = _run_pair(pair, prompts, [5, 3, 6, 4], slots=4,
                               decode_mode=mode)
        if mode != "auto":
            assert set(modes) == {mode}
        out[mode] = {r.uid: r.out for r in eng.finished}
    assert out["packed"] == out["lockstep"] == out["auto"]


def test_recurrent_arch_keeps_lockstep():
    """rwkv6 decodes in lockstep whatever is asked, as in the reference."""
    for arch in ("rwkv6-1.6b", "jamba-1.5-large-398b"):
        cfg = REG.smoke_config(arch)
        params = MD.init_params(cfg, seed=0, device="cpu")
        for mode in E.DECODE_MODES:
            eng = E.Engine(params, cfg, slots=2, max_len=32, decode_mode=mode,
                           **PORT)
            assert eng.decode_mode == "lockstep", (arch, mode)


def test_auto_with_the_kernels_is_not_refused(pair):
    """An explicit lockstep with decode_impl "cuda" is refused (it runs the
    plain version every round); auto with "cuda" passes the mode check
    (here it then stops at the device check: no card on this path)."""
    tcfg, tparams = pair[1], pair[3]
    kw = dict(prefill_impl="torch", decode_impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="plain version"):
        E.Engine(tparams, tcfg, decode_mode="lockstep", **kw)
    with pytest.raises(ValueError, match="needs device='cuda'"):
        E.Engine(tparams, tcfg, decode_mode="auto", **kw)
    assert E.Engine(tparams, tcfg, **PORT).decode_mode == "auto"
    with pytest.raises(ValueError, match="decode_mode"):
        E.Engine(tparams, tcfg, decode_mode="fused", **PORT)


def test_decode_span_names_the_mode_that_ran(pair, tmp_path):
    tcfg, tparams = pair[1], pair[3]
    path = SK.enable(str(tmp_path))
    try:
        eng = E.Engine(tparams, tcfg, **PORT, **dict(SMALL, slots=4))
        for uid, s in enumerate((3, 30, 4, 3, 22, 5, 7, 2)):
            eng.submit(np.arange(1, s + 1, dtype=np.int32), max_new=6,
                       uid=uid)
        eng.run()
    finally:
        SK.disable()
    with open(path) as f:
        spans = [ev["attrs"]["mode"] for ev in map(json.loads, f)
                 if ev.get("name") == "engine.decode_round"]
    st = eng.stats
    assert spans.count("packed") == st["decode_packed_launches"] > 0
    assert spans.count("lockstep") == st["decode_lockstep_launches"] > 0




STRAGGLER = (3, 3, 3, 37)  # tiles [1, 1, 1, 5] at blk 8: packed rounds


def _auto_engine(tparams, tcfg, prompts, **kw):
    eng = E.Engine(tparams, tcfg, **PORT, **dict(SMALL, slots=4, **kw))
    for uid, p in enumerate(prompts):
        eng.submit(p, max_new=6, uid=uid)
    return eng


def _prompts(tcfg, seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, tcfg.vocab_size, size=s).astype(np.int32)
            for s in lens]


def test_failing_packed_round_raises_without_a_lockstep_rung(pair,
                                                             monkeypatch):
    """The first round the rule sends packed fails (the packed decode op
    raises): run() raises EngineStepError from the decode phase, and no
    round re-runs it lockstep, degrades or retries (the reference's
    packed -> lockstep rung is not ported)."""
    tcfg, tparams = pair[1], pair[3]
    modes = []
    picked = E.Engine._round_mode

    def spy(self, tiles):
        modes.append(picked(self, tiles))
        return modes[-1]

    def boom(*a, **k):
        raise RuntimeError("packed decode launch failed")

    monkeypatch.setattr(E.Engine, "_round_mode", spy)
    monkeypatch.setattr(SC, "packed_decode_torch", boom)
    eng = _auto_engine(tparams, tcfg, _prompts(tcfg, 3, STRAGGLER))
    with pytest.raises(E.EngineStepError,
                       match="packed decode launch failed") as info:
        eng.run()
    assert info.value.phase == "decode"
    assert modes and modes[-1] == "packed"
    st = eng.stats
    assert st["decode_packed_launches"] == 0
    assert st["decode_lockstep_launches"] == modes.count("lockstep")
    assert st["launches_degraded_total"] == st["requests_retried_total"] \
        == st["requests_failed_total"] == 0


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_auto_engine_survives_snapshot_file_and_restore(pair, tmp_path,
                                                        step_mode):
    """An auto engine (either step mode) snapshotted mid-decode, written by
    to_dir, read by from_dir and restored comes back in decode_mode "auto"
    and finishes with the uninterrupted run's tokens and round modes."""
    tcfg, tparams = pair[1], pair[3]
    prompts = _prompts(tcfg, 13, (3, 35, 4, 3, 20, 9))
    base = _auto_engine(tparams, tcfg, prompts, step_mode=step_mode)
    baseline = base.run()
    eng = _auto_engine(tparams, tcfg, prompts, step_mode=step_mode)
    for _ in range(6):
        eng.round()
    assert eng.stats["decode_rounds"] > 0
    path = SNAP.to_dir(SNAP.snapshot(eng), str(tmp_path / "snap"))
    restored = E.Engine.restore(SNAP.from_dir(path))
    assert (restored.decode_mode, restored.step_mode) == ("auto", step_mode)
    assert restored.run() == baseline
    # the counters start anew on the restored engine: the rounds before
    # the snapshot and after it add up to the uninterrupted run's
    for name in ("decode_packed_launches", "decode_lockstep_launches"):
        assert eng.stats[name] + restored.stats[name] == base.stats[name] \
            > 0, name


def test_fleet_migration_keeps_auto(pair):
    """A replica killed mid-decode is snapshotted and its requests
    migrate; the restarted replica decodes in "auto" and every stream
    equals a fault-free single auto engine's."""
    tcfg, tparams = pair[1], pair[3]
    prompts = _prompts(tcfg, 17, (30, 3, 3, 3, 28, 4, 3, 3))
    baseline = _auto_engine(tparams, tcfg, prompts).run()
    kill = F.FaultPlan([F.Fault("launch_error", "decode", 2, times=99,
                                engine=0)])
    fleet = FL.Fleet(tparams, tcfg, engines=2, fault_plan=kill,
                     clock=F.VirtualClock(), heartbeat_timeout_s=5.0,
                     snapshot_every=0,
                     engine_kw=dict(PORT, **dict(SMALL, slots=4)))
    for uid, p in enumerate(prompts):
        fleet.submit(p, max_new=6, uid=uid)
    results = fleet.run(max_steps=300)
    assert fleet.stats["fleet_failovers_total"] >= 1
    assert all(r["status"] == "done" for r in fleet.report().values())
    assert results == baseline
    live = [e for e in fleet.engines if e is not None]
    assert len(live) == 2 and all(e.decode_mode == "auto" for e in live)
