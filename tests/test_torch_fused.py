"""repro_torch's fused continuous-batching step == the JAX reference's.

The same numpy inputs go through the reference's fused step (the op with
impl="pallas" in interpret mode and impl="scan", the model's fused_step,
the fused Engine with the scan impls) and through the port's plain PyTorch
version on the CPU, at float32 2e-5 (tests/oracles.py) and, for bf16
logits, at test_torch_models' relative tolerance. The port's fused op also
equals its two split ops, its capacity padding is inert, and its fused
engine emits the reference's greedy tokens, equals its split engine,
walks fused -> split only on a poisoned output and raises on anything
else.
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
from repro.obs import metrics as JMET
from repro.serve import decode as JD
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import registry as REG
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.kernels.tri_attn import scan_impl as SC
from repro_torch.models import model as MD
from repro_torch.obs import metrics as MET
from repro_torch.resilience import faults as F
from repro_torch.serve import decode as D
from repro_torch.serve import engine as E
from repro_torch.serve.engine import Engine

torch.set_num_threads(2)

TOL = O.tol("attn", jnp.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _round(g, blk, kv_lens, slots, *, b=4, hkv=2, d=16, seed=0):
    """One fused round's inputs for both packages: ltm, band and prefix
    prefill members, the given live decode slots over S_cache = 8 * blk."""
    h, s_cache = g * hkv, 8 * blk
    lens = [3 * blk, 2 * blk, 2 * blk]
    window, prefix = [None, blk + 1, None], [0, 0, blk // 2 + 1]
    jps = JOPS.make_packed_sched(lens, block=blk, window=window,
                                 prefix=prefix)
    tps = OPS.make_packed_sched(lens, block=blk, window=window,
                                prefix=prefix)
    n_members = len(lens) + b + 1
    kw = dict(blk=blk, n_members=n_members, n_slots=b, s_cache=s_cache)
    jtbl, jneeded = JOPS.make_fused_table(jps, kv_lens, slots, **dict(
        kw, s_cache=s_cache if kv_lens else 0))
    tbl, needed = OPS.make_fused_table(tps, kv_lens, slots, **kw)
    assert needed == jneeded and tbl.tobytes() == jtbl.tobytes()
    rng = np.random.default_rng(seed)
    s = tps.s_total
    arrs = [rng.standard_normal(shape, np.float32) for shape in (
        (1, h, s, d), (1, hkv, s, d), (1, hkv, s, d), (b, h, d),
        (b, s_cache, hkv, d), (b, s_cache, hkv, d))]
    n_dec = needed - tps.steps
    capacity = tps.steps + (JD.round_capacity(n_dec) if kv_lens else 0)
    return (jps, tps, [jnp.asarray(a) for a in arrs] + [jnp.asarray(jtbl)],
            [torch.as_tensor(a) for a in arrs] + [torch.as_tensor(tbl)],
            n_members, capacity, needed)


def _counters(reg, impl):
    labels = {"name": "tri_attn.fused_step_fwd", "impl": impl}
    return {c: reg.counter_value(c, labels)
            for c in ("launches_total", "tiles_launched_total",
                      "tiles_domain_total", "tiles_bb_total")}


@pytest.mark.parametrize("g,blk,kv_lens,slots", [
    (1, 4, [13, 3, 30], [0, 2, 3]),      # skewed, slot 1 retired
    (2, 8, [61, 9], [3, 1]),             # two live slots, out of order
    (2, 4, [32], [2]),                   # one live slot
    (1, 8, [], []),                      # no live slot: the first admit
])
def test_fused_step_matches_reference(g, blk, kv_lens, slots):
    jps, tps, jin, tin, n_members, capacity, needed = _round(
        g, blk, kv_lens, slots)
    jreg, treg = JMET.Registry(), MET.Registry()
    wants = {}
    with JMET.scope(jreg):
        for impl in ("pallas", "scan"):
            spec = JOPS.FusedStepSpec(n_members=n_members, capacity=capacity,
                                      blk=blk, impl=impl)
            wants[impl] = JOPS.fused_step_attention(*jin, jps, spec)
    spec = OPS.FusedStepSpec(n_members=n_members, capacity=capacity,
                             blk=blk, impl="torch", tiles=needed)
    with MET.scope(treg):
        got_p, got_d = OPS.fused_step_attention(*tin, tps, spec)
    for impl, (want_p, want_d) in wants.items():
        np.testing.assert_allclose(_np(got_p), _np(want_p), err_msg=impl,
                                   **TOL)
        np.testing.assert_allclose(_np(got_d), _np(want_d), err_msg=impl,
                                   **TOL)
    for slot in set(range(4)) - set(slots):
        assert torch.count_nonzero(got_d[slot]) == 0
    ref_p, ref_d = OPS.fused_step_attention(
        *tin, tps, dataclasses.replace(spec, impl="ref"))
    np.testing.assert_allclose(_np(got_p), _np(ref_p), **TOL)
    np.testing.assert_allclose(_np(got_d), _np(ref_d), **TOL)
    # telemetry: the reference's grid walks the bucketed capacity, the
    # port's the live tiles; the BB bounds agree
    jc, tc = _counters(jreg, "scan"), _counters(treg, "torch")
    h = tin[0].shape[1]
    assert jc["tiles_launched_total"] == capacity * h
    assert tc["tiles_launched_total"] == tc["tiles_domain_total"] \
        == needed * h
    assert jc["tiles_bb_total"] == tc["tiles_bb_total"]


def test_fused_op_equals_the_split_ops():
    """The fused op's pack half is packed_prefill_attention and its decode
    half packed_decode_attention, on the same tensors: bitwise."""
    kv_lens, slots = [13, 3, 30], [0, 2, 3]
    _, tps, _, tin, n_members, capacity, needed = _round(2, 4, kv_lens,
                                                         slots)
    qp, kp, vp, qd, kc, vc, tbl = tin
    spec = OPS.FusedStepSpec(n_members, capacity, 4, "torch", needed)
    got_p, got_d = OPS.fused_step_attention(*tin, tps, spec)
    want_p = OPS.packed_prefill_attention(qp, kp, vp, tps, impl="torch")
    dtbl, dneeded = OPS.make_decode_table(kv_lens, slots, blk=4,
                                          n_members=5, n_slots=4,
                                          s_cache=kc.shape[1])
    want_d = OPS.packed_decode_attention(
        qd, kc, vc, torch.as_tensor(dtbl),
        OPS.DecodeRoundSpec(5, JD.round_capacity(dneeded), 4, "torch",
                            dneeded))
    assert torch.equal(got_p, want_p)
    assert torch.equal(got_d, want_d)
    # the kernel wrapper's CPU path returns the kernel's (B + 1)-row layout
    o_pack, o_dec = K.fused_step_fwd(*tin, psched=tps, capacity=capacity,
                                     tiles=needed)
    assert o_dec.shape == (5,) + tuple(qd.shape[1:])
    assert torch.equal(o_pack, got_p) and torch.equal(o_dec[:4], got_d)


def test_fused_capacity_padding_is_inert():
    """Within one impl, a larger capacity bucket leaves the outputs
    bitwise unchanged; across impls they agree at the tolerance (the
    reference's test compares pallas and scan bitwise, which fails)."""
    _, tps, _, tin, n_members, _, needed = _round(1, 4, [13, 3, 30],
                                                  [0, 2, 3])
    outs = {}
    for impl in ("torch", "ref"):
        runs = [OPS.fused_step_attention(*tin, tps, OPS.FusedStepSpec(
            n_members, needed + extra, 4, impl, needed))
            for extra in (0, 5, 3 * needed)]
        for o_p, o_d in runs[1:]:
            assert torch.equal(o_p, runs[0][0]) and \
                torch.equal(o_d, runs[0][1])
        outs[impl] = runs[0]
    for a, b in zip(outs["torch"], outs["ref"]):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_cuda_impl_on_cpu_tensors_raises():
    _, tps, _, tin, n_members, capacity, needed = _round(1, 4, [5], [0])
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        OPS.fused_step_attention(*tin, tps, OPS.FusedStepSpec(
            n_members, capacity, 4, "cuda", needed))


def _pair(dtype="float32", n_kv_heads=2):
    jcfg = dataclasses.replace(JREG.smoke_config("yi-9b"), dtype=dtype,
                               n_kv_heads=n_kv_heads)
    tcfg = dataclasses.replace(REG.smoke_config("yi-9b"), dtype=dtype,
                               n_kv_heads=n_kv_heads)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = MD.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


def _close_logits(got, want, dtype):
    """test_torch_models' tolerance: bf16's absolute part relative to the
    largest magnitude (XLA fuses elementwise chains with excess
    precision)."""
    got, want = _np(got), _np(want)
    tol = O.tol("attn", jnp.dtype(dtype))
    if dtype == "bfloat16":
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_fused_step_matches_reference(dtype):
    """model.fused_step over a cache filled by earlier decode steps: admit
    and decode logits, the pack's k/v states and the written cache."""
    jcfg, tcfg, jparams, tparams = _pair(dtype)
    b, max_len, blk = 3, 32, 8
    rng = np.random.default_rng(2)
    jcache = JMD.init_cache(jcfg, b, max_len, jnp.float32)
    tcache = MD.init_cache(tcfg, b, max_len, torch.float32, device="cpu")
    jdecode = jax.jit(lambda c, t, pos: JMD.decode_step(jparams, jcfg, c, t,
                                                        pos))
    for t in range(9):
        toks = rng.integers(1, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
        _, jcache = jdecode(jcache, jnp.asarray(toks), jnp.int32(t))
        MD.decode_step(tparams, tcfg, tcache, torch.as_tensor(toks).long(),
                       t)
    prompts = [rng.integers(1, jcfg.vocab_size, size=s).astype(np.int32)
               for s in (11, 3)]
    live, pos = [0, 2], np.array([8, 0, 8], np.int32)
    kv_lens = [int(pos[s]) + 1 for s in live]
    toks = rng.integers(1, jcfg.vocab_size, size=(b, 1)).astype(np.int32)
    jla, jld, jcache, jst, *_ = JD.fused_step(
        jparams, jcfg, jcache, prompts, jnp.asarray(toks), jnp.asarray(pos),
        kv_lens, live, block=blk, impl="scan")
    tla, tld, tcache, tst, tps, starts, lens, info = D.fused_step(
        tparams, tcfg, tcache, prompts, torch.as_tensor(toks).long(),
        torch.as_tensor(pos), kv_lens, live, block=blk, impl="torch")
    _close_logits(tla, jla, dtype)
    _close_logits(tld[live], np.asarray(jld)[live], dtype)
    for kv in ("k", "v"):
        _close_logits(tst["l0"][kv], jst["l0"][kv], dtype)
        _close_logits(tcache["l0"][kv], jcache["l0"][kv], dtype)
    assert info["tiles"] == tps.steps + sum(-(-k // blk) for k in kv_lens)
    assert (starts, lens) == ([0, 16], [11, 3])


SHARED = dict(slots=2, max_len=48, temperature=0.0, prefill_block=8,
              decode_mode="packed", decode_block=8)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return ([rng.integers(1, vocab, size=s).astype(np.int32)
             for s in (11, 2, 19, 5, 30)], [6, 9, 4, 7, 5])


@pytest.mark.parametrize("n_kv_heads", [4, 2])  # g = 1, g = 2
def test_fused_engine_tokens_identical_to_reference(n_kv_heads):
    """More requests than slots and staggered budgets, so admit rounds
    carry live decode slots: the port's fused engine emits the reference
    fused engine's greedy tokens with the same round accounting, and the
    port's split engine's tokens."""
    jcfg, tcfg, jparams, tparams = _pair(n_kv_heads=n_kv_heads)
    prompts, max_news = _prompts(jcfg.vocab_size)
    jeng = JEngine(jparams, jcfg, prefill_impl="scan", decode_impl="scan",
                   step_mode="fused", **SHARED)
    teng = Engine(tparams, tcfg, prefill_impl="torch", decode_impl="torch",
                  step_mode="fused", device="cpu", **SHARED)
    split = Engine(tparams, tcfg, prefill_impl="torch", decode_impl="torch",
                   device="cpu", **SHARED)
    for eng in (jeng, teng, split):
        for uid, (p, mn) in enumerate(zip(prompts, max_news)):
            eng.submit(p, max_new=mn, uid=uid)
    want, got = jeng.run(), teng.run()
    assert got == want == split.run()
    st = teng.stats
    for name in ("admit_rounds", "decode_rounds", "fused_rounds",
                 "fused_launches", "fused_tiles", "decode_packed_launches",
                 "prefill_requests", "prefill_tokens"):
        assert st[name] == jeng.stats[name], name
    assert st["decode_rounds"] - st["decode_packed_launches"] >= 2  # mixed
    assert st["fused_fallbacks"] == st["launches_degraded_total"] == 0
    assert {u: r["status"] for u, r in teng.report().items()} == \
        {u: "done" for u in range(len(prompts))}


def _smoke_run(**kw):
    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device="cpu")
    eng = Engine(params, cfg, prefill_impl="torch", decode_impl="torch",
                 device="cpu", step_mode="fused", **dict(SHARED, **kw))
    prompts, max_news = _prompts(cfg.vocab_size)
    for uid, (p, mn) in enumerate(zip(prompts[:4], max_news)):
        eng.submit(p, max_new=mn, uid=uid)
    return eng


def test_poisoned_fused_round_walks_to_split_once():
    want = _smoke_run().run()
    plan = F.FaultPlan([F.Fault("poison", "admit", 1)])
    eng = _smoke_run(fault_plan=plan)
    assert eng.run() == want
    st = eng.stats
    assert st["fused_fallbacks"] == st["launches_degraded_total"] == 1
    assert st["prefill_launches"] == 1  # the split rung's packed admit
    assert st["requests_failed_total"] == 0


@pytest.mark.parametrize("fault,cause", [
    ("op", RuntimeError),
    (F.Fault("launch_error", "admit", 0), F.InjectedLaunchError),
    (F.Fault("admit_oom", "admit", 1), F.InjectedOOM)])
def test_fused_round_error_raises_without_split_fallback(monkeypatch, fault,
                                                         cause):
    """An exception inside the fused step other than a poisoned output —
    a failing op, an injected fault in the first (no live slot) or a later
    (live slots) fused round — leaves run() as EngineStepError; the
    round's admits go back to the queue and no split rung runs."""
    plan = None
    if fault == "op":
        def boom(*a, **k):
            raise RuntimeError("launch failed")

        monkeypatch.setattr(SC, "fused_step_torch", boom)
    else:
        plan = F.FaultPlan([fault])
    eng = _smoke_run(fault_plan=plan)
    with pytest.raises(E.EngineStepError) as info:
        eng.run()
    assert info.value.phase == "fused"
    assert type(info.value.cause) is cause
    st = eng.stats
    assert st["fused_fallbacks"] == st["launches_degraded_total"] == \
        st["prefill_launches"] == 0
    report = eng.report()
    assert sorted(report) == [0, 1, 2, 3]
    assert sum(r["status"] == "queued" for r in report.values()) >= 1


def test_launch_hook_fault_strikes_at_the_launch_site():
    """A phase="launch" fault raises where the launch is recorded, before
    the kernel or its plain version runs: the first fused launch here."""
    plan = F.FaultPlan([F.Fault("launch_error", "launch", 0)])
    eng = _smoke_run()
    with F.install_launch_hook(plan):
        with pytest.raises(E.EngineStepError, match="launch #0") as info:
            eng.run()
    assert isinstance(info.value.cause, F.InjectedLaunchError)
    assert eng.run() == _smoke_run().run()  # the hook is gone again
