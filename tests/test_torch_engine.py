"""repro_torch serving engine == the JAX reference engine, token for token.

Same float32 weights (carried over with params_from_jax), same prompts
(skewed lengths, more requests than slots, mixed max_new so slots retire
mid-round), greedy decoding: the port's Engine on the CPU with the plain
PyTorch impls emits the SAME token streams as the reference's
Engine(prefill_impl="scan", decode_mode="packed"), with equal launch and
tile counters, for GQA groups g = 1 and g = 2.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import model as JMD
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import registry as REG
from repro_torch.kernels.tri_attn import scan_impl as SC
from repro_torch.models import model as MD
from repro_torch.resilience import faults as F
from repro_torch.serve import decode as D
from repro_torch.serve import engine as E
from repro_torch.serve.engine import Engine

torch.set_num_threads(2)

SHARED = dict(slots=2, max_len=48, temperature=0.0, prefill_block=8,
              decode_mode="packed", decode_block=8)


def _pair(n_kv_heads):
    jcfg = dataclasses.replace(JREG.smoke_config("yi-9b"),
                               n_kv_heads=n_kv_heads)
    tcfg = dataclasses.replace(REG.smoke_config("yi-9b"),
                               n_kv_heads=n_kv_heads)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = MD.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("n_kv_heads", [4, 2])  # g = 1, g = 2
def test_engine_tokens_identical_to_reference(n_kv_heads):
    jcfg, tcfg, jparams, tparams = _pair(n_kv_heads)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, jcfg.vocab_size, size=s).astype(np.int32)
               for s in (11, 2, 19, 5, 30)]
    max_news = [6, 9, 4, 7, 5]
    jeng = JEngine(jparams, jcfg, prefill_impl="scan", decode_impl="scan",
                   **SHARED)
    teng = Engine(tparams, tcfg, prefill_impl="torch", decode_impl="torch",
                  device="cpu", **SHARED)
    for eng in (jeng, teng):
        for uid, (p, mn) in enumerate(zip(prompts, max_news)):
            eng.submit(p, max_new=mn, uid=uid)
    want, got = jeng.run(), teng.run()
    assert got == want
    assert all(len(got[u]) == mn for u, mn in enumerate(max_news))
    for name in ("prefill_launches", "prefill_requests", "prefill_tokens",
                 "admit_rounds", "decode_rounds", "decode_packed_launches",
                 "decode_tiles_packed", "decode_tiles_padded",
                 "launches_degraded_total", "requests_failed_total"):
        assert teng.stats[name] == jeng.stats[name], name
    assert teng.stats["admit_order_log"] == jeng.stats["admit_order_log"]
    assert teng.stats["launches_degraded_total"] == 0
    assert {u: r["status"] for u, r in teng.report().items()} == \
        {u: "done" for u in range(len(prompts))}


def test_engine_lockstep_and_sequential_rungs_match_reference():
    """The ladder's lower rungs (lockstep decode, sequential prefill) are
    ported too and emit the reference's tokens."""
    jcfg, tcfg, jparams, tparams = _pair(2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, jcfg.vocab_size, size=s).astype(np.int32)
               for s in (7, 3, 12)]
    kw = dict(SHARED, decode_mode="lockstep", prefill_mode="sequential")
    jeng = JEngine(jparams, jcfg, **kw)
    teng = Engine(tparams, tcfg, prefill_impl="torch", decode_impl="torch",
                  device="cpu", **kw)
    for eng in (jeng, teng):
        for uid, p in enumerate(prompts):
            eng.submit(p, max_new=4, uid=uid)
    assert teng.run() == jeng.run()
    assert teng.stats["decode_lockstep_launches"] == \
        jeng.stats["decode_lockstep_launches"] > 0


def test_no_silent_cpu_fallback():
    """The card is the default: without CUDA the default device raises,
    and the CUDA impls refuse CPU tensors instead of running the plain
    version."""
    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="impl='cuda' needs device='cuda'"):
        Engine(params, cfg, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(params, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        MD.init_params(cfg)


def test_kernel_ladder_holds_no_plain_rung():
    """With impl="cuda" no rung runs the plain version: the admit ladder
    is the packed kernel alone, and the plain-only modes are refused."""
    assert E.admit_ladder("packed", "cuda") == ("packed",)
    assert E.admit_ladder("packed", "torch") == ("packed", "sequential")
    assert E.admit_ladder("sequential", "torch") == ("sequential",)
    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device="cpu")
    for kw in (dict(prefill_mode="sequential", decode_impl="torch"),
               dict(decode_mode="lockstep", prefill_impl="torch")):
        with pytest.raises(ValueError, match="plain version"):
            Engine(params, cfg, device="cpu", **kw)


def _smoke_engine(**kw):
    cfg = REG.smoke_config("yi-9b")
    params = MD.init_params(cfg, seed=0, device="cpu")
    eng = Engine(params, cfg, prefill_impl="torch", decode_impl="torch",
                 device="cpu", **dict(SHARED, **kw))
    rng = np.random.default_rng(5)
    for uid, s in enumerate((9, 4, 14)):
        eng.submit(rng.integers(1, cfg.vocab_size, size=s), max_new=3,
                   uid=uid)
    return eng


@pytest.mark.parametrize("phase,fn", [("admit", "packed_fwd_torch"),
                                      ("decode", "packed_decode_torch")])
def test_launch_error_raises_instead_of_degrading(monkeypatch, phase, fn):
    """An exception inside a round (here the attention op) is neither
    retried nor absorbed by a lower rung: run() raises EngineStepError."""
    def boom(*a, **k):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(SC, fn, boom)
    eng = _smoke_engine()
    with pytest.raises(E.EngineStepError, match="launch failed") as info:
        eng.run()
    assert info.value.phase == phase
    st = eng.stats
    assert st["launches_degraded_total"] == st["requests_retried_total"] \
        == st["requests_failed_total"] == 0


def test_poisoned_admit_walks_the_ladder_to_sequential(monkeypatch):
    """A packed admit whose states stay non-finite is retried, then
    handed to the sequential rung, which emits the same tokens."""
    want = _smoke_engine().run()
    monkeypatch.setattr(D, "states_finite", lambda states: False)
    eng = _smoke_engine(retry=F.RetryPolicy(max_retries=1, base_s=0.0))
    assert eng.run() == want
    st = eng.stats
    assert st["launches_degraded_total"] == st["admit_rounds"] > 0
    assert st["requests_retried_total"] == sum(
        len(r) for r in st["admit_order_log"])
    assert st["requests_failed_total"] == 0
