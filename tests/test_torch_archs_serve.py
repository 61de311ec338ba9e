"""The other seven architectures served, trained and launched by the port
(smoke_config, float32, CPU).

Held to the JAX reference: the engine's greedy tokens, split and fused,
equal the JAX MODEL's per-request greedy decode for granite-moe (MoE, top
2 of 4 experts at smoke size), for mixtral with one prompt of 80 tokens
past its smoke window of 64 (band members in the admission prefill, a
rolling slot cache that wraps) and for granite-34b (gelu, one kv head).
Port alone: one train step of each new arch (finite, params moved, grad
norm above 0), nemotron-4-340b's head dim 192 taken by the engine, the
prefill step, the trainer and the attention ops on the kernels (a head
dim outside the kernels' set still refused up front), and each new arch's
smoke config through the serving and training CLIs.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import model as JMD
from repro_torch.configs import registry as REG
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve as SERVE
from repro_torch.launch import train as TRAIN
from repro_torch.models import model as MD
from repro_torch.serve.engine import Engine
from repro_torch.train import data as DATA
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

torch.set_num_threads(2)

NEW_ARCHS = ("granite-moe-3b-a800m", "mixtral-8x7b", "granite-34b",
             "llama3-405b", "musicgen-large", "internvl2-1b",
             "nemotron-4-340b")
MAX_NEW, MAX_LEN = 5, 96
PROMPTS = {
    "granite-moe-3b-a800m": [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5],
                             [4, 4, 2]],
    # 80 tokens: past the smoke window of 64
    "mixtral-8x7b": [list(np.random.default_rng(2).integers(0, 512, 80)),
                     [5, 3, 9]],
    "granite-34b": [[3, 1, 4, 1, 5], [2, 7, 1], [7]],
}


def _greedy_reference(jcfg, jdecode, prompt):
    """The JAX model's single-sequence greedy decode, token by token."""
    cache = JMD.init_cache(jcfg, 1, MAX_LEN, jnp.float32)
    for t, p in enumerate(prompt):
        logits, cache = jdecode(cache, jnp.array([[p]], jnp.int32),
                                jnp.int32(t))
    out, pos = [], len(prompt) - 1
    nxt = int(jnp.argmax(logits[0, 0, :jcfg.vocab_size]))
    for _ in range(MAX_NEW):
        out.append(nxt)
        pos += 1
        logits, cache = jdecode(cache, jnp.array([[nxt]], jnp.int32),
                                jnp.int32(pos))
        nxt = int(jnp.argmax(logits[0, 0, :jcfg.vocab_size]))
    return out


@pytest.mark.parametrize("arch", sorted(PROMPTS))
def test_engine_tokens_equal_the_jax_models_greedy_decode(arch):
    jcfg, tcfg = JREG.smoke_config(arch), REG.smoke_config(arch)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    tparams = MD.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    jdecode = jax.jit(lambda c, t, p: JMD.decode_step(jparams, jcfg, c, t,
                                                      p))
    prompts = PROMPTS[arch]
    want = {uid: _greedy_reference(jcfg, jdecode, p)
            for uid, p in enumerate(prompts)}
    for step_mode in ("split", "fused"):
        eng = Engine(tparams, tcfg, slots=2, max_len=MAX_LEN,
                     prefill_impl="torch", decode_impl="torch",
                     step_mode=step_mode, device="cpu")
        for uid, p in enumerate(prompts):
            eng.submit(np.asarray(p, np.int32), max_new=MAX_NEW, uid=uid)
        got = eng.run()
        assert got == want, (arch, step_mode)
        assert all(r["status"] == "done" for r in eng.report().values())
        assert eng.stats["launches_degraded_total"] == 0
        if tcfg.sliding_window is not None:  # a rolling slot cache
            assert eng.s_cache == tcfg.sliding_window < len(prompts[0])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_one_train_step(arch):
    """One AdamW step on the arch's SyntheticLM batch ("embeds" for the
    stub frontends): finite loss and params, grad norm above 0, params
    moved."""
    cfg = REG.smoke_config(arch)
    opt = OPT.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    state = TS.init_state(cfg, opt, seed=0, device="cpu")
    before = copy.deepcopy(state.params)
    batch = DATA.SyntheticLM(cfg, ShapeConfig("smoke", 32, 2, "train"),
                             device="cpu").batch(0)
    step = TS.make_train_step(cfg, opt, attn_impl="torch", block=16)
    new_state, metrics = step(state, batch)
    assert new_state.step == 1
    assert bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    moved = []

    def walk(a, b):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k])
            return
        assert bool(torch.isfinite(a.float()).all())
        moved.append(not torch.equal(a, b))

    walk(new_state.params, before)
    assert any(moved)


def test_nemotron_head_dim_is_refused_up_front():
    """At published widths every kernel path takes head dim 192: the
    engine gets past the head-dim check to its device check, the prefill
    step and the trainer build on impl "cuda", and both autograd Functions
    take a D 192 operand that needs a grad (their forward, on a CPU
    tensor, the plain version). A head dim no kernel body has (96, 256)
    is still refused up front by the engine, the prefill step and the
    trainer, naming the dim and the kernels' set; the plain versions are
    not refused."""
    from repro_torch.kernels.tri_attn import kernel as K
    from repro_torch.kernels.tri_attn import ops as OPS

    cfg = REG.get_config("nemotron-4-340b")
    assert cfg.head_dim == 192 and 192 in K.HEAD_DIMS
    opt = OPT.OptConfig(kind="adafactor", lr=1e-3, warmup_steps=1,
                        total_steps=10)
    with pytest.raises(ValueError, match="needs device='cuda'"):
        Engine(None, cfg, slots=2, max_len=64, device="cpu")
    TS.make_prefill_step(cfg, attn_impl="cuda")
    TS.make_train_step(cfg, opt, attn_impl="cuda")
    TS.make_train_step(cfg, opt, attn_impl="torch")
    for d in (96, 256):
        odd = dataclasses.replace(cfg, head_dim=d)
        msg = rf"head dim {d} .*\(16, 32, 64, 128, 192\)"
        with pytest.raises(NotImplementedError, match=msg):
            TS.make_train_step(odd, opt, attn_impl="cuda")
        with pytest.raises(NotImplementedError, match=msg):
            TS.make_prefill_step(odd, attn_impl="cuda")
        with pytest.raises(NotImplementedError, match=msg):
            Engine(None, odd, slots=2, max_len=64, device="cpu")
        TS.make_train_step(odd, opt, attn_impl="torch")
    q = torch.zeros((1, 2, 32, 192), requires_grad=True)
    kv = torch.zeros((1, 1, 32, 192))
    sched = OPS.make_sched(32, block=16)
    psched = OPS.make_packed_sched([16, 16], block=16)
    for fn, s in ((OPS._TriAttention, sched),
                  (OPS._PackedTriAttention, psched)):
        for impl in ("cuda", "torch"):
            out = fn.apply(q, kv, kv, s, 192 ** -0.5, impl)
            assert out.shape == q.shape and out.requires_grad
            out.sum().backward()
            assert q.grad is not None and q.grad.shape == q.shape
            q.grad = None


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_clis_start_each_new_arch(arch, capsys):
    """--arch takes each new arch: its smoke config serves and trains on
    the plain versions."""
    results, eng = SERVE.main(["--arch", arch, "--device", "cpu",
                               "--requests", "3", "--max-new", "3"])
    assert len(results) == 3 and all(len(v) == 3 for v in results.values())
    assert eng.cfg.name == arch
    state, log = TRAIN.main(["--arch", arch, "--device", "cpu", "--steps",
                             "2", "--batch", "2", "--seq", "32"])
    assert state.step == 2 and np.isfinite(log[-1]["loss"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "3/3 requests" in out
