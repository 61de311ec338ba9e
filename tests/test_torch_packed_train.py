"""repro_torch packed ragged-document training == the JAX package.

The counterpart of tests/test_packed_backward.py for the port:

  * kernel level: the port's packed dq and dk/dv (their plain versions,
    what the kernel wrappers run on CPU tensors) against the reference's
    ``packed_bwd`` Pallas kernels in interpret mode on the reference's
    member zoo (ltm + prefix + band in one launch), g = 1 and 2, float32
    and bfloat16; grads through ``packed_prefill_attention`` against the
    f64 oracle; a packed grad is exactly three launches with the
    reference's tile counts, and no autograd through the forward;
  * property (hypothesis): packed grads equal per-document
    ``triangular_attention`` grads for random member mixes;
  * data: ``pack_documents`` and ``PackedDocsLM`` give the reference's
    bins and batches bit for bit;
  * train: ``loss_fn(packed=)`` and its grads equal the reference's and
    the pad-to-max batch's, and three ``make_train_step(packed=)`` steps
    from a ``state_from_jax`` state match the reference's.
Tolerances come from tests/oracles.py; the port runs its plain versions
(impl 'torch'), the reference its Pallas kernels (interpret) or scan.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import oracles as O
from repro.configs import registry as JREG
from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro.models import model as JMD
from repro.obs import launch as JOBS
from repro.obs import metrics as JMET
from repro.train import data as JDATA
from repro.train import optimizer as JOPT
from repro.train import train_step as JTS
from repro_torch.configs import registry as REG
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.models import model as MD
from repro_torch.obs import launch as OBS
from repro_torch.obs import metrics as MET
from repro_torch.train import data as DATA
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

torch.set_num_threads(2)

# the reference's mixed member zoo: ltm + prefix + band in one launch
LENS = (32, 8, 16)
WINDOWS = (None, None, 8)
PREFIXES = (0, 4, 0)
BLK = 8
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the documents of the reference's packed-equals-padded test
DOCS = (13, 3, 7)
DOC_BLOCK = 4
NAMES = ("tri_attn.packed_fwd", "tri_attn.packed_bwd_dq",
         "tri_attn.packed_bwd_dkv")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _zoo_scheds(lens=LENS, blk=BLK, windows=WINDOWS, prefixes=PREFIXES):
    kw = dict(block=blk, window=list(windows), prefix=list(prefixes))
    return JOPS.make_packed_sched(lens, **kw), OPS.make_packed_sched(lens,
                                                                     **kw)


def _inputs(seed, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for shape in
            ((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d), (1, h, s, d))]


def _close_grad(got, want, dtype, msg=""):
    """float32: the oracles' attn_grad tolerance. bfloat16: the bf16 attn
    tolerance with its absolute part taken relative to the largest
    magnitude, since each grad sums many bf16-rounded terms (as in
    tests/test_torch_tri_attn_train.py)."""
    if dtype == "float32":
        tol = O.tol("attn_grad", jnp.float32)
    else:
        tol = O.tol("attn", jnp.bfloat16)
        tol["atol"] *= max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, err_msg=msg, **tol)


def _counters(reg, name, impl):
    return {c: reg.counter_value(c, {"name": name, "impl": impl})
            for c in ("launches_total", "tiles_launched_total",
                      "tiles_domain_total", "tiles_bb_total")}


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
def test_packed_bwd_matches_reference_kernels(g, dtype):
    """The port's packed dq and dk/dv against the reference's packed_bwd
    Pallas kernels (interpret mode) on the same q, k, v, do and the same
    forward out and lse (the reference's packed_fwd)."""
    hkv, d = 2, 16
    h = g * hkv
    jps, tps = _zoo_scheds()
    q, k, v, do = _inputs(7 * g, h, hkv, tps.s_total, d)
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    out, lse = JK.packed_fwd(jq, jk, jv, jps, interpret=True)
    want = JK.packed_bwd(jq, jk, jv, out, lse, jdo, jps, interpret=True)
    tq, tk, tv, tdo = (torch.as_tensor(x).to(tdt) for x in (q, k, v, do))
    tout = torch.as_tensor(np.array(out, np.float32)).to(tdt)
    tlse = torch.as_tensor(np.array(lse, np.float32))
    got = K.packed_bwd(tq, tk, tv, tout, tlse, tdo, tps)
    delta = (tdo.float() * tout.float()).sum(dim=-1)
    assert torch.equal(K.packed_bwd_dq(tq, tk, tv, tdo, tlse, delta, tps),
                       got[0])
    for x, w, ref, name in zip(got, want, (tq, tk, tv), "qkv"):
        assert x.dtype == ref.dtype and x.shape == ref.shape, name
        _close_grad(_np(x), _np(w), dtype, f"d{name}")


@pytest.mark.parametrize("impl", ["torch", "ref"])
def test_packed_grads_match_f64_oracle(impl):
    """Grads through packed_prefill_attention against the f64 oracle (the
    reference's test_packed_grad_matches_f64_oracle, same inputs)."""
    s = sum(LENS)
    q, k, v = (np.asarray(x) for x in O.rand_qkv(0, 1, 4, 2, s, 16))
    do = np.asarray(jax.random.normal(jax.random.PRNGKey(9), q.shape,
                                      jnp.float32))
    _, tps = _zoo_scheds()
    leaves = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
    out = OPS.packed_prefill_attention(*leaves, tps, impl=impl)
    out.backward(torch.as_tensor(do))
    want = O.packed_attention_grad_oracle(q, k, v, do, LENS,
                                          windows=WINDOWS, prefixes=PREFIXES)
    for leaf, w, name in zip(leaves, want, "qkv"):
        O.assert_close(_np(leaf.grad), w, "attn_grad",
                       err_msg=f"d{name} {impl}")


def test_packed_grad_is_three_launches_with_reference_tiles():
    """A packed grad records exactly the forward, dq and dk/dv launches
    (the counterpart of test_pallas_grad_runs_packed_bwd_not_fallback),
    its graph is one custom node straight onto the leaves (no autograd
    through the forward), and the tile counters equal the reference's
    scan path; the CUDA launches' metas carry the reference's Pallas
    numbers."""
    hkv, d, g = 2, 16, 2
    h = g * hkv
    jps, tps = _zoo_scheds()
    q, k, v, do = _inputs(3, h, hkv, tps.s_total, d)
    jreg, treg = JMET.Registry("jax"), MET.Registry("torch")
    with JMET.scope(jreg):
        jax.grad(lambda q_, k_, v_: jnp.sum(JOPS.packed_prefill_attention(
            q_, k_, v_, jps, impl="scan") * do), argnums=(0, 1, 2))(
            *(jnp.asarray(x) for x in (q, k, v)))
    with MET.scope(treg):
        leaves = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
        out = OPS.packed_prefill_attention(*leaves, tps, impl="torch")
        nexts = [type(f).__name__ for f, _ in out.grad_fn.next_functions]
        assert nexts == ["AccumulateGrad"] * 3, nexts
        out.backward(torch.as_tensor(do))
    assert all(leaf.grad is not None for leaf in leaves)
    total = treg.counter_total("launches_total")
    assert total == 3, total
    for name in NAMES:
        want = _counters(jreg, name, "scan")
        assert want["launches_total"] == 1 and \
            want["tiles_domain_total"] == tps.steps * h, (name, want)
        assert _counters(treg, name, "torch") == want, name
        got = OBS.meta_from_packed(name, tps, impl="cuda", cells=h)
        ref = JOBS.meta_from_packed(name, jps, impl="pallas", cells=h)
        assert (got.tiles_launched, got.tiles_domain, got.tiles_bb,
                got.kind, got.block_shape) == \
            (ref.tiles_launched, ref.tiles_domain, ref.tiles_bb, ref.kind,
             ref.block_shape)


def test_packed_forward_without_grad_saves_nothing():
    """Serving's path: operands that need no grad give an output with no
    graph (nothing saved for a backward) and one forward launch."""
    _, tps = _zoo_scheds()
    q, k, v, _ = _inputs(4, 2, 1, tps.s_total, 16)
    reg = MET.Registry("serve")
    with MET.scope(reg):
        out = OPS.packed_prefill_attention(*(torch.as_tensor(x)
                                             for x in (q, k, v)), tps,
                                           impl="torch")
    assert out.grad_fn is None and not out.requires_grad
    assert reg.counter_total("launches_total") == 1


def test_packed_cuda_impl_refuses_cpu_tensors():
    _, tps = _zoo_scheds()
    q = torch.zeros((1, 2, tps.s_total, 16), requires_grad=True)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        OPS.packed_prefill_attention(q, q, q, tps, impl="cuda")


@given(st.data())
@settings(max_examples=6, deadline=None)
def test_property_packed_grads_equal_per_document(data):
    """Random member mixes (ltm / band / prefix, random tile counts): the
    one packed backward equals the per-document backward of
    triangular_attention (same schedules, same op order per member)."""
    r = data.draw(st.integers(min_value=1, max_value=4))
    blk = 4 * data.draw(st.integers(min_value=1, max_value=2))
    lens, wins, pres = [], [], []
    for _ in range(r):
        n = data.draw(st.integers(min_value=1, max_value=4))
        kind = data.draw(st.sampled_from(["ltm", "band", "prefix"]))
        lens.append(n * blk)
        wins.append(data.draw(st.integers(1, n * blk))
                    if kind == "band" else None)
        pres.append(data.draw(st.integers(1, n * blk))
                    if kind == "prefix" and n > 1 else 0)
    q, k, v, do = _inputs(data.draw(st.integers(0, 99)), 2, 1, sum(lens), 8)
    psched = OPS.make_packed_sched(lens, block=blk, window=wins,
                                   prefix=pres)
    leaves = [torch.as_tensor(x).requires_grad_() for x in (q, k, v)]
    OPS.packed_prefill_attention(*leaves, psched, impl="torch").backward(
        torch.as_tensor(do))
    base = 0
    for s_r, w, p in zip(lens, wins, pres):
        seg = slice(base, base + s_r)
        parts = [torch.as_tensor(x[:, :, seg]).requires_grad_()
                 for x in (q, k, v)]
        OPS.triangular_attention(*parts, window=w, prefix=p, impl="torch",
                                 block=blk).backward(
            torch.as_tensor(do[:, :, seg]))
        for leaf, part, nm in zip(leaves, parts, "qkv"):
            O.assert_close(_np(leaf.grad[:, :, seg]), _np(part.grad),
                           "attn_bitwise_pair",
                           err_msg=f"d{nm} {lens} {wins} {pres}")
        base += s_r


# ---------------------------------------------------------------------------
# data level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lens,cap,block", [
    ((13, 3, 7), 16, 4), ((1500, 1000, 600, 370, 250, 100, 60, 40), 4096,
                          64),
    ((5, 9, 2, 30, 17, 8, 8, 1), 32, 8)])
def test_pack_documents_matches_reference(lens, cap, block):
    assert DATA.pack_documents(lens, cap, block=block) == \
        JDATA.pack_documents(lens, cap, block=block)


def test_pack_documents_refuses_oversized_documents():
    with pytest.raises(ValueError, match="padded tokens"):
        DATA.pack_documents([5, 40], 32, block=8)


@given(st.data())
@settings(max_examples=10, deadline=None)
def test_property_pack_documents_ffd(data):
    """Every document placed exactly once, within capacity, in descending
    padded length per bin (the reference's property)."""
    block = 4
    cap = block * data.draw(st.integers(min_value=2, max_value=8))
    n = data.draw(st.integers(min_value=1, max_value=12))
    lens = [data.draw(st.integers(min_value=1, max_value=cap))
            for _ in range(n)]
    bins = DATA.pack_documents(lens, cap, block=block)
    assert bins == JDATA.pack_documents(lens, cap, block=block)
    assert sorted(i for b in bins for i in b) == list(range(n))
    pad = lambda s: -(-s // block) * block
    for b in bins:
        assert sum(pad(lens[i]) for i in b) <= cap
        assert [pad(lens[i]) for i in b] == \
            sorted([pad(lens[i]) for i in b], reverse=True)


@pytest.mark.parametrize("lens,block,seed,step", [
    (DOCS, DOC_BLOCK, 1, 0), ((5, 2, 9), 4, 3, 2),
    ((1500, 1000, 600, 370, 250, 100, 60, 40), 64, 0, 7)])
def test_packed_docs_batches_bitwise(lens, block, seed, step):
    tcfg, jcfg = REG.smoke_config("yi-9b"), JREG.smoke_config("yi-9b")
    got = DATA.PackedDocsLM(tcfg, lens, block=block, seed=seed,
                            device="cpu")
    want = JDATA.PackedDocsLM(jcfg, lens, block=block, seed=seed)
    assert got.member_lens == want.member_lens
    assert got.s_total == want.s_total
    for gb, wb in ((got.batch(step), want.batch(step)),
                   (got.padded_batch(step), want.padded_batch(step))):
        assert gb.keys() == wb.keys()
        for key in wb:
            w = np.asarray(wb[key])
            assert gb[key].numpy().dtype == w.dtype, key
            np.testing.assert_array_equal(gb[key].numpy(), w, err_msg=key)


# ---------------------------------------------------------------------------
# train level
# ---------------------------------------------------------------------------


def _cfgs():
    return (dataclasses.replace(JREG.smoke_config("yi-9b"), dtype="float32"),
            dataclasses.replace(REG.smoke_config("yi-9b"), dtype="float32"))


def _docs(jcfg, tcfg, lens=DOCS, seed=1):
    jd = JDATA.PackedDocsLM(jcfg, lens, block=DOC_BLOCK, seed=seed)
    td = DATA.PackedDocsLM(tcfg, lens, block=DOC_BLOCK, seed=seed,
                           device="cpu")
    kw = dict(block=DOC_BLOCK, window=tcfg.sliding_window)
    return jd, td, JOPS.make_packed_sched(jd.member_lens, **kw), \
        OPS.make_packed_sched(td.member_lens, **kw)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}.{k}")
    elif isinstance(tree, list):
        yield prefix, torch.stack(tree)
    else:
        yield prefix, tree


def _assert_trees_close(got, want, **tol):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    for key in w:
        np.testing.assert_allclose(_np(g[key]), _np(w[key]), err_msg=key,
                                   **tol)


def _port_loss_and_grads(tcfg, params, batch, **kw):
    views = TS.trainable(params)
    loss, met = MD.loss_fn(views, tcfg, batch, attn_impl="torch",
                           aux_weight=0.0, block=DOC_BLOCK, **kw)
    loss.backward()
    return loss, met, TS.grads_of(views)


def test_packed_loss_and_grads_match_reference():
    """float32, smoke size: loss_fn(packed=) and its grads against the
    reference's (its scan impl), from the same weights and documents."""
    jcfg, tcfg = _cfgs()
    jd, td, jps, tps = _docs(jcfg, tcfg)
    jparams = JMD.init_params(jax.random.key(0), jcfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JMD.loss_fn(p, jcfg, jd.batch(0), attn_impl="scan",
                              packed=jps, aux_weight=0.0, block=DOC_BLOCK),
        has_aux=True)(jparams)
    tparams = MD.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg,
                                 device="cpu")
    loss, met, grads = _port_loss_and_grads(tcfg, tparams, td.batch(0),
                                            packed=tps)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]),
                               rtol=1e-5)
    _assert_trees_close(grads, jgrads, **O.tol("attn_grad", jnp.float32))


def test_packed_loss_and_grads_equal_padded():
    """Same documents, two layouts, the port alone: the packed row and
    the pad-to-max batch give the same loss (rtol 1e-6) and parameter
    grads (within 2e-6), the reference's own limits."""
    jcfg, tcfg = _cfgs()
    jd, td, _, tps = _docs(jcfg, tcfg)
    params = MD.params_from_jax(
        jax.tree.map(np.asarray, JMD.init_params(jax.random.key(0), jcfg)),
        tcfg, device="cpu")
    lp, _, gp = _port_loss_and_grads(tcfg, params, td.batch(0), packed=tps)
    ld, _, gd = _port_loss_and_grads(tcfg, params, td.padded_batch(0))
    np.testing.assert_allclose(lp.item(), ld.item(), rtol=1e-6)
    err = max(float((a - b).abs().max()) for (_, a), (_, b) in
              zip(_leaves(gp), _leaves(gd)))
    assert err < 2e-6, err


def test_three_packed_train_steps_match_reference():
    jcfg, tcfg = _cfgs()
    jd, td, jps, tps = _docs(jcfg, tcfg, lens=(21, 6, 11, 3), seed=2)
    opt = OPT.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    jopt = JOPT.OptConfig(**dataclasses.asdict(opt))
    jstate = JTS.init_state(jax.random.key(0), jcfg, jopt)
    tstate = TS.state_from_jax(jax.tree.map(np.asarray, jstate), tcfg,
                               device="cpu")
    jstep = jax.jit(JTS.make_train_step(jcfg, jopt, attn_impl="scan",
                                        block=DOC_BLOCK, packed=jps))
    treg = MET.Registry("packed")
    tstep = TS.make_train_step(tcfg, opt, attn_impl="torch",
                               block=DOC_BLOCK, packed=tps)
    for i in range(3):
        jstate, jm = jstep(jstate, jd.batch(i))
        with MET.scope(treg):
            tstate, tm = tstep(tstate, td.batch(i))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert tstate.step == int(jstate.step) == 3
    _assert_trees_close(tstate.params, jstate.params, atol=2e-5, rtol=2e-4)
    _assert_trees_close(tstate.opt_state, jstate.opt_state, atol=1e-6,
                        rtol=2e-3)
    labels = {"impl": "torch", "packed": "1"}
    assert treg.counter_value("train_step_calls", labels) == 3
    # remat runs each layer's packed forward twice a step
    layers = tcfg.n_layers
    for name, per_step in zip(NAMES, (2 * layers, layers, layers)):
        assert treg.counter_value("launches_total",
                                  {"name": name, "impl": "torch"}) == \
            3 * per_step, name
    assert treg.counter_value("launches_total",
                              {"name": "tri_attn.fwd", "impl": "torch"}) == 0


def test_packed_train_step_refuses_microbatches():
    _, tcfg = _cfgs()
    tps = OPS.make_packed_sched((8, 4), block=DOC_BLOCK)
    with pytest.raises(ValueError, match="microbatches=1"):
        TS.make_train_step(tcfg, OPT.OptConfig(), microbatches=2,
                           attn_impl="torch", packed=tps)
