"""Head dim 192 (nemotron-4-340b) on the forward side of the port, against
the reference.

The card runs D 192 on every forward attention body: the tensor-core
forward of ``tri_fwd``, ``packed_fwd`` and the fused step's prefill half
(csrc/attn_mma.cuh: wgmma m64n192k16 for O += P V, three 128-byte atoms a
tile row), and the decode body of ``packed_decode_fwd`` and the fused
step's decode half (csrc/attn_decode.cuh, whose PV items at D 192 lie on
several columns a thread). Here, on the CPU, in plain torch:

- the tensor-core body's numerics (``_tc_tile`` of
  tests/test_torch_tri_fwd_numerics.py: f32 S, the finite MASK_VALUE,
  log2 e after the mask, P in bf16) walking ``tri_fwd``'s rows and
  ``packed_fwd``'s and the fused prefill half's owners at (blk, D) (16,
  192) and (64, 192), against the reference's interpret-mode ``fwd``,
  ``packed_fwd`` and ``fused_step_fwd`` at the bf16 attention tolerance;
- the decode kernels' chunked walk and chunk-order merge (``_chunked`` of
  tests/test_torch_packed_decode_numerics.py) against the reference's
  interpret-mode ``packed_decode_fwd`` at g 1 and 12, members of one chunk
  and of several, at the f32 attention tolerance; a one-chunk member
  bitwise equal to the plain sequential walk, each member alone bitwise
  equal to itself among the round;
- the port's plain versions (what a wrapper runs on a CPU tensor) against
  the reference's kernels at D 192, f32 attention tolerance;
- a narrow D 192 model (2 layers, 2 heads of 192 over 1 kv head) carried
  across by ``params_from_jax``: engine tokens equal to the JAX model's
  greedy decode in split and fused mode, and ``make_prefill_step`` against
  the JAX forward at the f32 policy.

The tolerances are tests/oracles.py's attention policy (f32 2e-5, bf16
2e-2). About 55 s on one worker.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.configs import registry as JREG
from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro.models import model as JMD
from repro_torch.configs import registry as REG
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.kernels.tri_attn import scan_impl as SC
from repro_torch.models import model as MD
from repro_torch.serve.engine import Engine
from repro_torch.train import train_step as TS
from test_torch_archs_serve import _greedy_reference
from test_torch_archs_serve import MAX_LEN, MAX_NEW
from test_torch_packed_bwd_numerics import _zoo
from test_torch_packed_decode_numerics import _chunked, _cols
from test_torch_packed_fwd_numerics import _tc_packed
from test_torch_tri_fwd_numerics import _case, _check, _tc_fwd

torch.set_num_threads(2)

D = 192
GEOMS = [(16, D), (64, D)]  # (blk, D)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# ---------------------------------------------------------------------------
# the tensor-core forward body
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blk,d", GEOMS)
@pytest.mark.parametrize("kind", ["ltm", "prefix", "band_short"])
def test_d192_tensor_core_walk_matches_reference_fwd(kind, blk, d):
    (jq, jk, jv), (q, k, v), jsched, sched = _case(kind, blk, d, 0)
    want = JK.fwd(jq, jk, jv, jsched, interpret=True)
    _check(_tc_fwd(q, k, v, sched, d ** -0.5), want)


@pytest.mark.parametrize("blk,g,hkv", [(16, 1, 2), (64, 12, 1)])
def test_d192_packed_tensor_core_walk_matches_reference(blk, g, hkv):
    """packed_fwd's owners on the 5/2/3/1-tile ltm/prefix/band/3-token
    band zoo, and the fused step's prefill owners (found over the (8, R)
    table's q_off row, live decode members in the table) against the pack
    output of the reference's fused_step_fwd; the two walks bitwise
    equal."""
    jps, tps = _zoo(blk, JOPS.make_packed_sched), _zoo(blk,
                                                       OPS.make_packed_sched)
    b, h, s, s_cache = 3, g * hkv, tps.s_total, 2 * blk
    arrs = _inputs(((1, h, s, D), (1, hkv, s, D), (1, hkv, s, D), (b, h, D),
                    (b, s_cache, hkv, D), (b, s_cache, hkv, D)), blk + g)
    q, k, v = (torch.as_tensor(x).to(torch.bfloat16) for x in arrs[:3])
    scale = D ** -0.5
    want = JK.packed_fwd(*(jnp.asarray(x, jnp.bfloat16) for x in arrs[:3]),
                         jps, interpret=True)
    got = _tc_packed(q, k, v, tps.members, tps.table()[1], scale)
    for x, w, name in zip(got, want, ("out", "lse")):
        assert torch.isfinite(x.float()).all(), name
        O.assert_close(_np(x), _np(w), "attn", jnp.bfloat16, name)

    kv_lens, slots = [2 * blk, 3], [0, 2]
    n_members = len(tps.members) + b + 1
    kw = dict(blk=blk, n_members=n_members, n_slots=b, s_cache=s_cache)
    jtbl, needed = JOPS.make_fused_table(jps, kv_lens, slots, **kw)
    tbl, t_needed = OPS.make_fused_table(tps, kv_lens, slots, **kw)
    assert t_needed == needed > tps.steps
    assert tbl.tobytes() == jtbl.tobytes()
    jin = [jnp.asarray(x, jnp.bfloat16) for x in arrs[:4]] + \
        [jnp.asarray(x) for x in arrs[4:]] + [jnp.asarray(jtbl)]
    spec = JOPS.FusedStepSpec(n_members=n_members, capacity=needed,
                              blk=blk, impl="pallas")
    want_pack, _ = JOPS.fused_step_attention(*jin, jps, spec)
    r_p = len(tps.members)
    fused, _ = _tc_packed(q, k, v, tps.members, tbl[5, :r_p], scale)
    O.assert_close(_np(fused), _np(want_pack), "attn", jnp.bfloat16, "pack")
    assert torch.equal(fused, got[0])


# ---------------------------------------------------------------------------
# the decode body's chunked walk
# ---------------------------------------------------------------------------

DEC_B, DEC_CACHE = 5, 512
# kv_len 1, one chunk exactly, one chunk and a token, the whole cache, and
# a band-limited slot (kv_first 167, off a tile edge); slot 1 retired
DEC_ZOO = dict(kv_lens=[1, K.DECODE_CHUNK, K.DECODE_CHUNK + 1, DEC_CACHE,
                        300],
               slots=[0, 2, 3, 4, 1], window=[None, None, None, None, 133])


def _dec_table(make, blk, **zoo):
    return make(zoo["kv_lens"], zoo["slots"], blk=blk,
                n_members=len(zoo["slots"]) + 2, n_slots=DEC_B,
                s_cache=DEC_CACHE, window=zoo["window"])


@pytest.mark.parametrize("blk,g,hkv", [(16, 1, 2), (64, 12, 1)])
def test_d192_chunked_decode_matches_reference(blk, g, hkv):
    h = g * hkv
    arrs = _inputs(((DEC_B, h, D), (DEC_B, DEC_CACHE, hkv, D),
                    (DEC_B, DEC_CACHE, hkv, D)), blk + g)
    jtbl, needed = _dec_table(JOPS.make_decode_table, blk, **DEC_ZOO)
    tbl, t_needed = _dec_table(OPS.make_decode_table, blk, **DEC_ZOO)
    assert t_needed == needed and tbl.tobytes() == jtbl.tobytes()
    want = np.asarray(JK.packed_decode_fwd(
        *(jnp.asarray(x) for x in arrs), jnp.asarray(jtbl),
        capacity=needed, blk=blk, interpret=True))
    q, k, v = (torch.as_tensor(x) for x in arrs)
    scale = D ** -0.5
    got, _ = _chunked(q, k, v, _cols(tbl, (1, 2, 3, 4)), blk=blk,
                      tiles=needed, scale=scale)
    slots = DEC_ZOO["slots"]
    assert torch.isfinite(got[slots]).all()
    O.assert_close(got[slots].numpy(), want[slots], "attn", jnp.float32,
                   "o_dec")

    ct = K.DECODE_CHUNK // blk
    chunks = {int(tbl[1, c]): -(-int(tbl[2, c]) // ct)
              for c in range(len(slots))}
    assert chunks == {0: 1, 2: 1, 3: 2, 4: DEC_CACHE // K.DECODE_CHUNK,
                      1: 2}
    plain = SC.packed_decode_torch(q, k, v, torch.as_tensor(tbl),
                                   capacity=needed, blk=blk, tiles=needed,
                                   scale=scale)
    for slot, n in chunks.items():
        if n == 1:  # the merge of one chunk is its acc / l
            assert torch.equal(got[slot], plain[slot]), slot
        alone = {key: [val[slots.index(slot)]] for key, val in
                 DEC_ZOO.items()}
        atbl, a_needed = _dec_table(OPS.make_decode_table, blk, **alone)
        one, _ = _chunked(q, k, v, _cols(atbl, (1, 2, 3, 4)), blk=blk,
                          tiles=a_needed, scale=scale)
        assert torch.equal(one[slot], got[slot]), slot


# ---------------------------------------------------------------------------
# the port's plain versions
# ---------------------------------------------------------------------------


def test_d192_plain_versions_match_reference():
    """fwd, fwd_bb, packed_fwd, packed_decode_fwd and fused_step_fwd on CPU
    tensors (their plain versions) against the reference's interpret-mode
    kernels, f32, g 12."""
    blk, g, hkv, n = 16, 12, 1, 3
    h, s = g * hkv, n * blk
    tol = ("attn", jnp.float32)
    q, k, v = _inputs(((1, h, s, D), (1, hkv, s, D), (1, hkv, s, D)), 5)
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    for window, prefix in ((None, 0), (blk + 5, 0), (None, blk + 3)):
        jsched = JOPS.make_sched(s, block_q=blk, block_k=blk, window=window,
                                 prefix=prefix)
        sched = OPS.make_sched(s, block=blk, window=window, prefix=prefix)
        for got, want in zip(K.fwd(tq, tk, tv, sched),
                             JK.fwd(jq, jk, jv, jsched, interpret=True)):
            O.assert_close(_np(got), _np(want), *tol, f"fwd {window} {prefix}")
        if not prefix:
            for got, want in zip(K.fwd_bb(tq, tk, tv, sched),
                                 JK.fwd_bb(jq, jk, jv, jsched,
                                           interpret=True)):
                O.assert_close(_np(got), _np(want), *tol, f"fwd_bb {window}")

    jps = JOPS.make_packed_sched([2 * blk, blk], block=blk,
                                 window=[None, 3], prefix=[0, 0])
    tps = OPS.make_packed_sched([2 * blk, blk], block=blk, window=[None, 3],
                                prefix=[0, 0])
    pq, pk, pv = _inputs(((1, h, s, D), (1, hkv, s, D), (1, hkv, s, D)), 6)
    for got, want in zip(
            K.packed_fwd(*(torch.as_tensor(x) for x in (pq, pk, pv)), tps),
            JK.packed_fwd(*(jnp.asarray(x) for x in (pq, pk, pv)), jps,
                          interpret=True)):
        O.assert_close(_np(got), _np(want), *tol, "packed_fwd")

    b, s_cache = 3, 4 * blk
    dq, kc, vc = _inputs(((b, h, D), (b, s_cache, hkv, D),
                          (b, s_cache, hkv, D)), 7)
    kv_lens, slots = [4 * blk, 5], [0, 2]
    jtbl, needed = JOPS.make_decode_table(kv_lens, slots, blk=blk,
                                          n_members=b + 1, n_slots=b)
    tbl, _ = OPS.make_decode_table(kv_lens, slots, blk=blk, n_members=b + 1,
                                   n_slots=b)
    got = K.packed_decode_fwd(*(torch.as_tensor(x) for x in (dq, kc, vc)),
                              torch.as_tensor(tbl), capacity=needed,
                              blk=blk, tiles=needed)
    want = JK.packed_decode_fwd(*(jnp.asarray(x) for x in (dq, kc, vc)),
                                jnp.asarray(jtbl), capacity=needed, blk=blk,
                                interpret=True)
    O.assert_close(_np(got)[slots], np.asarray(want)[slots], *tol,
                   "packed_decode_fwd")

    n_members = len(tps.members) + b + 1
    kw = dict(blk=blk, n_members=n_members, n_slots=b, s_cache=s_cache)
    jtbl, needed = JOPS.make_fused_table(jps, kv_lens, slots, **kw)
    tbl, _ = OPS.make_fused_table(tps, kv_lens, slots, **kw)
    ins = (pq, pk, pv, dq, kc, vc)
    got_p, got_d = K.fused_step_fwd(
        *(torch.as_tensor(x) for x in ins), torch.as_tensor(tbl),
        psched=tps, capacity=needed, tiles=needed)
    want_p, want_d = JOPS.fused_step_attention(
        *(jnp.asarray(x) for x in ins), jnp.asarray(jtbl), jps,
        JOPS.FusedStepSpec(n_members=n_members, capacity=needed, blk=blk,
                           impl="pallas"))
    O.assert_close(_np(got_p), _np(want_p), *tol, "fused pack")
    O.assert_close(_np(got_d)[slots], np.asarray(want_d)[slots], *tol,
                   "fused o_dec")


# ---------------------------------------------------------------------------
# a narrow D 192 model
# ---------------------------------------------------------------------------

NARROW = dict(n_layers=2, n_heads=2, n_kv_heads=1, head_dim=D)
PROMPTS = [[3, 1, 4, 1, 5], [2, 7, 1], [9, 9, 8, 2, 6, 5], [4]]


def _narrow():
    jcfg = dataclasses.replace(JREG.smoke_config("nemotron-4-340b"),
                               **NARROW)
    tcfg = dataclasses.replace(REG.smoke_config("nemotron-4-340b"),
                               **NARROW)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    np_params = jax.tree.map(np.asarray,
                             JMD.init_params(jax.random.key(0), jcfg))
    return (jcfg, jax.tree.map(jnp.asarray, np_params), tcfg,
            MD.params_from_jax(np_params, tcfg, device="cpu"))


@pytest.mark.parametrize("step_mode", ["split", "fused"])
def test_d192_engine_tokens_equal_the_jax_models_greedy_decode(step_mode):
    jcfg, jparams, tcfg, tparams = _narrow()
    jdecode = jax.jit(lambda c, t, p: JMD.decode_step(jparams, jcfg, c, t,
                                                      p))
    want = {uid: _greedy_reference(jcfg, jdecode, p)
            for uid, p in enumerate(PROMPTS)}
    eng = Engine(tparams, tcfg, slots=2, max_len=MAX_LEN,
                 prefill_impl="torch", decode_impl="torch",
                 step_mode=step_mode, device="cpu")
    for uid, p in enumerate(PROMPTS):
        eng.submit(np.asarray(p, np.int32), max_new=MAX_NEW, uid=uid)
    assert eng.run() == want
    assert all(r["status"] == "done" for r in eng.report().values())
    assert eng.stats["launches_degraded_total"] == 0


def test_d192_prefill_step_matches_the_jax_forward():
    """make_prefill_step's last-position logits and its cache's k/v
    against the reference forward's, f32 policy."""
    jcfg, jparams, tcfg, tparams = _narrow()
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 32))
    hidden, _, states = JMD.forward(
        jparams, jcfg, {"tokens": jnp.asarray(toks, jnp.int32)},
        attn_impl="scan", block=16, collect_state=True)
    want = JMD.logits_from_hidden(jparams, jcfg, hidden)[:, -1]
    prefill = TS.make_prefill_step(tcfg, attn_impl="torch", block=16,
                                   cache_dtype=torch.float32)
    logits, cache = prefill(tparams, {"tokens": torch.as_tensor(toks)})
    O.assert_close(_np(logits), _np(want), "attn", jnp.float32, "logits")
    for slot, leaves in cache.items():
        for name in ("k", "v"):
            assert leaves[name].shape[-1] == D
            O.assert_close(_np(leaves[name]), _np(states[slot][name]),
                           "attn", jnp.float32, f"{slot} {name}")
