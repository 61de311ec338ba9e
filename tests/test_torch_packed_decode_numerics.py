"""The chunked walk and in-launch merge of the decode kernels
(csrc/attn_decode.cuh: packed_decode.cu and the fused step's decode half)
against the reference's kernels.

On the card a member's walk from its first tile kv_first // blk is cut
into chunks of DECODE_CHUNK // blk tiles; each (chunk, head slice) is a
block found by a scan over the table's kv_tiles row (``K.decode_owner``
over ``K.decode_grid``), computes its chunk's f32 softmax state (m, l,
acc) tile by tile, and the member's chunks are merged in chunk order
(m = max m_c, l = sum l_c exp(m_c - m), acc = sum acc_c exp(m_c - m)). A
member of one chunk writes its own acc / l. ``_chunked`` below does that
in plain torch f32, each tile step the plain version's
(scan_impl._decode_member), and is held:

- against the reference's ``packed_decode_fwd`` and the o_dec of its
  ``fused_step_fwd`` (Pallas in interpret mode, as their own tests run
  them) at the f32 attention tolerance of tests/oracles.py, on a zoo of
  kv_len 1, one chunk exactly, one chunk and a token, the whole 2048-token
  cache and a band-limited slot whose kv_first is off a tile edge, beside
  an empty column, a retired slot and the pad member, at blk 16 and 64, D
  64 and 128, g 1 and 8;
- bitwise: each member alone equals the member among the zoo (a slot's
  chunking reads its own column), and a member of one chunk equals the
  plain sequential walk (the merge of one chunk is its acc / l).

A split member's merge sums the chunk partials in another order than the
reference's sequential walk, so the two agree within the f32 tolerance and
not bitwise (ROADMAP.md C, deliberate differences).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles as O
from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS
from repro_torch.kernels.tri_attn import scan_impl as SC

torch.set_num_threads(2)

S_CACHE = 2048
B = 6
# slot 1 retired; slot 5 band-limited to its last 333 tokens (kv_first
# 367, off a tile edge at blk 16 and 64, its tiles across a chunk edge)
ZOO = dict(kv_lens=[1, K.DECODE_CHUNK, K.DECODE_CHUNK + 1, S_CACHE, 700],
           slots=[0, 2, 3, 4, 5], window=[None, None, None, None, 333])
GEOMS = [(16, 64), (16, 128), (64, 64), (64, 128)]  # (blk, D)
GROUPS = [(1, 2), (8, 1)]  # (g, Hkv)


def _tile_step(qs, kb, vb, keep, state, scale):
    """One cache tile of a chunk for every (kv head, query head): the ops
    of the plain version's step (scan_impl._decode_member)."""
    m_s, l_s, acc = state
    s = torch.einsum("kgd,tkd->kgt", qs, kb) * scale
    s = torch.where(keep, s, K.MASK_VALUE)
    m_new = torch.maximum(m_s, s.amax(dim=-1))
    alpha = torch.exp(m_s - m_new)
    p = torch.exp(s - m_new[..., None])
    l_s = l_s * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + torch.einsum("kgt,tkd->kgd", p, vb)
    return m_new, l_s, acc


def _cols(tbl, rows):
    """(slot, kv_tiles, kv_len, kv_first) of each decode column, from the
    table rows that hold them."""
    return [tuple(int(tbl[r, c]) for r in rows) for c in range(tbl.shape[1])]


def _chunked(q, k, v, cols, *, blk, tiles, scale):
    """The decode kernels' owners in plain torch: the grid's chunk blocks,
    each chunk's (m, l, acc), each member's chunks merged in chunk order.
    Returns (out (B, H, D) f32, NaN where no member wrote, and the owner of
    each chunk block)."""
    b, h, d = q.shape
    hkv = k.shape[2]
    g = h // hkv
    grid = K.decode_grid(tiles, len(cols), blk, hkv, g)
    ar = torch.arange(blk)
    owners, parts = [], {}
    for x in range(grid[0]):
        own = K.decode_owner(x, cols, b=b, s_cache=k.shape[1], blk=blk)
        owners.append(own)
        if own is None:
            continue
        r, c, _, tile0, n_tiles = own
        slot, _, kv_len, kv_first = cols[r]
        qs = q[slot].float().reshape(hkv, g, d)
        state = (torch.full((hkv, g), K.MASK_VALUE),
                 torch.zeros((hkv, g)), torch.zeros((hkv, g, d)))
        for tile in range(tile0, tile0 + n_tiles):
            toks = slice(tile * blk, (tile + 1) * blk)
            kpos = tile * blk + ar
            state = _tile_step(qs, k[slot, toks].float(),
                               v[slot, toks].float(),
                               (kpos >= kv_first) & (kpos < kv_len), state,
                               scale)
        parts[r, c] = state
    out = torch.full((b, h, d), float("nan"))
    for r, (slot, *_rest) in enumerate(cols):
        chunks = [parts[key] for key in sorted(parts) if key[0] == r]
        if not chunks:
            continue
        if len(chunks) == 1:
            _, l_s, acc = chunks[0]
        else:
            m = torch.stack([mc for mc, _, _ in chunks]).amax(dim=0)
            l_s, acc = torch.zeros_like(m), torch.zeros_like(chunks[0][2])
            for mc, lc, ac in chunks:  # chunk order 0 .. n - 1
                w = torch.exp(mc - m)
                l_s = l_s + lc * w
                acc = acc + ac * w[..., None]
        out[slot] = (acc / l_s[..., None]).reshape(h, d)
    return out, owners


def _inputs(h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, h, d), (B, S_CACHE, hkv, d), (B, S_CACHE, hkv, d))]


def _decode_table(blk, make, **zoo):
    # one empty column before the pad member
    return make(zoo["kv_lens"], zoo["slots"], blk=blk,
                n_members=len(zoo["slots"]) + 2, n_slots=B, s_cache=S_CACHE,
                window=zoo["window"])


def _live(slots, out):
    return out[slots].numpy()


@pytest.mark.parametrize("g,hkv", GROUPS)
@pytest.mark.parametrize("blk,d", GEOMS)
def test_chunked_decode_matches_reference(blk, d, g, hkv):
    h = g * hkv
    arrs = _inputs(h, hkv, d, blk + d + g)
    jtbl, needed = _decode_table(blk, JOPS.make_decode_table, **ZOO)
    tbl, t_needed = _decode_table(blk, OPS.make_decode_table, **ZOO)
    assert t_needed == needed and tbl.tobytes() == jtbl.tobytes()
    want = JK.packed_decode_fwd(*(jnp.asarray(x) for x in arrs),
                                jnp.asarray(jtbl), capacity=needed, blk=blk,
                                interpret=True)
    q, k, v = (torch.as_tensor(x) for x in arrs)
    scale = d ** -0.5
    got, _ = _chunked(q, k, v, _cols(tbl, (1, 2, 3, 4)), blk=blk,
                      tiles=needed, scale=scale)
    slots = ZOO["slots"]
    assert torch.isfinite(got[slots]).all()  # every live slot written
    assert torch.isnan(got[1]).all()  # the retired slot: nothing wrote
    O.assert_close(_live(slots, got), np.asarray(want)[slots], "attn",
                   jnp.float32, "o_dec")

    # each member alone: the same bits as among the zoo
    for i, slot in enumerate(slots):
        alone = {key: [val[i]] for key, val in ZOO.items()}
        atbl, a_needed = _decode_table(blk, OPS.make_decode_table, **alone)
        one, _ = _chunked(q, k, v, _cols(atbl, (1, 2, 3, 4)), blk=blk,
                          tiles=a_needed, scale=scale)
        assert torch.equal(one[slot], got[slot]), (blk, d, g, slot)

    # a member of one chunk: the plain sequential walk, bit for bit
    plain = SC.packed_decode_torch(q, k, v, torch.as_tensor(tbl),
                                   capacity=needed, blk=blk, tiles=needed,
                                   scale=scale)
    ct = K.DECODE_CHUNK // blk
    one_chunk = [int(tbl[1, c]) for c in range(len(slots))
                 if -(-int(tbl[2, c]) // ct) == 1]
    assert one_chunk == [0, 2]  # kv_len 1 and one chunk exactly
    for slot in one_chunk:
        assert torch.equal(got[slot], plain[slot]), (blk, d, g, slot)


@pytest.mark.parametrize("g,hkv", GROUPS)
@pytest.mark.parametrize("blk,d", [(16, 64), (64, 128)])
def test_chunked_fused_decode_half_matches_reference(blk, d, g, hkv):
    """The fused step's decode columns (rows 2-5 of the (8, R) table,
    after the prefill columns) walked in the same chunks: against the
    o_dec of the reference's fused_step_fwd, and bitwise equal to the
    walk over the (5, R) table of the same round, which the card holds
    the fused kernel's decode half to."""
    h = g * hkv
    arrs = _inputs(h, hkv, d, blk + d + g + 1)
    rng = np.random.default_rng(blk + g)
    kw = dict(block=blk, window=[None, blk + 3], prefix=[0, 0])
    lens = [2 * blk, blk]
    jps = JOPS.make_packed_sched(lens, **kw)
    tps = OPS.make_packed_sched(lens, **kw)
    s = tps.s_total
    pack = [rng.standard_normal(x).astype(np.float32)
            for x in ((1, h, s, d), (1, hkv, s, d), (1, hkv, s, d))]
    n_members = len(tps.members) + len(ZOO["slots"]) + 2
    fkw = dict(blk=blk, n_members=n_members, n_slots=B, s_cache=S_CACHE,
               window=ZOO["window"])
    jtbl, needed = JOPS.make_fused_table(jps, ZOO["kv_lens"], ZOO["slots"],
                                         **fkw)
    tbl, t_needed = OPS.make_fused_table(tps, ZOO["kv_lens"], ZOO["slots"],
                                         **fkw)
    assert t_needed == needed and tbl.tobytes() == jtbl.tobytes()
    spec = JOPS.FusedStepSpec(n_members=n_members, capacity=needed, blk=blk,
                              impl="pallas")
    _, want = JOPS.fused_step_attention(
        *(jnp.asarray(x) for x in pack + arrs), jnp.asarray(jtbl), jps, spec)
    q, k, v = (torch.as_tensor(x) for x in arrs)
    r_p = len(tps.members)
    assert (tbl[1, :r_p] == 0).all() and (tbl[1, r_p:] == 1).all()
    got, _ = _chunked(q, k, v, _cols(tbl[:, r_p:], (5, 2, 3, 4)), blk=blk,
                      tiles=needed - tps.steps, scale=d ** -0.5)
    slots = ZOO["slots"]
    O.assert_close(_live(slots, got), np.asarray(want)[slots], "attn",
                   jnp.float32, "fused o_dec")
    dtbl, d_needed = _decode_table(blk, OPS.make_decode_table, **ZOO)
    split, _ = _chunked(q, k, v, _cols(dtbl, (1, 2, 3, 4)), blk=blk,
                        tiles=d_needed, scale=d ** -0.5)
    assert torch.equal(got[slots], split[slots])


@pytest.mark.parametrize("blk", [16, 32, 64, 128])
@pytest.mark.parametrize("tiles_given", ["live", "understated"])
def test_decode_grid_covers_each_live_tile_once(blk, tiles_given):
    """decode_grid's chunk blocks, each walking chunks x, x + blocks, ...
    as the kernels do, own every live tile of every member exactly once,
    a member's tiles in order chunk after chunk; the surplus blocks own
    nothing. An understated tile count (0) only leaves fewer blocks, each
    walking more chunks."""
    tbl, needed = _decode_table(blk, OPS.make_decode_table, **ZOO)
    cols = _cols(tbl, (1, 2, 3, 4))
    tiles = needed if tiles_given == "live" else 0
    blocks, slices = K.decode_grid(tiles, len(cols), blk, 4, 8)
    assert slices == 4
    ct = K.DECODE_CHUNK // blk
    walked = {r: [] for r in range(len(cols))}
    per_block = []
    for x0 in range(blocks):
        mine = []
        x = x0
        while (own := K.decode_owner(x, cols, b=B, s_cache=S_CACHE,
                                     blk=blk)) is not None:
            r, c, n, tile0, n_tiles = own
            assert n == -(-cols[r][1] // ct) and 1 <= n_tiles <= ct
            walked[r].append((c, list(range(tile0, tile0 + n_tiles))))
            mine.append(own)
            x += blocks
        per_block.append(mine)
    for r, (slot, kv_tiles, kv_len, kv_first) in enumerate(cols):
        chunks = sorted(walked[r])
        assert [c for c, _ in chunks] == list(range(len(chunks)))
        tiles_r = [t for _, ts in chunks for t in ts]
        live = 0 <= slot < B and 0 < kv_tiles < K.DECODE_NO_EMIT
        want = list(range(kv_first // blk, kv_first // blk + kv_tiles)) \
            if live else []
        assert tiles_r == want, (blk, r)
    total = sum(len(w) for w in walked.values())
    if tiles_given == "live":
        assert blocks >= total
        assert all(len(m) == 1 for m in per_block[:total])
        assert not any(per_block[total:])  # surplus blocks own nothing
    else:
        assert blocks == len(cols) < total


def test_chunk_constants_match_the_cuda_body():
    """kernel.py's DECODE_CHUNK and DECODE_HEADS, which size the grid and
    the workspace, are the ones csrc/attn_decode.cuh compiles with."""
    import re
    from pathlib import Path

    src = (Path(K.__file__).resolve().parents[2] / "csrc"
           / "attn_decode.cuh").read_text()
    for name in ("DECODE_CHUNK", "DECODE_HEADS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == getattr(K, name), name
    assert all(K.DECODE_CHUNK % blk == 0 for blk in K.SUPPORTED_BLOCKS)


@pytest.mark.parametrize("blk", [4, 16])
def test_capacity_padding_is_inert(blk):
    """The split decode round's capacity bucket only pads the reference's
    grid: within one impl ("torch", the plain version; "ref", the masked
    oracle) three capacities give the same bits, across impls and against
    the reference's scan impl they agree within the f32 tolerance (the
    reference's own test asks scan and pallas for the same bits, which
    fails: ROADMAP C). The card's impl "cuda" is held the same way in
    tests/test_torch_cuda.py."""
    b, s_cache = 3, 8 * blk
    kv_lens, slots = [2 * blk + 1, 8 * blk - 2], [0, 2]
    q, kc, vc = O.rand_decode_state(0, b, 4, 2, s_cache, 8)
    jtbl, needed = JOPS.make_decode_table(kv_lens, slots, blk=blk,
                                          n_members=b + 1, n_slots=b)
    tbl, t_needed = OPS.make_decode_table(kv_lens, slots, blk=blk,
                                          n_members=b + 1, n_slots=b)
    assert t_needed == needed and tbl.tobytes() == jtbl.tobytes()
    want = JOPS.packed_decode_attention(q, kc, vc, jnp.asarray(jtbl),
                                        JOPS.DecodeRoundSpec(
                                            n_members=b + 1,
                                            capacity=needed, blk=blk,
                                            impl="scan"))
    tq, tk, tv = (torch.as_tensor(np.asarray(x)) for x in (q, kc, vc))
    outs = {}
    for impl in ("torch", "ref"):
        runs = [OPS.packed_decode_attention(
            tq, tk, tv, torch.as_tensor(tbl),
            OPS.DecodeRoundSpec(b + 1, capacity, blk, impl, needed))
            for capacity in (needed, needed + 5, 4 * needed)]
        for run in runs[1:]:
            assert torch.equal(run, runs[0]), impl
        assert torch.count_nonzero(runs[0][1]) == 0  # the retired slot
        outs[impl] = runs[0].numpy()
    O.assert_close(outs["torch"], outs["ref"], "attn", jnp.float32)
    O.assert_close(outs["torch"], np.asarray(want), "attn", jnp.float32)
