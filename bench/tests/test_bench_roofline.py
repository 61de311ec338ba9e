"""The benchmark's copy of the attention work and the decode bytes against
hand-computed cases and against the port's own functions."""

import pytest

from bench.roofline import model as RF


def test_forward_at_seq_4096_by_hand():
    # yi-9b's attention: S 4096, H 32, Hkv 4, D 128, bf16
    pairs = RF.causal_pairs([4096], 32)
    assert pairs == 32 * 4096 * 4097 // 2 == 268_500_992
    nbytes, flops = RF.attn_work("fwd", q_elems=16_777_216,
                                 k_elems=2_097_152, d=128, elt=2,
                                 pairs=pairs)
    assert nbytes == 2 * (2 * 16_777_216 + 2 * 2_097_152) + 524_288
    assert flops == 137_472_507_904
    assert RF.bound(nbytes, flops) * 1e3 == pytest.approx(0.139002, rel=1e-5)


def test_training_attention_counts_each_documents_triangle():
    one = RF.train_attn_seconds([4096], rows=4096, heads=32, kv_heads=4,
                                head_dim=128)
    docs = RF.train_attn_seconds([2048, 2048], rows=4096, heads=32,
                                 kv_heads=4, head_dim=128)
    # 18 D flops a pair over the forward, dq and dk/dv, all compute-bound
    assert one == pytest.approx(18 * 128 * 268_500_992 / 989e12)
    assert docs == pytest.approx(18 * 128 * 32 * 2048 * 2049 / 989e12)


def test_decode_bytes_by_hand():
    # nemotron: H 96, Hkv 8, D 192, bf16 q, float32 cache, three live slots
    nbytes, flops = RF.decode_work(q_elems=3 * 96 * 192, b=3, h=96, d=192,
                                   elt=2, tbl_elems=0,
                                   kv_tokens=100 + 2000 + 4096, hkv=8,
                                   cache_elt=4)
    assert nbytes == 221_184 + 76_136_448
    assert flops == 456_818_688
    assert RF.decode_attn_seconds([100, 2000, 4096], heads=96, kv_heads=8,
                                  head_dim=192) == \
        pytest.approx(nbytes / 3.35e12)


@pytest.mark.parametrize("op", ["fwd", "dq", "dkv"])
def test_copy_matches_the_ports_arithmetic(op):
    from bench import run  # noqa: F401  (puts src/ on the path)
    from repro_torch.roofline import model as PM

    kw = dict(q_elems=3 * 2048 * 96 * 192, k_elems=3 * 2048 * 8 * 192,
              d=192, elt=2, pairs=RF.causal_pairs([2048] * 3, 96))
    assert RF.attn_work(op, **kw) == PM.attn_work(op, **kw)
    nb, fl = RF.attn_work(op, **kw)
    import torch

    assert RF.bound(nb, fl) * 1e3 == pytest.approx(
        PM.bound(nb, fl, torch.bfloat16)[0])
    dk = dict(q_elems=4 * 32 * 128, b=4, h=32, d=128, elt=2, tbl_elems=25,
              kv_tokens=5000, hkv=4, cache_elt=4)
    assert RF.decode_work(**dk) == PM.decode_work(**dk)
