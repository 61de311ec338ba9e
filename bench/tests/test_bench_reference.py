"""The plain reference agrees with the port run with impl="torch" at a tiny
size in float32: a served forward's logits, and the checked training steps
(loss, first gradient and the parameters' change) of both training mixes."""

import numpy as np
import pytest
import torch

from bench.core import spec
from bench.core import weights as W
from bench.reference import model as RM
from bench.tests.util import run_tiny, tiny_cell


@pytest.mark.parametrize("cell", ["yi9b-train-packed-docs",
                                  "yi9b-train-dense"])
def test_training_steps_agree_in_float32(cell):
    res = run_tiny(cell, seed=2**31 + 3)
    for name, v in res["_extra"]["readings"].items():
        assert v < 2e-5, (name, v)
    assert res["correct"]


@pytest.mark.parametrize("cell", ["nemotron-serve-chat"])
def test_served_logits_agree_with_the_ports_forward(cell):
    from repro_torch.models import model as MD

    conf = tiny_cell(cell)["config"]
    m = spec.model(conf)
    params = W.make_params(m, 5, "cpu")
    toks = np.random.default_rng(0).integers(0, m["vocab_size"], size=37)
    batch = {"tokens": torch.as_tensor(toks[None])}
    hidden, _, _ = MD.forward(params, spec.program_config(conf), batch,
                              attn_impl="torch", block=16)
    want = MD.logits_from_hidden(params, spec.program_config(conf), hidden)[0]
    rows = list(range(10, 37))
    got = RM.served_logits(params, m, [toks], [rows], RM.Precision("f32"),
                           "cpu")[0]
    torch.testing.assert_close(got, want[rows], rtol=1e-4, atol=1e-4)


def test_served_tokens_agree_in_float32():
    res = run_tiny("nemotron-serve-batch", seed=77)
    assert res["_extra"]["readings"]["tok_gap"] < 1e-4
    assert res["correct"]
