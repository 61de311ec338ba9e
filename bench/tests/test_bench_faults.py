"""A run with the timed path broken underneath, driven past the harness's
look for a card, comes out not correct, once for each fault its cell can
have and for a learning rate 1.2 times the configuration's; the same run
unbroken comes out correct. Tiny size, float32."""

import pytest

from bench.tests.util import run_tiny

CASES = [("yi9b-train-packed-docs", None), ("yi9b-train-packed-docs",
                                            "state_unchanged"),
         ("yi9b-train-packed-docs", "half_batch"),
         ("yi9b-train-packed-docs", "lr_high"),
         ("yi9b-train-dense", None), ("yi9b-train-dense", "state_unchanged"),
         ("yi9b-train-dense", "half_batch"), ("yi9b-train-dense", "lr_high"),
         ("nemotron-serve-chat", None),
         ("nemotron-serve-chat", "token_altered"),
         ("nemotron-serve-batch", None),
         ("nemotron-serve-batch", "token_altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_turns_correct_false(cell, fault):
    res = run_tiny(cell, seed=31, fault=fault)
    assert res["correct"] is (fault is None), res["checks"]
    assert list(res)[-2] == "checks"
