"""The control comes out not correct: the plain reference computed in
float8 (e4m3), put in the program's place, against the float32 reference,
judged by each cell's own limits, at a tiny size in the configurations'
bfloat16."""

import pytest

from bench import calibrate as CAL
from bench.core import checks
from bench.tests.util import run_tiny, tiny_cell

SEEDS = (1, 2, 3)


@pytest.mark.parametrize("cell", ["yi9b-train-packed-docs",
                                  "yi9b-train-dense"])
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_fails(cell, seed):
    c = tiny_cell(cell, "bfloat16")
    readings, _ = CAL.train_control(c, seed, "cpu")
    correct, shown = checks.judge(readings, c["limits"])
    assert not correct, shown


@pytest.mark.parametrize("cell", ["nemotron-serve-chat",
                                  "nemotron-serve-batch"])
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_fails(cell, seed):
    res = run_tiny(cell, seed, dtype="bfloat16", seconds=0.5)
    readings = CAL.serve_control(res["_extra"], "cpu")
    correct, shown = checks.judge(readings, tiny_cell(cell)["limits"])
    assert not correct, shown
