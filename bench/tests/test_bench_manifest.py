"""BENCHMARK.json keeps to the benchmark's contract: names and units of the
allowed characters, every piece a file found by its name, and a run length
that fits a full check."""

import json
import re
from pathlib import Path

import pytest

from bench.core import spec, traffic

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")


def test_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(B["paths"]) <= 16
    assert all(PATH.match(p) and (ROOT / p).is_dir() for p in B["paths"])
    assert 1 <= len(B["command"]) <= 32
    assert B["command"][1].startswith(B["paths"][0] + "/")
    assert 1 <= B["run_seconds"] <= 51


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in B[k]]
    assert all(NAME.match(n) for n in names)
    metric_names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert "\n" not in w["why"] and "\t" not in w["why"]
    for c in B["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for m in B["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_end_to_end_bounds():
    names = {m["name"] for m in B["end_to_end"]}
    assert "setup_s" in names
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_piece_is_a_file_found_by_name():
    for c in B["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"]
        assert set(c["reduced"]) <= set(conf)
        assert conf["reduced"] == c["reduced"]
    for w in B["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["limits"]
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
    for m in B["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in B["end_to_end"]}
        for w in m["workloads"]:
            cell = spec.cell(w)
            assert m["moves"] in {e["name"] for e in cell["end_to_end"]}


def test_every_kind_law_and_family_is_a_file_found_by_name():
    for w in B["workloads"]:
        cell = spec.cell(w["name"])
        mix = cell["traffic"]
        kind = traffic.kind(mix)
        assert kind.DRIVER in ("train", "serve")
        assert (ROOT / "bench" / "core" / f"{kind.DRIVER}_cell.py").is_file()
        if "arrivals" in mix:
            assert callable(traffic.arrivals(mix["arrivals"]).gaps)
        fam = spec.family(spec.model(cell["config"]))
        for f in ("leaf_specs", "layer", "decays", "matmul_params",
                  "cache_bytes_per_token", "attn_layers"):
            assert callable(getattr(fam, f)), f


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (B["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("w", [w["name"] for w in B["workloads"]])
def test_four_chips_only_where_allowed(w):
    four = [x for x in B["workloads"] if x["chips"] == 4]
    assert len(four) <= max(1, len(B["workloads"]) // 4)
