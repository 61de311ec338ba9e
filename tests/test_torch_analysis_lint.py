"""The port's block-space checker (repro_torch.analysis), on the CPU.

Mirrors tests/test_analysis_lint.py for the port:
  * every pass of ``python -m repro_torch.analysis.lint --device cpu`` is
    green, and its JSON report well formed;
  * the CLI fails, with a tet / isqrt rule, when a declared probe count
    is lowered below what the envelope pass derives from the port's own
    arithmetic (torch.sqrt / torch.pow, the device's sqrtf / cbrtf);
  * the tensor maps agree with the reference's traced maps at the edges
    of the certified envelopes, and just past them;
  * the verifier catches a closed form off by one, and a kind without a
    contract; the static obs rule catches a raw ctypes call; the launch
    lint catches a wrapper that records twice.
Property tests take no function-scoped fixture under @given.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import mapping as JM
from repro_torch.analysis import contracts as C
from repro_torch.analysis import envelope as E
from repro_torch.analysis import launch_lint as LL
from repro_torch.analysis import lint
from repro_torch.analysis import obs_lint as OL
from repro_torch.analysis import resilience_lint as RL
from repro_torch.analysis import verifier as V
from repro_torch.core import mapping as M
from repro_torch.core import schedule as S

torch.set_num_threads(2)


@pytest.mark.parametrize("name", lint.PASSES)
def test_every_pass_is_green_on_the_cpu(name, tmp_path):
    report = tmp_path / "lint_report.json"
    rc = lint.main(["--pass", name, "--device", "cpu", "-q", "--json",
                    str(report)])
    rep = json.loads(report.read_text())
    assert rc == 0, [r for r in rep["results"] if not r["ok"]]
    assert rep["device"] == "cpu" and rep["total_failures"] == 0
    assert rep["passes"][name]["checks"] == rep["total_checks"] > 0
    assert all({"pass_name", "rule", "ok", "detail"} == set(r)
               for r in rep["results"])
    assert {r["pass_name"] for r in rep["results"]} == {name}


@pytest.mark.parametrize("const,value,family", [
    ("TET_PROBES_DOWN", 1, "tet"),
    ("ISQRT_PROBES", 0, "isqrt"),
])
def test_lint_cli_fails_on_a_lowered_probe_count(const, value, family,
                                                 monkeypatch, tmp_path):
    monkeypatch.setattr(M, const, value)
    report = tmp_path / "lint_report.json"
    rc = lint.main(["--pass", "envelope", "--device", "cpu", "-q",
                    "--json", str(report)])
    assert rc != 0
    rep = json.loads(report.read_text())
    bad = {r["rule"] for r in rep["results"] if not r["ok"]}
    assert any(r.startswith(family + ".probes") for r in bad), bad


def test_envelope_derivation_reads_the_ports_arithmetic():
    tet = E.derive_tet()
    err = tet["abs_err"]
    # torch.pow's float32 exponent and powf's 4 ulp on CUDA dominate
    assert err["cuda torch.pow"] > err["cpu torch.pow"] > err["cuda cbrtf"]
    assert 0 < tet["exponent_err"] < err["cpu torch.pow"] < 1
    assert (tet["probes_up_required"], tet["probes_down_required"]) == (1, 2)
    assert tet["max_i"] == M.TET_TRACED_MAX_I
    assert E.derive_isqrt()["probes_required"] == M.ISQRT_PROBES
    dev = E.device_constants()
    assert (dev["ISQRT_MAX_R"], dev["TET_MAX_I"], dev["TET_PROBES"]) == \
        (M.ISQRT_MAX_R, M.TET_TRACED_MAX_I, M.TET_PROBES_DOWN)
    assert dev["ISQRT_PROBES_UP"] == dev["ISQRT_PROBES_DOWN"] == 1


def _tensor(fn, lam):
    return tuple(int(v) for v in fn(torch.tensor([lam], dtype=torch.int32)))


def _traced(fn, lam):
    return tuple(int(v) for v in fn(jnp.asarray(lam, jnp.int32)))


@pytest.mark.parametrize("i", [M.TET_TRACED_MAX_I - 2, M.TET_TRACED_MAX_I - 1,
                               M.TET_TRACED_MAX_I])
def test_tet_tensor_map_equals_reference_at_envelope_planes(i):
    for lam in (M.tet(i) - 2, M.tet(i) - 1, M.tet(i), M.tet(i) + 1):
        got = _tensor(M.tet_map, lam)
        assert got == _traced(JM.tet_map, lam), lam
        if lam <= M.TET_TRACED_MAX_LAM:
            assert got == M.tet_map(lam), lam
        else:  # past the envelope both clamp to the last exact plane
            assert got[0] == M.TET_TRACED_EXACT_PLANES, lam


def test_ltm_and_isqrt_tensor_forms_at_envelope_edges():
    top, row0 = M.LTM_TRACED_MAX_LAM, M.tri(M.LTM_TRACED_MAX_I)
    for lam in (top, top - 1, row0, row0 - 1, row0 + 1):
        assert _tensor(M.ltm_map, lam) == M.ltm_map(lam) == \
            _traced(JM.ltm_map, lam), lam
    xs = sorted({r * r + d for r in (1, 2, 46339, M.ISQRT_MAX_R)
                 for d in (-1, 0, 1)} | {M.INT32_MAX - 1, M.INT32_MAX})
    got = M._isqrt_tensor(torch.as_tensor(xs, dtype=torch.int32))
    assert got.tolist() == [int(np.floor(np.sqrt(np.float64(x))))
                            for x in xs]


@settings(max_examples=300, deadline=None)
@given(st.integers(0, M.TET_TRACED_MAX_LAM))
def test_tet_tensor_map_is_exact_inside_the_envelope(lam):
    assert _tensor(M.tet_map, lam) == M.tet_map(lam)


@settings(max_examples=300, deadline=None)
@given(st.integers(0, M.LTM_TRACED_MAX_LAM))
def test_ltm_tensor_maps_are_exact_inside_the_envelope(lam):
    assert _tensor(M.ltm_map, lam) == M.ltm_map(lam)
    if lam <= M.tri(M.LTM_TRACED_MAX_I - 1) - 1:
        assert _tensor(M.ltm_map_nodiag, lam) == M.ltm_map_nodiag(lam)


def test_schedule_guards_read_the_certified_envelopes():
    S.TriangularSchedule(n=M.LTM_TRACED_MAX_I).index_map(torch.zeros(1))
    with pytest.raises(ValueError, match="envelope"):
        S.TriangularSchedule(n=M.LTM_TRACED_MAX_I + 2).index_map(
            torch.zeros(1, dtype=torch.int32))
    S.TetrahedralSchedule(n=M.TET_TRACED_MAX_I).index_map(
        torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="envelope"):
        S.TetrahedralSchedule(n=M.TET_TRACED_MAX_I + 1).index_map(
            torch.zeros(1, dtype=torch.int32))


def test_verifier_catches_a_closed_form_off_by_one():
    con = C.schedule_contracts()["ltm"]
    broken = C.ScheduleContract(
        kind=con.kind, bijectivity=con.bijectivity, rank=con.rank,
        make=con.make, launched=lambda case: con.launched(case) + 1,
        domain=con.domain, segments=con.segments, in_domain=con.in_domain,
        inverse=con.inverse, cases=con.cases[:2])
    results = V.verify_contract(broken)
    assert any(not r.ok and r.rule.endswith("counting") for r in results)
    wrong_inverse = C.ScheduleContract(
        kind="tet", bijectivity=C.BIJECTION, rank=3,
        make=lambda c: S.make_schedule("tet", c.n),
        launched=lambda c: c.n * (c.n + 1) * (c.n + 2) // 6,
        domain=lambda c: c.n * (c.n + 1) * (c.n + 2) // 6,
        segments=C.schedule_contracts()["tet"].segments,
        in_domain=lambda ijk, c: True,
        inverse=lambda ijk, c: ijk[0] + ijk[1] + ijk[2],
        cases=(C.Case(label="n=5", n=5),))
    assert any(not r.ok and r.rule.endswith("boundaries")
               for r in V.verify_contract(wrong_inverse))


def test_registry_coverage_needs_a_contract_for_every_kind():
    assert all(r.ok for r in V.verify_registry_coverage())
    assert set(C.REGISTERED_KINDS) == set(S._KINDS) | {"packed", "mixed"}
    cons = dict(C.schedule_contracts())
    del cons["bb3"]
    res = V.verify_registry_coverage(cons)
    assert not res[0].ok and "bb3" in res[0].detail


def test_static_obs_rule_catches_a_raw_ctypes_call(tmp_path):
    head = "from repro_torch.kernels import build as BUILD\n"
    (tmp_path / "good.py").write_text(
        head + "from repro_torch.obs import launch as OBS\n"
        "lib = BUILD.load('tri_edm')\n"
        "OBS.instrumented_launch(meta, lib.dummy_ltm_launch, (), 0, 1, 0)\n")
    (tmp_path / "bad.py").write_text(
        head + "def f():\n"
        "    BUILD.load('tri_edm').dummy_ltm_launch(0, 1, 0)\n")
    raw, reached = OL.scan_source(tmp_path / "good.py")
    assert raw == [] and reached == {"dummy_ltm_launch"}
    res = {r.rule: r for r in OL.lint_static_coverage(root=tmp_path)}
    assert not res["obs.coverage.no_raw_entry_call"].ok
    assert "bad.py" in res["obs.coverage.no_raw_entry_call"].detail
    assert not res["obs.coverage.every_entry_instrumented"].ok


def test_launch_lint_catches_a_wrapper_that_records_twice(monkeypatch):
    from repro_torch.kernels.tri_edm import kernel as EK

    once = EK.edm_ltm_torch
    monkeypatch.setattr(EK, "edm_ltm_torch",
                        lambda *a, **k: (once(*a, **k), once(*a, **k))[1])
    res = {r.rule: r for r in LL.lint_ops("cpu")}
    assert not res["launch.tri_edm.ltm.count"].ok
    assert all(r.ok for name, r in res.items()
               if not name.startswith("launch.tri_edm.ltm."))


def test_launch_lint_declares_every_site():
    assert len(LL.SITE_RULES) == 17
    assert set(LL.SITE_RULES.values()) <= set(LL.EXPECTED)
    named = {n for counts in LL.EXPECTED.values() for n in counts}
    assert set(LL.SITE_RULES) == named
    assert sum(LL.EXPECTED["tri_attn.grad"].values()) == 3
    assert sum(LL.EXPECTED["tri_attn.packed_grad"].values()) == 3
    assert sum(LL.EXPECTED["tri_attn.fused_step"].values()) == 1


def test_resilience_lint_catches_a_stage_outside_the_schema(monkeypatch):
    from repro_torch.resilience import faults as F

    monkeypatch.setitem(F.LADDERS, "admit",
                        F.LADDERS["admit"] + ("host_copy",))
    res = {r.rule: r for r in RL.lint_vocab_sync()}
    assert not res["resilience.vocab.ladders_match_schema"].ok
