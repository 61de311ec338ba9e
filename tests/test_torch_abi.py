"""Member-table ABI and package isolation of repro_torch.

* PackedTriSched.table() (7, R), make_decode_table (5, R) and
  make_fused_table (8, R), pad columns included, are byte-identical int32
  arrays to the reference's.
* No module of src/repro_torch, nor chip_smoke.py, imports jax or the
  JAX package (an AST scan of every import statement).
* every slice's modules (serving, training, the fused step and fleet,
  the paper's experiment, the 3-body workload and the serving CLI, the
  schedule registry and the checker, data-parallel training with the
  int8 grad compression) import in a process where importing jax is
  impossible, one parametrised case a slice.
* Every ``extern "C"`` entry point of ``src/repro_torch/csrc/*.cu`` is
  bound in ``kernels/build.py`` with one ctypes type per parameter, of
  the right kind (pointer, int or float): the check nvcc and the card
  cannot make here.
"""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.kernels.tri_attn import kernel as JK
from repro.kernels.tri_attn import ops as JOPS
from repro_torch.kernels import build as BUILD
from repro_torch.kernels.tri_attn import kernel as K
from repro_torch.kernels.tri_attn import ops as OPS

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


@pytest.mark.parametrize("blk,lens,window,prefix", [
    (8, [40, 16, 24, 8], [None, None, 11, None], [0, 9, 0, 0]),
    (16, [16], None, 0),
    (4, [4, 8, 12, 16, 20], 6, 0),
    (16, [64, 32], None, [20, 3]),
])
def test_packed_table_bytes_match(blk, lens, window, prefix):
    want = JOPS.make_packed_sched(lens, block=blk, window=window,
                                  prefix=prefix)
    got = OPS.make_packed_sched(lens, block=blk, window=window,
                                prefix=prefix)
    wt, gt = want.table(), got.table()
    assert gt.dtype == wt.dtype == np.int32 and gt.shape == wt.shape
    assert gt.tobytes() == wt.tobytes()
    assert (got.steps, got.total_tiles, got.s_total) == \
        (want.steps, want.total_tiles, want.s_total)


@pytest.mark.parametrize("kv_lens,slots,n_members,window", [
    ([64, 3, 17], [0, 2, 4], 6, None),
    ([5], [3], 4, None),
    ([40, 33, 9, 1], [1, 0, 3, 2], 5, [None, 8, None, 1]),
    ([], [], 3, None),
])
def test_decode_table_bytes_match(kv_lens, slots, n_members, window):
    # the reference's s_cache check calls max() on the lengths, so an empty
    # round is built without it there (ROADMAP queue C)
    kw = dict(blk=8, n_members=n_members, n_slots=5,
              s_cache=64 if kv_lens else 0, window=window)
    wt, wn = JOPS.make_decode_table(kv_lens, slots, **kw)
    gt, gn = OPS.make_decode_table(kv_lens, slots, **kw)
    assert gn == wn
    assert gt.dtype == wt.dtype == np.int32 and gt.shape == wt.shape
    assert gt.tobytes() == wt.tobytes()
    assert tuple(gt[:, -1][1:]) == (5, K.DECODE_NO_EMIT, 0, 0)
    assert K.DECODE_NO_EMIT == JK.DECODE_NO_EMIT
    assert K.MASK_VALUE == JK.MASK_VALUE


@pytest.mark.parametrize("lens,window,prefix,kv_lens,slots,b,n_members", [
    ([8, 4], None, 0, [], [], 3, 6),                     # no live slot
    ([12, 8, 4], [None, 6, None], [0, 0, 5], [30], [1], 3, 8),
    ([16], None, [9], [7, 18, 3, 26], [0, 1, 2, 3], 4, 6),  # all B live
    ([4, 4], [3, None], 0, [9, 17], [2, 0], 5, 10),      # unused columns
])
def test_fused_table_bytes_match(lens, window, prefix, kv_lens, slots, b,
                                 n_members):
    kw = dict(blk=4, n_members=n_members, n_slots=b)
    jps = JOPS.make_packed_sched(lens, block=4, window=window, prefix=prefix)
    tps = OPS.make_packed_sched(lens, block=4, window=window, prefix=prefix)
    # the reference's s_cache check fails on an empty round (queue C)
    wt, wn = JOPS.make_fused_table(jps, kv_lens, slots, s_cache=32 if kv_lens
                                   else 0, **kw)
    gt, gn = OPS.make_fused_table(tps, kv_lens, slots, s_cache=32, **kw)
    assert gn == wn == tps.steps + sum(-(-k // 4) for k in kv_lens)
    assert gt.dtype == wt.dtype == np.int32 and gt.shape == wt.shape == \
        (8, n_members)
    r_p = len(lens)
    # the port bounds a prefill member's prefix width p_b (row 4) by its n
    # tiles (row 2), where the reference's runs past a prefix longer than
    # the member (the 5-token prefix of the 4-token member here)
    wt = wt.copy()
    wt[4, :r_p] = np.minimum(wt[4, :r_p], wt[2, :r_p])
    assert gt.tobytes() == wt.tobytes()
    assert tuple(gt[:, -1][1:]) == (1, K.DECODE_NO_EMIT, 0, 0, b, 0, 0)
    assert list(gt[1]) == [0] * r_p + [1] * (n_members - r_p)
    unused = gt[:, r_p + len(kv_lens):-1]
    assert (unused[1:] == np.array([[1], [0], [0], [0], [0], [0], [0]])).all()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    assert {"kernels/tri_edm/kernel.py", "kernels/tri_edm/ops.py",
            "kernels/tri_edm/ref.py", "core/analysis.py",
            "kernels/tri_3body/kernel.py", "kernels/tri_3body/ops.py",
            "kernels/tri_3body/ref.py", "launch/serve.py"} <= \
        {str(f.relative_to(PKG)) for f in files if PKG in f.parents}
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not bad, bad


# each slice's modules, imported in a process where jax and the JAX
# package cannot be imported
SLICES = {
    "serving": "import repro_torch, repro_torch.serve.engine, "
               "repro_torch.kernels.tri_attn.ops, repro_torch.models.model",
    "training": "import repro_torch.train.train_step, repro_torch.train.data, "
                "repro_torch.train.optimizer, repro_torch.train.checkpoint, "
                "repro_torch.train.fault_tolerance, repro_torch.launch.train",
    "fused": "import repro_torch.serve.fleet, "
             "repro_torch.resilience.snapshot, "
             "repro_torch.resilience.faults, repro_torch.obs.schema",
    "paper": "import repro_torch.kernels.tri_edm.ops, "
             "repro_torch.kernels.tri_edm.kernel, "
             "repro_torch.kernels.tri_edm.ref, repro_torch.core.analysis; "
             "from repro_torch.kernels.tri_attn.scan_impl import fwd_bb_torch",
    "3body": "import repro_torch.kernels.tri_3body.ops, "
             "repro_torch.kernels.tri_3body.kernel, "
             "repro_torch.kernels.tri_3body.ref, repro_torch.launch.serve; "
             "from repro_torch.core.mapping import tet_map",
    "checker": "import repro_torch.core.schedule, repro_torch.core.packing, "
               "repro_torch.analysis, repro_torch.analysis.contracts, "
               "repro_torch.analysis.verifier, repro_torch.analysis.envelope, "
               "repro_torch.analysis.launch_lint, "
               "repro_torch.analysis.obs_lint, "
               "repro_torch.analysis.resilience_lint, "
               "repro_torch.analysis.lint, repro_torch.obs.timing, "
               "repro_torch.obs.validate, repro_torch.resilience.smoke",
    "archs": "import repro_torch.configs.granite_moe_3b_a800m, "
             "repro_torch.configs.mixtral_8x7b, "
             "repro_torch.configs.granite_34b, "
             "repro_torch.configs.llama3_405b, "
             "repro_torch.configs.musicgen_large, "
             "repro_torch.configs.internvl2_1b, "
             "repro_torch.configs.nemotron_4_340b, "
             "repro_torch.configs.registry, repro_torch.models.layers, "
             "repro_torch.models.model, repro_torch.train.data; "
             "from repro_torch.configs.registry import all_configs; "
             "assert len(all_configs()) == 10",
    "roofline": "import repro_torch.roofline.model, "
                "repro_torch.roofline.dispatch_count, "
                "repro_torch.roofline.attribution, "
                "repro_torch.launch.dryrun, repro_torch.launch.mesh, "
                "repro_torch.launch.compat, repro_torch.parallel.sharding; "
                "import tempfile; "
                "from repro_torch.launch.dryrun import run_cell; "
                "assert run_cell('yi-9b', 'train_4k', 'card', "
                "tempfile.mkdtemp(), n_layers=1, batch=1)['ok']",
    "data_parallel": "import repro_torch.parallel.compression, "
                     "repro_torch.launch.mesh, repro_torch.launch.train, "
                     "repro_torch.train.train_step, "
                     "repro_torch.train.checkpoint, "
                     "repro_torch.train.fault_tolerance, "
                     "repro_torch.resilience.health, "
                     "repro_torch.models.model; "
                     "import torch; "
                     "from repro_torch.parallel.compression import "
                     "compressed_psum; "
                     "g, e = compressed_psum({'w': torch.ones(3)}, "
                     "{'w': torch.zeros(3)}); "
                     "assert torch.equal(g['w'], torch.ones(3))",
}


@pytest.mark.parametrize("name", list(SLICES))
def test_slice_modules_import_with_jax_blocked(name):
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; " + SLICES[name] + "; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_checker_modules_are_scanned_for_jax_imports():
    files = {str(f.relative_to(PKG)) for f in PKG.rglob("*.py")}
    assert {"roofline/model.py", "roofline/dispatch_count.py",
            "roofline/attribution.py", "launch/dryrun.py", "launch/mesh.py",
            "launch/compat.py", "parallel/sharding.py",
            "parallel/compression.py", "train/fault_tolerance.py",
            "resilience/health.py"} <= files
    assert {"core/schedule.py", "analysis/contracts.py",
            "analysis/verifier.py", "analysis/envelope.py",
            "analysis/launch_lint.py", "analysis/obs_lint.py",
            "analysis/resilience_lint.py", "analysis/lint.py",
            "obs/timing.py", "obs/validate.py",
            "resilience/smoke.py"} <= files


def _c_entry_points(src: str):
    """{name: [parameter kinds]} of the extern "C" functions in ``src``:
    'p' for a pointer, 'i' for an int, 'f' for a float."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        kinds = []
        for param in m.group(2).split(","):
            param = " ".join(param.split())
            kinds.append("p" if "*" in param else
                         "f" if param.startswith("float ") else
                         "i" if param.startswith("int ") else param)
        out[m.group(1)] = kinds
    return out


def test_c_entry_points_match_the_ctypes_bindings():
    import ctypes

    kind = {ctypes.c_void_p: "p", ctypes.c_int: "i", ctypes.c_float: "f"}
    sources = sorted(p.stem for p in (PKG / "csrc").glob("*.cu"))
    assert sorted(BUILD.SOURCES) == sorted(BUILD.SIGNATURES) == sources
    assert {"packed_bwd", "fwd_bb", "tri_edm", "tri_3body"} <= set(sources)
    assert set(BUILD.SIGNATURES["tri_3body"]) == {
        "three_body_tet_launch", "three_body_bb3_launch", "dummy_tet_launch"}
    for name in sources:
        declared = _c_entry_points((PKG / "csrc" / f"{name}.cu").read_text())
        bound = {fn: [kind[t] for t in types]
                 for fn, types in BUILD.SIGNATURES[name].items()}
        assert declared == bound, name
