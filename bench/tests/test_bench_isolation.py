"""What the harness loads: no module of JAX or of the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference loads nothing of the port either."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path[:0] = "
         f"[{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n" + code +
         "\nimport json; print(json.dumps(sorted({n.split('.')[0] for n in "
         "sys.modules})))"],
        capture_output=True, text=True, timeout=240, cwd=str(ROOT),
        env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT / "build"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    mods = _loaded("from bench.tests.util import run_tiny\n"
                   "run_tiny('yi9b-train-packed-docs')\n"
                   "run_tiny('nemotron-serve-chat')\n"
                   "from bench import run\n"
                   "assert run.forbidden_loaded() == []")
    assert "repro_torch" in mods
    assert not mods & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _loaded("import bench.reference.model, bench.reference.train")
    assert not mods & (FORBIDDEN | {"repro_torch"})


def test_nothing_under_bench_names_the_old_benchmark():
    for p in (ROOT / "bench").rglob("*.py"):
        if p.parent.name == "tests":
            continue
        text = p.read_text()
        for old in ("benchmarks", "BENCH_trajectory", "artifacts/"):
            assert old not in text, (p, old)
