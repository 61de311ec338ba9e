"""Build and bind the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
builds run in parallel (one ``nvcc`` per source, all started together)
into ``build/repro_torch_kernels/<hash>/`` under the checkout, keyed by a
hash of every source and the flags, so a changed source rebuilds and an
unchanged one loads at once. Nothing is compiled at import time: the
first ``load`` (or an explicit ``build_all``) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("packed_fwd", "packed_decode", "fused_step", "tri_fwd", "tri_bwd",
           "packed_bwd", "fwd_bb", "tri_edm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "packed_fwd": {
        "packed_fwd_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _I, _P],
        "member_map_probe": [_P, _P, _P, _P, _I, _P],
    },
    "packed_decode": {
        "packed_decode_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                 _I, _F, _I, _I, _P],
    },
    "fused_step": {
        "fused_step_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    },
    # (B, H, Hkv, S, D, blk, n, w, p, win, pre, scale, dtype, stream)
    "tri_fwd": {
        "tri_fwd_launch": [_P] * 5 + [_I] * 11 + [_F, _I, _P],
    },
    "tri_bwd": {
        "tri_bwd_dq_launch": [_P] * 7 + [_I] * 11 + [_F, _I, _P],
        "tri_bwd_dkv_launch": [_P] * 8 + [_I] * 11 + [_F, _I, _P],
    },
    # (B, H, Hkv, S, D, blk, table, n_members, total_tiles, scale, dtype,
    #  stream)
    "packed_bwd": {
        "packed_bwd_dq_launch": [_P] * 7 + [_I] * 6 + [_P, _I, _I]
        + [_F, _I, _P],
        "packed_bwd_dkv_launch": [_P] * 8 + [_I] * 6 + [_P, _I, _I]
        + [_F, _I, _P],
    },
    # (q, k, v, out, lse, part, arrivals, B, H, Hkv, S, D, blk, n, win,
    #  scale, dtype, stream)
    "fwd_bb": {
        "fwd_bb_launch": [_P] * 7 + [_I] * 8 + [_F, _I, _P],
    },
    # (x, out, N, d, blk, squared, dtype, stream); (out, n, stream)
    "tri_edm": {
        "edm_ltm_launch": [_P, _P] + [_I] * 5 + [_P],
        "edm_bb_launch": [_P, _P] + [_I] * 5 + [_P],
        "dummy_ltm_launch": [_P, _I, _P],
    },
}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME/bin or PATH): the "
                           "CUDA kernels build only where the toolkit is")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every missing library in parallel; returns the seconds the
    build took (0.0 when everything was already built). Raises with the
    compiler's output when a source does not compile."""
    out = build_dir()
    todo = [s for s in SOURCES if not (out / f"lib{s}.so").exists()]
    if not todo:
        return 0.0
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for s in todo:
        tmp = out / f"lib{s}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{s}.cu")]
        procs[s] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for s, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{s}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {s}.cu (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out / f"lib{s}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name`` (built on first use), with
    argtypes/restype declared for every exported function."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib
