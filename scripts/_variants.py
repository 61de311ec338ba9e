"""What the scripts that time candidate kernel sources on one card share
(decode_variants.py, prefill_variants.py, scan_variants.py): edits of a
source's text, a copy of the port's source directory with edits applied,
the copies built with the port's nvcc flags in parallel and loaded through
ctypes, ptxas's report read, and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _die(msg: str):
    sys.exit(f"{Path(sys.argv[0]).stem}: {msg}")


def swap(old: str, new: str, count: int = 1):
    """An edit replacing ``old``, which the text must hold ``count``
    times, by ``new``."""
    def edit(text):
        if text.count(old) != count:
            _die(f"the source no longer holds {old!r} {count} times")
        return text.replace(old, new)
    return edit


def between(start: str, end: str, new: str):
    """An edit replacing the text from ``start`` up to ``end`` (each held
    once) by ``new``."""
    def edit(text):
        if text.count(start) != 1 or text.count(end) != 1:
            _die(f"the source no longer holds {start!r} ... {end!r}")
        a, b = text.index(start), text.index(end)
        return text[:a] + new + text[b:]
    return edit


def patched(csrc: Path, script: str, name: str, edits: dict) -> Path:
    """A copy of the source directory ``csrc`` at
    build/<script>/<name>, with ``edits`` ({file: [edit]}) applied."""
    out = ROOT / "build" / script / re.sub(r"[^A-Za-z0-9.]+", "_", name)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for fname, fns in edits.items():
        text = (out / fname).read_text()
        for edit in fns:
            text = edit(text)
        (out / fname).write_text(text)
    return out


def build(BUILD, jobs: dict) -> dict:
    """Compiles every job, name -> (source directory, source, output
    directory[, signatures]), with the port's nvcc flags, all at once.
    Returns name -> (the library loaded with the source's signatures,
    BUILD.SIGNATURES[source] unless given; ptxas's report, also written
    beside the library as <source>.log)."""
    procs = {}
    for name, (csrc, src, out, *_) in jobs.items():
        out.mkdir(parents=True, exist_ok=True)
        cmd = [BUILD._nvcc(), *BUILD.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(out / f"lib{src}.so"), str(csrc / f"{src}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        csrc, src, out, *sig = jobs[name]
        log, _ = proc.communicate()
        (out / f"{src}.log").write_text(log)
        if proc.returncode != 0:
            _die(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{src}.so"))
        for fn, argtypes in (sig[0] if sig else BUILD.SIGNATURES[src]).items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, log)
    return libs


def f32_ptxas(log: str, kernel: str) -> list:
    """ptxas's (registers, spill store bytes) of each f32 instantiation of
    ``kernel`` (mangled ``<kernel>If...``), in the report's order."""
    lines = log.splitlines()
    rows = []
    for at, line in enumerate(lines):
        if "Compiling entry" in line and f"{kernel}If" in line:
            text = " ".join(lines[at + 1:at + 4])
            regs = re.search(r"Used (\d+) registers", text)
            spill = re.search(r"(\d+) bytes spill stores", text)
            rows.append((int(regs.group(1)) if regs else None,
                         int(spill.group(1)) if spill else None))
    return rows


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
