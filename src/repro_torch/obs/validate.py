"""CLI: validate obs artifacts against the port's ``obs/schema.py``
(port of ``repro/obs/validate.py``).

    python -m repro_torch.obs.validate artifacts/metrics.json \\
        [trajectory.json] [artifacts/trace/*.jsonl]

A file's role follows from its shape: a JSON object is a metrics
document, a JSON array a trajectory, a ``.jsonl`` file a trace event
stream. Exits 0 iff every file parses and validates.
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import schema


def validate_file(path: str) -> list:
    """'<path>: problem' strings (empty: valid)."""
    if path.endswith(".jsonl"):
        errors, n = [], 0
        with open(path, encoding="utf-8") as fh:
            for line_no, line in enumerate(fh, 1):
                line = line.strip()
                if not line:
                    continue
                n += 1
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError as e:
                    errors.append(f"{path}:{line_no}: bad JSON: {e}")
                    continue
                errors.extend(f"{path}:{line_no}: {msg}"
                              for msg in schema.validate_event(ev))
        if n == 0:
            errors.append(f"{path}: empty trace stream")
        return errors
    with open(path, encoding="utf-8") as fh:
        try:
            doc = json.load(fh)
        except json.JSONDecodeError as e:
            return [f"{path}: bad JSON: {e}"]
    if isinstance(doc, list):
        return [f"{path}: {msg}" for msg in schema.validate_trajectory(doc)]
    return [f"{path}: {msg}" for msg in schema.validate_metrics(doc)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.validate",
        description="Validate obs metrics / trajectory / trace artifacts.")
    ap.add_argument("paths", nargs="+")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)
    all_errors = []
    for path in args.paths:
        errs = validate_file(path)
        all_errors.extend(errs)
        if not args.quiet:
            print(f"[obs.validate] {'FAIL' if errs else 'ok':4s} {path}")
    for e in all_errors:
        print(f"[obs.validate]   {e}", file=sys.stderr)
    return 1 if all_errors else 0


if __name__ == "__main__":
    sys.exit(main())
