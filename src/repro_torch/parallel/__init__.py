"""Layout hints (port of ``repro/parallel/hints.py``; one device)."""
