"""Layout hints and sharding rules (ports of ``repro/parallel/hints.py``
and ``sharding.py``)."""
