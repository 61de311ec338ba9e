"""Block-space maps (mapping.py) and packed member tables (packing.py)."""
