"""Model configurations (ports of ``repro/configs``)."""
