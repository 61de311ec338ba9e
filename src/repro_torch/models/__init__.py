"""Model layers and the dense transformer (ports of ``repro/models``)."""
