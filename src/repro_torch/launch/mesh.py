"""Abstract meshes (port of ``repro/launch/mesh.py``): axis names and
sizes, with no devices behind them.

The sharding rules (``parallel/sharding.py``) and the dry-run read a mesh's
``axis_names`` and its ``shape`` (a dict, axis -> size) and nothing else,
as the reference's rules read a ``jax.sharding.Mesh``. The port runs on one
card, so ``make_card_mesh`` is its own mesh; the reference's pod meshes
(``make_production_mesh``) are reckoned, never built. A
``torch.distributed`` device mesh waits with the grad compression and the
elastic restore (ROADMAP queue A).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's pod meshes: 16 x 16 = 256 chips a pod, 2 pods =
    512. Axes: "data" = DP/FSDP, "model" = TP; "pod" composes with "data"
    for the batch dimension."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_card_mesh() -> AbstractMesh:
    """The one card the port runs on: ("data",) of 1."""
    return AbstractMesh(("data",), (1,))


def make_local_mesh() -> AbstractMesh:
    """Every visible CUDA device on a 1-D "data" axis (at least one: the
    CPU alone is a mesh of 1)."""
    import torch

    return AbstractMesh(("data",), (max(1, torch.cuda.device_count()),))
