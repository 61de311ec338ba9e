"""Meshes (port of ``repro/launch/mesh.py``): abstract axis names and
sizes, and the ``torch.distributed`` process group behind a data axis.

The sharding rules (``parallel/sharding.py``) and the dry-run read a mesh's
``axis_names`` and its ``shape`` (a dict, axis -> size) and nothing else,
as the reference's rules read a ``jax.sharding.Mesh``. The port runs on one
card, so ``make_card_mesh`` is its own mesh; the reference's pod meshes
(``make_production_mesh``) are reckoned, never built.

``init_data_group`` puts a process group behind a mesh's data axis: gloo
across local processes on the CPU, NCCL on the card (where the one H100
is a group of one). Each rank holds the whole model: tensor parallelism
is not ported, so a mesh with a "model" axis larger than 1 is refused.
The trainer's data-parallel step and the int8 grad compression
(``parallel/compression.py``) reduce over that group.
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
    """The ranks of the process group on a 1-D "data" axis when one is up,
    else every visible CUDA device (at least one: the CPU alone is a mesh
    of 1)."""
    import torch
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return AbstractMesh(("data",), (dist.get_world_size(),))
    return AbstractMesh(("data",), (max(1, torch.cuda.device_count()),))


# the backend of each device type: no other is tried
BACKENDS = {"cpu": "gloo", "cuda": "nccl"}
# a collective that waits longer than this on a missing rank raises
GROUP_TIMEOUT_S = 300


def data_parallel_size(mesh: AbstractMesh) -> int:
    """The ranks of ``mesh``'s data axes ("pod" x "data"); refuses an axis
    the port does not shard over (tensor parallelism is not ported)."""
    shape = mesh.shape
    other = {a: n for a, n in shape.items()
             if a not in ("pod", "data") and n > 1}
    if other:
        raise ValueError(
            f"mesh {shape}: the port is data parallel only (each rank holds "
            f"the whole model; tensor parallelism is not ported), so "
            f"{other} must be 1")
    return shape.get("pod", 1) * shape.get("data", 1)


def init_data_group(device, mesh: AbstractMesh | None = None, *,
                    rank: int = 0, store_path: str | None = None):
    """Initialise ``torch.distributed``'s default group as ``mesh``'s data
    axis (default: the card's mesh, one rank) and return it. The backend
    follows ``device``: gloo for "cpu", NCCL for "cuda". The ranks meet
    through a ``FileStore`` at ``store_path`` (any path the ranks share;
    no TCP port), or, for a group of one, through an in-process store."""
    import datetime

    import torch
    import torch.distributed as dist

    world = data_parallel_size(mesh or make_card_mesh())
    dev = torch.device(device)
    backend = BACKENDS.get(dev.type)
    if backend is None:
        raise ValueError(f"no process group backend for device {dev}")
    if store_path is None:
        if world != 1:
            raise ValueError(f"a group of {world} ranks needs a store_path")
        store = dist.HashStore()
    else:
        store = dist.FileStore(store_path, world)
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kw)
    return dist.group.WORLD
