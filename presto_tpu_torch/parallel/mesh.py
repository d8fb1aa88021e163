"""Device mesh of the scheduler's multi-device stages (the port of
presto_tpu/parallel/mesh.py).

The reference maps FIXED_HASH task partition i onto position i of a 1-D
`jax.sharding.Mesh` over WORKER_AXIS, and the hashed exchange between
stages pinned to it is an all_to_all over the mesh (parallel/exchange.py).
The port's mesh is the same thing without a collective library: an
ordered list of `torch.device`s, one per task partition, driven by one
process.  Positions may repeat: N positions on `cuda:0` are the card
split the way the reference's tests split the CPU into virtual devices,
and on a host with several cards the positions are distinct cards, where
the exchange's copies become peer copies.  `torch.distributed` is not the
fabric: a process group needs one process per rank and refuses two ranks
on one card, while the reference's exchange runs under one controller.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

WORKER_AXIS = "workers"


class DeviceMesh:
    """Ordered mesh positions over WORKER_AXIS (`devices[i]` is task
    partition i's device)."""

    def __init__(self, devices: Sequence, axis_names=(WORKER_AXIS,)):
        self.devices: List[torch.device] = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one position")
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return {WORKER_AXIS: len(self.devices)}

    def __repr__(self) -> str:
        return f"DeviceMesh({[str(d) for d in self.devices]})"

    def check_on(self, device: torch.device) -> None:
        """Raise unless every position is of `device`'s kind (a runner
        on the card takes a mesh of card positions, a CPU runner one of
        CPU positions): no mesh moves a runner off its device."""
        kinds = {d.type for d in self.devices}
        if kinds != {torch.device(device).type}:
            raise ValueError(
                f"mesh positions {[str(d) for d in self.devices]} are not "
                f"on the runner's device {device}")


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh over `devices` (default: every visible CUDA device; without
    CUDA that raises, as every entry point of the port does), cut to its
    first `n_devices` positions."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() defaults to the visible CUDA devices but CUDA "
                "is not available; pass devices=[...] to build a CPU mesh")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return DeviceMesh(devs)


def mesh_size(mesh: Optional[DeviceMesh]) -> int:
    """Worker count of a scheduler mesh (0 when no mesh is configured) --
    the task count the scheduler pins 1:1 to positions for ici-fabric
    stages (parallel/fabric.py resolve_fabric)."""
    return 0 if mesh is None else mesh.shape[WORKER_AXIS]


@dataclass(frozen=True)
class Placement:
    """How a tensor lies on a mesh: `spec` (WORKER_AXIS,) shards dim 0
    (rows) across the positions, () replicates it on every position (the
    reference's NamedSharding over a PartitionSpec)."""
    mesh: DeviceMesh
    spec: tuple

    def place(self, tensor: torch.Tensor) -> List[torch.Tensor]:
        """The per-position shards of `tensor` (row shards split dim 0
        into equal parts, which must divide evenly)."""
        devs = self.mesh.devices
        if not self.spec:
            return [tensor.to(d) for d in devs]
        n = len(devs)
        if tensor.shape[0] % n:
            raise ValueError(f"{tensor.shape[0]} rows do not shard evenly "
                             f"over {n} positions")
        return [part.to(d) for part, d in zip(tensor.chunk(n), devs)]


def row_sharding(mesh: DeviceMesh) -> Placement:
    """Shard dim 0 (rows) across workers."""
    return Placement(mesh, (WORKER_AXIS,))


def replicated(mesh: DeviceMesh) -> Placement:
    return Placement(mesh, ())
