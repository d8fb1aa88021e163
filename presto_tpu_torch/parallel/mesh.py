"""Device mesh of the scheduler's multi-device stages (the port of
presto_tpu/parallel/mesh.py's host half).

The reference maps FIXED_HASH task partition i onto position i of a 1-D
`jax.sharding.Mesh` over WORKER_AXIS.  The port has no mesh yet
(multi-device exchange on torch.distributed is still to come): `mesh`
is always None here, so every remote exchange rides the page ("http")
fabric and mesh_size is 0.
"""
from __future__ import annotations

WORKER_AXIS = "workers"


def mesh_size(mesh) -> int:
    """Worker count of a scheduler mesh (0 when no mesh is configured);
    a mesh raises, since the port cannot pin tasks to devices yet."""
    if mesh is None:
        return 0
    raise NotImplementedError(
        "a device mesh is not ported yet (ROADMAP queue 1: the "
        "multi-device exchange on torch.distributed)")
