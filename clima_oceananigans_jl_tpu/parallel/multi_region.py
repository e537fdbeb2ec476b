"""MultiRegion: intra-host multi-device partitioning.

API-parity wrapper for /root/reference/src/MultiRegion/ (multi_region_grid.jl:5-66,
``MultiRegionGrid(grid; partition=XPartition(n), devices)``,
``@apply_regionally``). Under JAX this subsystem collapses: the reference's
per-GPU region objects, device switching and unified-memory solvers
(multi_region_transformation.jl:93-111) are exactly what a
``jax.sharding.Mesh`` over the host's local GPUs provides — so a
MultiRegionGrid here is a thin front-end that builds the mesh and reuses
the general distributed machinery (shard_map + ppermute halo exchange).
The cubed-sphere region exchange — the part of MultiRegion with real
structure — lives in grids/cubed_sphere.py.
"""
from __future__ import annotations

import dataclasses

import jax

from .distributed import DistributedModel, make_mesh


@dataclasses.dataclass(frozen=True)
class XPartition:
    n: int


@dataclasses.dataclass(frozen=True)
class YPartition:
    n: int


class MultiRegionGrid:
    """grid + partition → a device mesh; ``wrap(model)`` gives the
    region-parallel model (the @apply_regionally analog is the shard_map
    inside DistributedModel)."""

    def __init__(self, grid, partition=None, devices=None):
        self.global_grid = grid
        if partition is None:
            partition = XPartition(len(devices or jax.devices()))
        if isinstance(partition, XPartition):
            shape = (partition.n, 1)
        elif isinstance(partition, YPartition):
            shape = (1, partition.n)
        else:
            shape = tuple(partition)
        self.mesh = make_mesh(shape, devices)
        self.partition = partition

    def wrap(self, model):
        """Distribute a model built on the global grid over the regions."""
        return DistributedModel(model, self.mesh)


def apply_regionally(fn, *args, **kwargs):
    """The reference's @apply_regionally: under jax there is no device
    loop — sharded arrays already execute region-parallel. Provided for
    API familiarity; simply calls fn."""
    return fn(*args, **kwargs)
