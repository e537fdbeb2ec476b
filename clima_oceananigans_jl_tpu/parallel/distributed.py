"""Distributed models: shard_map the full time step over a device mesh.

Analog of the reference's ``MultiArch`` + distributed model
wiring (/root/reference/src/Distributed/): the user builds a model on the
GLOBAL grid, wraps it in ``DistributedModel(model, mesh)``, and gets the
same ``initial_state``/``step`` API with every per-step array op running
under one ``shard_map`` over the ``(x, y)`` mesh. Halo exchange rides the
BC layer (ppermute, NCCL over NVLink), global reductions become psums,
and XLA
overlaps communication with interior compute.
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import functools

try:  # jax>=0.8: check_vma replaces check_rep
    from jax import shard_map as _shard_map
    shard_map = functools.partial(_shard_map, check_vma=False)
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map
    shard_map = functools.partial(_shard_map, check_rep=False)

from .decomposition import gather_array, partition_grid, scatter_array


def make_mesh(mesh_shape, devices=None):
    import numpy as np
    devices = devices if devices is not None else jax.devices()
    n = mesh_shape[0] * mesh_shape[1]
    return Mesh(np.array(devices[:n]).reshape(mesh_shape), ("x", "y"))


class DistributedModel:
    """Wraps a model built on a global grid; steps run shard_mapped.

    ``overlap_halo=True`` enables the interior/edge-split step
    (``tendencies_overlapped`` on the nonhydrostatic and hydrostatic
    models): halo-exchange ppermutes are issued with no data dependency
    on the bulk tendency compute, so XLA schedules the collectives
    concurrently with it — the analog of the reference's
    nonblocking-MPI interior/boundary kernel split
    (halo_communication.jl:68-86). Supports immersed boundaries
    (shard-local masks, strip-sliced) and background fields; requires a
    model with that method, no particles, and local shards at least
    2 halo-widths wide on each cut axis.
    """

    def __init__(self, model, mesh, overlap_halo=False):
        self.mesh = mesh
        self.mesh_shape = (mesh.shape["x"], mesh.shape["y"])
        self.global_model = model
        self.grid = model.grid  # the global grid (for the user-facing API)
        (self.stacked_grid, self.grid_specs,
         self.local_grid) = partition_grid(model.grid, self.mesh_shape)
        self.local_model = copy.copy(model)
        self.local_model.grid = self.local_grid
        if getattr(self.local_grid, "immersed", None) is not None:
            self.local_model.immersed_boundary = self.local_grid.immersed
        if overlap_halo:
            if not hasattr(model, "tendencies_overlapped"):
                raise ValueError("overlap_halo: model has no "
                                 "tendencies_overlapped")
            if getattr(model, "particles", None) is not None:
                raise ValueError("overlap_halo is not supported with "
                                 "particles")
            for axis, nsh in zip((0, 1), self.mesh_shape):
                if nsh > 1 and (self.local_grid.shape[axis]
                                < 2 * self.local_grid.halo[axis]):
                    raise ValueError("overlap_halo: local shard thinner "
                                     "than 2 halo widths on a cut axis")
            self.local_model.halo_overlap = True
        if getattr(model, "pressure_solver", None) is not None:
            # swap the serial FFT solver for the all_to_all pencil solver
            from .distributed_fft import select_distributed_pressure_solver
            self.local_model.pressure_solver = \
                select_distributed_pressure_solver(self.local_grid)

        local_model = self.local_model

        def _local_step(grid, state, dt):
            m = copy.copy(local_model)
            m.grid = grid
            if getattr(grid, "immersed", None) is not None:
                # per-shard solid masks ride the partitioned grid
                m.immersed_boundary = grid.immersed
            return m.step(state, dt)

        self._sharded_step = None
        self._local_step = _local_step

    def _spec_of(self, leaf):
        if getattr(leaf, "ndim", 0) >= 2:
            return P("x", "y")
        return P()

    def _state_specs(self, state):
        return jax.tree_util.tree_map(self._spec_of, state)

    def scatter_state(self, state):
        """Global-array state → stacked distributed state (device_put sharded)."""
        def scatter(leaf):
            if getattr(leaf, "ndim", 0) >= 2:
                arr = scatter_array(leaf, self.grid, self.mesh_shape)
                return jax.device_put(arr, NamedSharding(self.mesh, P("x", "y")))
            return jax.device_put(leaf, NamedSharding(self.mesh, P()))
        return jax.tree_util.tree_map(scatter, state)

    def gather_state(self, state):
        return jax.tree_util.tree_map(
            lambda leaf: (gather_array(jax.device_get(leaf), self.grid,
                                       self.mesh_shape)
                          if getattr(leaf, "ndim", 0) >= 2 else leaf),
            state)

    def initial_state(self, **values):
        return self.scatter_state(self.global_model.initial_state(**values))

    def step(self, state, dt):
        if self._sharded_step is None:
            specs = self._state_specs(state)
            fn = shard_map(self._local_step, mesh=self.mesh,
                           in_specs=(self.grid_specs, specs, P()),
                           out_specs=specs)
            self._sharded_step = jax.jit(fn)
        return self._sharded_step(self.stacked_grid, state,
                                  jnp.asarray(dt, self.grid.dtype))

    # conveniences mirroring the plain models
    def prognostic_names(self):
        return self.global_model.prognostic_names()
