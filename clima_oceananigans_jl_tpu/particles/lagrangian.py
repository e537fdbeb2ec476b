"""Lagrangian particle tracking.

Array re-design of the reference's src/LagrangianParticleTracking/
(LagrangianParticleTracking.jl:17-29, update_particle_properties.jl):
particles are a pytree of coordinate arrays (N,) plus custom property
arrays, advected by trilinear interpolation of the staggered velocity
field — a fully vectorized gather over the particle batch (the array
replacement for the per-particle kernel loop). Walls reflect positions
with a ``restitution`` coefficient; periodic axes wrap. Tracked fields
are sampled onto per-particle properties each step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..grids.topology import BOUNDED, FLAT, PERIODIC
from ..utils.location import C, CENTER, F, U_LOC, V_LOC, W_LOC


def _frac_index(coords, q):
    """Fractional index of q in the increasing 1D coordinate array."""
    if coords.shape[0] == 1:
        z = jnp.zeros_like(q, dtype=jnp.int32)
        return z, jnp.zeros_like(q)
    i = jnp.clip(jnp.searchsorted(coords, q, side="right") - 1,
                 0, coords.shape[0] - 2)
    w = (q - coords[i]) / (coords[i + 1] - coords[i])
    return i.astype(jnp.int32), jnp.clip(w, 0.0, 1.0)


def interpolate_field(data, grid, loc, x, y, z):
    """Trilinear interpolation of a with-halo field at particle positions
    (reference Fields/interpolate.jl, vectorized over particles)."""
    ix, wx = _frac_index(grid.coord(0, loc[0], with_halo=True), x)
    iy, wy = _frac_index(grid.coord(1, loc[1], with_halo=True), y)
    iz, wz = _frac_index(grid.coord(2, loc[2], with_halo=True), z)

    def g(dx, dy, dz):
        return data[jnp.minimum(ix + dx, data.shape[0] - 1),
                    jnp.minimum(iy + dy, data.shape[1] - 1),
                    jnp.minimum(iz + dz, data.shape[2] - 1)]

    return (
        g(0, 0, 0) * (1 - wx) * (1 - wy) * (1 - wz)
        + g(1, 0, 0) * wx * (1 - wy) * (1 - wz)
        + g(0, 1, 0) * (1 - wx) * wy * (1 - wz)
        + g(1, 1, 0) * wx * wy * (1 - wz)
        + g(0, 0, 1) * (1 - wx) * (1 - wy) * wz
        + g(1, 0, 1) * wx * (1 - wy) * wz
        + g(0, 1, 1) * (1 - wx) * wy * wz
        + g(1, 1, 1) * wx * wy * wz)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class LagrangianParticles:
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    properties: Dict[str, jnp.ndarray] = dataclasses.field(default_factory=dict)
    restitution: float = 1.0
    tracked_fields: Tuple[str, ...] = ()

    def tree_flatten(self):
        keys = tuple(sorted(self.properties))
        return ((self.x, self.y, self.z) + tuple(self.properties[k] for k in keys),
                (keys, self.restitution, self.tracked_fields))

    @classmethod
    def tree_unflatten(cls, static, leaves):
        keys, restitution, tracked = static
        return cls(leaves[0], leaves[1], leaves[2],
                   dict(zip(keys, leaves[3:])), restitution, tracked)

    def __len__(self):
        return self.x.shape[0]

    def _apply_boundaries(self, q, grid, axis):
        ax = grid._axes[axis]
        if ax.topo is FLAT:
            return q
        lo = ax.cf[ax.h]
        hi = lo + ax.extent
        if ax.topo is PERIODIC:
            return lo + jnp.mod(q - lo, ax.extent)
        # bounded: elastic reflection damped by restitution (reference
        # enforce_boundary_conditions, restitution kwarg)
        e = self.restitution
        q = jnp.where(q < lo, lo + e * (lo - q), q)
        q = jnp.where(q > hi, hi - e * (q - hi), q)
        return jnp.clip(q, lo, hi)

    def step(self, grid, velocities, dt, fields=None):
        """Advect with forward-Euler trilinear-sampled velocities, apply
        wall/periodic boundaries, sample tracked fields; returns a new
        LagrangianParticles."""
        u = interpolate_field(velocities["u"], grid, U_LOC, self.x, self.y, self.z)
        v = interpolate_field(velocities["v"], grid, V_LOC, self.x, self.y, self.z)
        w = interpolate_field(velocities.get("w", jnp.zeros_like(velocities["u"])),
                              grid, W_LOC, self.x, self.y, self.z) \
            if "w" in velocities else jnp.zeros_like(u)
        x = self._apply_boundaries(self.x + dt * u, grid, 0)
        y = self._apply_boundaries(self.y + dt * v, grid, 1)
        z = self._apply_boundaries(self.z + dt * w, grid, 2)
        props = dict(self.properties)
        if fields:
            for name in self.tracked_fields:
                if name in fields:
                    props[name] = interpolate_field(fields[name], grid, CENTER,
                                                    x, y, z)
        return LagrangianParticles(x, y, z, props, self.restitution,
                                   self.tracked_fields)
