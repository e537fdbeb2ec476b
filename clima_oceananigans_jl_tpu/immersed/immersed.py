"""Immersed boundaries: masked topography on any grid.

Array re-design of the reference's src/ImmersedBoundaries/
(ImmersedBoundaries.jl:103, grid_fitted_immersed_boundaries.jl:39,137,
mask_immersed_field.jl, conditional_fluxes.jl): solid geometry is a set
of precomputed boolean masks — one per staggered location — and masking
is a ``jnp.where`` applied to fields and tendencies after each update
(branch-free, fused by XLA). A velocity face is
solid when either adjacent cell center is solid (the reference's
"peripheral node" rule), which zeroes advective/diffusive transport
through the boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..utils.location import C, CENTER, F, U_LOC, V_LOC, W_LOC


def _face_mask(solid_c, axis):
    """Face solid if either adjacent center solid; with-halo roll."""
    return solid_c | jnp.roll(solid_c, 1, axis=axis)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ImmersedBoundary:
    """Precomputed solid masks per staggered location (True = solid)."""

    solid_ccc: jnp.ndarray
    solid_fcc: jnp.ndarray
    solid_cfc: jnp.ndarray
    solid_ccf: jnp.ndarray

    def tree_flatten(self):
        return (self.solid_ccc, self.solid_fcc, self.solid_cfc, self.solid_ccf), ()

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves)

    @classmethod
    def from_mask(cls, grid, mask_fn):
        """GridFittedBoundary (reference :137): mask_fn(x,y,z) → True solid."""
        x, y, z = grid.nodes(CENTER, with_halo=True)
        solid = jnp.broadcast_to(mask_fn(x, y, z), grid.total_shape)
        return cls(solid, _face_mask(solid, 0), _face_mask(solid, 1),
                   _face_mask(solid, 2))

    @classmethod
    def from_bottom_height(cls, grid, bottom):
        """GridFittedBottom (reference :39): solid where z < h(x, y)."""
        x, y, z = grid.nodes(CENTER, with_halo=True)
        h = bottom(x, y) if callable(bottom) else jnp.asarray(bottom, grid.dtype)
        solid = jnp.broadcast_to(z < h, grid.total_shape)
        return cls(solid, _face_mask(solid, 0), _face_mask(solid, 1),
                   _face_mask(solid, 2))

    def mask_for(self, loc):
        """Solid mask at any staggered location: a node is solid when any
        adjacent cell center is solid (the reference's peripheral-node
        rule, extended to corner locations like (F,F,C))."""
        loc = tuple(loc)
        if loc == U_LOC:
            return self.solid_fcc
        if loc == V_LOC:
            return self.solid_cfc
        if loc == W_LOC:
            return self.solid_ccf
        if loc == (C, C, C):
            return self.solid_ccc
        m = self.solid_ccc
        for a in range(3):
            if loc[a] is F:
                m = m | jnp.roll(m, 1, axis=a)
        return m

    def mask_field(self, data, loc, value=0.0):
        """Zero (or set) a field inside the solid
        (reference mask_immersed_field!)."""
        return jnp.where(self.mask_for(loc), value, data)

    # -- model hooks ---------------------------------------------------------
    def mask_state(self, model, state):
        locs = model._locs()
        sol = {name: self.mask_field(arr, locs[name])
               for name, arr in state["solution"].items()}
        return dict(state, solution=sol)

    def mask_tendency(self, model, name, G):
        return self.mask_field(G, model._locs().get(name, CENTER))


@jax.tree_util.register_pytree_node_class
class ImmersedGrid:
    """Grid wrapper carrying an immersed boundary — the array analog of the
    reference's ImmersedBoundaryGrid (ImmersedBoundaries.jl:103). Models
    wrap their (halo-inflated) grid in this internally when an immersed
    boundary is supplied; everything forwards to the parent grid, and

    * ``.immersed`` exposes the boundary's masks — advection's
      ``transport`` consults it for conditional (reduced-order /
      zeroed) fluxes near the solid (conditional_fluxes.jl), and field
      reductions exclude solid cells (immersed_reductions.jl);
    * PartialCellBottom overrides the vertical metrics with 3D arrays
      whose bottom-adjacent cells have fractional heights
      (partial_cell_immersed_boundaries.jl) — legal everywhere the
      operators broadcast metrics, which is all of them.
    """

    def __init__(self, parent, boundary, dz_ccc=None, dz_ccf=None):
        self.parent = parent
        self.boundary = boundary
        self._dz_ccc = dz_ccc
        self._dz_ccf = dz_ccf

    @classmethod
    def wrap(cls, parent, boundary):
        return cls(parent, boundary, getattr(boundary, "dz_ccc", None),
                   getattr(boundary, "dz_ccf", None))

    def tree_flatten(self):
        return (self.parent, self.boundary, self._dz_ccc, self._dz_ccf), ()

    @classmethod
    def tree_unflatten(cls, static, leaves):
        obj = object.__new__(cls)
        (obj.parent, obj.boundary, obj._dz_ccc, obj._dz_ccf) = leaves
        return obj

    @property
    def immersed(self):
        return self.boundary

    def __getattr__(self, name):
        if name.startswith("__") or "parent" not in self.__dict__:
            raise AttributeError(name)
        return getattr(self.parent, name)

    def __repr__(self):
        return f"ImmersedGrid({self.parent!r})"

    def subgrid_along(self, axis, start, n_new):
        """Immersed-aware sub-grid strip (see RectilinearGrid.subgrid_along):
        the parent grid slices its coordinates and every boundary leaf —
        solid masks and partial-cell Δz overrides — is sliced with the
        same with-halo window, so the halo-overlap edge-strip recompute
        sees exactly the local masks it would on the full grid."""
        parent_sub = self.parent.subgrid_along(axis, start, n_new)
        h = self.parent.halo[axis]
        sl = [slice(None)] * 3
        sl[axis] = slice(start, start + n_new + 2 * h)
        sl = tuple(sl)
        bl, btd = jax.tree_util.tree_flatten(self.boundary)
        b_sub = jax.tree_util.tree_unflatten(
            btd, [l[sl] if getattr(l, "ndim", 0) == 3 else l for l in bl])
        cut = lambda a: None if a is None else a[sl]
        return ImmersedGrid(parent_sub, b_sub,
                            cut(self._dz_ccc), cut(self._dz_ccf))

    # -- partial-cell vertical metrics --------------------------------------
    def spacing(self, axis, loc):
        if axis == 2 and self._dz_ccc is not None:
            return self._dz_ccc if loc[2] is C else self._dz_ccf
        return self.parent.spacing(axis, loc)

    def dz(self, loc):
        return self.spacing(2, loc)

    def Ax(self, loc):
        return self.parent.dy(loc) * self.dz(loc)

    def Ay(self, loc):
        return self.parent.dx(loc) * self.dz(loc)

    def V(self, loc):
        return self.parent.Az(loc) * self.dz(loc)


@dataclasses.dataclass(frozen=True)
class GridFittedBoundary:
    """Spec: solid where mask(x, y, z); built by the model on its final
    (halo-inflated) grid via ``.build(grid)``."""

    mask: Any

    def build(self, grid):
        return ImmersedBoundary.from_mask(grid, self.mask)


@dataclasses.dataclass(frozen=True)
class GridFittedBottom:
    """Spec: solid where z < bottom_height(x, y) (or a constant/array)."""

    bottom_height: Any

    def build(self, grid):
        return ImmersedBoundary.from_bottom_height(grid, self.bottom_height)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PartialCellBoundary(ImmersedBoundary):
    """Bottom immersed boundary with fractional (partial) bottom cells
    (reference partial_cell_immersed_boundaries.jl:11): the lowest fluid
    cell of each column is shortened to the actual water depth above the
    bathymetry, clamped at ``minimum_fraction`` of the full cell. The 3D
    Δz arrays feed ImmersedGrid's vertical-metric overrides."""

    dz_ccc: jnp.ndarray = None
    dz_ccf: jnp.ndarray = None

    def tree_flatten(self):
        return (self.solid_ccc, self.solid_fcc, self.solid_cfc,
                self.solid_ccf, self.dz_ccc, self.dz_ccf), ()

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves)

    @classmethod
    def from_bottom(cls, grid, bottom, minimum_fraction=0.2):
        x, y, _ = grid.nodes(CENTER, with_halo=True)
        h = bottom(x, y) if callable(bottom) else jnp.asarray(bottom, grid.dtype)
        h = jnp.asarray(h, grid.dtype)
        ax = grid._axes[2]
        z_bot = ax.cf.reshape(1, 1, -1)
        dz = ax.dc.reshape(1, 1, -1)
        z_top = z_bot + dz
        # a cell is solid iff its top face is at/below the bottom height;
        # the partially-submerged cell keeps a fluid sliver
        solid = jnp.broadcast_to(z_top <= h, grid.total_shape)
        partial = (z_bot < h) & (z_top > h)
        dz_eff = jnp.where(partial,
                           jnp.maximum(z_top - h, minimum_fraction * dz), dz)
        dz_ccc = jnp.broadcast_to(dz_eff, grid.total_shape).astype(grid.dtype)
        # face spacing = distance between effective cell centers
        zc_eff = z_top - 0.5 * dz_eff
        dz_f = zc_eff - jnp.roll(zc_eff, 1, axis=2)
        df = ax.df.reshape(1, 1, -1)
        dz_f = dz_f.at[:, :, :1].set(jnp.broadcast_to(df, dz_f.shape)[:, :, :1])
        dz_ccf = jnp.broadcast_to(dz_f, grid.total_shape).astype(grid.dtype)
        return cls(solid, _face_mask(solid, 0), _face_mask(solid, 1),
                   _face_mask(solid, 2), dz_ccc, dz_ccf)


@dataclasses.dataclass(frozen=True)
class PartialCellBottom:
    """Spec: GridFittedBottom with partial (fractional-height) bottom
    cells (reference PartialCellBottom)."""

    bottom_height: Any
    minimum_fraction: float = 0.2

    def build(self, grid):
        return PartialCellBoundary.from_bottom(grid, self.bottom_height,
                                               self.minimum_fraction)
