"""Latitude-longitude (spherical-shell) grids with precomputed metrics.

Array re-design of the reference's src/Grids/latitude_longitude_grid.jl
(struct :5-44, ``precompute_metrics`` kwarg :92): curvilinear horizontal
metrics Δxᶠᶜᵃ…Azᶜᶜᵃ are always precomputed here (memory is cheap relative
to recomputing trig in every stencil; XLA streams them alongside the
fields). The grid exposes the same metric protocol as ``RectilinearGrid``
(``spacing``/``dx``/``dy``/``dz``/``Ax``/``Ay``/``Az``/``V`` as functions
of the location triple) so every operator, BC and model works unchanged.

Conventions: longitude λ and latitude φ in degrees (user-facing, like the
reference), z in meters; all metric arrays in meters. Cell x-width
Δx = R cos φ Δλ; y-width Δy = R Δφ; horizontal cell area uses the exact
spherical patch Az = R² Δλ (sin φ⁺ − sin φ⁻)
(reference spacings_and_areas_and_volumes.jl)."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.location import C, F, Loc
from .rectilinear import RectilinearGrid, _Axis, _build_axis, _bx
from .topology import BOUNDED, FLAT, FULLY_CONNECTED, PERIODIC, Topology

R_EARTH = 6_371_000.0  # meters (reference Grids.jl R_Earth)
DEG = np.pi / 180.0


class LatitudeLongitudeGrid(RectilinearGrid):
    """Spherical-shell grid; axis 0 = longitude, 1 = latitude, 2 = z."""

    curvilinear = True

    def __init__(self, *, size, longitude, latitude, z=None, radius=R_EARTH,
                 topology=None, halo=None, dtype=jnp.float32):
        if len(size) != 3:
            raise ValueError("size must be a 3-tuple")
        if topology is None:
            lam_span = abs(float(longitude[-1]) - float(longitude[0]))
            lam_topo = PERIODIC if abs(lam_span - 360.0) < 1e-10 else BOUNDED
            z_topo = FLAT if size[2] == 1 and z is None else BOUNDED
            topology = (lam_topo, BOUNDED, z_topo)
        topology = tuple(Topology(t) for t in topology)
        if halo is None:
            halo = tuple(0 if t is FLAT else 3 for t in topology)
        halo = tuple(0 if t is FLAT else max(1, h) for h, t in zip(halo, topology))
        self.dtype = dtype
        self.radius = float(radius)

        def interval(spec):
            if spec is not None and not callable(spec) and np.ndim(spec) == 1 and len(spec) == 2:
                return (float(spec[0]), float(spec[1])), None
            return None, spec

        lam_i, lam_s = interval(longitude)
        phi_i, phi_s = interval(latitude)
        z_i, z_s = interval(z if z is not None else (0.0, 1.0))
        self._axes = (
            _build_axis(size[0], halo[0], topology[0], lam_i, lam_s, dtype=dtype),
            _build_axis(size[1], halo[1], topology[1], phi_i, phi_s, dtype=dtype),
            _build_axis(size[2], halo[2], topology[2], z_i, z_s, dtype=dtype),
        )
        self.dist = (None, None, None)
        self._init_static()
        self._precompute_metrics()

    # -- metric precomputation ------------------------------------------------
    def _precompute_metrics(self):
        R = self.radius
        lam, phi = self._axes[0], self._axes[1]
        # 1D per-location ingredients (with halos), float64 for accuracy
        dlam = {C: np.asarray(lam.dc, np.float64), F: np.asarray(lam.df, np.float64)}
        phi_at = {C: np.asarray(phi.cc, np.float64), F: np.asarray(phi.cf, np.float64)}
        dphi = {C: np.asarray(phi.dc, np.float64), F: np.asarray(phi.df, np.float64)}
        to = lambda a: jnp.asarray(a, self.dtype)

        # Δx[(lx, ly)] with shape (nx, ny, 1): R cosφ Δλ
        self._dx_m = {}
        for lx in (C, F):
            for ly in (C, F):
                arr = (R * DEG * np.cos(DEG * phi_at[ly])[None, :]
                       * dlam[lx][:, None])
                self._dx_m[(lx, ly)] = to(arr[:, :, None])
        # Δy[ly] shape (1, ny, 1): R Δφ
        self._dy_m = {ly: to((R * DEG * dphi[ly])[None, :, None]) for ly in (C, F)}
        # Az[(lx, ly)] shape (nx, ny, 1): R² Δλ (sinφ⁺ − sinφ⁻)
        nyt = phi.cc.shape[0]
        sin_f = np.sin(DEG * phi_at[F])          # at faces j (lower face of cell j)
        sin_c = np.sin(DEG * phi_at[C])
        dsin = {}
        # centered in φ: faces j and j+1 bracket cell j
        d = np.empty(nyt)
        d[:-1] = sin_f[1:] - sin_f[:-1]
        d[-1] = d[-2] if nyt > 1 else 1.0
        dsin[C] = d
        # face-located in φ: centers j−1 and j bracket face j
        d2 = np.empty(nyt)
        d2[1:] = sin_c[1:] - sin_c[:-1]
        d2[0] = d2[1] if nyt > 1 else 1.0
        dsin[F] = d2
        self._az_m = {}
        for lx in (C, F):
            for ly in (C, F):
                arr = R * R * DEG * dlam[lx][:, None] * dsin[ly][None, :]
                self._az_m[(lx, ly)] = to(arr[:, :, None])

    # -- metric protocol overrides -------------------------------------------
    def spacing(self, axis, loc):
        if axis == 0:
            return self.dx(loc)
        if axis == 1:
            return self.dy(loc)
        return _bx(self._axes[2].dc if loc[2] is C else self._axes[2].df, 2)

    def dx(self, loc):
        return self._dx_m[(loc[0], loc[1])]

    def dy(self, loc):
        return self._dy_m[loc[1]]

    def Az(self, loc):
        return self._az_m[(loc[0], loc[1])]

    def Ax(self, loc):  # face normal to λ: Δy · Δz
        return self.dy(loc) * self.dz(loc)

    def Ay(self, loc):  # face normal to φ: Δx · Δz
        return self.dx(loc) * self.dz(loc)

    def V(self, loc):
        return self.Az(loc) * self.dz(loc)

    @property
    def all_regular(self):
        return False

    @property
    def hregular(self):
        return False

    def min_spacing(self):
        vals = []
        for m in (self._dx_m[(C, C)], self._dy_m[C]):
            vals.append(float(jnp.min(jnp.abs(self.interior_h(m)))))
        if self.topology[2] is not FLAT:
            a = self._axes[2]
            vals.append(float(jnp.min(a.dc[a.h: a.h + a.n])))
        return min(vals)

    def interior_h(self, arr):
        """Interior slice along the horizontal axes only (metrics are (nx,ny,1))."""
        sx = slice(self.Hx, self.Hx + self.Nx) if arr.shape[0] > 1 else slice(None)
        sy = slice(self.Hy, self.Hy + self.Ny) if arr.shape[1] > 1 else slice(None)
        return arr[sx, sy]

    # -- pytree ---------------------------------------------------------------
    def tree_flatten(self):
        axis_leaves = tuple((a.cf, a.cc, a.dc, a.df) for a in self._axes)
        mkeys_dx = tuple(sorted(self._dx_m, key=repr))
        mkeys_az = tuple(sorted(self._az_m, key=repr))
        mkeys_dy = tuple(sorted(self._dy_m, key=repr))
        leaves = sum(axis_leaves, ()) + tuple(self._dx_m[k] for k in mkeys_dx) \
            + tuple(self._az_m[k] for k in mkeys_az) \
            + tuple(self._dy_m[k] for k in mkeys_dy)
        static = (tuple((a.n, a.h, a.topo, a.regular, a.extent) for a in self._axes),
                  self.dtype, self.radius, mkeys_dx, mkeys_az, mkeys_dy, self.dist)
        return leaves, static

    @classmethod
    def tree_unflatten(cls, static, leaves):
        axes_meta, dtype, radius, mkeys_dx, mkeys_az, mkeys_dy, dist = static
        obj = object.__new__(cls)
        axes = []
        for i in range(3):
            n, h, topo, regular, extent = axes_meta[i]
            cf, cc, dc, df = leaves[4 * i: 4 * i + 4]
            axes.append(_Axis(n, h, topo, cf, cc, dc, df, regular, extent))
        obj._axes = tuple(axes)
        obj.dtype = dtype
        obj.radius = radius
        obj.dist = dist
        obj._init_static()
        i = 12
        obj._dx_m = {k: leaves[i + j] for j, k in enumerate(mkeys_dx)}
        i += len(mkeys_dx)
        obj._az_m = {k: leaves[i + j] for j, k in enumerate(mkeys_az)}
        i += len(mkeys_az)
        obj._dy_m = {k: leaves[i + j] for j, k in enumerate(mkeys_dy)}
        return obj

    def with_halo(self, halo):
        halo = tuple(0 if t is FLAT else max(h, 1)
                     for h, t in zip(halo, self.topology))
        if halo == self.halo:
            return self
        new = super()._rebuild_with_halo(halo)
        new.radius = self.radius
        new._precompute_metrics()
        return new

    def subgrid_along(self, axis, start, n_new):
        """Sub-grid strip (see RectilinearGrid.subgrid_along) with the
        precomputed spherical metric arrays sliced by the same with-halo
        window, so strip metrics stay exactly the shard's."""
        new = super().subgrid_along(axis, start, n_new)
        new.radius = self.radius
        sl = slice(start, start + n_new + 2 * self.halo[axis])

        def cut(v):
            if axis == 2 or v.shape[axis] == 1:
                return v
            idx = [slice(None)] * 3
            idx[axis] = sl
            return v[tuple(idx)]

        new._dx_m = {k: cut(v) for k, v in self._dx_m.items()}
        new._az_m = {k: cut(v) for k, v in self._az_m.items()}
        new._dy_m = {k: cut(v) for k, v in self._dy_m.items()}
        return new

    def __repr__(self):
        t = tuple(t.value for t in self.topology)
        return (f"LatitudeLongitudeGrid(size={self.shape}, halo={self.halo}, "
                f"topology={t}, radius={self.radius:g})")


jax.tree_util.register_pytree_node(
    LatitudeLongitudeGrid,
    LatitudeLongitudeGrid.tree_flatten,
    LatitudeLongitudeGrid.tree_unflatten,
)
