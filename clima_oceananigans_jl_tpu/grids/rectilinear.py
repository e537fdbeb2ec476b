"""Rectilinear staggered grids (regular or stretched per axis).

Array re-design of the reference's ``RectilinearGrid``
(/root/reference/src/Grids/rectilinear_grid.jl:1-58):

* No OffsetArrays — every field array carries explicit halos of width
  ``(Hx, Hy, Hz)``; array index ``a`` along an axis maps to logical cell
  ``i = a - H`` with interior cells ``i ∈ [0, N)``. Face ``i`` is the
  *left/lower* face of cell ``i``; bounded axes have one extra valid
  interior face at ``i = N`` (stored inside the halo region, hence H ≥ 1).
* The grid is a registered pytree: coordinate/spacing arrays are leaves
  (jnp arrays living on device), all shape/topology information is static
  aux data, so model functions taking a grid jit cleanly and all
  topology-dependent branching resolves at trace time.
* Regularity is tracked per axis (``x_regular`` etc.) and selects the
  pressure-solver family exactly like the reference's type-level
  ``RegRectilinearGrid``/``HRegRectilinearGrid`` distinction
  (rectilinear_grid.jl:50-58).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.location import C, F, Loc
from .topology import BOUNDED, FLAT, FULLY_CONNECTED, PERIODIC, Topology

AXIS_NAMES = ("x", "y", "z")


def _face_positions(extent, n, dtype, spec=None):
    """1D interior face positions (length n+1) from an interval, array, or callable."""
    if spec is None:
        lo, hi = extent
        return np.linspace(lo, hi, n + 1, dtype=np.float64)
    if callable(spec):
        return np.asarray([spec(k) for k in range(n + 1)], dtype=np.float64)
    arr = np.asarray(spec, dtype=np.float64)
    if arr.shape != (n + 1,):
        raise ValueError(f"face-position array must have length n+1={n + 1}, got {arr.shape}")
    if np.any(np.diff(arr) <= 0):
        raise ValueError("face positions must be strictly increasing "
                         "(reference Grids/input_validation.jl)")
    return arr


def _extend_faces(xF, topo, H):
    """Extend interior faces (length n+1) into halos → length n+2H+1."""
    n = len(xF) - 1
    if topo is FLAT:
        return xF
    L = xF[-1] - xF[0]
    left, right = [], []
    for k in range(1, H + 1):
        if topo in (PERIODIC, FULLY_CONNECTED):
            left.append(xF[n - k] - L)  # periodic continuation (wrapped spacings)
            right.append(xF[k] + L)
        else:  # bounded: continue with edge spacing
            left.append(xF[0] - k * (xF[1] - xF[0]))
            right.append(xF[-1] + k * (xF[-1] - xF[-2]))
    return np.concatenate([left[::-1], xF, right])


@dataclasses.dataclass(frozen=True)
class _Axis:
    """Per-axis geometry: coordinates + spacings, with halos, as jnp 1D arrays."""

    n: int
    h: int
    topo: Topology
    cf: jnp.ndarray   # face coordinates,   len n+2h   (face i = lower face of cell i)
    cc: jnp.ndarray   # center coordinates, len n+2h
    dc: jnp.ndarray   # Δ at centers (cell widths),          len n+2h
    df: jnp.ndarray   # Δ at faces (center-to-center dist),  len n+2h
    regular: bool
    extent: float


def _build_axis(n, h, topo, extent=None, spec=None, *, dtype):
    if topo is FLAT:
        one = jnp.ones((1,), dtype=dtype)
        zero = jnp.zeros((1,), dtype=dtype)
        return _Axis(1, 0, topo, zero, zero, one, one, True, 1.0)
    if h < 1:
        raise ValueError("halo width must be ≥ 1 on non-flat axes")
    xF = _face_positions(extent, n, dtype, spec)
    ext = _extend_faces(xF, topo, h)           # len n+2h+1
    centers = 0.5 * (ext[:-1] + ext[1:])       # len n+2h
    dc = np.diff(ext)                          # len n+2h
    df = np.empty_like(dc)
    df[1:] = centers[1:] - centers[:-1]
    df[0] = df[1] if len(df) > 1 else dc[0]
    regular = bool(np.allclose(dc, dc[0]))
    if regular:
        # canonicalize: regular-axis spacing arrays hold EXACTLY extent/n
        # everywhere (np.diff of linspace varies in the last ulp). This
        # makes every metric bitwise position-independent.
        const = float(xF[-1] - xF[0]) / n
        dc = np.full_like(dc, const)
        df = np.full_like(df, const)
    to = lambda a: jnp.asarray(a, dtype=dtype)
    return _Axis(n, h, topo, to(ext[:-1]), to(centers), to(dc), to(df),
                 regular, float(xF[-1] - xF[0]))


def _bx(arr, axis):
    """Reshape a 1D per-axis array for broadcasting over a 3D (x,y,z) field."""
    shape = [1, 1, 1]
    shape[axis] = arr.shape[0]
    return arr.reshape(shape)


class RectilinearGrid:
    """Staggered rectilinear grid; pytree with static shape/topology metadata."""

    curvilinear = False

    def __init__(self, *, size, extent=None, x=None, y=None, z=None,
                 topology=(PERIODIC, PERIODIC, BOUNDED), halo=None,
                 dtype=jnp.float32):
        if len(size) != 3:
            raise ValueError("size must be a 3-tuple (use 1 for flat axes)")
        topology = tuple(Topology(t) for t in topology)
        if halo is None:
            halo = tuple(0 if t is FLAT else 3 for t in topology)
        halo = tuple(0 if t is FLAT else max(1, h) for h, t in zip(halo, topology))
        intervals = [None, None, None]
        specs = [x, y, z]
        if extent is not None:
            ex = list(extent)
            k = 0
            for a in range(3):
                if topology[a] is not FLAT and specs[a] is None:
                    intervals[a] = (0.0, float(ex[k]))
                    k += 1
        for a, s in enumerate(specs):
            # a 2-element spec is an interval (for n=1 it coincides with faces)
            if s is not None and not callable(s) and np.ndim(s) == 1 and len(s) == 2:
                intervals[a] = (float(s[0]), float(s[1]))
                specs[a] = None
        self.dtype = dtype
        self._axes = tuple(
            _build_axis(size[a], halo[a], topology[a], intervals[a], specs[a], dtype=dtype)
            for a in range(3)
        )
        #: per-axis distribution metadata: None or (mesh_axis, n_shards, global_topo)
        self.dist = (None, None, None)
        self._init_static()

    def _init_static(self):
        ax = self._axes
        self.Nx, self.Ny, self.Nz = (a.n for a in ax)
        self.Hx, self.Hy, self.Hz = (a.h for a in ax)
        self.topology = tuple(a.topo for a in ax)
        self.Lx, self.Ly, self.Lz = (a.extent for a in ax)

    # -- pytree plumbing ---------------------------------------------------
    def tree_flatten(self):
        leaves = tuple((a.cf, a.cc, a.dc, a.df) for a in self._axes)
        static = tuple((a.n, a.h, a.topo, a.regular, a.extent) for a in self._axes) + (self.dtype, type(self), self.dist)
        return sum(leaves, ()), static

    @classmethod
    def tree_unflatten(cls, static, leaves):
        obj = object.__new__(static[4])
        axes = []
        for i in range(3):
            n, h, topo, regular, extent = static[i]
            cf, cc, dc, df = leaves[4 * i: 4 * i + 4]
            axes.append(_Axis(n, h, topo, cf, cc, dc, df, regular, extent))
        obj._axes = tuple(axes)
        obj.dtype = static[3]
        obj.dist = static[5]
        obj._init_static()
        return obj

    # -- shapes ------------------------------------------------------------
    @property
    def shape(self):
        """Interior shape (Nx, Ny, Nz)."""
        return (self.Nx, self.Ny, self.Nz)

    @property
    def total_shape(self):
        """Array shape with halos."""
        return (self.Nx + 2 * self.Hx, self.Ny + 2 * self.Hy, self.Nz + 2 * self.Hz)

    @property
    def halo(self):
        return (self.Hx, self.Hy, self.Hz)

    def interior(self, data):
        """Interior view of a with-halo array (last-index convention: N
        points). Arrays already of interior shape pass through
        unchanged."""
        if data.ndim == 3 and tuple(data.shape) == tuple(self.shape):
            return data
        sl = tuple(slice(h, h + n) for h, n in zip(self.halo, self.shape))
        return data[sl]

    def new_field(self, fill=0.0):
        return jnp.full(self.total_shape, fill, dtype=self.dtype)

    # -- coordinates ---------------------------------------------------------
    def coord(self, axis, loc: Loc, with_halo=False):
        a = self._axes[axis]
        arr = a.cc if Loc(loc) is C else a.cf
        return arr if with_halo else arr[a.h: a.h + a.n]

    def nodes(self, loc, with_halo=False):
        """Broadcastable (x, y, z) coordinate arrays at a location triple."""
        return tuple(
            _bx(self.coord(a, loc[a], with_halo), a) for a in range(3)
        )

    # -- metrics (broadcastable over (x,y,z) with-halo arrays) ---------------
    def spacing(self, axis, loc):
        """Grid spacing along `axis` for a field at location-triple `loc`."""
        a = self._axes[axis]
        return _bx(a.dc if loc[axis] is C else a.df, axis)

    def dx(self, loc):
        return self.spacing(0, loc)

    def dy(self, loc):
        return self.spacing(1, loc)

    def dz(self, loc):
        return self.spacing(2, loc)

    def Ax(self, loc):  # area of the yz cell face crossed by u
        return self.dy(loc) * self.dz(loc)

    def Ay(self, loc):
        return self.dx(loc) * self.dz(loc)

    def Az(self, loc):
        return self.dx(loc) * self.dy(loc)

    def V(self, loc):
        return self.dx(loc) * self.dy(loc) * self.dz(loc)

    # -- regularity / solver selection ---------------------------------------
    @property
    def x_regular(self):
        return self._axes[0].regular

    @property
    def y_regular(self):
        return self._axes[1].regular

    @property
    def z_regular(self):
        return self._axes[2].regular

    @property
    def all_regular(self):
        return self.x_regular and self.y_regular and self.z_regular

    @property
    def hregular(self):
        """Regular in x,y (z may be stretched) → Fourier-tridiagonal solver."""
        return self.x_regular and self.y_regular

    def min_spacing(self):
        """Minimum interior grid spacing (host-side scalar for CFL estimates)."""
        vals = []
        for a_idx, a in enumerate(self._axes):
            if a.topo is not FLAT:
                vals.append(float(jnp.min(a.dc[a.h: a.h + a.n])))
        return min(vals) if vals else 1.0

    def with_halo(self, halo):
        """Rebuild this grid with (at least) the given halo widths."""
        halo = tuple(0 if t is FLAT else max(h, 1)
                     for h, t in zip(halo, self.topology))
        if halo == self.halo:
            return self
        return self._rebuild_with_halo(halo)

    def _rebuild_with_halo(self, halo):
        new = object.__new__(type(self))
        new.dtype = self.dtype
        new.dist = self.dist
        axes = []
        for a_idx, (a, h) in enumerate(zip(self._axes, halo)):
            if a.topo is FLAT:
                axes.append(a)
                continue
            old_h = a.h
            cf = np.asarray(a.cf, dtype=np.float64)
            if a.regular:
                # regular axes: rebuild from the interval so low-precision
                # stored coordinates don't destroy the regularity flag
                lo = float(cf[old_h])
                axes.append(_build_axis(a.n, h, a.topo, (lo, lo + a.extent),
                                        None, dtype=self.dtype))
                continue
            dc = np.asarray(a.dc, dtype=np.float64)
            interior_faces = np.empty(a.n + 1)
            interior_faces[:-1] = cf[old_h: old_h + a.n]
            interior_faces[-1] = cf[old_h + a.n - 1] + dc[old_h + a.n - 1]
            axes.append(_build_axis(a.n, h, a.topo, None, interior_faces, dtype=self.dtype))
        new._axes = tuple(axes)
        new._init_static()
        return new

    def subgrid_along(self, axis, start, n_new):
        """A sub-grid spanning interior cells [start, start+n_new) of
        `axis`, with this grid's halo width; coordinate/spacing arrays are
        SLICED (array index offset = start), so absolute positions —
        forcing/Coriolis coordinates, metric spacings — stay exact. Used
        by the halo-overlap edge-strip recompute
        (models/nonhydrostatic.py ``tendencies_overlapped``); the strip's
        halo cells must already hold valid data. ``dist`` is cleared on
        the sliced axis (strips never exchange)."""
        a = self._axes[axis]
        new = object.__new__(type(self))
        new.dtype = self.dtype
        new.dist = tuple(None if i == axis else d
                         for i, d in enumerate(self.dist))
        sl = slice(start, start + n_new + 2 * a.h)
        # extent must stay STATIC (coords may be traced inside jit); the
        # proportional value is exact for regular axes and unused by the
        # stencil tendencies that run on strips
        sub = _Axis(n_new, a.h, a.topo, a.cf[sl], a.cc[sl], a.dc[sl],
                    a.df[sl], a.regular, a.extent * n_new / a.n)
        new._axes = tuple(sub if i == axis else ax
                          for i, ax in enumerate(self._axes))
        new._init_static()
        return new

    def __repr__(self):
        t = tuple(t.value for t in self.topology)
        return (f"{type(self).__name__}(size={self.shape}, halo={self.halo}, "
                f"topology={t}, dtype={jnp.dtype(self.dtype).name})")


jax.tree_util.register_pytree_node(
    RectilinearGrid, RectilinearGrid.tree_flatten, RectilinearGrid.tree_unflatten
)
