"""Distributed Poisson solvers: all_to_all pencil transposes.

Array re-design of the reference's PencilFFTs-based
``DistributedFFTBasedPoissonSolver``
(/root/reference/src/Distributed/distributed_fft_based_poisson_solver.jl:24-80):
the same pencil algorithm — transform each axis while it is device-local,
transposing between pencil layouts in between — but the MPI all-to-alls
become ``lax.all_to_all`` collectives (NCCL over NVLink) inside the
model's ``shard_map``. Keeping z local throughout (the mesh is (x, y)
only, like the reference's decomposition restriction) lets the same
4-transpose skeleton serve both the full-FFT solve and the stretched-z
Fourier-tridiagonal solve (batched Thomas along the always-local z).

Layouts (local interior blocks, Rx × Ry mesh):
    (x/Rx, y/Ry, z) ──a2a('x', z)──► (x, y/Ry, z/Rx)   transform x
                    ◄─a2a back──
    (x/Rx, y/Ry, z) ──a2a('y', z)──► (x/Rx, y, z/Ry)   transform y
                    ◄─a2a back──
    divide by (λx+λy+λz) at the (x/Rx, y/Ry, z) layout (λ slices via
    axis_index dynamic_slice), then run the transforms in reverse.

Constraint (reference :74-80 analog): Nz divisible by Rx and Ry.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import jax.scipy.fft as jfft
from jax import lax

from ..grids.topology import BOUNDED, FLAT, PERIODIC
from ..solvers.fft_poisson import poisson_eigenvalues
from ..solvers.tridiagonal import solve_batched_tridiagonal


def _global_axis(grid, axis):
    """(global_N, global_extent, global_topo, mesh_axis, n_shards)."""
    d = grid.dist[axis]
    ax = grid._axes[axis]
    if d is None:
        return ax.n, ax.extent, ax.topo, None, 1
    mesh_axis, n_shards, global_topo = d
    return ax.n * n_shards, ax.extent * n_shards, global_topo, mesh_axis, n_shards


def _fwd_1d(b, axis, topo):
    if topo is PERIODIC:
        return jnp.fft.fft(b, axis=axis)
    if topo is BOUNDED:
        # jax.scipy.fft.dct silently mangles complex input (it is built on
        # rfft); split into real/imag like _inv_1d does
        if jnp.iscomplexobj(b):
            return (jfft.dct(jnp.real(b), type=2, axis=axis, norm="ortho")
                    + 1j * jfft.dct(jnp.imag(b), type=2, axis=axis, norm="ortho"))
        return jfft.dct(b, type=2, axis=axis, norm="ortho")
    return b


def _inv_1d(b, axis, topo):
    if topo is PERIODIC:
        return jnp.fft.ifft(b, axis=axis)
    if topo is BOUNDED:
        was_complex = jnp.iscomplexobj(b)
        if was_complex:
            return (jfft.idct(jnp.real(b), type=2, axis=axis, norm="ortho")
                    + 1j * jfft.idct(jnp.imag(b), type=2, axis=axis, norm="ortho"))
        return jfft.idct(b, type=2, axis=axis, norm="ortho")
    return b


def _transform_axis_distributed(b, axis, topo, mesh_axis, n_shards, inverse):
    """Gather `axis` via an all_to_all against z, transform, scatter back."""
    fn = _inv_1d if inverse else _fwd_1d
    if mesh_axis is None or n_shards == 1:
        return fn(b, axis, topo)
    # (…, z) → gather axis, split z
    b = lax.all_to_all(b, mesh_axis, split_axis=2, concat_axis=axis, tiled=True)
    b = fn(b, axis, topo)
    return lax.all_to_all(b, mesh_axis, split_axis=axis, concat_axis=2, tiled=True)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DistributedFFTPoissonSolver:
    """Eigenexpansion solve of (∇²+m)φ = b on a distributed regular grid.

    Built from the LOCAL grid (carrying ``dist`` metadata); ``solve``
    must run inside the model's shard_map. rhs/φ are local interior
    blocks (nxl, nyl, nzl-is-full-z).
    """

    lam_x: jnp.ndarray  # global eigenvalue arrays (length global N)
    lam_y: jnp.ndarray
    lam_z: jnp.ndarray
    meta: tuple         # static: per-axis (topo, mesh_axis, n_shards, n_local)
    dtype: object

    @classmethod
    def build(cls, grid):
        lams, meta = [], []
        for a in range(3):
            N, L, topo, mesh_axis, n_shards = _global_axis(grid, a)
            lams.append(poisson_eigenvalues(N, L if topo is not FLAT else 1.0,
                                            topo, grid.dtype))
            meta.append((topo, mesh_axis, n_shards, grid._axes[a].n))
            if a == 2 and n_shards != 1:
                raise ValueError("z must not be distributed (mesh is (x, y))")
        (_, _, rx, _), (_, _, ry, _) = meta[0], meta[1]
        nz = meta[2][3]
        if nz % max(rx, 1) or nz % max(ry, 1):
            raise ValueError(f"Nz={nz} must divide the mesh {rx}x{ry} for the "
                             "pencil transposes (reference Nz>=Rx analog)")
        return cls(lams[0], lams[1], lams[2], tuple(meta), grid.dtype)

    def tree_flatten(self):
        return (self.lam_x, self.lam_y, self.lam_z), (self.meta, self.dtype)

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves, *static)

    def _local_lam(self, lam, axis):
        topo, mesh_axis, n_shards, n_local = self.meta[axis]
        if mesh_axis is None or n_shards == 1:
            loc = lam
        else:
            idx = lax.axis_index(mesh_axis)
            loc = lax.dynamic_slice(lam, (idx * n_local,), (n_local,))
        shape = [1, 1, 1]
        shape[axis] = loc.shape[0]
        return loc.reshape(shape)

    def _is_origin(self):
        ok = True
        for axis in (0, 1):
            _, mesh_axis, n_shards, _ = self.meta[axis]
            if mesh_axis is not None and n_shards > 1:
                ok = ok & (lax.axis_index(mesh_axis) == 0)
        return ok

    def solve(self, rhs, m=0.0):
        b = rhs
        for axis in (0, 1):
            topo, mesh_axis, n_shards, _ = self.meta[axis]
            b = _transform_axis_distributed(b, axis, topo, mesh_axis, n_shards,
                                            inverse=False)
        b = _fwd_1d(b, 2, self.meta[2][0])  # z local

        lam = (self._local_lam(self.lam_x, 0) + self._local_lam(self.lam_y, 1)
               + self._local_lam(self.lam_z, 2))
        denom = lam - m
        phi = -b / jnp.where(denom == 0, jnp.ones_like(denom), denom)
        if m == 0.0:
            # zero the undetermined global mean mode (lives on shard (0,0))
            mask = jnp.zeros(phi.shape, bool).at[0, 0, 0].set(True) & self._is_origin()
            phi = jnp.where(mask, 0.0, phi)

        phi = _inv_1d(phi, 2, self.meta[2][0])
        for axis in (1, 0):
            topo, mesh_axis, n_shards, _ = self.meta[axis]
            phi = _transform_axis_distributed(phi, axis, topo, mesh_axis,
                                              n_shards, inverse=True)
        phi = jnp.real(phi) if jnp.iscomplexobj(phi) else phi
        return phi.astype(self.dtype)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DistributedFourierTridiagonalSolver:
    """Distributed stretched-z solve: transforms in x,y (pencil transposes)
    + batched Thomas along the always-local z (reference
    fourier_tridiagonal_poisson_solver.jl on PencilFFTs layouts)."""

    lam_x: jnp.ndarray
    lam_y: jnp.ndarray
    lower: jnp.ndarray
    upper: jnp.ndarray
    dzc: jnp.ndarray
    meta: tuple
    dtype: object

    @classmethod
    def build(cls, grid):
        from ..solvers.fourier_tridiagonal import FourierTridiagonalSolver
        meta = []
        lams = []
        for a in (0, 1):
            N, L, topo, mesh_axis, n_shards = _global_axis(grid, a)
            lams.append(poisson_eigenvalues(N, L if topo is not FLAT else 1.0,
                                            topo, grid.dtype))
            meta.append((topo, mesh_axis, n_shards, grid._axes[a].n))
        az = grid._axes[2]
        Nz, Hz = az.n, az.h
        dzc = az.dc[Hz:Hz + Nz]
        dzf = az.df[Hz:Hz + Nz]
        dzf_up = jnp.concatenate([dzf[1:], jnp.ones((1,), grid.dtype)])
        a_band = (1.0 / dzf).at[0].set(0.0)
        c_band = (1.0 / dzf_up).at[-1].set(0.0)
        meta.append((az.topo, None, 1, Nz))
        (_, _, rx, _), (_, _, ry, _) = meta[0], meta[1]
        if Nz % max(rx, 1) or Nz % max(ry, 1):
            raise ValueError(f"Nz={Nz} must divide the mesh {rx}x{ry}")
        return cls(lams[0], lams[1], a_band, c_band, dzc, tuple(meta), grid.dtype)

    def tree_flatten(self):
        return ((self.lam_x, self.lam_y, self.lower, self.upper, self.dzc),
                (self.meta, self.dtype))

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves[0], *static)

    def _local_lam(self, lam, axis):
        topo, mesh_axis, n_shards, n_local = self.meta[axis]
        if mesh_axis is None or n_shards == 1:
            loc = lam
        else:
            idx = lax.axis_index(mesh_axis)
            loc = lax.dynamic_slice(lam, (idx * n_local,), (n_local,))
        shape = [1, 1, 1]
        shape[axis] = loc.shape[0]
        return loc.reshape(shape)

    def _is_origin(self):
        ok = True
        for axis in (0, 1):
            _, mesh_axis, n_shards, _ = self.meta[axis]
            if mesh_axis is not None and n_shards > 1:
                ok = ok & (lax.axis_index(mesh_axis) == 0)
        return ok

    def solve(self, rhs, m=0.0):
        b = rhs
        for axis in (0, 1):
            topo, mesh_axis, n_shards, _ = self.meta[axis]
            b = _transform_axis_distributed(b, axis, topo, mesh_axis, n_shards,
                                            inverse=False)

        lam_h = self._local_lam(self.lam_x, 0) + self._local_lam(self.lam_y, 1) - m
        dzc = self.dzc.reshape(1, 1, -1)
        lo = jnp.broadcast_to(self.lower.reshape(1, 1, -1), b.shape).astype(self.dtype)
        up = jnp.broadcast_to(self.upper.reshape(1, 1, -1), b.shape).astype(self.dtype)
        diag = jnp.broadcast_to(-(lo + up) - lam_h * dzc, b.shape).astype(self.dtype)
        d = b * dzc

        if m == 0.0:
            # pin the first row of the singular (0,0) horizontal mode
            iz = jnp.arange(b.shape[2]).reshape(1, 1, -1)
            mode00 = (jnp.arange(b.shape[0]).reshape(-1, 1, 1) == 0) & \
                     (jnp.arange(b.shape[1]).reshape(1, -1, 1) == 0) & \
                     self._is_origin()
            pin = mode00 & (iz == 0)
            diag = jnp.where(pin, jnp.ones_like(diag), diag)
            up = jnp.where(pin, jnp.zeros_like(up), up)
            d = jnp.where(pin, jnp.zeros_like(d), d)

        if jnp.iscomplexobj(d):
            phi = (solve_batched_tridiagonal(lo, diag, up, jnp.real(d))
                   + 1j * solve_batched_tridiagonal(lo, diag, up, jnp.imag(d)))
        else:
            phi = solve_batched_tridiagonal(lo, diag, up, d)

        for axis in (1, 0):
            topo, mesh_axis, n_shards, _ = self.meta[axis]
            phi = _transform_axis_distributed(phi, axis, topo, mesh_axis,
                                              n_shards, inverse=True)
        phi = jnp.real(phi) if jnp.iscomplexobj(phi) else phi
        phi = phi.astype(self.dtype)
        if m == 0.0:
            # zero-mean gauge across all shards
            w = self.dzc.reshape(1, 1, -1)
            s = jnp.sum(phi * w)
            cnt = jnp.sum(jnp.broadcast_to(w, phi.shape))
            for axis in (0, 1):
                _, mesh_axis, n_shards, _ = self.meta[axis]
                if mesh_axis is not None and n_shards > 1:
                    s = lax.psum(s, mesh_axis)
                    cnt = lax.psum(cnt, mesh_axis)
            phi = phi - s / cnt
        return phi


def select_distributed_pressure_solver(grid):
    """Distributed analog of NonhydrostaticModels.jl:18-27 solver choice."""
    if grid.all_regular:
        return DistributedFFTPoissonSolver.build(grid)
    if grid.hregular:
        return DistributedFourierTridiagonalSolver.build(grid)
    raise ValueError("distributed pressure solve needs regular x,y spacing")
