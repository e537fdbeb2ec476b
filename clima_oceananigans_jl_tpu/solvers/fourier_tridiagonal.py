"""Fourier-tridiagonal Poisson solver for vertically-stretched grids.

Array analog of the reference's src/Solvers/fourier_tridiagonal_poisson_solver.jl:
FFT/DCT in the regular horizontal directions + a batched tridiagonal solve
along (possibly stretched) z for every horizontal mode.

Vertical operator (staggered FV, Neumann at top/bottom):
  (1/Δzᶜ(k)) [ (φ(k+1)−φ(k))/Δzᶠ(k+1) − (φ(k)−φ(k−1))/Δzᶠ(k) ] − λ_h φ(k) = b(k)

Multiplying through by Δzᶜ(k) (the reference's rhs scaling,
Models/NonhydrostaticModels/solve_for_pressure.jl:30-33) gives bands
independent of the mode:
  a(k) = 1/Δzᶠ(k),  c(k) = 1/Δzᶠ(k+1),  b(k) = −a−c − λ_h Δzᶜ(k)
with a(0) = c(N−1) = 0 (Neumann walls).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import jax.scipy.fft as jfft

from ..grids.topology import BOUNDED, FLAT, PERIODIC
from .fft_poisson import _reshape_axis, poisson_eigenvalues
from .tridiagonal import solve_batched_tridiagonal


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FourierTridiagonalSolver:
    lam_x: jnp.ndarray
    lam_y: jnp.ndarray
    lower: jnp.ndarray   # a(k), shape (Nz,)
    upper: jnp.ndarray   # c(k)
    dzc: jnp.ndarray     # Δzᶜ interior, shape (Nz,)
    topology: tuple
    dtype: object

    @classmethod
    def build(cls, grid):
        if not grid.hregular:
            raise ValueError("FourierTridiagonalSolver requires regular x,y")
        ax = grid._axes[2]
        Nz, Hz = ax.n, ax.h
        dzc = ax.dc[Hz: Hz + Nz]
        # Δzᶠ(k) = distance between centers k−1 and k (face k)
        dzf = ax.df[Hz: Hz + Nz]
        dzf_up = jnp.concatenate([dzf[1:], jnp.ones((1,), grid.dtype)])  # Δzᶠ(k+1)
        a = 1.0 / dzf
        c = 1.0 / dzf_up
        a = a.at[0].set(0.0)         # bottom Neumann
        c = c.at[-1].set(0.0)        # top Neumann
        lx = _reshape_axis(poisson_eigenvalues(
            grid.Nx, grid.Nx * float(grid._axes[0].dc[0]) if grid.topology[0] is not FLAT else 1.0,
            grid.topology[0], grid.dtype), 0)
        ly = _reshape_axis(poisson_eigenvalues(
            grid.Ny, grid.Ny * float(grid._axes[1].dc[0]) if grid.topology[1] is not FLAT else 1.0,
            grid.topology[1], grid.dtype), 1)
        return cls(lx, ly, a, c, dzc, grid.topology, grid.dtype)

    def tree_flatten(self):
        return ((self.lam_x, self.lam_y, self.lower, self.upper, self.dzc),
                (self.topology, self.dtype))

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves[0], static[0], static[1])

    def solve(self, rhs, m=0.0):
        """(∇² + m)φ = rhs, interior arrays; mean mode zeroed when m=0."""
        topo = self.topology
        dct_axes = tuple(a for a in (0, 1) if topo[a] is BOUNDED)
        fft_axes = tuple(a for a in (0, 1) if topo[a] is PERIODIC)

        b = rhs
        for a in dct_axes:
            b = jfft.dct(b, type=2, axis=a, norm="ortho")
        if fft_axes:
            b = jnp.fft.fftn(b, axes=fft_axes)

        lam_h = self.lam_x + self.lam_y - m
        dzc = self.dzc.reshape(1, 1, -1)
        lo = jnp.broadcast_to(self.lower.reshape(1, 1, -1), b.shape).astype(self.dtype)
        up = jnp.broadcast_to(self.upper.reshape(1, 1, -1), b.shape).astype(self.dtype)
        diag = jnp.broadcast_to(-(lo + up) - lam_h * dzc, b.shape).astype(self.dtype)
        d = b * dzc  # scale rhs by Δzᶜ

        if m == 0.0:
            # the (0,0) horizontal mode is pure-Neumann singular: pin its
            # first row to φ = 0 to make the system non-singular
            iz = jnp.arange(b.shape[2]).reshape(1, 1, -1)
            mode00 = (jnp.arange(b.shape[0]).reshape(-1, 1, 1) == 0) & \
                     (jnp.arange(b.shape[1]).reshape(1, -1, 1) == 0)
            pin = mode00 & (iz == 0)
            diag = jnp.where(pin, jnp.ones_like(diag), diag)
            up = jnp.where(pin, jnp.zeros_like(up), up)
            d = jnp.where(pin, jnp.zeros_like(d), d)

        if jnp.iscomplexobj(d):
            phi_r = solve_batched_tridiagonal(lo, diag, up, jnp.real(d))
            phi_i = solve_batched_tridiagonal(lo, diag, up, jnp.imag(d))
            phi = phi_r + 1j * phi_i
        else:
            phi = solve_batched_tridiagonal(lo, diag, up, d)

        if fft_axes:
            phi = jnp.fft.ifftn(phi, axes=fft_axes)
        phi = jnp.real(phi) if jnp.iscomplexobj(phi) else phi
        for a in reversed(dct_axes):
            phi = jfft.idct(phi, type=2, axis=a, norm="ortho")
        phi = phi.astype(self.dtype)
        if m == 0.0:
            # zero-mean gauge (the λ=0 mode's tridiagonal system is singular
            # up to a constant; subtract the volume mean)
            w = self.dzc.reshape(1, 1, -1)
            mean = jnp.sum(phi * w) / (jnp.sum(w) * phi.shape[0] * phi.shape[1])
            phi = phi - mean
        return phi
