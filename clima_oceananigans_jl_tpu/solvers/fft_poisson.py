"""FFT-based Poisson solver on regular grids.

Array re-design of the reference's src/Solvers/fft_based_poisson_solver.jl
(+ plan_transforms.jl, poisson_eigenvalues.jl:1-32): solves
(∇² + m)φ = b by eigenfunction expansion of the staggered 2nd-order
Laplacian. Per-axis transform by topology: FFT (periodic), DCT-II
(bounded / staggered-Neumann, via jax.scipy.fft — XLA lowers it to FFTs,
which is exactly the reference's own GPU trick of doing DCT with FFT +
index permutation, index_permutations.jl), none (flat).

Everything is jittable; eigenvalue arrays are precomputed grid constants.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import jax.scipy.fft as jfft

from ..grids.topology import BOUNDED, FLAT, PERIODIC


def poisson_eigenvalues(N, L, topo, dtype):
    """Positive eigenvalues −λ of the staggered 1D Laplacian
    (reference poisson_eigenvalues.jl)."""
    i = jnp.arange(N, dtype=dtype)
    d = L / N
    if topo is PERIODIC:
        return (2.0 * jnp.sin(i * jnp.pi / N) / d) ** 2
    if topo is BOUNDED:
        return (2.0 * jnp.sin(i * jnp.pi / (2 * N)) / d) ** 2
    return jnp.zeros((N,), dtype)


def _reshape_axis(arr, axis):
    shape = [1, 1, 1]
    shape[axis] = arr.shape[0]
    return arr.reshape(shape)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FFTPoissonSolver:
    """Interior-shaped solve: rhs (Nx,Ny,Nz) → φ (Nx,Ny,Nz), mean(φ)=0."""

    eigenvalues: tuple
    topology: tuple
    dtype: object

    @classmethod
    def build(cls, grid):
        if not grid.all_regular:
            raise ValueError("FFTPoissonSolver requires a fully regular grid "
                             "(use FourierTridiagonalSolver for stretched z)")
        eig = tuple(
            _reshape_axis(
                poisson_eigenvalues(grid.shape[a],
                                    grid.shape[a] * float(grid._axes[a].dc[0])
                                    if grid.topology[a] is not FLAT else 1.0,
                                    grid.topology[a], grid.dtype), a)
            for a in range(3))
        return cls(eig, grid.topology, grid.dtype)

    def tree_flatten(self):
        return (self.eigenvalues,), (self.topology, self.dtype)

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(leaves[0], static[0], static[1])

    def _axes_of(self, topo):
        return tuple(a for a in range(3) if self.topology[a] is topo)

    def solve(self, rhs, m=0.0):
        """(∇² + m)φ = rhs (interior arrays, no halos). Bounded axes take
        an orthonormal DCT-II; the first periodic axis a real FFT (halved
        spectrum) and the rest complex FFTs."""
        dct_axes = self._axes_of(BOUNDED)
        fft_axes = self._axes_of(PERIODIC)
        eig = list(self.eigenvalues)

        b = rhs
        for a in dct_axes:
            b = jfft.dct(b, type=2, axis=a, norm="ortho")
        use_rfft = bool(fft_axes) and not jnp.iscomplexobj(b)
        r_axis = fft_axes[0] if use_rfft else None
        c_axes = tuple(a for a in fft_axes if a != r_axis)
        if use_rfft:
            n_r = b.shape[r_axis]
            b = jnp.fft.rfft(b, axis=r_axis)
        if c_axes:
            b = jnp.fft.fftn(b, axes=c_axes)

        if use_rfft:
            sl = [slice(None)] * 3
            sl[r_axis] = slice(0, n_r // 2 + 1)
            eig[r_axis] = eig[r_axis][tuple(sl)]
        lam = eig[0] + eig[1] + eig[2]
        denom = lam - m
        phi = -b / jnp.where(denom == 0, jnp.ones_like(denom), denom)
        if m == 0.0:
            # zero the undetermined mean mode (reference solve! :108-111)
            phi = phi.at[0, 0, 0].set(0.0)

        if c_axes:
            phi = jnp.fft.ifftn(phi, axes=c_axes)
        if use_rfft:
            phi = jnp.fft.irfft(phi, n=n_r, axis=r_axis)
        phi = jnp.real(phi) if jnp.iscomplexobj(phi) else phi
        for a in reversed(dct_axes):
            phi = jfft.idct(phi, type=2, axis=a, norm="ortho")
        return phi.astype(self.dtype)
