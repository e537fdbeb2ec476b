"""Free-surface treatments for the hydrostatic model.

Array re-design of the reference free-surface family:
* ``ExplicitFreeSurface`` (explicit_free_surface.jl): ∂t η = −∇h·U in the
  same AB2 sweep; g∂η appears in the momentum tendency.
* ``ImplicitFreeSurface`` (implicit_free_surface.jl:36-80): solve
  [∇h·(H∇h) − 1/gΔt²] η = (∇h·Q★ − η/Δt)/(gΔt), with a 2D FFT
  eigen-solve on horizontally-regular grids
  (fft_based_implicit_free_surface_solver.jl) or matrix-free CG
  (pcg_implicit_free_surface_solver.jl); then uⁿ⁺¹ = u★ − gΔt ∂x η.
* ``SplitExplicitFreeSurface`` (split_explicit_free_surface.jl,
  split_explicit_free_surface_kernels.jl:15-76): barotropic substepping
  ∂τU = −gH∇η + Gᵁ, ∂τη = −∇·U over 2Δt with time-filtered averages, as
  one on-device ``lax.fori_loop`` of cheap 2D kernels, then the
  barotropic corrector u += (U̅−U)/H.

All free-surface state (η, U̅, …) are with-halo ``(X, Y, 1)`` arrays.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..boundary_conditions.bcs import fill_halos
from ..grids.topology import BOUNDED, FLAT, PERIODIC
from ..ops import stencil as st
from ..solvers.fft_poisson import poisson_eigenvalues, _reshape_axis
from ..solvers.pcg import cg_solve
from ..utils.location import C, F, CENTER, U_LOC, V_LOC

ETA_LOC = (C, C, F)  # η sits at the top face; horizontal staggering is (C,C)


def fill2d(arr, grid, loc, bcs=None, t=0.0):
    return fill_halos(arr, grid, loc, bcs, t, axes=(0, 1))


def depth_integral(grid, q, loc):
    """∫ q dz over interior z (with-halo (X,Y,1) result)."""
    Hz, Nz = grid.Hz, grid.Nz
    qdz = q * grid.dz(loc)
    return jnp.sum(qdz[:, :, Hz:Hz + Nz], axis=2, keepdims=True)


def barotropic_mode(grid, u, v):
    """(U, V) = (∫u dz, ∫v dz) (reference barotropic_mode_kernel!)."""
    return depth_integral(grid, u, U_LOC), depth_integral(grid, v, V_LOC)


def column_depths(grid):
    """(Hᶠᶜ, Hᶜᶠ) static water depths (broadcastable (·,·,1) arrays).
    On an ImmersedGrid only FLUID cells contribute, so the implicit
    free-surface operator and the barotropic corrector see the true
    column depth over bathymetry (reference: the implicit-η solvers'
    ∫dz runs over the immersed column)."""
    Hz, Nz = grid.Hz, grid.Nz
    one = jnp.ones(grid.total_shape[:2] + (1,), grid.dtype)
    dz_fc = jnp.broadcast_to(grid.dz(U_LOC), grid.total_shape)
    dz_cf = jnp.broadcast_to(grid.dz(V_LOC), grid.total_shape)
    imm = getattr(grid, "immersed", None)
    if imm is not None:
        dz_fc = jnp.where(imm.mask_for(U_LOC), 0.0, dz_fc)
        dz_cf = jnp.where(imm.mask_for(V_LOC), 0.0, dz_cf)
    hfc = jnp.sum(dz_fc[:, :, Hz:Hz + Nz], axis=2, keepdims=True)
    hcf = jnp.sum(dz_cf[:, :, Hz:Hz + Nz], axis=2, keepdims=True)
    if imm is not None:
        # fully-solid columns: keep a positive depth so 1/H stays finite
        # (their velocities are masked to zero anyway)
        eps = jnp.asarray(grid._axes[2].extent * 1e-3, grid.dtype)
        hfc = jnp.maximum(hfc, eps)
        hcf = jnp.maximum(hcf, eps)
    return one * hfc, one * hcf


def div_xy_2d(grid, U, V):
    """2D transport divergence ∇h·(U,V) at centers: (δx(Δy U) + δy(Δx V))/Az."""
    return (st.dxc(grid.dy(U_LOC) * U) + st.dyc(grid.dx(V_LOC) * V)) / grid.Az(CENTER)


def grad_x(grid, eta):
    return st.dxf(eta) / grid.dx(U_LOC)


def grad_y(grid, eta):
    return st.dyf(eta) / grid.dy(V_LOC)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ExplicitFreeSurface:
    gravitational_acceleration: float = 9.80665

    def tree_flatten(self):
        return (self.gravitational_acceleration,), ()

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class ImplicitFreeSurface:
    """solver_method: 'fft' (regular horizontal spacing, constant depth),
    'pcg' (general, incl. lat-lon), 'matrix' (Jacobi-preconditioned CG on
    the assembled heptadiagonal coefficients — the reference's
    MatrixImplicitFreeSurfaceSolver / HeptadiagonalIterativeSolver pair),
    'multigrid' (geometric-multigrid-preconditioned CG, the reference's
    MGImplicitFreeSurfaceSolver), or 'auto'."""

    gravitational_acceleration: float = 9.80665
    solver_method: str = "auto"
    tolerance: float = 1e-10
    maxiter: int = 500

    def tree_flatten(self):
        return (self.gravitational_acceleration,), (self.solver_method,
                                                    self.tolerance, self.maxiter)

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(leaves[0], *static)

    def resolve_method(self, grid):
        if any(d is not None for d in getattr(grid, "dist", (None,) * 3)):
            return "pcg"  # distributed: CG with psum'd inner products
        if self.solver_method != "auto":
            return self.solver_method
        # the FFT eigen-solve assumes a CONSTANT column depth — immersed
        # bathymetry makes H(x, y) variable, so fall back to CG
        if getattr(grid, "immersed", None) is not None:
            return "pcg"
        return "fft" if (not grid.curvilinear and grid.hregular) else "pcg"

    def solve(self, grid, eta_bcs, rhs, eta0, dt):
        """Solve [∇h·(H∇h) − 1/gΔt²] η = rhs (with-halo (X,Y,1) arrays)."""
        g = self.gravitational_acceleration
        method = self.resolve_method(grid)
        Hfc, Hcf = column_depths(grid)
        if method == "fft":
            # constant H: (∇²h − 1/gHΔt²) η = rhs / H
            H = float(grid.Lz)
            # axis extents are static floats, so this traces cleanly under jit
            lx = _reshape_axis(poisson_eigenvalues(
                grid.Nx, grid._axes[0].extent, grid.topology[0], grid.dtype), 0)
            ly = _reshape_axis(poisson_eigenvalues(
                grid.Ny, grid._axes[1].extent, grid.topology[1], grid.dtype), 1)
            sl = (slice(grid.Hx, grid.Hx + grid.Nx), slice(grid.Hy, grid.Hy + grid.Ny))
            b = rhs[sl[0], sl[1], :] / H
            import jax.scipy.fft as jfft
            dct_x = grid.topology[0] is BOUNDED
            dct_y = grid.topology[1] is BOUNDED
            if dct_x:
                b = jfft.dct(b, type=2, axis=0, norm="ortho")
            if dct_y:
                b = jfft.dct(b, type=2, axis=1, norm="ortho")
            fft_axes = tuple(a for a, isdct in ((0, dct_x), (1, dct_y))
                             if not isdct and grid.topology[a] is PERIODIC)
            if fft_axes:
                b = jnp.fft.fftn(b, axes=fft_axes)
            m = 1.0 / (g * H * dt * dt)
            denom = -(lx + ly)[:, :, :1] - m
            phi = b / denom
            if fft_axes:
                phi = jnp.fft.ifftn(phi, axes=fft_axes)
            phi = jnp.real(phi) if jnp.iscomplexobj(phi) else phi
            if dct_y:
                phi = jfft.idct(phi, type=2, axis=1, norm="ortho")
            if dct_x:
                phi = jfft.idct(phi, type=2, axis=0, norm="ortho")
            eta = jnp.zeros_like(eta0).at[sl[0], sl[1], :].set(phi.astype(grid.dtype))
            return fill2d(eta, grid, ETA_LOC, eta_bcs)

        if method in ("matrix", "multigrid"):
            return self._solve_stencil(grid, eta_bcs, rhs, eta0, dt, method)

        # matrix-free CG on the negated, Az-symmetrized operator: multiplying
        # the equation by the cell area Az makes the FV 5-point stencil
        # symmetric in the plain l2 inner product CG assumes (on curvilinear
        # grids the raw operator incl. 1/Az is only self-adjoint in the
        # Az-weighted product)
        interior = (slice(grid.Hx, grid.Hx + grid.Nx),
                    slice(grid.Hy, grid.Hy + grid.Ny), slice(None))
        Az = grid.Az(CENTER)

        def matvec(eta_int):
            eta = jnp.zeros_like(eta0).at[interior].set(eta_int)
            eta = fill2d(eta, grid, ETA_LOC, eta_bcs)
            lap = div_xy_2d(grid, Hfc * grad_x(grid, eta), Hcf * grad_y(grid, eta))
            out = -(Az * lap - Az * eta / (g * dt * dt))
            return out[interior]

        axis_names = tuple(d[0] for d in getattr(grid, "dist", (None,) * 3)
                           if d is not None)
        x, n_it, res2 = cg_solve(matvec, (-Az * rhs)[interior], eta0[interior],
                                 reltol=self.tolerance, maxiter=self.maxiter,
                                 axis_names=axis_names)
        eta = jnp.zeros_like(eta0).at[interior].set(x)
        return fill2d(eta, grid, ETA_LOC, eta_bcs)

    def _fs_stencil(self, grid, Hfc, Hcf):
        """Assembled heptadiagonal couplings of the Az-symmetrized implicit
        free-surface operator (reference
        matrix_implicit_free_surface_solver.jl compute_matrix_coefficients:
        Ax = Δy Hᶠᶜ/Δx at x-faces, Ay = Δx Hᶜᶠ/Δy at y-faces). Returns
        (StencilMatrix sans diagonal shift, interior Az)."""
        from ..solvers.stencil_matrix import StencilMatrix
        ii = (slice(grid.Hx, grid.Hx + grid.Nx),
              slice(grid.Hy, grid.Hy + grid.Ny), slice(None))
        shp2 = grid.total_shape[:2] + (1,)
        L = [None, None, None]
        if grid.topology[0] is not FLAT:
            lx = jnp.broadcast_to(grid.dy(U_LOC) * Hfc / grid.dx(U_LOC), shp2)[ii]
            if grid.topology[0] is BOUNDED:
                lx = lx.at[0, :, :].set(0.0)
            L[0] = lx
        if grid.topology[1] is not FLAT:
            ly = jnp.broadcast_to(grid.dx(V_LOC) * Hcf / grid.dy(V_LOC), shp2)[ii]
            if grid.topology[1] is BOUNDED:
                ly = ly.at[:, 0, :].set(0.0)
            L[1] = ly
        Az_int = jnp.broadcast_to(grid.Az(CENTER), shp2)[ii]
        return StencilMatrix(tuple(L), None), Az_int

    def _solve_stencil(self, grid, eta_bcs, rhs, eta0, dt, method):
        """'matrix' / 'multigrid' solves on the assembled coefficients."""
        from ..solvers.stencil_matrix import (HeptadiagonalIterativeSolver,
                                              MultigridSolver, StencilMatrix)
        g = self.gravitational_acceleration
        Hfc, Hcf = column_depths(grid)
        A, Az_int = self._fs_stencil(grid, Hfc, Hcf)
        interior = (slice(grid.Hx, grid.Hx + grid.Nx),
                    slice(grid.Hy, grid.Hy + grid.Ny), slice(None))
        b = (Az_int * rhs[interior]).astype(grid.dtype)
        if method == "matrix":
            solver = HeptadiagonalIterativeSolver(A, 0.0, -Az_int / g,
                                                  tolerance=self.tolerance,
                                                  maxiter=self.maxiter)
            x = solver.solve(b, dt=dt, x0=eta0[interior])
        else:
            full = StencilMatrix(A.L, -Az_int / (g * dt * dt))
            solver = MultigridSolver(full, (grid.Nx, grid.Ny, 1),
                                     tolerance=self.tolerance,
                                     maxiter=self.maxiter)
            x = solver.solve(b, x0=eta0[interior])
        eta = jnp.zeros_like(eta0).at[interior].set(x.astype(grid.dtype))
        return fill2d(eta, grid, ETA_LOC, eta_bcs)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SplitExplicitFreeSurface:
    """Barotropic substepping with time-filtered averaging.

    ``velocity_weights`` / ``free_surface_weights`` are optional static
    tuples of per-substep averaging weights (normalized internally) —
    the analog of the reference's SplitExplicitSettings
    (split_explicit_free_surface.jl:146-171, whose default is the same
    uniform 1/substeps filter). ``SplitExplicitFreeSurface.with_hann_filter``
    builds a raised-cosine (Hann) averaging kernel that damps the
    poorly-resolved barotropic frequencies more strongly than the
    uniform box filter."""

    gravitational_acceleration: float = 9.80665
    substeps: int = 200
    velocity_weights: tuple = None
    free_surface_weights: tuple = None

    @classmethod
    def with_hann_filter(cls, gravitational_acceleration=9.80665, substeps=200):
        import math
        w = tuple(math.sin(math.pi * (k + 1) / (substeps + 1)) ** 2
                  for k in range(substeps))
        return cls(gravitational_acceleration, substeps, w, w)

    def tree_flatten(self):
        return ((self.gravitational_acceleration,),
                (self.substeps, self.velocity_weights,
                 self.free_surface_weights))

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(leaves[0], *static)

    def _weight_vec(self, weights, dtype):
        if weights is None:
            return jnp.full((self.substeps,), 1.0 / self.substeps, dtype)
        w = jnp.asarray(weights, dtype)
        return w / jnp.sum(w)

    @staticmethod
    def _squeeze_ok(bcs):
        """True when every BC value is absent or scalar — the rank-2 fast
        loop's halo fills then never broadcast a rank-3 boundary value."""
        if bcs is None:
            return True
        return all(bc is None or bc.value is None
                   or isinstance(bc.value, (int, float))
                   for _a, _s, bc in bcs.sides())

    def substep_eta(self, grid, eta_bcs, eta0, GU, GV, U0, V0, dt):
        """The barotropic substep loop (one lax.fori_loop over 2Δt).

        Returns (η̅-filtered η, U̅, V̅) — reference
        split_explicit_free_surface_kernels.jl:15-58 + settings weights.

        The loop runs on SQUEEZED rank-2 (x, y) arrays, which keeps a
        size-1 dimension out of the minor-most position of every loop
        array. Metric arrays are squeezed alongside; the halo-fill slab
        machinery is rank-agnostic along x/y."""
        g = self.gravitational_acceleration
        n = self.substeps
        dtau = 2.0 * dt / n
        wv = self._weight_vec(self.velocity_weights, eta0.dtype)
        wf = self._weight_vec(self.free_surface_weights, eta0.dtype)
        Hfc, Hcf = column_depths(grid)
        from ..boundary_conditions.bcs import fill_halos
        from ..ops import stencil as st

        squeeze = eta0.ndim == 3 and self._squeeze_ok(eta_bcs)
        sq = (lambda a: a[:, :, 0]) if squeeze else (lambda a: a)
        msq = (lambda m: m[..., 0] if getattr(m, "ndim", 0) == 3 else m) \
            if squeeze else (lambda m: m)
        eta0, U0, V0, GU, GV = map(sq, (eta0, U0, V0, GU, GV))
        Hfc, Hcf = sq(Hfc), sq(Hcf)
        dxu, dyv = msq(grid.dx(U_LOC)), msq(grid.dy(V_LOC))
        dyu, dxv = msq(grid.dy(U_LOC)), msq(grid.dx(V_LOC))
        az = msq(grid.Az(CENTER))

        def body(i, carry):
            eta, U, V, eta_av, U_av, V_av = carry
            eta = fill_halos(eta, grid, ETA_LOC, eta_bcs, axes=(0, 1))
            U = U + dtau * (-g * Hfc * st.dxf(eta) / dxu + GU)
            V = V + dtau * (-g * Hcf * st.dyf(eta) / dyv + GV)
            U = fill_halos(U, grid, U_LOC, None, axes=(0, 1))
            V = fill_halos(V, grid, V_LOC, None, axes=(0, 1))
            eta = eta - dtau * (st.dxc(dyu * U) + st.dyc(dxv * V)) / az
            return (eta, U, V, eta_av + wf[i] * eta,
                    U_av + wv[i] * U, V_av + wv[i] * V)

        z = jnp.zeros_like(eta0)
        carry = (eta0, U0, V0, z, jnp.zeros_like(U0), jnp.zeros_like(V0))
        carry = jax.lax.fori_loop(0, n, body, carry)
        eta, U, V, eta_av, U_av, V_av = carry
        eta_av = fill_halos(eta_av, grid, ETA_LOC, eta_bcs, axes=(0, 1))
        if squeeze:
            return eta_av[:, :, None], U_av[:, :, None], V_av[:, :, None]
        return eta_av, U_av, V_av

    def corrector(self, grid, u, v, U_av, V_av):
        """u += (U̅ − ∫u dz)/H (reference barotropic_split_explicit_corrector!)."""
        Hfc, Hcf = column_depths(grid)
        U, V = barotropic_mode(grid, u, v)
        return u + (U_av - U) / Hfc, v + (V_av - V) / Hcf
