"""Heptadiagonal stencil matrices: Krylov + geometric-multigrid solvers.

Array re-design of the reference's sparse-matrix solver pair:

* ``HeptadiagonalIterativeSolver``
  (/root/reference/src/Solvers/heptadiagonal_iterative_solver.jl:12-110):
  the reference assembles a CSC sparse matrix from per-face coefficients
  ``Ax, Ay, Az`` and per-cell ``C, D`` and runs IterativeSolvers.jl CG on
  it.  Here a 7-diagonal matrix IS its coefficient arrays: we keep the
  dense per-face coupling arrays and apply the operator matrix-free with
  ``jnp.roll`` shifts (XLA fuses the whole matvec into one
  bandwidth-bound pass — there is no sparse format to win anything).
* ``MultigridSolver``
  (/root/reference/src/Solvers/multigrid_solver.jl:10-84): the reference
  wraps AlgebraicMultigrid.jl's Ruge-Stüben AMG.  Algebraic coarsening is
  a host-side, pointer-chasing construction that XLA cannot trace, and on
  a structured grid it reduces to geometric coarsening anyway — so this
  is a GEOMETRIC multigrid with Galerkin-coarsened coefficients
  (factor-2 pooling; for the piecewise-constant prolongation P the
  Galerkin product ``Pᵀ A P`` is exactly "sum the fine face couplings
  across each coarse interface"), damped-Jacobi smoothing, and the
  V-cycle used as a preconditioner inside the same ``lax.while_loop``
  CG every other solver here uses.

Both operate on INTERIOR (halo-free) arrays in the difference form

    (A x)ᵢ = Σ_axis [ Lᵢ (xᵢ₋₁ − xᵢ) + Lᵢ₊₁ (xᵢ₊₁ − xᵢ) ] + cᵢ xᵢ

where ``L[axis][i]`` is the coupling through the LEFT face of cell ``i``
(``L[0]`` is the wrap coupling for a periodic axis and must be 0 for a
bounded one — walls carry no flux).  This form is symmetric by
construction and negative (semi-)definite for ``c ≤ 0``; the solvers run
CG on ``N = −A``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .pcg import cg_solve
from ..utils.location import C, CENTER, F


def _roll(x, shift, axis):
    return jnp.roll(x, shift, axis)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class StencilMatrix:
    """Symmetric 7-diagonal operator in left-face coupling form.

    ``L``: per-axis coupling arrays (same shape as x) or None (flat axis);
    ``c``: extra diagonal (array broadcastable to x, or None).
    """

    L: tuple  # (Lx|None, Ly|None, Lz|None)
    c: object  # array | None

    def tree_flatten(self):
        return (self.L, self.c), ()

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves)

    def apply(self, x):
        out = self.c * x if self.c is not None else jnp.zeros_like(x)
        for axis, L in enumerate(self.L):
            if L is None:
                continue
            R = _roll(L, -1, axis)  # coupling through the right face
            out = out + L * (_roll(x, 1, axis) - x) + R * (_roll(x, -1, axis) - x)
        return out

    def diag(self):
        d = 0.0
        for axis, L in enumerate(self.L):
            if L is None:
                continue
            d = d - (L + _roll(L, -1, axis))
        if self.c is not None:
            d = d + self.c
        return d

    # -- Galerkin coarsening -------------------------------------------------
    def coarsenable_axes(self, shape, min_size=4):
        return tuple(a for a in range(3)
                     if self.L[a] is not None
                     and shape[a] >= min_size and shape[a] % 2 == 0)

    def coarsen(self, shape, axes):
        """Pᵀ A P for piecewise-constant P over 2-blocks along `axes`."""
        def block_sum(arr, over):
            for a in over:
                s = list(arr.shape)
                s[a] //= 2
                s.insert(a + 1, 2)
                arr = arr.reshape(s).sum(axis=a + 1)
            return arr

        newL = []
        for a, L in enumerate(self.L):
            if L is None:
                newL.append(None)
                continue
            Lf = jnp.broadcast_to(L, shape)
            if a in axes:
                # keep every second face plane (the coarse interfaces), sum
                # the couplings crossing it over the other pooled axes, and
                # halve: the raw Pᵀ A P coupling of piecewise-constant P is
                # 2× the rediscretized A_face/d_face (the center-to-center
                # distance doubles) — the classic cell-centered-Galerkin
                # "too strong" operator that stalls MG on pure Poisson
                idx = [slice(None)] * 3
                idx[a] = slice(0, None, 2)
                Lf = Lf[tuple(idx)]
                newL.append(0.5 * block_sum(Lf, tuple(x for x in axes if x != a)))
            else:
                newL.append(block_sum(Lf, axes))
        newc = (block_sum(jnp.broadcast_to(self.c, shape), axes)
                if self.c is not None else None)
        new_shape = tuple(n // 2 if a in axes else n for a, n in enumerate(shape))
        return StencilMatrix(tuple(newL), newc), new_shape


def _prolong(x, axes):
    for a in axes:
        x = jnp.repeat(x, 2, axis=a)
    return x


def _restrict(x, axes):
    for a in axes:
        s = list(x.shape)
        s[a] //= 2
        s.insert(a + 1, 2)
        x = x.reshape(s).sum(axis=a + 1)
    return x


def build_levels(A, shape, min_size=4, max_levels=16):
    """[(StencilMatrix, shape, axes_coarsened_to_build_NEXT level), …]."""
    levels = []
    for _ in range(max_levels):
        axes = A.coarsenable_axes(shape, min_size)
        levels.append((A, shape, axes))
        if not axes:
            break
        A, shape = A.coarsen(shape, axes)
    else:
        levels[-1] = (levels[-1][0], levels[-1][1], ())
    return levels


def _safe_inv(d):
    return jnp.where(d == 0, jnp.zeros_like(d), 1.0 / jnp.where(d == 0, 1.0, d))


def _checkerboard(shape):
    ix = jnp.arange(shape[0]).reshape(-1, 1, 1)
    iy = jnp.arange(shape[1]).reshape(1, -1, 1)
    iz = jnp.arange(shape[2]).reshape(1, 1, -1)
    return (ix + iy + iz) % 2 == 0


def _rbgs(A, dinv, red, x, rhs, order, n):
    """Red-black Gauss-Seidel sweeps on N = −A (each color update is an
    exact GS half-sweep: the residual is recomputed with the freshly
    updated other color)."""
    for _ in range(n):
        for color in order:
            mask = red if color == "r" else ~red
            r = rhs + A.apply(x)  # rhs − N x
            x = x + jnp.where(mask, dinv * r, 0.0)
    return x


def v_cycle(levels, b, n_pre=1, n_post=1, n_coarse=12, omega=None):
    """One V-cycle with symmetric red-black Gauss-Seidel smoothing on
    N = −A, starting from x = 0: pre-smooth sweeps red→black, post-smooth
    black→red, so the cycle is a symmetric linear operator in ``b`` — a
    valid CG preconditioner."""
    rhss = [b]
    xs = []
    # downward leg
    for (A, shape, axes) in levels[:-1]:
        dinv = _safe_inv(-A.diag())
        red = _checkerboard(shape)
        x = _rbgs(A, dinv, red, jnp.zeros_like(rhss[-1]), rhss[-1],
                  ("r", "b"), n_pre)
        xs.append(x)
        r = rhss[-1] + A.apply(x)  # rhs − N x, N = −A
        rhss.append(_restrict(r, axes))
    # coarsest
    A, shape, _ = levels[-1]
    dinv = _safe_inv(-A.diag())
    red = _checkerboard(shape)
    x = _rbgs(A, dinv, red, jnp.zeros_like(rhss[-1]), rhss[-1],
              ("r", "b"), n_coarse)
    # upward leg
    for lev in range(len(levels) - 2, -1, -1):
        A, shape, axes = levels[lev]
        x = xs[lev] + _prolong(x, axes)
        dinv = _safe_inv(-A.diag())
        red = _checkerboard(shape)
        x = _rbgs(A, dinv, red, x, rhss[lev], ("b", "r"), n_post)
    return x


def _rb_ssor(A, dinv, red, r):
    """Symmetric red-black SSOR application M⁻¹r on N = −A from x = 0:
    a palindromic red→black→red exact-GS sweep (with red-black ordering a
    forward+backward GS pair collapses to this 3-color sweep — the
    repeated middle color is idempotent). Symmetric positive definite, so
    a valid CG preconditioner; 2 extra matvecs per application buy
    roughly half the iterations on irregular (immersed-column) matrices —
    the array-friendly stand-in for the reference's ILU
    (sparse_preconditioners.jl: ilu/sparse-inverse menus are pointer-
    chasing host constructions XLA cannot trace)."""
    x = jnp.where(red, dinv * r, 0.0)
    res = r + A.apply(x)  # r − N x
    x = x + jnp.where(~red, dinv * res, 0.0)
    res = r + A.apply(x)
    return x + jnp.where(red, dinv * res, 0.0)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class HeptadiagonalIterativeSolver:
    """Preconditioned CG on a StencilMatrix A plus the reference's
    Δt-dependent diagonal: solve ``[A + (C + D/Δt²) I] x = b`` given the
    face couplings in A and cell arrays C, D
    (heptadiagonal_iterative_solver.jl:29-66; the reference also defers
    the D/Δt² update to solve time).

    ``preconditioner``: "jacobi" (diagonal, default — the reference's
    default menu entry, sparse_preconditioners.jl), "ssor" (symmetric
    red-black Gauss-Seidel, the matrix-free stand-in for the reference's
    ILU on irregular matrices), or None."""

    A: StencilMatrix
    C: object  # array | scalar
    D: object  # array | scalar
    tolerance: float = 1e-10
    maxiter: int = 1000
    preconditioner: object = "jacobi"

    def tree_flatten(self):
        return (self.A, self.C, self.D), (self.tolerance, self.maxiter,
                                          self.preconditioner)

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves, *static)

    def _full(self, dt):
        c0 = self.A.c if self.A.c is not None else 0.0
        extra = self.C + (self.D / (dt * dt) if dt is not None else 0.0)
        return StencilMatrix(self.A.L, c0 + extra)

    def _M(self, A, shape):
        dinv = _safe_inv(-A.diag())
        if self.preconditioner == "ssor":
            red = _checkerboard(shape)
            return lambda r: _rb_ssor(A, dinv, red, r)
        if self.preconditioner == "jacobi":
            return lambda r: dinv * r
        return None

    def solve(self, b, dt=None, x0=None, axis_names=(), return_stats=False):
        A = self._full(dt)
        x0 = jnp.zeros_like(b) if x0 is None else x0
        x, it, res2 = cg_solve(lambda v: -A.apply(v), -b, x0,
                               M=self._M(A, b.shape),
                               reltol=self.tolerance, maxiter=self.maxiter,
                               axis_names=axis_names)
        return (x, it, res2) if return_stats else x


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MultigridSolver:
    """Geometric-multigrid-preconditioned CG on a StencilMatrix
    (reference multigrid_solver.jl:10-84; see module docstring for why
    AMG becomes GMG here). ``project_mean=True`` removes the constant
    nullspace (pure Neumann/periodic Poisson)."""

    A: StencilMatrix
    shape: tuple
    tolerance: float = 1e-10
    maxiter: int = 200
    n_pre: int = 1
    n_post: int = 1
    n_coarse: int = 12
    omega: float = None  # unused with RB-GS smoothing; kept for the API
    project_mean: bool = False

    def tree_flatten(self):
        return (self.A,), (self.shape, self.tolerance, self.maxiter,
                           self.n_pre, self.n_post, self.n_coarse,
                           self.omega, self.project_mean)

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(leaves[0], *static)

    def solve(self, b, x0=None):
        levels = build_levels(self.A, self.shape)

        def proj(x):
            return x - jnp.mean(x) if self.project_mean else x

        def M(r):
            return proj(v_cycle(levels, proj(r), self.n_pre, self.n_post,
                                self.n_coarse, self.omega))

        x0 = jnp.zeros_like(b) if x0 is None else x0
        x, it, res2 = cg_solve(lambda v: -self.A.apply(proj(v)), proj(-b), x0,
                               M=M, reltol=self.tolerance, maxiter=self.maxiter)
        return proj(x)


# -- grid-derived operators ----------------------------------------------------

def poisson_stencil(grid):
    """Volume-symmetrized FV Laplacian on a rectilinear grid's interior:
    ``V ∇²φ``, couplings L = A_face / d_face. Works for arbitrary
    per-axis stretching (the case the FFT/Fourier-tridiagonal solvers
    exclude)."""
    from ..grids.topology import BOUNDED, FLAT

    ii = tuple(slice(h, h + n) for h, n in zip(grid.halo, grid.shape))
    L = []
    for axis in range(3):
        if grid.topology[axis] is FLAT:
            L.append(None)
            continue
        floc = tuple(F if a == axis else C for a in range(3))
        # face area / center-to-center distance at the LEFT face of cell i
        area = 1.0
        for other in range(3):
            if other != axis and grid.topology[other] is not FLAT:
                area = area * grid.spacing(other, floc)
        d = grid.spacing(axis, floc)
        coef = jnp.broadcast_to(area / d, grid.total_shape)[ii]
        if grid.topology[axis] is BOUNDED:
            wall = [slice(None)] * 3
            wall[axis] = slice(0, 1)
            coef = coef.at[tuple(wall)].set(0.0)
        L.append(coef)
    return StencilMatrix(tuple(L), None)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class MultigridPoissonSolver:
    """Pressure-projection Poisson solve on grids stretched in x or y,
    where neither the FFT nor the Fourier-tridiagonal eigen-solvers
    apply (reference falls back to its iterative solvers there too).
    Interface matches FFTPoissonSolver.solve: interior rhs → interior φ,
    zero-mean gauge."""

    mg: MultigridSolver
    vol: jnp.ndarray  # interior cell volumes (the rhs symmetrization)
    dtype: object

    @classmethod
    def build(cls, grid, tolerance=1e-8, maxiter=100):
        A = poisson_stencil(grid)
        mg = MultigridSolver(A, grid.shape, tolerance=tolerance,
                             maxiter=maxiter, project_mean=True)
        ii = tuple(slice(h, h + n) for h, n in zip(grid.halo, grid.shape))
        vol = jnp.broadcast_to(grid.V(CENTER), grid.total_shape)[ii]
        return cls(mg, vol, grid.dtype)

    def tree_flatten(self):
        return (self.mg, self.vol), (self.dtype,)

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves, *static)

    def solve(self, rhs, m=0.0):
        return self.mg.solve(self.vol * rhs).astype(self.dtype)
