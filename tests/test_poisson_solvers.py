"""Poisson solver tests (model: /root/reference/test/test_poisson_solvers.jl)."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from clima_oceananigans_jl_tpu import (
    BOUNDED, FLAT, PERIODIC, RectilinearGrid, CENTER, U_LOC, V_LOC, W_LOC,
    fill_halos,
)
from clima_oceananigans_jl_tpu.ops import operators as op
from clima_oceananigans_jl_tpu.solvers.fft_poisson import FFTPoissonSolver
from clima_oceananigans_jl_tpu.solvers.fourier_tridiagonal import FourierTridiagonalSolver
from clima_oceananigans_jl_tpu.solvers.tridiagonal import solve_batched_tridiagonal

TOPOS = [PERIODIC, BOUNDED]


@pytest.mark.parametrize("tx,ty,tz", list(itertools.product(TOPOS, TOPOS, TOPOS)))
def test_fft_solver_satisfies_discrete_poisson(tx, ty, tz):
    n = (8, 8, 8)
    g = RectilinearGrid(size=n, extent=(1.0, 1.3, 0.7), topology=(tx, ty, tz),
                        dtype=jnp.float64)
    rng = np.random.default_rng(42)
    rhs = rng.standard_normal(n)
    rhs -= rhs.mean()
    solver = FFTPoissonSolver.build(g)
    phi_int = solver.solve(jnp.asarray(rhs))
    # embed and check ∇²φ = rhs via the FV laplacian
    phi = jnp.zeros(g.total_shape, jnp.float64)
    sl = tuple(slice(h, h + m) for h, m in zip(g.halo, g.shape))
    phi = phi.at[sl].set(phi_int)
    phi = fill_halos(phi, g, CENTER)
    lap = np.asarray(g.interior(op.laplacian(phi, g)))
    assert np.allclose(lap, rhs, atol=1e-9)


@pytest.mark.parametrize("tx,ty", [(PERIODIC, PERIODIC), (PERIODIC, BOUNDED),
                                   (BOUNDED, BOUNDED)])
def test_fourier_tridiagonal_on_stretched_z(tx, ty):
    faces = np.concatenate([[0.0], np.cumsum(np.random.default_rng(3).uniform(0.5, 1.5, 8))])
    g = RectilinearGrid(size=(8, 8, 8), x=(0, 1), y=(0, 1), z=faces,
                        topology=(tx, ty, BOUNDED), dtype=jnp.float64)
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal((8, 8, 8))
    # make rhs volume-mean-free (compatibility for pure-Neumann problem)
    w = np.asarray(g.interior(jnp.broadcast_to(g.V(CENTER), g.total_shape)))
    rhs -= (rhs * w).sum() / w.sum()
    solver = FourierTridiagonalSolver.build(g)
    phi_int = solver.solve(jnp.asarray(rhs))
    phi = jnp.zeros(g.total_shape, jnp.float64)
    sl = tuple(slice(h, h + m) for h, m in zip(g.halo, g.shape))
    phi = phi.at[sl].set(phi_int)
    phi = fill_halos(phi, g, CENTER)
    lap = np.asarray(g.interior(op.laplacian(phi, g)))
    assert np.allclose(lap, rhs, atol=1e-8)


@pytest.mark.parametrize("topo", [(PERIODIC, PERIODIC, PERIODIC),
                                  (PERIODIC, PERIODIC, BOUNDED),
                                  (BOUNDED, BOUNDED, BOUNDED)])
def test_divergence_free_projection(topo):
    """Random u* → projection → ∇·u ≈ 0 (reference test :45-84)."""
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
    g = RectilinearGrid(size=(16, 16, 16), extent=(1, 1, 1), topology=topo,
                        dtype=jnp.float64)
    model = NonhydrostaticModel(grid=g)
    rng = np.random.default_rng(0)
    state = model.initial_state(
        u=rng.standard_normal((16, 16, 16)),
        v=rng.standard_normal((16, 16, 16)),
        w=rng.standard_normal((16, 16, 16)))
    state = model.project_velocities(state, jnp.float64(1.0))
    sol = model.fill_all_halos(state["solution"])
    div = op.div_ccc(sol["u"], sol["v"], sol["w"], model.grid)
    assert np.max(np.abs(np.asarray(model.grid.interior(div)))) < 1e-10


def test_poisson_solver_second_order_convergence():
    """cos(2πx) RHS → analytic solution, 2nd-order (reference :87-91)."""
    errs = []
    for n in (16, 32, 64):
        g = RectilinearGrid(size=(n, 1, 1), x=(0, 1), y=(0, 1),
                            topology=(PERIODIC, FLAT, FLAT), dtype=jnp.float64)
        x = np.asarray(g.coord(0, "c"))
        rhs = -(2 * np.pi) ** 2 * np.cos(2 * np.pi * x).reshape(n, 1, 1)
        solver = FFTPoissonSolver.build(g)
        phi = np.asarray(solver.solve(jnp.asarray(rhs)))[:, 0, 0]
        exact = np.cos(2 * np.pi * x)
        errs.append(np.max(np.abs(phi - exact)))
    r1 = np.log2(errs[0] / errs[1])
    r2 = np.log2(errs[1] / errs[2])
    assert r1 > 1.9 and r2 > 1.9


def test_odd_sized_fft_solver():
    g = RectilinearGrid(size=(11, 13, 7), extent=(1, 1, 1),
                        topology=(PERIODIC, BOUNDED, BOUNDED), dtype=jnp.float64)
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal((11, 13, 7))
    rhs -= rhs.mean()
    solver = FFTPoissonSolver.build(g)
    phi_int = solver.solve(jnp.asarray(rhs))
    phi = jnp.zeros(g.total_shape, jnp.float64)
    sl = tuple(slice(h, h + m) for h, m in zip(g.halo, g.shape))
    phi = phi.at[sl].set(phi_int)
    phi = fill_halos(phi, g, CENTER)
    lap = np.asarray(g.interior(op.laplacian(phi, g)))
    assert np.allclose(lap, rhs, atol=1e-9)


def test_batched_tridiagonal_vs_dense():
    rng = np.random.default_rng(5)
    nz = 10
    a = rng.uniform(0.5, 1.0, nz)
    b = rng.uniform(3.0, 4.0, nz)
    c = rng.uniform(0.5, 1.0, nz)
    a[0] = 0.0
    c[-1] = 0.0
    d = rng.standard_normal((4, 3, nz))
    phi = np.asarray(solve_batched_tridiagonal(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), jnp.asarray(d)))
    M = np.diag(b) + np.diag(a[1:], -1) + np.diag(c[:-1], 1)
    for i in range(4):
        for j in range(3):
            expected = np.linalg.solve(M, d[i, j])
            assert np.allclose(phi[i, j], expected, atol=1e-12)


def _f32_vs_f64(build, rhs):
    """Solve in fp32 and in fp64 on the same grid; return (φ32, φ64)."""
    out = {}
    for dtype in (jnp.float32, jnp.float64):
        g = build(dtype)
        solver = (FourierTridiagonalSolver if not g.z_regular
                  else FFTPoissonSolver).build(g)
        phi = solver.solve(jnp.asarray(rhs, dtype))
        assert phi.dtype == dtype
        out[dtype] = np.asarray(phi, np.float64)
        assert np.all(np.isfinite(out[dtype]))
    return out[jnp.float32], out[jnp.float64]


@pytest.mark.parametrize("tx,ty,tz", list(itertools.product(TOPOS, TOPOS, TOPOS)))
def test_fft_solver_f32_matches_f64(tx, ty, tz):
    """The precision the card runs: fp32 transforms (cuFFT on the GPU)
    agree with the fp64 solve to fp32 round-off grown over three
    transform pairs of ~10 points (a few ulp × log N), far below any
    error in the eigenvalues or the transform kinds."""
    n = (8, 12, 10)
    rhs = np.random.default_rng(11).standard_normal(n)
    rhs -= rhs.mean()
    phi32, phi64 = _f32_vs_f64(
        lambda d: RectilinearGrid(size=n, extent=(1.0, 1.3, 0.7),
                                  topology=(tx, ty, tz), dtype=d), rhs)
    np.testing.assert_allclose(phi32, phi64, rtol=0,
                               atol=1e-5 * np.abs(phi64).max())


@pytest.mark.parametrize("tx,ty", [(PERIODIC, PERIODIC), (PERIODIC, BOUNDED),
                                   (BOUNDED, BOUNDED)])
def test_fourier_tridiagonal_f32_matches_f64(tx, ty):
    faces = np.concatenate(
        [[0.0], np.cumsum(np.random.default_rng(5).uniform(0.5, 1.5, 8))])
    build = lambda d: RectilinearGrid(size=(8, 8, 8), x=(0, 1), y=(0, 1),
                                      z=faces, topology=(tx, ty, BOUNDED),
                                      dtype=d)
    g = build(jnp.float64)
    rhs = np.random.default_rng(9).standard_normal((8, 8, 8))
    w = np.asarray(g.interior(jnp.broadcast_to(g.V(CENTER), g.total_shape)))
    rhs -= (rhs * w).sum() / w.sum()
    phi32, phi64 = _f32_vs_f64(build, rhs)
    np.testing.assert_allclose(phi32, phi64, rtol=0,
                               atol=1e-5 * np.abs(phi64).max())
