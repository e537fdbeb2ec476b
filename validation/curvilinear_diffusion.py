"""Diffusion on the sphere vs the spherical-harmonic eigenvalue
(reference validation/curvilinear_diffusion): a zonal harmonic
c = P_n(sinφ) is an eigenfunction of the spherical Laplacian,

    ∇²Pₙ(sinφ) = −n(n+1)/R² · Pₙ(sinφ),

so under pure diffusion it must decay as exp(−κ n(n+1) t/R²) with its
SHAPE preserved — a sharp test of the lat-lon grid's curvilinear
metrics (Δx(φ) = R cosφ Δλ etc.).

Run: JAX_PLATFORMS=cpu python validation/curvilinear_diffusion.py [ny]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import Simulation, ScalarDiffusivity
from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid
from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from clima_oceananigans_jl_tpu.models.free_surface import ImplicitFreeSurface

ny = int(sys.argv[1]) if len(sys.argv) > 1 else 120
nx = 8
R = 6.371e6
n_mode = 4
kappa = 1e6  # large so the decay is measurable in hours

grid = LatitudeLongitudeGrid(size=(nx, ny, 1), longitude=(0, 360),
                             latitude=(-89.5, 89.5), z=(-1.0, 0.0),
                             dtype=jnp.float64)
model = HydrostaticFreeSurfaceModel(
    grid=grid, tracers=("c",), momentum_advection=None, tracer_advection=None,
    free_surface=ImplicitFreeSurface(solver_method="pcg"),
    closure=ScalarDiffusivity(nu=0.0, kappa=kappa))
g = model.grid

def P4(s):
    return (35 * s ** 4 - 30 * s ** 2 + 3) / 8.0

state = model.initial_state(
    c=lambda lam, phi, z: P4(jnp.sin(jnp.radians(phi))))
c0 = np.asarray(g.interior(state["solution"]["c"]))[0, :, 0]
lam_exact = kappa * n_mode * (n_mode + 1) / R ** 2  # 4.9e-7 /s
dt = jnp.float64(600.0)
steps = int(2.0 / (lam_exact * float(dt)))  # two e-folding times
step = jax.jit(model.step)
print(f"ny={ny} steps={steps} analytic decay rate {lam_exact:.3e} /s")
for i in range(steps):
    state = step(state, dt)
t = float(state["clock"].time)
c1 = np.asarray(g.interior(state["solution"]["c"]))[0, :, 0]

# shape preserved: the decayed field is proportional to the initial one
scale = (c1 @ c0) / (c0 @ c0)
shape_err = np.abs(c1 - scale * c0).max() / np.abs(c0).max()
lam_meas = -np.log(scale) / t
print(f"measured decay rate {lam_meas:.3e} /s "
      f"({lam_meas/lam_exact:.4f} × analytic)")
print(f"shape error {shape_err:.2e}")
assert abs(lam_meas / lam_exact - 1) < 0.02, lam_meas / lam_exact
assert shape_err < 5e-3, shape_err
print("PASS: spherical-harmonic diffusion eigenvalue on the lat-lon grid")
