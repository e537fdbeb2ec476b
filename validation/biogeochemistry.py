"""Biogeochemistry building blocks: reacting tracer pairs with opposed
slip velocities, and a sinking phytoplankton column with light-limited
growth — reference validation/biogeochemistry/two_reacting_tracers.jl
and sinking_tracer.jl.

Case 1 (two reacting tracers, 1D column): tracers a and b react
(ȧ = −ab, ḃ = +ab), a sinks and b rises via ``AdvectiveForcing`` slip
velocities (WENO5 flux form), both diffuse with κ = 10⁻². Checks:
  * ∫(a+b) dz is conserved to round-off — the reaction is antisymmetric
    and the slip advection is in flux form through impenetrable walls;
  * mass transfers from a to b (∫a decreases, ∫b increases);
  * the slip velocities move the centers of mass in opposite directions.

Case 2 (sinking phytoplankton, 2D x–z): P is produced by a prescribed
light curve g(z) = (1/τ)·exp(z/h) and sinks at 1 m s⁻¹. Checks:
  * the P inventory matches the analytic source integral t·∬g dx dz to
    a few % (sinking redistributes, production dominates the budget);
  * the center of mass sits below the production-weighted depth and
    deepens over time (sinking).

Run: JAX_PLATFORMS=cpu python validation/biogeochemistry.py
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from clima_oceananigans_jl_tpu import (BOUNDED, FLAT, PERIODIC,
                                       RectilinearGrid, ScalarDiffusivity,
                                       WENO5)
from clima_oceananigans_jl_tpu.advection.schemes import BoundsPreservingWENO5
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.forcings.forcing import AdvectiveForcing, Forcing
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
from clima_oceananigans_jl_tpu.models.prescribed import (
    PrescribedVelocityFields, PrescribedVelocityModel)

failures = []


def check(name, ok, detail=""):
    print(f"  {'PASS' if ok else 'FAIL'}  {name} {detail}")
    if not ok:
        failures.append(name)


# -- case 1: two reacting tracers ------------------------------------------
print("two_reacting_tracers (reference two_reacting_tracers.jl):")
grid = RectilinearGrid(size=(1, 1, 128), x=(0, 1), y=(0, 1), z=(-10, 10),
                       topology=(FLAT, FLAT, BOUNDED),
                       dtype=jnp.float64)
model = PrescribedVelocityModel(
    grid, PrescribedVelocityFields(), tracers=("a", "b"),
    tracer_advection=WENO5(),
    closure=ScalarDiffusivity(kappa=1e-2),
    forcing={
        "a": (Forcing(lambda x, y, z, t, a, b: -a * b,
                      field_dependencies=("a", "b")),
              AdvectiveForcing(WENO5(), w=-1.0)),
        "b": (Forcing(lambda x, y, z, t, a, b: +a * b,
                      field_dependencies=("a", "b")),
              AdvectiveForcing(WENO5(), w=+1.0)),
    })
state = model.initial_state(
    a=lambda x, y, z: jnp.exp(-(z - 4.0) ** 2),
    b=lambda x, y, z: jnp.exp(-(z + 4.0) ** 2))
step = jax.jit(model.step)

from clima_oceananigans_jl_tpu.utils.location import CENTER
zc = np.asarray(grid.nodes(CENTER, with_halo=False)[2]).ravel()


def totals(s):
    a = np.asarray(grid.interior(s["solution"]["a"]))[0, 0]
    b = np.asarray(grid.interior(s["solution"]["b"]))[0, 0]
    return a, b


a0, b0 = totals(state)
com_a0 = (zc * a0).sum() / a0.sum()
com_b0 = (zc * b0).sum() / b0.sum()
dt = 1e-2
for _ in range(400):
    state = step(state, dt)
a1, b1 = totals(state)
com_a1 = (zc * a1).sum() / a1.sum()
com_b1 = (zc * b1).sum() / b1.sum()

tot0, tot1 = (a0 + b0).sum(), (a1 + b1).sum()
check("sum conservation", abs(tot1 - tot0) <= 1e-10 * tot0,
      f"(drift {abs(tot1 - tot0) / tot0:.2e})")
check("a->b mass transfer", a1.sum() < a0.sum() and b1.sum() > b0.sum(),
      f"(∫a {a0.sum():.3f}->{a1.sum():.3f}, ∫b {b0.sum():.3f}->{b1.sum():.3f})")
check("a sinks", com_a1 < com_a0 - 1.0,
      f"(com {com_a0:.2f}->{com_a1:.2f})")
check("b rises", com_b1 > com_b0 + 1.0,
      f"(com {com_b0:.2f}->{com_b1:.2f})")
check("positivity", a1.min() > -1e-8 and b1.min() > -1e-8)

# -- case 2: sinking phytoplankton -----------------------------------------
print("sinking_tracer (reference sinking_tracer.jl):")
nx, nz = 64, 64
grid2 = RectilinearGrid(size=(nx, 1, nz), x=(0, 128), y=(0, 1), z=(-64, 0),
                        topology=(PERIODIC, FLAT, BOUNDED),
                        dtype=jnp.float64)
tau, h = 3600.0, 4.0
growth = Forcing(lambda x, y, z, t: (1.0 / tau) * jnp.exp(z / h))
# slip velocity tapered to 0 at the walls: sinking particles carry no
# flux through the surface or the bottom (a constant w=-1 would advect
# ghost-mirror tracer IN through the surface and leak mass out the
# bottom, making the production budget unclosable)
from clima_oceananigans_jl_tpu.utils.location import W_LOC
zf = grid2.nodes(W_LOC, with_halo=True)[2]
w_slip = jnp.where((zf > -64.0 + 1e-9) & (zf < -1e-9), -1.0, 0.0)
model2 = NonhydrostaticModel(
    grid2, advection=WENO5(), tracers=("b", "P"),
    buoyancy=BuoyancyTracer(),
    forcing={"P": (growth, AdvectiveForcing(BoundsPreservingWENO5(), w=w_slip))})
state2 = model2.initial_state(b=lambda x, y, z: 1e-5 * z)
step2 = jax.jit(model2.step)
dz = 64.0 / nz
dt2 = 0.1 * dz
nsteps = 400
for _ in range(nsteps):
    state2 = step2(state2, dt2)
P = np.asarray(grid2.interior(state2["solution"]["P"]))[:, 0, :]
zc2 = np.asarray(grid2.nodes(CENTER, with_halo=False)[2]).ravel()
dx = 128.0 / nx

inventory = P.sum() * dx * dz
t_final = nsteps * dt2
analytic = t_final / tau * 128.0 * h * (1.0 - np.exp(-64.0 / h))
check("production budget", abs(inventory - analytic) <= 0.05 * analytic,
      f"(got {inventory:.3f}, analytic {analytic:.3f})")
com_P = (P.sum(axis=0) * zc2).sum() / P.sum()
# production-weighted depth of the light curve alone
com_g = (np.exp(zc2 / h) * zc2).sum() / np.exp(zc2 / h).sum()
check("sinking displaces production", com_P < com_g - 5.0,
      f"(P com {com_P:.2f} m vs source com {com_g:.2f} m)")
# AB2's (3/2)G − (1/2)G⁻ extrapolation is not TVD even with
# bounds-preserving fluxes — a ~1% front undershoot is the expected
# stepper artifact (the reference documents the same AB2 caveat for its
# positivity schemes); the scheme-level limiter keeps it small
check("near-positivity (AB2 + bounds-preserving WENO)",
      P.min() > -0.02 * P.max(), f"(min {P.min():.2e}, max {P.max():.2e})")

print("biogeochemistry:", "ALL PASS" if not failures else f"FAILED {failures}")
sys.exit(1 if failures else 0)
