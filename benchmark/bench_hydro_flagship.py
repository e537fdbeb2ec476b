"""Hydrostatic lat-lon flagship benchmark.

    python benchmark/bench_hydro_flagship.py [deg] [reps]

1440x600x24 at deg=0.25 (default): weno-VI momentum + 2 WENO tracers,
spherical Coriolis, split-explicit(30), stretched z, fp32 — stepped
through ``compile_step`` with donation. deg=0.125 is the
scale-invariance check (83 M points on one card)."""
import sys, time
import bench_common
DEVICE = bench_common.setup()
import jax, jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid
from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from clima_oceananigans_jl_tpu.models.free_surface import SplitExplicitFreeSurface
from clima_oceananigans_jl_tpu.coriolis.coriolis import HydrostaticSphericalCoriolis
from clima_oceananigans_jl_tpu.advection.vector_invariant import VectorInvariant
from clima_oceananigans_jl_tpu.advection.schemes import WENO5
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.models.compile import compile_step

deg = float(sys.argv[1]) if len(sys.argv) > 1 else 0.25
reps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
nx, ny, nz = int(360 / deg), int(150 / deg), 24
k = np.arange(nz + 1)
zf = -3000.0 * (1.0 - k / nz) ** 1.8
grid = LatitudeLongitudeGrid(size=(nx, ny, nz), longitude=(0, 360),
                             latitude=(-75, 75), z=zf, dtype=jnp.float32)
model = HydrostaticFreeSurfaceModel(
    grid, momentum_advection=VectorInvariant(scheme="weno_velocity"),
    tracer_advection=WENO5(), tracers=("T", "S"),
    free_surface=SplitExplicitFreeSurface(substeps=30),
    coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer())
state = model.initial_state(
    u=0.1 * jax.random.normal(jax.random.PRNGKey(0), model.grid.shape,
                              jnp.float32),
    b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
dt = jnp.asarray(600.0, grid.dtype)
step = compile_step(model, donate=True)
state = jax.block_until_ready(step(state, dt))
t0 = time.perf_counter()
for _ in range(reps):
    state = step(state, dt)
jax.block_until_ready(state)
ms = (time.perf_counter() - t0) / reps * 1e3
print(f"hydrostatic {deg}° ({nx}x{ny}x{nz}): {ms:.1f} ms/step "
      f"-> {nx * ny * nz / ms * 1e3 / 1e6:.0f} M pts/s")
