"""Near-global hydrostatic flagship benchmark (BASELINE config 5 analog):
lat-lon grid, immersed continents, split-explicit free surface,
spherical Coriolis, wind stress, vertically-implicit diffusion.

    python benchmark/bench_near_global.py [deg] [steps]

Reports ms/step and grid-points/s on the current backend. The reference
anchor is its quarter-degree near-global setup (BASELINE.md config 5).
"""
import sys
import bench_common
DEVICE = bench_common.setup()
import time
import jax, jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import (ScalarDiffusivity, FieldBCs, FluxBC,
                                       GridFittedBottom)
from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid
from clima_oceananigans_jl_tpu.models.compile import compile_step
from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from clima_oceananigans_jl_tpu.models.free_surface import SplitExplicitFreeSurface
from clima_oceananigans_jl_tpu.coriolis.coriolis import HydrostaticSphericalCoriolis
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer

deg = float(sys.argv[1]) if len(sys.argv) > 1 else 0.25
steps = int(sys.argv[2]) if len(sys.argv) > 2 else 10
nx, ny, nz = int(360 / deg), int(150 / deg), 24
k = np.arange(nz + 1)
z_faces = -3000.0 * (1.0 - k / nz) ** 1.8
grid = LatitudeLongitudeGrid(size=(nx, ny, nz), longitude=(0, 360),
                             latitude=(-75, 75), z=z_faces,
                             dtype=jnp.float32)

def bathymetry(lam, phi):
    land = (jax.nn.sigmoid((lam - 255.0) / 8.0) * jax.nn.sigmoid((300.0 - lam) / 8.0)
            * jax.nn.sigmoid((phi + 55.0) / 6.0) * jax.nn.sigmoid((70.0 - phi) / 6.0))
    return jnp.where(land > 0.5, 100.0, -3000.0)

model = HydrostaticFreeSurfaceModel(
    grid=grid, free_surface=SplitExplicitFreeSurface(substeps=30),
    coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer(),
    closure=ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                              time_discretization="vertically_implicit"),
    immersed_boundary=GridFittedBottom(bathymetry),
    boundary_conditions={"u": FieldBCs(top=FluxBC(
        lambda lam, phi, t: -1e-4 * jnp.cos(3.0 * jnp.pi * phi / 180.0)))})
state = model.initial_state(
    b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
dt = jnp.asarray(600.0, grid.dtype)
step = compile_step(model, donate=True)
state = step(state, dt)
jax.block_until_ready(jax.tree_util.tree_leaves(state)[0])
print("compiled", flush=True)
t0 = time.perf_counter()
for _ in range(steps):
    state = step(state, dt)
jax.block_until_ready(jax.tree_util.tree_leaves(state)[0])
ms = (time.perf_counter() - t0) / steps * 1e3
pts = nx * ny * nz
print(f"near-global {deg}° ({nx}x{ny}x{nz}): {ms:.1f} ms/step "
      f"-> {pts / ms * 1e3 / 1e6:.0f} M pts/s")
