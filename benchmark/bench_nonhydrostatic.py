"""Nonhydrostatic benchmark at a given N (AB2, the reference's config)."""
import sys
import bench_common
DEVICE = bench_common.setup()
import time, jax, jax.numpy as jnp
from clima_oceananigans_jl_tpu import PERIODIC, BOUNDED, RectilinearGrid, WENO5
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.models.compile import compile_step
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel

n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
stepper = sys.argv[2] if len(sys.argv) > 2 else "QuasiAdamsBashforth2"
grid = RectilinearGrid(size=(n, n, n), extent=(1., 1., 1.),
                       topology=(PERIODIC, PERIODIC, BOUNDED), dtype=jnp.float32)
model = NonhydrostaticModel(grid, advection=WENO5(), buoyancy=BuoyancyTracer(),
                            timestepper=stepper)
t0 = time.perf_counter()
state = model.initial_state(u=1e-2 * jax.random.normal(jax.random.PRNGKey(0),
                                                       grid.shape, grid.dtype))
jax.block_until_ready(state)
print(f"state {time.perf_counter()-t0:.1f}s", flush=True)
step = compile_step(model, donate=True)
t0 = time.perf_counter()
state = step(state, jnp.float32(1e-4)); jax.block_until_ready(state)
print(f"compile+first {time.perf_counter()-t0:.1f}s", flush=True)
state = step(state, jnp.float32(1e-4)); jax.block_until_ready(state)
t0 = time.perf_counter()
reps = 10
for _ in range(reps):
    state = step(state, jnp.float32(1e-4))
jax.block_until_ready(state)
dt = (time.perf_counter() - t0) / reps
print(f"N={n} {stepper}: {dt*1e3:.2f} ms/step -> {n**3/dt/1e6:.1f} M pts/s", flush=True)
