"""Per-phase timing of the nonhydrostatic step (compile + steady-state)."""
import sys
import bench_common
DEVICE = bench_common.setup()
import time, jax, jax.numpy as jnp
from clima_oceananigans_jl_tpu import PERIODIC, BOUNDED, RectilinearGrid, WENO5
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel

n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
grid = RectilinearGrid(size=(n, n, n), extent=(1., 1., 1.),
                       topology=(PERIODIC, PERIODIC, BOUNDED), dtype=jnp.float32)
model = NonhydrostaticModel(grid, advection=WENO5(), buoyancy=BuoyancyTracer(),
                            timestepper="RungeKutta3")
grid = model.grid
state = model.initial_state(u=1e-2 * jax.random.normal(jax.random.PRNGKey(0),
                                                       grid.shape, grid.dtype))
jax.block_until_ready(state)
print("state ready", flush=True)


def bench_fn(name, fn, *args, reps=10):
    f = jax.jit(fn)
    out = f(*args); jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(*args)
    jax.block_until_ready(out)
    print(f"{name}: {(time.perf_counter()-t0)/reps*1e3:.2f} ms", flush=True)


bench_fn("full step", lambda s: model.step(s, jnp.float32(1e-4)), state)
bench_fn("tendencies", model.tendencies, state)
bench_fn("projection", lambda s: model.project_velocities(s, jnp.float32(1e-4)), state)
bench_fn("update_state", model.update_state, state)
bench_fn("fill_halos all", lambda s: model.fill_all_halos(s["solution"]), state)
rhs = grid.interior(state["solution"]["u"])
bench_fn("fft solve only", model.pressure_solver.solve, rhs)
from clima_oceananigans_jl_tpu.advection.fluxes import div_vu
bench_fn("div_vu WENO alone",
         lambda s: div_vu(grid, model.advection, s["solution"]["u"],
                          s["solution"]["v"], s["solution"]["w"]), state)
