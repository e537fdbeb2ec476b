"""Weak-scaling benchmark: fixed per-GPU subdomain, growing (x, y) mesh.

Reference anchors (docs/src/appendix/benchmarks.md): shallow-water MPI
weak scaling 2→128 ranks: 97%→81% efficiency; nonhydrostatic (distributed
FFT dominated): 12% at 128 ranks.

Run on a host of several GPUs:
    python benchmark/bench_weak_scaling.py [model] [local_n]
measures ms/step and pts/s/GPU for every mesh size that divides the
available devices; efficiency = throughput_per_gpu(N) / (N=1).
"""
import sys
import bench_common
DEVICE = bench_common.setup()
import time, jax, jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import (
    PERIODIC, BOUNDED, FLAT, RectilinearGrid, WENO5, DistributedModel, make_mesh,
)
from clima_oceananigans_jl_tpu.models.shallow_water import ShallowWaterModel
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer

which = sys.argv[1] if len(sys.argv) > 1 else "shallow_water"
local_n = int(sys.argv[2]) if len(sys.argv) > 2 else 1024

def mesh_shapes(n_dev):
    shapes = []
    n = 1
    while n <= n_dev:
        rx = int(n ** 0.5)
        while n % rx:
            rx -= 1
        shapes.append((rx, n // rx))
        n *= 2
    return shapes

results = []
for rx, ry in mesh_shapes(len(jax.devices())):
    n_chips = rx * ry
    if which == "shallow_water":
        grid = RectilinearGrid(size=(local_n * rx, local_n * ry, 1),
                               x=(0, 2*np.pi*rx), y=(0, 2*np.pi*ry),
                               topology=(PERIODIC, PERIODIC, FLAT),
                               dtype=jnp.float32)
        model = ShallowWaterModel(grid=grid, gravitational_acceleration=10.0,
                                  advection=WENO5())
        init = dict(uh=lambda x, y, z: 0.1*jnp.sin(x)*jnp.cos(y), h=1.0)
        pts = (local_n * rx) * (local_n * ry)
    else:
        nz = 64
        grid = RectilinearGrid(size=(local_n * rx, local_n * ry, nz),
                               extent=(rx, ry, 1.0),
                               topology=(PERIODIC, PERIODIC, BOUNDED),
                               dtype=jnp.float32)
        model = NonhydrostaticModel(grid, advection=WENO5(),
                                    buoyancy=BuoyancyTracer())
        init = dict(u=lambda x, y, z: 1e-2*jnp.sin(2*jnp.pi*y))
        pts = (local_n * rx) * (local_n * ry) * nz

    if n_chips == 1:
        state = model.initial_state(**init)
        step = jax.jit(model.step, donate_argnums=0)
        stepper = lambda s: step(s, jnp.float32(1e-4))
    else:
        dmodel = DistributedModel(model, make_mesh((rx, ry)))
        state = dmodel.initial_state(**init)
        stepper = lambda s: dmodel.step(s, 1e-4)
    state = stepper(state); state = stepper(state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    for _ in range(10):
        state = stepper(state)
    jax.block_until_ready(state)
    d = (time.perf_counter() - t0) / 10
    per_chip = pts / d / n_chips
    results.append((n_chips, d, per_chip))
    eff = per_chip / results[0][2]
    print(f"chips={n_chips:3d} mesh=({rx},{ry}) {d*1e3:8.2f} ms/step "
          f"{per_chip/1e6:8.1f} M pts/s/chip  efficiency={eff:.2%}", flush=True)
