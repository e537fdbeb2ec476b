"""Shallow-water benchmark (reference benchmark_shallow_water_model.jl:
16384^2 on V100 = 681 ms/step FP64, ~394 M pts/s).

Prints a human line plus ONE JSON line in the bench.py artifact format
(vs_baseline against the reference's V100 anchor above), naming the
card it ran on.
"""
import json
import sys
import bench_common
DEVICE = bench_common.setup()
import time, jax, jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import PERIODIC, FLAT, RectilinearGrid, WENO5
from clima_oceananigans_jl_tpu.models.compile import compile_step
from clima_oceananigans_jl_tpu.models.shallow_water import ShallowWaterModel

n = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
grid = RectilinearGrid(size=(n, n, 1), x=(0, 2*np.pi), y=(0, 2*np.pi),
                       topology=(PERIODIC, PERIODIC, FLAT), dtype=jnp.float32)
model = ShallowWaterModel(grid=grid, gravitational_acceleration=10.0,
                          advection=WENO5())
state = model.initial_state(
    uh=lambda x, y, z: 0.1*jnp.sin(x)*jnp.cos(y), h=1.0)
jax.block_until_ready(state)
print("state ready", flush=True)
step = compile_step(model, donate=True)
dt = jnp.float32(1e-4)
state = step(state, dt); state = step(state, dt)
jax.block_until_ready(state)
t0 = time.perf_counter()
reps = 10
for _ in range(reps):
    state = step(state, dt)
jax.block_until_ready(state)
d = (time.perf_counter()-t0)/reps
print(f"SW {n}^2 RK3: {d*1e3:.1f} ms/step -> {n*n/d/1e6:.0f} M pts/s", flush=True)
print(json.dumps({
    "metric": f"grid-points/s/chip ({n}^2 shallow-water WENO5 RK3, fp32)",
    "value": round(n * n / d),
    "unit": "points/s",
    "vs_baseline": round(n * n / d / 394e6, 3),
    "device": {"platform": DEVICE.platform, "kind": DEVICE.device_kind,
               "count": len(jax.devices())},
}), flush=True)
