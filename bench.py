"""Headline benchmark: 256^3 nonhydrostatic WENO5 step, grid points/s.

The reference's flagship benchmark (Oceananigans
benchmark/benchmark_nonhydrostatic_models.jl; published numbers in
docs/src/appendix/benchmarks.md:120-142 — V100 FP64 56.4 ms/step at 256^3
(~298 M pts/s), FP32 38.8 ms (~432 M pts/s)). Same configuration: WENO5
momentum advection, one active tracer, quasi-AB2 time stepping (one
tendency evaluation + one FFT projection per step), FP32; compared
against the reference's FP32 anchor.

    python bench.py            # needs an NVIDIA GPU; BENCH_N / BENCH_STEPS resize

One process. It refuses to run unless JAX's default device is a GPU,
and prints ONE JSON line naming the device (platform, kind, count) and
the card's power limit beside the measurement.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REFERENCE_PTS_PER_S = 432e6  # V100 FP32, docs/src/appendix/benchmarks.md:124

N = int(os.environ.get("BENCH_N", "256"))
STEPS = int(os.environ.get("BENCH_STEPS", "20"))


def main() -> int:
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX's default device is {dev.platform}",
              file=sys.stderr)
        return 1
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    from clima_oceananigans_jl_tpu import BOUNDED, PERIODIC, RectilinearGrid, WENO5
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
    from clima_oceananigans_jl_tpu.models.compile import compile_step
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel

    grid = RectilinearGrid(size=(N, N, N), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=jnp.float32)
    model = NonhydrostaticModel(grid, advection=WENO5(),
                                buoyancy=BuoyancyTracer(),
                                timestepper="QuasiAdamsBashforth2")
    ku, kv, kb = jax.random.split(jax.random.PRNGKey(0), 3)
    state = model.initial_state(
        u=1e-2 * jax.random.normal(ku, grid.shape, grid.dtype),
        v=1e-2 * jax.random.normal(kv, grid.shape, grid.dtype),
        b=1e-4 * jax.random.normal(kb, grid.shape, grid.dtype),
    )
    dt = jnp.asarray(1e-4, grid.dtype)
    step = compile_step(model, donate=True)

    state = step(state, dt)  # compile + warmup
    state = jax.block_until_ready(step(state, dt))
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = step(state, dt)
    jax.block_until_ready(state)
    elapsed = time.perf_counter() - t0
    if not bool(jnp.all(jnp.isfinite(state["solution"]["u"]))):
        print("non-finite state after the timed steps", file=sys.stderr)
        return 1

    pts_per_s = N ** 3 / (elapsed / STEPS)
    print(json.dumps({
        "metric": f"grid-points/s ({N}^3 nonhydrostatic WENO5 AB2, fp32)",
        "value": round(pts_per_s),
        "unit": "points/s",
        "vs_baseline": round(pts_per_s / REFERENCE_PTS_PER_S, 3),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": power,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
