"""One-dimensional periodic advection: every scheme advects a Gaussian
and a square wave through one full period and is scored against the
exact (translated) profile — reference
validation/periodic_advection/periodic_advection.jl.

Checks: high-order schemes beat low-order ones on the smooth profile at
the expected margins; WENO5 stays essentially non-oscillatory on the
square wave while the linear schemes ring.

Run: JAX_PLATFORMS=cpu python validation/periodic_advection.py [N]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import FLAT, PERIODIC, RectilinearGrid
from clima_oceananigans_jl_tpu.advection.schemes import (
    BoundsPreservingWENO5, CenteredSecondOrder, CenteredFourthOrder,
    UpwindBiasedFirstOrder, UpwindBiasedThirdOrder, UpwindBiasedFifthOrder,
    WENO5)
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel

N = int(sys.argv[1]) if len(sys.argv) > 1 else 128
U = 1.0

SCHEMES = [("centered2", CenteredSecondOrder()),
           ("centered4", CenteredFourthOrder()),
           ("upwind1", UpwindBiasedFirstOrder()),
           ("upwind3", UpwindBiasedThirdOrder()),
           ("upwind5", UpwindBiasedFifthOrder()),
           ("weno5", WENO5()),
           ("weno5_bp", BoundsPreservingWENO5())]

gauss = lambda x: jnp.exp(-((x - 0.5) / 0.1) ** 2)
square = lambda x: jnp.where((x > 0.3) & (x < 0.7), 1.0, 0.0)

results = {}
for profile_name, profile in (("gaussian", gauss), ("square", square)):
    print(f"--- {profile_name} profile, one period at CFL 0.2, N={N}")
    for name, scheme in SCHEMES:
        grid = RectilinearGrid(size=(N, 1, 1), x=(0, 1), y=(0, 1),
                               topology=(PERIODIC, FLAT, FLAT),
                               halo=(4, 1, 1), dtype=jnp.float64)
        model = NonhydrostaticModel(grid, tracers=("c",),
                                    tracer_advection=scheme,
                                    advection=CenteredSecondOrder(),
                                    timestepper="RungeKutta3")
        g = model.grid
        state = model.initial_state(u=U, c=lambda x, y, z: profile(x))
        dt = 0.2 / N / U
        steps = round(1.0 / (U * dt))
        dt = jnp.float64(1.0 / steps)
        step = jax.jit(model.step)
        for _ in range(steps):
            state = step(state, dt)
        got = np.asarray(g.interior(state["solution"]["c"]))[:, 0, 0]
        exact = np.asarray(profile(jnp.asarray(g.coord(0, "c"))))
        l1 = np.abs(got - exact).mean()
        over = max(got.max() - 1.0, -got.min())
        print(f"  {name:10s}: L1={l1:.2e}  over/undershoot={over:+.3e}")
        results[(profile_name, name)] = (l1, over)

# smooth profile: order hierarchy holds
assert results[("gaussian", "weno5")][0] < results[("gaussian", "upwind3")][0]
assert results[("gaussian", "upwind5")][0] < results[("gaussian", "upwind3")][0]
assert results[("gaussian", "upwind3")][0] < results[("gaussian", "upwind1")][0]
# square wave: WENO is (essentially) non-oscillatory, centered rings hard
assert results[("square", "weno5")][1] < 2e-2
assert results[("square", "weno5_bp")][1] < 2e-2
assert results[("square", "centered2")][1] > 0.1
# first-order upwind is monotone but the most diffusive of all
assert results[("square", "upwind1")][1] < 1e-12
assert results[("square", "upwind1")][0] == max(
    results[("square", n)][0] for n, _ in SCHEMES)
print("PASS: periodic advection scheme hierarchy")
