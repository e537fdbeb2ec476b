"""Rising thermal bubble (reference validation/thermal_bubble): a warm
buoyant anomaly in a neutrally stratified box rises, accelerating from
rest; physics checks are against conservation laws and the initial
linear-regime buoyancy acceleration — independent invariants, not
framework-generated goldens.

Checks:
  * total buoyancy (heat) is conserved exactly (periodic x, rigid lids),
  * the bubble's centroid rises, with initial acceleration near
    ¼·b_max: the b-weighted mean of a Gaussian is b_max/2 and the 2-D
    (cylindrical) added-mass factor is ½ → a ≈ 0.25·b_max,
  * kinetic energy grows from 0 monotonically in the early phase,
  * velocity field stays divergence-free.

Run: JAX_PLATFORMS=cpu python validation/thermal_bubble.py [N]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import (
    BOUNDED, FLAT, PERIODIC, RectilinearGrid, ScalarDiffusivity,
)
from clima_oceananigans_jl_tpu.advection.schemes import WENO5
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
from clima_oceananigans_jl_tpu.ops import operators as op
from clima_oceananigans_jl_tpu.utils.location import CENTER

N = int(sys.argv[1]) if len(sys.argv) > 1 else 64
L = 1000.0
b0 = 0.01
R = 100.0

grid = RectilinearGrid(size=(N, 1, N), x=(0, L), y=(0, 1), z=(0, L),
                       topology=(PERIODIC, FLAT, BOUNDED), dtype=jnp.float64)
model = NonhydrostaticModel(grid, advection=WENO5(), tracers=("b",),
                            buoyancy=BuoyancyTracer(),
                            closure=ScalarDiffusivity(nu=1e-2, kappa=1e-2),
                            timestepper="RungeKutta3")
g = model.grid
state = model.initial_state(
    b=lambda x, y, z: b0 * jnp.exp(-((x - L / 2) ** 2 + (z - L / 4) ** 2)
                                   / (2 * R * R)))

vol = float(L / N) ** 2
zc = np.asarray(g.coord(2, "c"))

def diag(s):
    sol = s["solution"]
    b = np.asarray(g.interior(sol["b"]))[:, 0, :]
    heat = b.sum() * vol
    zbar = (b * zc[None, :]).sum() / b.sum()
    u = np.asarray(g.interior(sol["u"]))
    w = np.asarray(g.interior(sol["w"]))
    ke = 0.5 * float((u * u + w * w).sum()) * vol
    return heat, zbar, ke

heat0, z0, _ = diag(state)
dt = jnp.float64(0.5)
step = jax.jit(model.step)
hist = [(0.0, z0, 0.0)]
for i in range(1, 241):
    state = step(state, dt)
    if i % 40 == 0:
        heat, zbar, ke = diag(state)
        hist.append((i * float(dt), zbar, ke))
        print(f"t={i*float(dt):6.0f}s  Σb drift={heat/heat0-1:+.2e}  "
              f"z̄={zbar:7.2f} m  KE={ke:.3e}")

heat, zbar, ke = diag(state)
assert abs(heat / heat0 - 1) < 1e-12
# centroid rises
rises = [hist[k + 1][1] > hist[k][1] for k in range(len(hist) - 1)]
assert all(rises), [h[1] for h in hist]
# initial acceleration from the first sample: z̄ ≈ z0 + ½ a t²
t1 = hist[1][0]
a_meas = 2 * (hist[1][1] - z0) / t1 ** 2
print(f"measured initial acceleration {a_meas:.2e} m/s² (b_max = {b0:.0e})")
assert 0.12 * b0 < a_meas < 0.4 * b0, a_meas
# KE grows monotonically during the rise phase
kes = [h[2] for h in hist]
assert all(kes[k + 1] > kes[k] for k in range(len(kes) - 1))
# projection keeps the flow divergence-free
sol = state["solution"]
div = op.div_ccc(sol["u"], sol["v"], sol["w"], g)
assert float(jnp.abs(g.interior(div)).max()) < 1e-10
print("PASS: thermal bubble rises with exact heat conservation")
