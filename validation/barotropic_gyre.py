"""Wind-driven Stommel gyre vs the analytic solution
(reference validation/stommel_gyre + validation/barotropic_gyre).

Linear β-plane basin, steady wind curl, linear bottom drag. The steady
transport streamfunction of Stommel (1948),

    β ψ_x + r ∇²ψ = curl τ = −(τ0 π / b) sin(π y / b),

separates as ψ = sin(πy/b) P(x) with r P'' + β P' − r(π/b)² P = −τ0π/b
and P(0) = P(λ) = 0 — solved exactly below and compared against the
steady state of the (weakly nonlinear) ShallowWaterModel.

Run: JAX_PLATFORMS=cpu python validation/barotropic_gyre.py [N]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import BOUNDED, FLAT, RectilinearGrid
from clima_oceananigans_jl_tpu.models.shallow_water import ShallowWaterModel
from clima_oceananigans_jl_tpu.coriolis.coriolis import BetaPlane
from clima_oceananigans_jl_tpu.utils.location import C, F

N = int(sys.argv[1]) if len(sys.argv) > 1 else 64
L = 1.0e6           # basin size (m)
H = 1000.0          # depth (m)
g = 0.1             # reduced gravity → slow, well-resolved gravity waves
beta = 1e-11
f0 = 1e-5
r = 1e-6            # linear drag (1/s): Stommel layer δ = r/β = 100 km
tau0 = 1e-4         # kinematic wind stress (m²/s²)

grid = RectilinearGrid(size=(N, N, 1), x=(0.0, L), y=(0.0, L),
                       topology=(BOUNDED, BOUNDED, FLAT), dtype=jnp.float64)

def wind_drag_u(grid, clock, fields):
    _, y, _ = grid.nodes((F, C, C), with_halo=True)
    tau = -tau0 * jnp.cos(jnp.pi * y / L)
    return (tau - r * fields["uh"]) * jnp.ones_like(fields["uh"])

def drag_v(grid, clock, fields):
    return -r * fields["vh"]

model = ShallowWaterModel(grid=grid, gravitational_acceleration=g,
                          coriolis=BetaPlane(f0=f0, beta=beta),
                          forcing={"uh": wind_drag_u, "vh": drag_v})
state = model.initial_state(h=H)
dt = jnp.float64(0.25 * (L / N) / np.sqrt(g * H))
n_steps = int(4.0 / (r * float(dt)))  # ~4 spin-down times to steady state
step = jax.jit(model.step)
print(f"N={N} dt={float(dt):.0f}s steps={n_steps} "
      f"({n_steps * float(dt) / 86400:.0f} days)")
for i in range(n_steps):
    state = step(state, dt)
    if i % (n_steps // 8) == 0:
        vh = state["solution"]["vh"]
        print(f"  it={i:6d} max|vh|={float(jnp.abs(vh).max()):.3f} m²/s")

# numerical transport streamfunction: ψ(x, y) = ∫₀ˣ vh dx'
vh = np.asarray(grid.interior(state["solution"]["vh"]))[:, :, 0]  # (N, N) at (C,F)
dx = L / N
psi_num = np.cumsum(vh, axis=0) * dx  # at x-cell right edges, y faces

# analytic Stommel streamfunction at the same nodes
xe = (np.arange(1, N + 1)) * dx       # right edges
yf = np.asarray(grid.coord(1, "f"))[:N]
kpi = np.pi / L
Pp = tau0 * L / (np.pi * r)
disc = np.sqrt(beta ** 2 + 4 * r ** 2 * kpi ** 2)
mp, mm = (-beta + disc) / (2 * r), (-beta - disc) / (2 * r)
Amat = np.array([[1.0, 1.0], [np.exp(mp * L), np.exp(mm * L)]])
a, c = np.linalg.solve(Amat, [-Pp, -Pp])
P = Pp + a * np.exp(mp * xe) + c * np.exp(mm * xe)
psi_ana = np.sin(kpi * yf)[None, :] * P[:, None]

corr = np.corrcoef(psi_num.ravel(), psi_ana.ravel())[0, 1]
ipk = np.unravel_index(np.argmax(np.abs(psi_ana)), psi_ana.shape)
amp = psi_num[ipk] / psi_ana[ipk]     # gyre strength at the analytic peak
# western intensification: peak |vh| in the western Stommel layer vs east
west = np.abs(vh[: N // 8]).max()
east = np.abs(vh[N // 2:]).max()
print(f"corr(ψ_num, ψ_Stommel) = {corr:.4f}")
print(f"amplitude ratio ψ_peak num/ana = {amp:.3f}")
print(f"western/eastern boundary-current strength = {west / east:.1f}")
assert corr > 0.98, corr
assert 0.85 < amp < 1.15, amp
assert west / east > 3.0, west / east
print("PASS: Stommel gyre matches the analytic solution")
