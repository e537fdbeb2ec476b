"""Lid-driven cavity at Re=100 vs the Ghia, Ghia & Shin (1982) benchmark
(reference validation/lid_driven_cavity/lid_driven_cavity.jl). This is an
INDEPENDENT parity check: the targets are published multigrid solutions,
not output of this framework.

Run: JAX_PLATFORMS=cpu python validation/lid_driven_cavity.py [N]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import (
    BOUNDED, FLAT, RectilinearGrid, FieldBCs, ValueBC,
)
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
from clima_oceananigans_jl_tpu.advection.schemes import WENO5
from clima_oceananigans_jl_tpu.closures.scalar_diffusivity import ScalarDiffusivity

# Ghia et al. (1982), Table I/II, Re=100: u on the vertical centerline
# (x=0.5) at height y, and v on the horizontal centerline (y=0.5) at x.
GHIA_Y_U = np.array([
    (0.0000, 0.00000), (0.0547, -0.03717), (0.0625, -0.04192),
    (0.1016, -0.06434), (0.1719, -0.10150), (0.2813, -0.15662),
    (0.4531, -0.21090), (0.5000, -0.20581), (0.6172, -0.13641),
    (0.7344, 0.00332), (0.8516, 0.23151), (0.9531, 0.68717),
    (0.9688, 0.78871), (1.0000, 1.00000)])
GHIA_X_V = np.array([
    (0.0000, 0.00000), (0.0625, 0.09233), (0.0781, 0.10091),
    (0.0938, 0.12317), (0.1563, 0.16077), (0.2266, 0.17507),
    (0.5000, 0.05454), (0.8047, -0.24533), (0.8594, -0.22445),
    (0.9063, -0.16914), (0.9531, -0.08864), (0.9688, -0.05906),
    (1.0000, 0.00000)])

N = int(sys.argv[1]) if len(sys.argv) > 1 else 64
Re = 100.0
nu = 1.0 / Re

grid = RectilinearGrid(size=(N, 1, N), x=(0.0, 1.0), y=(0.0, 1.0),
                       z=(0.0, 1.0), topology=(BOUNDED, FLAT, BOUNDED),
                       dtype=jnp.float64)
model = NonhydrostaticModel(
    grid, advection=WENO5(), closure=ScalarDiffusivity(nu=nu),
    timestepper="RungeKutta3",  # AB2's real-axis stability (λΔt<1) sits
                                # exactly at the diffusive limit at N=64
    boundary_conditions={
        # moving lid: u = 1 at the top wall; no-slip elsewhere
        "u": FieldBCs(top=ValueBC(1.0), bottom=ValueBC(0.0)),
        "w": FieldBCs(west=ValueBC(0.0), east=ValueBC(0.0)),
    })
state = model.initial_state()
dt = jnp.float64(min(0.2 / N, 0.2 * (1.0 / N) ** 2 / nu))
n_steps = int(25.0 / float(dt))  # ~25 advective times to steady state
step = jax.jit(model.step)
print(f"N={N} dt={float(dt):.2e} steps={n_steps}")
for i in range(n_steps):
    state = step(state, dt)
    if i % (n_steps // 10) == 0:
        u = state["solution"]["u"]
        print(f"  it={i:6d} t={float(state['clock'].time):.2f} "
              f"max|u|={float(jnp.abs(u).max()):.4f}")

sol = state["solution"]
ui = np.asarray(grid.interior(sol["u"]))[:, 0, :]   # (N, N) at (F, C)
wi = np.asarray(grid.interior(sol["w"]))[:, 0, :]   # (N, N) at (C, F)
zc = np.asarray(grid.coord(2, "c"))
xc = np.asarray(grid.coord(0, "c"))

# u at the vertical centerline x=0.5: face index N//2 IS x=0.5
u_mid = ui[N // 2, :]
u_ghia = np.interp(GHIA_Y_U[:, 0], zc, u_mid)
# clamp exact wall values the grid cannot collocate
u_ghia[0], u_ghia[-1] = 0.0, 1.0
err_u = np.abs(u_ghia - GHIA_Y_U[:, 1]).max()

# w(=v in Ghia's 2D notation) at the horizontal centerline z=0.5
w_mid = wi[:, N // 2]
w_ghia = np.interp(GHIA_X_V[:, 0], xc, w_mid)
w_ghia[0], w_ghia[-1] = 0.0, 0.0
err_w = np.abs(w_ghia - GHIA_X_V[:, 1]).max()

print(f"max|u - Ghia| on x=0.5: {err_u:.4f}")
print(f"max|w - Ghia| on z=0.5: {err_w:.4f}")
assert err_u < 0.035, err_u
assert err_w < 0.035, err_w
print("PASS: Re=100 cavity matches Ghia et al. (1982)")
