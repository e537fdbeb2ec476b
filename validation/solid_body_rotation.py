"""Solid-body rotation on the conformal cubed sphere: a Gaussian tracer
blob advected by steady zonal solid-body flow (reference
validation/solid_body_rotation + validation/cubed_sphere_tracer_advection,
the Williamson et al. (1992) test-1 setup).

Checks after a quarter revolution (the blob crosses two cube faces):
  * tracer mass ∬c dA is conserved,
  * max amplitude is not spuriously amplified,
  * the blob centroid tracks the exact rotated position.

Run: JAX_PLATFORMS=cpu python validation/solid_body_rotation.py [N]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu.grids.cubed_sphere import CubedSphereGrid
from clima_oceananigans_jl_tpu.models.cubed_sphere_hydrostatic import (
    CubedSphereHydrostaticModel)

N = int(sys.argv[1]) if len(sys.argv) > 1 else 32
R = 6.371e6
U0 = 2 * np.pi * R / (12.0 * 86400.0)  # one revolution in 12 days

grid = CubedSphereGrid(size=(N, N, 1), radius=R, dtype=jnp.float64, halo=3)
model = CubedSphereHydrostaticModel(grid, tracers=("c",), depth=1000.0,
                                    prescribed_velocities=True)

def vel(p):
    n = p / np.linalg.norm(p, axis=-1, keepdims=True)
    return np.cross([0.0, 0.0, U0], n)

# blob centered on the equator at lon 0
lon0 = 0.0
p0 = np.array([np.cos(lon0), np.sin(lon0), 0.0])
width = 0.08 * np.pi * R  # radians * R

def blob(p):
    n = p / np.linalg.norm(p, axis=-1, keepdims=True)
    ang = np.arccos(np.clip(n @ p0, -1, 1))
    return np.exp(-(ang * R / width) ** 2)

# build the velocity from a CORNER streamfunction ψ = −U0·R·sinφ so the
# C-grid transport divergence δx(dy·u) + δy(dx·v) telescopes to EXACTLY
# zero — analytically sampled u,v are only divergence-free to O(h²) and
# flux-form advection then spuriously amplifies the tracer
from clima_oceananigans_jl_tpu.utils.location import C as LC, F as LF
fgs = grid.face_grids()
shp = grid.total_shape
psi_faces = []
for f in range(6):
    pts = np.asarray(grid._nodes(f, (LF, LF)))   # true corner lattice
    nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    psi_faces.append(-U0 * R * nrm[..., 2])  # −U0 R sinφ at corners
psi = np.stack(psi_faces)
dy_fc = np.asarray(fgs.dy((LF, LC)))[..., 0]
dx_cf = np.asarray(fgs.dx((LC, LF)))[..., 0]
u2 = -(np.roll(psi, -1, axis=2) - psi) / dy_fc   # −δyψ/dy at (F,C)
v2 = (np.roll(psi, -1, axis=1) - psi) / dx_cf    # +δxψ/dx at (C,F)
nzt = shp[-1]
u3 = jnp.asarray(u2[..., None] * np.ones((nzt,)), grid.dtype)
v3 = jnp.asarray(v2[..., None] * np.ones((nzt,)), grid.dtype)
state = model.initial_state(u=u3, v=v3, c=blob)

# cell areas for conservation accounting
from clima_oceananigans_jl_tpu.utils.location import C as LC
Az = np.asarray(grid.face_grids().Az((LC, LC)))[..., 0]  # (6, X, Y) w/ halos
ii = (slice(None), slice(grid.H, grid.H + N), slice(grid.H, grid.H + N))

def tracer_mass(s):
    c = np.asarray(s["solution"]["c"])[..., 0]
    return (c[ii] * Az[ii]).sum()

def centroid(s):
    c = np.asarray(s["solution"]["c"])[..., 0][ii]
    pts = np.stack([np.asarray(grid._nodes(f, (LC, LC))) for f in range(6)])
    pts = pts[:, grid.H:grid.H + N, grid.H:grid.H + N]
    w = (c * Az[ii])[..., None]
    p = (pts * w).sum((0, 1, 2)) / w.sum()
    return p / np.linalg.norm(p)

m0 = tracer_mass(state)
def interior_max(s):
    return float(np.asarray(s["solution"]["c"])[..., 0][ii].max())
c0max = interior_max(state)
quarter = 0.25 * 2 * np.pi * R / U0
dt = 0.2 * (np.pi / 2 * R / N) / U0  # advective CFL 0.2 on the face spacing
n_steps = int(quarter / dt)
dt = jnp.float64(quarter / n_steps)
print(f"N={N} dt={float(dt):.0f}s steps={n_steps} (quarter revolution)")
step = jax.jit(model.step)
for i in range(n_steps):
    state = step(state, dt)
    if i % (n_steps // 6) == 0:
        print(f"  it={i:5d} mass drift={tracer_mass(state) / m0 - 1:+.2e} "
              f"cmax={interior_max(state):.4f}")

drift = abs(tracer_mass(state) / m0 - 1)
cen = centroid(state)
# exact: blob rotated by π/2 about ẑ → at lon 90°E on the equator
exact = np.array([0.0, 1.0, 0.0])
ang_err = np.degrees(np.arccos(np.clip(cen @ exact, -1, 1)))
cmax = interior_max(state)
print(f"tracer mass drift: {drift:.2e}")
print(f"centroid angular error: {ang_err:.2f}° "
      f"(cell size {90.0 / N:.2f}°)")
print(f"amplitude: {cmax:.4f} (initial {c0max:.4f})")
assert drift < 1e-3, drift
assert ang_err < 2.0 * 90.0 / N + 0.5, ang_err
assert cmax < 1.02 * c0max
assert cmax > 0.55 * c0max  # bounded numerical diffusion at this N
print("PASS: cubed-sphere solid-body rotation")
