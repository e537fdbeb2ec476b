"""Surface gravity waves on the conformal cubed sphere: a small Gaussian
free-surface bump radiates an axisymmetric gravity-wave ring whose front
travels at the shallow-water phase speed c = sqrt(g H) (reference
validation/cubed_sphere_surface_gravity_waves/cubed_sphere_surface_gravity_
waves.jl — same H = 4 km, g = 0.1, A = 1e-5 H, 15-degree bump; the
reference case is qualitative/animated, here the phase speed is asserted
against the analytic value).

Checks:
  * the eta-weighted ring radius advances at c = sqrt(gH) = 20 m/s to
    within 10% between t1 = 2 days and t2 = 4 days (the ring crosses
    cube-face edges in that window, exercising the rotated exchange),
  * volume (area-integrated eta) is conserved to round-off,
  * the bump actually radiates: the residual at the source drops well
    below the initial amplitude.

Run: JAX_PLATFORMS=cpu python validation/cubed_sphere_gravity_waves.py [N]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu.grids.cubed_sphere import CubedSphereGrid
from clima_oceananigans_jl_tpu.models.cubed_sphere_hydrostatic import (
    CubedSphereHydrostaticModel)
from clima_oceananigans_jl_tpu.utils.location import C as LC

N = int(sys.argv[1]) if len(sys.argv) > 1 else 32
R = 6.371e6
H = 4.0e3                      # barotropic depth [m]
g = 0.1                        # reduced gravity, reference's value
c = np.sqrt(g * H)             # = 20 m/s, the analytic phase speed
A = 1e-5 * H                   # 4 cm bump: linear dynamics

grid = CubedSphereGrid(size=(N, N, 1), radius=R, dtype=jnp.float64, halo=3)
model = CubedSphereHydrostaticModel(grid, depth=H,
                                    gravitational_acceleration=g,
                                    coriolis_rotation_rate=0.0)

# Gaussian eta bump at the center of face 1 (lon 0, lat 0), the
# reference's face_number=1 case: width 15 degrees in lon and lat
p0 = np.array([1.0, 0.0, 0.0])

def eta_bump(pts):
    n = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    lam = np.degrees(np.arctan2(n[..., 1], n[..., 0]))
    phi = np.degrees(np.arcsin(np.clip(n[..., 2], -1, 1)))
    return A * np.exp(-lam ** 2 / 15.0 ** 2) * np.exp(-phi ** 2 / 15.0 ** 2)

state = model.initial_state(eta=eta_bump)

# geometry for the diagnostics: interior cell centers + areas
Hh = grid.H
pts = np.stack([np.asarray(grid._nodes(f, (LC, LC)))[Hh:Hh + N, Hh:Hh + N]
                for f in range(6)])
nrm = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
theta = np.arccos(np.clip(nrm @ p0, -1, 1))          # (6,N,N) angle from source
area = np.stack([np.asarray(grid.face_grids().Az((LC, LC, LC)))[f][
    Hh:Hh + N, Hh:Hh + N, 0] for f in range(6)])


def eta_interior(s):
    return np.asarray(s["eta"])[:, Hh:Hh + N, Hh:Hh + N, 0]


def ring_radius(e):
    """Energy-weighted mean angular distance of the eta signal outside
    the source neighborhood — tracks the expanding ring's position."""
    w = area * e ** 2
    w = np.where(theta > np.radians(8.0), w, 0.0)
    return float((w * theta).sum() / w.sum())


dt = 900.0                          # c*dt = 18 km << min face spacing
day = 86400.0
t1, t2 = 2.0 * day, 4.0 * day
step = jax.jit(model.step)

vol0 = float((area * eta_interior(state)).sum())
t = 0.0
while t < t1 - 1e-9:
    state = step(state, dt)
    t += dt
th1 = ring_radius(eta_interior(state))
while t < t2 - 1e-9:
    state = step(state, dt)
    t += dt
e2 = eta_interior(state)
th2 = ring_radius(e2)
vol2 = float((area * e2).sum())

c_meas = R * (th2 - th1) / (t2 - t1)
vol_drift = abs(vol2 - vol0) / abs(vol0)
residual = float(np.abs(np.where(theta < np.radians(8.0), e2, 0.0)).max())

print(f"ring radius: {np.degrees(th1):.1f} deg @ 2 d -> "
      f"{np.degrees(th2):.1f} deg @ 4 d")
print(f"measured phase speed {c_meas:.2f} m/s vs analytic {c:.2f} m/s "
      f"({100 * (c_meas / c - 1):+.1f}%)")
print(f"volume drift (relative) {vol_drift:.2e}; "
      f"source residual {residual / A:.3f} A")

assert abs(c_meas / c - 1) < 0.10, f"phase speed off: {c_meas} vs {c}"
assert vol_drift < 1e-12, f"volume not conserved: {vol_drift}"
assert residual < 0.5 * A, f"bump did not radiate: residual {residual}"
print("PASS: cubed-sphere surface gravity waves at sqrt(gH)")
