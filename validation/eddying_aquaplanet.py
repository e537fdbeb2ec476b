"""Eddying aquaplanet on the conformal cubed sphere: the Galewsky et al.
(2004) barotropic-instability test — a reduced analog of the reference's
validation/cubed_sphere_eddying_aquaplanet (an unstable zonal jet on the
full sphere developing a mid-latitude eddy train).

A zonally symmetric jet at 45°N (u_max = 80 m s⁻¹, Galewsky's profile
u(φ) ∝ exp[1/((φ−φ₀)(φ−φ₁))]) in gradient-wind balance with the height
field is seeded with Galewsky's localized height bump. Barotropic
instability (the jet's absolute-vorticity gradient changes sign) rolls
the jet up into an eddy train over ~4–6 days. Checks:

  * instability: the zonal-asymmetry eddy measure (area-weighted var of
    η around its per-latitude zonal mean) grows ≥ 30× between day 1 and
    day 6 (the balanced state is zonally symmetric);
  * the solution stays bounded (max speed < 2.5 u_max) and finite —
    the eddies saturate instead of blowing up;
  * mass: the area integral of η is conserved to round-off;
  * the southern hemisphere (no jet, no perturbation) stays quiet
    relative to the northern eddy band.

Run: JAX_PLATFORMS=cpu python validation/eddying_aquaplanet.py [N]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from clima_oceananigans_jl_tpu.grids.cubed_sphere import CubedSphereGrid
from clima_oceananigans_jl_tpu.models.cubed_sphere_hydrostatic import (
    CubedSphereHydrostaticModel)
from clima_oceananigans_jl_tpu.utils.location import C as LC

N = int(sys.argv[1]) if len(sys.argv) > 1 else 32
a = 6.371e6
Omega = 7.292115e-5
g0 = 9.80665
H0 = 10_000.0          # mean depth (Galewsky gh0/g ≈ 10 km)
u_max = 80.0
phi0, phi1 = np.pi / 7.0, np.pi / 2.0 - np.pi / 7.0
en = np.exp(-4.0 / (phi1 - phi0) ** 2)


def u_profile(phi):
    inside = (phi > phi0) & (phi < phi1)
    denom = np.where(inside, (phi - phi0) * (phi - phi1), -1.0)
    return np.where(inside, u_max / en * np.exp(1.0 / denom), 0.0)


# gradient-wind balanced surface height: g dη/dφ = −u (a f + u tanφ)/a · a
# → η(φ) = −(1/g)∫ u(φ')(a f(φ') + u(φ') tanφ') dφ'
phis = np.linspace(-np.pi / 2 + 1e-6, np.pi / 2 - 1e-6, 4001)
uu = u_profile(phis)
integrand = uu * (2 * Omega * np.sin(phis) * a + uu * np.tan(phis))
eta_tab = -np.concatenate([[0.0], np.cumsum(
    0.5 * (integrand[1:] + integrand[:-1]) * np.diff(phis))]) / g0
eta_tab -= eta_tab.mean()


def sph(pts):
    n = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    lam = np.arctan2(n[..., 1], n[..., 0])
    phi = np.arcsin(np.clip(n[..., 2], -1, 1))
    return lam, phi


def vel(pts):
    lam, phi = sph(pts)
    u = u_profile(phi)
    e_lam = np.stack([-np.sin(lam), np.cos(lam), np.zeros_like(lam)], -1)
    return u[..., None] * e_lam


def eta_init(pts):
    lam, phi = sph(pts)
    base = np.interp(phi, phis, eta_tab)
    # Galewsky's localized bump: 120 m, α=1/3, β=1/15, centered 45°N
    bump = (120.0 * np.cos(phi)
            * np.exp(-(lam / (1.0 / 3.0)) ** 2)
            * np.exp(-((np.pi / 4.0 - phi) / (1.0 / 15.0)) ** 2))
    return base + bump


grid = CubedSphereGrid(size=(N, N, 1), radius=a, dtype=jnp.float64, halo=3)
model = CubedSphereHydrostaticModel(grid, depth=H0,
                                    gravitational_acceleration=g0)
state = model.initial_state(u=vel, eta=eta_init)

Hh = grid.H
pts = np.stack([np.asarray(grid._nodes(f, (LC, LC)))[Hh:Hh + N, Hh:Hh + N]
                for f in range(6)])
_, phi_c = sph(pts)
area = np.stack([np.asarray(grid.face_grids().Az((LC, LC, LC)))[f][
    Hh:Hh + N, Hh:Hh + N, 0] for f in range(6)])
north = (phi_c > np.radians(20.0)) & (phi_c < np.radians(70.0))
south = (phi_c < np.radians(-20.0)) & (phi_c > np.radians(-70.0))


def interior(s, name):
    arr = s["eta"] if name == "eta" else s["solution"][name]
    return np.asarray(arr)[:, Hh:Hh + N, Hh:Hh + N, 0]


# eddy measure: zonal ASYMMETRY of the (frame-independent) height field
# — area-weighted variance of η around its per-latitude-bin zonal mean.
# The balanced jet is zonally symmetric, so this is ~0 at t=0 up to the
# seeded bump; the instability's wavetrain sends it up orders of
# magnitude.
bins = np.radians(np.arange(-90.0, 90.1, 2.0))
bin_ix = np.digitize(phi_c.ravel(), bins)


def eddy_var(s, band):
    e = interior(s, "eta").ravel()
    w = area.ravel()
    ix = bin_ix
    zonal_mean = np.zeros(len(bins) + 1)
    counts = np.zeros(len(bins) + 1)
    np.add.at(zonal_mean, ix, w * e)
    np.add.at(counts, ix, w)
    zonal_mean /= np.maximum(counts, 1e-300)
    dev = e - zonal_mean[ix]
    m = band.ravel()
    return float((w[m] * dev[m] ** 2).sum() / w[m].sum())


# CFL: min spacing ~ a*(pi/2)/N * 0.7 (corner clustering); c = sqrt(g H0)
c = np.sqrt(g0 * H0)
dxmin = 0.7 * a * (np.pi / 2) / N
dt = 0.45 * dxmin / (c + u_max)
day = 86400.0

mass0 = float((area * interior(state, "eta")).sum())
step = jax.jit(model.step)
t = 0.0
while t < 1.0 * day - 1e-9:
    state = step(state, dt)
    t += dt
ev1 = eddy_var(state, north)
while t < 6.0 * day - 1e-9:
    state = step(state, dt)
    t += dt
ev6 = eddy_var(state, north)
ev6_s = eddy_var(state, south)
mass6 = float((area * interior(state, "eta")).sum())
umax6 = max(np.abs(interior(state, "u")).max(),
            np.abs(interior(state, "v")).max())

growth = ev6 / max(ev1, 1e-30)
mass_drift = abs(mass6 - mass0) / (area.sum() * H0)
failures = []


def check(name, ok, detail=""):
    print(f"  {'PASS' if ok else 'FAIL'}  {name} {detail}")
    if not ok:
        failures.append(name)


print(f"eddying aquaplanet (Galewsky) N={N}, dt={dt:.0f}s:")
check("barotropic instability grows", growth >= 30.0,
      f"(eddy var day1 {ev1:.3e} -> day6 {ev6:.3e}, x{growth:.0f})")
check("eddies saturate bounded", umax6 < 2.5 * u_max and np.isfinite(umax6),
      f"(max speed {umax6:.1f} m/s)")
check("mass conservation", mass_drift < 1e-9,
      f"(relative drift {mass_drift:.2e})")
check("southern hemisphere quiet", ev6_s < 0.05 * ev6,
      f"(south {ev6_s:.3e} vs north {ev6:.3e})")
print("eddying_aquaplanet:", "ALL PASS" if not failures
      else f"FAILED {failures}")
sys.exit(1 if failures else 0)
