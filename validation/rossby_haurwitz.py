"""Rossby-Haurwitz wave (Williamson et al. 1992, test 6) on the conformal
cubed sphere (reference validation/cubed_sphere_rossby_haurwitz).

The wavenumber-4 pattern is an exact solution of the nondivergent
barotropic vorticity equation that translates zonally without change of
shape at angular speed  ν = [R(3+R)ω − 2Ω] / [(1+R)(2+R)].  On the
shallow-water system it remains close to that for days. Checks after
one simulated day: the zonal-wavenumber-4 spectral peak of η survives
intact, the amplitude is bounded, and the measured phase drift is small
(as the analytic speed predicts ≈ 12°/day).

Run: JAX_PLATFORMS=cpu python validation/rossby_haurwitz.py [N]
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
a = 6.371e6
Omega = 7.292115e-5
g0 = 9.80665
K = w = 7.848e-6
R = 4.0
h0 = 8000.0

grid = CubedSphereGrid(size=(N, N, 1), radius=a, dtype=jnp.float64, halo=3)
model = CubedSphereHydrostaticModel(grid, depth=h0,
                                    gravitational_acceleration=g0)

def sph(p):
    n = p / np.linalg.norm(p, axis=-1, keepdims=True)
    lam = np.arctan2(n[..., 1], n[..., 0])
    phi = np.arcsin(np.clip(n[..., 2], -1, 1))
    return lam, phi, n

def vel(p):
    lam, phi, n = sph(p)
    c = np.cos(phi); s = np.sin(phi)
    u = a * w * c + a * K * c ** (R - 1) * (R * s * s - c * c) * np.cos(R * lam)
    v = -a * K * R * c ** (R - 1) * s * np.sin(R * lam)
    # east/north unit vectors
    e_lam = np.stack([-np.sin(lam), np.cos(lam), np.zeros_like(lam)], -1)
    e_phi = np.stack([-s * np.cos(lam), -s * np.sin(lam), c], -1)
    return u[..., None] * e_lam + v[..., None] * e_phi

def eta0(p):
    lam, phi, _ = sph(p)
    c = np.cos(phi)
    A = (w / 2 * (2 * Omega + w) * c ** 2
         + 0.25 * K ** 2 * c ** (2 * R)
         * ((R + 1) * c ** 2 + (2 * R ** 2 - R - 2) - 2 * R ** 2 * c ** -2))
    B = (2 * (Omega + w) * K / ((R + 1) * (R + 2)) * c ** R
         * ((R ** 2 + 2 * R + 2) - (R + 1) ** 2 * c ** 2))
    C = 0.25 * K ** 2 * c ** (2 * R) * ((R + 1) * c ** 2 - (R + 2))
    return (a * a * (A + B * np.cos(R * lam) + C * np.cos(2 * R * lam))) / g0

state = model.initial_state(u=vel, eta=eta0)

from clima_oceananigans_jl_tpu.utils.location import C as LC
H = grid.H
_ll = [sph(np.asarray(grid._nodes(f, (LC, LC)))) for f in range(6)]
lam_c = np.stack([x[0] for x in _ll])
phi_c = np.stack([x[1] for x in _ll])

def wave4_phase(s):
    """Amplitude & phase of the zonal wavenumber-4 mode of η in a
    low-latitude band, via a direct Fourier projection on cell centers."""
    eta = np.asarray(s["eta"])[:, H:H + N, H:H + N, 0]
    lam = lam_c[:, H:H + N, H:H + N]
    phi = phi_c[:, H:H + N, H:H + N]
    band = np.abs(phi) < np.radians(30.0)
    e = eta[band] - eta[band].mean()
    l4 = 4 * lam[band]
    zc = (e * np.cos(l4)).mean() + 1j * (e * np.sin(l4)).mean()
    return np.abs(zc), np.angle(zc)

amp0, ph0 = wave4_phase(state)
day = 86400.0
dt = jnp.float64(100.0)
n_steps = int(day / float(dt))
step = jax.jit(model.step)
print(f"N={N} dt={float(dt)}s steps={n_steps} wave4 amp0={amp0:.2f}")
for i in range(n_steps):
    state = step(state, dt)
    if i % (n_steps // 6) == 0:
        amp, ph = wave4_phase(state)
        print(f"  it={i:5d} amp={amp:8.2f} phase={np.degrees(ph):+7.2f}°"
              f" max|u|={float(jnp.abs(grid.interior(state['solution']['u'])).max()):.1f}")

amp1, ph1 = wave4_phase(state)
nu = (R * (3 + R) * w - 2 * Omega) / ((1 + R) * (2 + R))
# η ∝ cos(4λ − 4νt): the projection phase advances by +4ν per unit time
expected_shift = np.degrees(4 * nu * day)
shift = np.degrees(np.angle(np.exp(1j * (ph1 - ph0))))
print(f"amplitude ratio: {amp1 / amp0:.3f}")
print(f"wave-4 phase shift after 1 day: {shift:+.2f}° "
      f"(analytic barotropic: {expected_shift:+.2f}°)")
assert 0.85 < amp1 / amp0 < 1.15, amp1 / amp0
# the divergent shallow-water wave drifts a touch slower than the
# nondivergent-barotropic analytic speed; allow ~20%
assert abs(shift - expected_shift) < 10.0, (shift, expected_shift)
assert bool(jnp.all(jnp.isfinite(state["solution"]["u"])))
print("PASS: Rossby-Haurwitz wave propagates intact on the cubed sphere")
