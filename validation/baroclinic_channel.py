"""Baroclinically unstable channel (reference
validation/mesoscale_turbulence — the eddying-channel family): a zonal
jet in thermal-wind balance over a meridional buoyancy front goes
baroclinically unstable; the fastest-growing eddy must appear at the
Eady wavelength and grow at a rate consistent with the Eady maximum —
independent analytic targets.

Setup notes (each reference-faithful): the deformation radius is
resolved (Ld = NH/f = 4Δx — with Ld ≲ Δx the C-grid's averaged Coriolis
vanishes at grid scale and the front is locally unbalanced, producing a
spurious Nyquist mode growing at ~M²/N); the lateral closure is a
HORIZONTAL-formulation biharmonic (an isotropic ν₄ sized for Δx ≫ Δz is
unstable along z); η starts in geostrophic balance.

Checks over 30 days:
  * the dominant zonal mode sits at the Eady wavelength ≈ 3.9·L_d,
  * the growth rate is within [0.3, 1.2]·(0.31 f Λ/N),
  * EKE grows ≥ 10³× from the seed and everything stays finite.

Run: JAX_PLATFORMS=cpu python validation/baroclinic_channel.py
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import (
    BOUNDED, PERIODIC, RectilinearGrid, ScalarDiffusivity, FPlane,
)
from clima_oceananigans_jl_tpu.closures.scalar_diffusivity import (
    ScalarBiharmonicDiffusivity)
from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from clima_oceananigans_jl_tpu.models.free_surface import ImplicitFreeSurface
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.advection.vector_invariant import VectorInvariant
from clima_oceananigans_jl_tpu.advection.schemes import WENO5

Lx, Ly, H = 1e6, 1e6, 1000.0
nx, ny, nz = 64, 64, 8
f0, N2, M2 = 1e-4, 4e-5, 1e-7
Lam = M2 / f0                      # thermal-wind shear Λ
Ld = np.sqrt(N2) * H / f0          # 63 km = 4 Δx
g0 = 9.80665

grid = RectilinearGrid(size=(nx, ny, nz), x=(0, Lx), y=(0, Ly), z=(-H, 0),
                       topology=(PERIODIC, BOUNDED, BOUNDED),
                       dtype=jnp.float64)
model = HydrostaticFreeSurfaceModel(
    grid=grid, coriolis=FPlane(f=f0), buoyancy=BuoyancyTracer(),
    momentum_advection=VectorInvariant(scheme="weno_velocity"),
    tracer_advection=WENO5(),
    free_surface=ImplicitFreeSurface(solver_method="fft"),
    closure=(ScalarBiharmonicDiffusivity(nu=1e10, kappa=1e10,
                                         formulation="horizontal"),
             ScalarDiffusivity(nu=0.0, kappa=0.0, nu_z=1e-3, kappa_z=1e-4,
                               time_discretization="vertically_implicit")))
g = model.grid

key = jax.random.PRNGKey(11)
noise = 1e-4 * jax.random.normal(key, g.shape, jnp.float64)
state = model.initial_state(
    b=lambda x, y, z: N2 * z + M2 * (y - Ly / 2),
    u=lambda x, y, z: -Lam * (z + H / 2) + 0 * x,
    eta=lambda x, y: (f0 * Lam * H / (2 * g0)) * (y - Ly / 2))
sol = dict(state["solution"])
sol["v"] = sol["v"].at[tuple(slice(h, h + n) for h, n in
                             zip(g.halo, g.shape))].add(noise)
state = dict(state, solution=sol)

def eke(s):
    u = np.asarray(g.interior(s["solution"]["u"]))
    v = np.asarray(g.interior(s["solution"]["v"]))
    up = u - u.mean(axis=0, keepdims=True)
    vp = v - v.mean(axis=0, keepdims=True)
    return 0.5 * float((up * up + vp * vp).mean())

def dominant_kx(s):
    v = np.asarray(g.interior(s["solution"]["v"]))[:, :, nz // 2]
    spec = np.abs(np.fft.rfft(v, axis=0)).mean(axis=1)
    return int(np.argmax(spec[1:]) + 1)

dt = jnp.float64(900.0)
days = 30
steps = int(days * 86400 / float(dt))
step = jax.jit(model.step)
e0 = eke(state)
series = [(0.0, e0)]
for i in range(1, steps + 1):
    state = step(state, dt)
    if i % (steps // 10) == 0:
        t = i * float(dt)
        series.append((t, eke(state)))
        print(f"day {t/86400:5.1f}: EKE = {series[-1][1]:.3e} m²/s²  "
              f"dominant kx = {dominant_kx(state)}")

kx = dominant_kx(state)
lam_eady = 3.9 * Ld
print(f"dominant wavelength {Lx/kx/1e3:.0f} km (Eady: {lam_eady/1e3:.0f} km)")
assert abs(Lx / kx - lam_eady) < 0.45 * lam_eady, (Lx / kx, lam_eady)

e_final = series[-1][1]
assert e_final > 1e3 * e0, (e_final, e0)
# growth rate over the last 40% of the record (clean exponential phase)
ts = np.array([s[0] for s in series[-5:]])
es = np.array([s[1] for s in series[-5:]])
sigma_meas = 0.5 * np.polyfit(ts, np.log(es), 1)[0]
sigma_eady = 0.31 * f0 * Lam / np.sqrt(N2)
print(f"growth rate σ = {sigma_meas:.2e} /s "
      f"({sigma_meas/sigma_eady:.2f} × Eady max)")
assert 0.3 * sigma_eady < sigma_meas < 1.2 * sigma_eady, (
    sigma_meas, sigma_eady)
for name in ("u", "v", "b"):
    assert bool(jnp.all(jnp.isfinite(state["solution"][name]))), name
print("PASS: baroclinic instability at the Eady wavelength and growth rate")
