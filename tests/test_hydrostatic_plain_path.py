"""The hydrostatic model's plain XLA path: the split-explicit substep
loop conserves volume, and each vector-invariant momentum variant
stepped in fp32 agrees with the same step in fp64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clima_oceananigans_jl_tpu import BOUNDED, PERIODIC, RectilinearGrid, WENO5
from clima_oceananigans_jl_tpu.advection.vector_invariant import VectorInvariant
from clima_oceananigans_jl_tpu.boundary_conditions.bcs import FieldBCs, ValueBC
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.coriolis.coriolis import HydrostaticSphericalCoriolis
from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid
from clima_oceananigans_jl_tpu.models.free_surface import SplitExplicitFreeSurface
from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from clima_oceananigans_jl_tpu.utils.location import CENTER


def _split_explicit_case(kind):
    """(grid, η boundary conditions) for each closed or periodic basin."""
    if kind.startswith("latlon"):
        zf = [-100.0 * (1 - (k / 4.0) ** 1.5) for k in range(5)]
        grid = LatitudeLongitudeGrid(size=(16, 12, 4), longitude=(0, 360),
                                     latitude=(-60, 60), z=zf,
                                     dtype=jnp.float64)
        bcs = (FieldBCs(south=ValueBC(0.25), north=ValueBC(-0.5))
               if kind == "latlon_value_bc" else None)
        return grid, bcs
    topo = ((BOUNDED, BOUNDED, BOUNDED) if kind == "rect_bounded_xy"
            else (PERIODIC, PERIODIC, BOUNDED))
    return RectilinearGrid(size=(16, 12, 4), extent=(1e5, 1e5, 100.0),
                           topology=topo, dtype=jnp.float64), None


@pytest.mark.parametrize("kind", ["latlon", "rect_periodic",
                                  "rect_bounded_xy", "latlon_value_bc"])
def test_split_explicit_substeps_conserve_volume(kind):
    """∂τη = −∇·U in flux form over a basin that is closed (walls, where
    the normal transport is zero) or periodic: Σ Az η is the same for the
    time-filtered η̅ as for η⁰, to fp64 round-off. η boundary values
    enter only the pressure gradient, never the volume."""
    grid, eta_bcs = _split_explicit_case(kind)
    keys = jax.random.split(jax.random.PRNGKey(3), 5)
    shp = grid.total_shape[:2] + (1,)
    eta0, U0, V0 = (s * jax.random.normal(k, shp, jnp.float64)
                    for s, k in zip((0.1, 1.0, 1.0), keys[:3]))
    GU, GV = (1e-3 * jax.random.normal(k, shp, jnp.float64) for k in keys[3:])
    fs = SplitExplicitFreeSurface(substeps=12)
    eta, U, V = jax.jit(lambda *a: fs.substep_eta(grid, eta_bcs, *a))(
        eta0, GU, GV, U0, V0, jnp.float64(50.0))
    sl = np.s_[grid.Hx:grid.Hx + grid.Nx, grid.Hy:grid.Hy + grid.Ny, 0]
    az = np.broadcast_to(np.asarray(grid.Az(CENTER))[..., 0], shp[:2])[sl[:2]]
    vol0 = float((az * np.asarray(eta0)[sl]).sum())
    vol = float((az * np.asarray(eta)[sl]).sum())
    scale = float((az * np.abs(np.asarray(eta0)[sl])).sum())
    assert abs(vol - vol0) <= 1e-12 * scale, (vol, vol0, scale)
    assert np.all(np.isfinite(np.asarray(U))) and np.all(np.isfinite(np.asarray(V)))


def _latlon_step(scheme, dtype, steps=2):
    grid = LatitudeLongitudeGrid(size=(32, 16, 6), longitude=(0, 360),
                                 latitude=(-60, 60), z=(-1000.0, 0.0),
                                 dtype=dtype)
    model = HydrostaticFreeSurfaceModel(
        grid, momentum_advection=VectorInvariant(scheme=scheme),
        tracer_advection=WENO5(), tracers=("T",),
        free_surface=SplitExplicitFreeSurface(substeps=10),
        coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer())
    rng = np.random.default_rng(5)
    shape = model.grid.shape
    init = {k: jnp.asarray(s * rng.standard_normal(shape).astype(np.float32), dtype)
            for k, s in (("u", 0.1), ("v", 0.1), ("T", 1.0))}
    state = model.initial_state(
        b=lambda lam, phi, z: 2e-5 * (z + 1000.0) / 1000.0, **init)
    step = jax.jit(model.step)
    for _ in range(steps):
        state = step(state, jnp.asarray(300.0, dtype))
    g = model.grid
    out = {k: np.asarray(g.interior(v), np.float64)
           for k, v in state["solution"].items()}
    out["eta"] = np.asarray(state["eta"], np.float64)[
        g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    return out


@pytest.mark.parametrize("scheme", ["enstrophy", "energy", "weno",
                                    "weno_velocity"])
def test_vector_invariant_latlon_step_f32_matches_f64(scheme):
    """Two lat-lon steps (curvilinear metrics, spherical Coriolis,
    split-explicit η): the fp32 run stays within fp32 round-off, carried
    through 2×10 barotropic substeps, of the fp64 run."""
    f64 = _latlon_step(scheme, jnp.float64)
    f32 = _latlon_step(scheme, jnp.float32)
    for k, ref in f64.items():
        assert np.all(np.isfinite(f32[k])), k
        scale = np.abs(ref).max()
        np.testing.assert_allclose(f32[k], ref, rtol=0, atol=1e-4 * scale,
                                   err_msg=f"{k} ({scheme})")
