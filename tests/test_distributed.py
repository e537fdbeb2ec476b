"""Distributed (shard_map + ppermute) tests
(model: /root/reference/test/test_distributed_models.jl — rank-id halo
correctness over (4,1),(1,4),(2,2) meshes — and 1-vs-N-device equality;
runs on the virtual 8-device CPU mesh, see conftest.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

import functools
try:
    from jax import shard_map as _shard_map
    shard_map = functools.partial(_shard_map, check_vma=False)
except ImportError:
    from jax.experimental.shard_map import shard_map as _shard_map
    shard_map = functools.partial(_shard_map, check_rep=False)

from clima_oceananigans_jl_tpu import (
    BOUNDED, FLAT, PERIODIC, RectilinearGrid, WENO5, ScalarDiffusivity, CENTER,
)
from clima_oceananigans_jl_tpu.boundary_conditions.bcs import fill_halos, regularize_bcs
from clima_oceananigans_jl_tpu.parallel.decomposition import (
    gather_array, partition_grid, scatter_array,
)
from clima_oceananigans_jl_tpu.parallel.distributed import DistributedModel, make_mesh
from clima_oceananigans_jl_tpu.models.shallow_water import ShallowWaterModel
from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from clima_oceananigans_jl_tpu.models.free_surface import ImplicitFreeSurface
from clima_oceananigans_jl_tpu.coriolis.coriolis import FPlane


needs8 = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


@needs8
@pytest.mark.parametrize("mesh_shape", [(4, 1), (1, 4), (2, 2), (2, 4)])
@pytest.mark.parametrize("topo_x", [PERIODIC, BOUNDED])
def test_rank_id_halo_exchange(mesh_shape, topo_x):
    """Fill each shard's interior with its rank id, exchange, check halos
    (the reference's core distributed test, test_distributed_models.jl:40-120)."""
    Rx, Ry = mesh_shape
    grid = RectilinearGrid(size=(8 * Rx, 8 * Ry, 2), extent=(1.0, 1.0, 1.0),
                           topology=(topo_x, PERIODIC, BOUNDED),
                           dtype=jnp.float64)
    mesh = make_mesh(mesh_shape)
    stacked, specs, local = partition_grid(grid, mesh_shape)
    bcs = regularize_bcs(local, CENTER)

    def f(g, _):
        i, j = lax.axis_index("x"), lax.axis_index("y")
        rank = (i * Ry + j).astype(jnp.float64)
        data = jnp.zeros(local.total_shape, jnp.float64)
        sl = tuple(slice(h, h + n) for h, n in zip(local.halo, local.shape))
        data = data.at[sl].set(rank)
        return fill_halos(data, g, CENTER, bcs)

    dummy = jax.device_put(jnp.zeros((), jnp.float64))
    out = jax.jit(shard_map(f, mesh=mesh, in_specs=(specs, P()),
                            out_specs=P("x", "y")))(stacked, dummy)
    out = np.asarray(out)
    lx, ly = local.total_shape[0], local.total_shape[1]
    Hx, Hy = local.Hx, local.Hy
    for i in range(Rx):
        for j in range(Ry):
            blk = out[i * lx:(i + 1) * lx, j * ly:(j + 1) * ly]
            rank = i * Ry + j
            # interior is my rank
            assert np.all(blk[Hx:-Hx or None, Hy:-Hy or None] == rank)
            # west halo ← west neighbor's rank (wrap if periodic)
            if Rx > 1:
                if i > 0:
                    assert np.all(blk[:Hx, Hy:-Hy, 0] == (i - 1) * Ry + j), (i, j)
                elif topo_x is PERIODIC:
                    assert np.all(blk[:Hx, Hy:-Hy, 0] == (Rx - 1) * Ry + j)
                else:  # bounded: zero-gradient fill of own rank
                    assert np.all(blk[:Hx, Hy:-Hy, 0] == rank)
                if i < Rx - 1:
                    assert np.all(blk[-Hx:, Hy:-Hy, 0] == (i + 1) * Ry + j)
            # south halo ← south neighbor (y periodic globally)
            if Ry > 1:
                jm = (j - 1) % Ry
                assert np.all(blk[Hx:-Hx, :Hy, 0] == i * Ry + jm)


def _bickley_state(model):
    def u0(x, y, z):
        return 1.0 / jnp.cosh(y) ** 2 + 1e-4 * jnp.sin(2 * x) * jnp.exp(-y * y)
    return model.initial_state(uh=u0, vh=lambda x, y, z: 1e-4 * jnp.cos(3 * x)
                               * jnp.exp(-y * y), h=1.0)


@needs8
def test_distributed_shallow_water_matches_single_device():
    grid = RectilinearGrid(size=(32, 32, 1), x=(0, 4 * np.pi), y=(-4.0, 4.0),
                           topology=(PERIODIC, BOUNDED, FLAT), dtype=jnp.float64)
    model = ShallowWaterModel(grid=grid, gravitational_acceleration=10.0,
                              advection=WENO5(), coriolis=FPlane(f=1.0))
    state0 = _bickley_state(model)
    dt = jnp.float64(1e-3)

    step = jax.jit(model.step)
    s_single = state0
    for _ in range(10):
        s_single = step(s_single, dt)

    mesh = make_mesh((2, 4))
    dmodel = DistributedModel(model, mesh)
    s_dist = dmodel.scatter_state(state0)
    for _ in range(10):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    for name in ("uh", "vh", "h"):
        a = np.asarray(model.grid.interior(s_single["solution"][name]))
        b = np.asarray(model.grid.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-12), name


@needs8
def test_distributed_hydrostatic_matches_single_device():
    grid = RectilinearGrid(size=(16, 16, 4), x=(0, 1e5), y=(0, 1e5), z=(-100.0, 0),
                           topology=(PERIODIC, BOUNDED, BOUNDED), dtype=jnp.float64)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=ImplicitFreeSurface(solver_method="pcg",
                                                    tolerance=1e-13, maxiter=400),
        coriolis=FPlane(f=1e-4),
        closure=ScalarDiffusivity(nu=10.0, nu_z=1e-3))
    state0 = model.initial_state(
        eta=lambda x, y: 0.01 * jnp.sin(2 * jnp.pi * x / 1e5)
        * jnp.sin(jnp.pi * y / 1e5),
        u=lambda x, y, z: 0.01 * jnp.cos(2 * jnp.pi * y / 1e5))
    dt = jnp.float64(50.0)

    step = jax.jit(model.step)
    s_single = state0
    for _ in range(5):
        s_single = step(s_single, dt)

    mesh = make_mesh((2, 2))
    dmodel = DistributedModel(model, mesh)
    s_dist = dmodel.scatter_state(state0)
    for _ in range(5):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    for name in ("u", "v"):
        a = np.asarray(model.grid.interior(s_single["solution"][name]))
        b = np.asarray(model.grid.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-10), name
    g = model.grid
    a = np.asarray(s_single["eta"])[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    b = np.asarray(s_dist["eta"])[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    assert np.allclose(a, b, atol=1e-10)


@needs8
def test_scatter_gather_roundtrip():
    grid = RectilinearGrid(size=(16, 8, 4), extent=(1, 1, 1),
                           topology=(PERIODIC, PERIODIC, BOUNDED), dtype=jnp.float64)
    arr = jax.random.normal(jax.random.PRNGKey(0), grid.total_shape)
    arr = fill_halos(arr, grid, CENTER, regularize_bcs(grid, CENTER))
    st = scatter_array(arr, grid, (2, 4))
    back = gather_array(st, grid, (2, 4))
    assert np.allclose(np.asarray(back), np.asarray(arr))


@needs8
def test_distributed_nonhydrostatic_fft_matches_single_device():
    """Distributed pencil-FFT projection vs serial FFT (reference
    test_distributed_poisson_solvers.jl divergence-free equivalence)."""
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
    from clima_oceananigans_jl_tpu.ops import operators as op

    grid = RectilinearGrid(size=(16, 16, 8), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, PERIODIC),
                           dtype=jnp.float64)
    model = NonhydrostaticModel(grid, tracers=("c",))
    key = jax.random.PRNGKey(1)
    ku, kv, kc = jax.random.split(key, 3)
    state0 = model.initial_state(
        u=1e-2 * jax.random.normal(ku, grid.shape, jnp.float64),
        v=1e-2 * jax.random.normal(kv, grid.shape, jnp.float64),
        c=jax.random.normal(kc, grid.shape, jnp.float64))
    dt = jnp.float64(1e-3)

    step = jax.jit(model.step)
    s_single = state0
    for _ in range(3):
        s_single = step(s_single, dt)

    mesh = make_mesh((2, 2))
    dmodel = DistributedModel(model, mesh)
    s_dist = dmodel.scatter_state(state0)
    for _ in range(3):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    for name in ("u", "v", "w", "c"):
        a = np.asarray(model.grid.interior(s_single["solution"][name]))
        b = np.asarray(model.grid.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-10), name

    # corrected velocity field is discretely divergence-free
    sol = s_dist["solution"]
    div = op.div_ccc(sol["u"], sol["v"], sol["w"], model.grid)
    assert float(jnp.abs(model.grid.interior(div)).max()) < 1e-8


@needs8
def test_distributed_fourier_tridiagonal_matches_single_device():
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel

    z_faces = -np.cos(np.linspace(0, np.pi / 2, 9))  # stretched z
    grid = RectilinearGrid(size=(16, 16, 8), x=(0, 1.0), y=(0, 1.0), z=z_faces,
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=jnp.float64)
    model = NonhydrostaticModel(grid)
    key = jax.random.PRNGKey(2)
    ku, kv = jax.random.split(key)
    state0 = model.initial_state(
        u=1e-2 * jax.random.normal(ku, grid.shape, jnp.float64),
        v=1e-2 * jax.random.normal(kv, grid.shape, jnp.float64))
    dt = jnp.float64(1e-3)

    step = jax.jit(model.step)
    s_single = state0
    for _ in range(3):
        s_single = step(s_single, dt)

    mesh = make_mesh((2, 2))
    dmodel = DistributedModel(model, mesh)
    s_dist = dmodel.scatter_state(state0)
    for _ in range(3):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    for name in ("u", "v", "w"):
        a = np.asarray(model.grid.interior(s_single["solution"][name]))
        b = np.asarray(model.grid.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-9), name


@needs8
def test_overlap_halo_step_matches_single_device():
    """The interior/edge-split step (overlap_halo=True: ppermutes issued
    with no dependency on the bulk tendency pass, edge strips recomputed
    and patched — the reference's halo_communication.jl:68-86 nonblocking
    overlap pattern) must be numerically identical to the plain step."""
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer

    grid = RectilinearGrid(size=(16, 16, 8), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=jnp.float64)
    model = NonhydrostaticModel(grid, advection=WENO5(), tracers=("c",),
                                buoyancy=BuoyancyTracer(),
                                coriolis=FPlane(f=1e-4),
                                closure=ScalarDiffusivity(nu=1e-3, kappa=1e-3))
    key = jax.random.PRNGKey(3)
    ku, kv, kb, kc = jax.random.split(key, 4)
    state0 = model.initial_state(
        u=1e-2 * jax.random.normal(ku, grid.shape, jnp.float64),
        v=1e-2 * jax.random.normal(kv, grid.shape, jnp.float64),
        b=1e-3 * jax.random.normal(kb, grid.shape, jnp.float64),
        c=jax.random.normal(kc, grid.shape, jnp.float64))
    dt = jnp.float64(5e-4)

    step = jax.jit(model.step)
    s_single = state0
    for _ in range(3):
        s_single = step(s_single, dt)

    mesh = make_mesh((2, 2))
    dmodel = DistributedModel(model, mesh, overlap_halo=True)
    s_dist = dmodel.scatter_state(state0)
    for _ in range(3):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    for name in ("u", "v", "w", "b", "c"):
        a = np.asarray(model.grid.interior(s_single["solution"][name]))
        b = np.asarray(model.grid.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-10), name


@needs8
def test_overlap_halo_rk3_matches_single_device():
    """overlap_halo with the RK3 stepper (every stage runs the
    interior/edge split)."""
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer

    grid = RectilinearGrid(size=(16, 16, 8), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, PERIODIC),
                           dtype=jnp.float64)
    model = NonhydrostaticModel(grid, advection=WENO5(), tracers=("c",),
                                timestepper="RungeKutta3")
    key = jax.random.PRNGKey(7)
    ku, kc = jax.random.split(key)
    state0 = model.initial_state(
        u=1e-2 * jax.random.normal(ku, grid.shape, jnp.float64),
        c=jax.random.normal(kc, grid.shape, jnp.float64))
    dt = jnp.float64(5e-4)

    step = jax.jit(model.step)
    s_single = state0
    for _ in range(2):
        s_single = step(s_single, dt)

    mesh = make_mesh((2, 2))
    dmodel = DistributedModel(model, mesh, overlap_halo=True)
    s_dist = dmodel.scatter_state(state0)
    for _ in range(2):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    for name in ("u", "v", "w", "c"):
        a = np.asarray(model.grid.interior(s_single["solution"][name]))
        b = np.asarray(model.grid.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-10), name


@needs8
def test_distributed_split_explicit_matches_single_device():
    """The flagship near-global configuration's free surface: every
    barotropic substep's 2D halo fill rides the same ppermute exchange
    (reference distributed split-explicit kernels)."""
    from clima_oceananigans_jl_tpu.models.free_surface import (
        SplitExplicitFreeSurface)

    grid = RectilinearGrid(size=(16, 16, 4), x=(0, 1e5), y=(0, 1e5),
                           z=(-100.0, 0),
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=jnp.float64)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=SplitExplicitFreeSurface(substeps=20),
        coriolis=FPlane(f=1e-4), closure=ScalarDiffusivity(nu=10.0, nu_z=1e-3))
    state0 = model.initial_state(
        eta=lambda x, y: 0.01 * jnp.sin(2 * jnp.pi * x / 1e5),
        u=lambda x, y, z: 0.01 * jnp.cos(2 * jnp.pi * y / 1e5))
    dt = jnp.float64(50.0)

    step = jax.jit(model.step)
    s_single = state0
    for _ in range(5):
        s_single = step(s_single, dt)

    mesh = make_mesh((2, 2))
    dmodel = DistributedModel(model, mesh)
    s_dist = dmodel.scatter_state(state0)
    for _ in range(5):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    g = model.grid
    for name in ("u", "v"):
        a = np.asarray(g.interior(s_single["solution"][name]))
        b = np.asarray(g.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-12), name
    a = np.asarray(s_single["eta"])[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    b = np.asarray(s_dist["eta"])[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    assert np.allclose(a, b, atol=1e-12)


@needs8
def test_distributed_immersed_matches_single_device():
    """Immersed (GridFittedBottom) grids partition with per-shard solid
    masks (the reference's distributed immersed grids carry per-rank
    bathymetry); the sharded step is bit-exact vs single device."""
    from clima_oceananigans_jl_tpu import GridFittedBottom
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel

    grid = RectilinearGrid(size=(16, 16, 8), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=jnp.float64)
    bump = lambda x, y: -1.0 + 0.4 * jnp.exp(
        -((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)
    model = NonhydrostaticModel(grid, tracers=("c",),
                                immersed_boundary=GridFittedBottom(bump))
    state0 = model.initial_state(
        u=1e-2, c=lambda x, y, z: jnp.exp(-((x - 0.3) ** 2
                                            + (z + 0.5) ** 2) / 0.05))
    dt = jnp.float64(1e-3)
    step = jax.jit(model.step)
    s_single = state0
    for _ in range(3):
        s_single = step(s_single, dt)

    mesh = make_mesh((2, 2))
    dmodel = DistributedModel(model, mesh)
    s_dist = dmodel.scatter_state(state0)
    for _ in range(3):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    for name in ("u", "v", "w", "c"):
        a = np.asarray(model.grid.interior(s_single["solution"][name]))
        b = np.asarray(model.grid.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-12), name


@needs8
def test_overlap_halo_immersed_background_matches_single_device():
    """overlap_halo with an immersed bottom AND background fields: the
    edge strips slice the shard-local solid masks through
    ImmersedGrid.subgrid_along, masking stays pointwise-local, and
    background cross terms get the same bulk/strip treatment (closes the
    reference's nonblocking exchange over immersed grids,
    halo_communication.jl:68-86)."""
    from clima_oceananigans_jl_tpu import GridFittedBottom
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel

    grid = RectilinearGrid(size=(16, 16, 8), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=jnp.float64)
    bump = lambda x, y: -1.0 + 0.4 * jnp.exp(
        -((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)
    model = NonhydrostaticModel(
        grid, tracers=("c",), immersed_boundary=GridFittedBottom(bump),
        background_fields={"u": lambda x, y, z, t: 0.05 * jnp.cos(
            2 * jnp.pi * y)})
    state0 = model.initial_state(
        u=1e-2, c=lambda x, y, z: jnp.exp(-((x - 0.3) ** 2
                                            + (z + 0.5) ** 2) / 0.05))
    dt = jnp.float64(1e-3)
    step = jax.jit(model.step)
    s_single = state0
    for _ in range(3):
        s_single = step(s_single, dt)

    mesh = make_mesh((2, 2))
    dmodel = DistributedModel(model, mesh, overlap_halo=True)
    s_dist = dmodel.scatter_state(state0)
    for _ in range(3):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    for name in ("u", "v", "w", "c"):
        a = np.asarray(model.grid.interior(s_single["solution"][name]))
        b = np.asarray(model.grid.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-12), name


@needs8
def test_overlap_halo_near_global_flagship():
    """The flagship near-global stack (lat-lon grid, immersed bathymetry,
    split-explicit free surface, spherical Coriolis, wind stress,
    implicit vertical diffusion) with overlap_halo=True — VERDICT r2
    item 4's done-criterion: the comm/compute-overlapped step accepts the
    near-global config and stays bit-exact vs the single-device step."""
    from clima_oceananigans_jl_tpu import FluxBC, GridFittedBottom, ScalarDiffusivity
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid
    from clima_oceananigans_jl_tpu.models.free_surface import (
        SplitExplicitFreeSurface)
    from clima_oceananigans_jl_tpu.coriolis.coriolis import (
        HydrostaticSphericalCoriolis)
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
    from clima_oceananigans_jl_tpu.boundary_conditions.bcs import FieldBCs

    grid = LatitudeLongitudeGrid(size=(48, 24, 8), longitude=(0, 360),
                                 latitude=(-60, 60), z=(-3000.0, 0.0),
                                 dtype=jnp.float64)
    bathy = lambda lam, phi: jnp.where(
        (lam > 170) & (lam < 190), 100.0,
        -3000.0 + 800.0 * jnp.exp(-((lam - 60) / 15.0) ** 2))
    wind = lambda lam, phi, t: -1e-4 * jnp.cos(3.0 * jnp.pi * phi / 180.0)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=SplitExplicitFreeSurface(substeps=12),
        coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer(),
        closure=ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                                  time_discretization="vertically_implicit"),
        immersed_boundary=GridFittedBottom(bathy),
        boundary_conditions={"u": FieldBCs(top=FluxBC(wind))})
    state0 = model.initial_state(
        b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    dt = jnp.float64(600.0)

    step = jax.jit(model.step)
    s_single = state0
    for _ in range(3):
        s_single = step(s_single, dt)

    dmodel = DistributedModel(model, make_mesh((2, 2)), overlap_halo=True)
    s_dist = dmodel.scatter_state(state0)
    for _ in range(3):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    g = model.grid
    for name in ("u", "v", "b"):
        a = np.asarray(g.interior(s_single["solution"][name]))
        b = np.asarray(g.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-13), name
    a = np.asarray(s_single["eta"])[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    b = np.asarray(s_dist["eta"])[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    assert np.allclose(a, b, atol=1e-13)


@needs8
def test_distributed_near_global_flagship_config():
    """Capstone: the full near-global stack — lat-lon grid, immersed
    bathymetry, split-explicit free surface, spherical Coriolis, wind
    stress, vertically-implicit diffusion — distributed over a (2,2)
    mesh, bit-exact vs single device."""
    from clima_oceananigans_jl_tpu import FluxBC, GridFittedBottom, ScalarDiffusivity
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid
    from clima_oceananigans_jl_tpu.models.free_surface import (
        SplitExplicitFreeSurface)
    from clima_oceananigans_jl_tpu.coriolis.coriolis import (
        HydrostaticSphericalCoriolis)
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
    from clima_oceananigans_jl_tpu.boundary_conditions.bcs import FieldBCs

    grid = LatitudeLongitudeGrid(size=(48, 24, 8), longitude=(0, 360),
                                 latitude=(-60, 60), z=(-3000.0, 0.0),
                                 dtype=jnp.float64)
    bathy = lambda lam, phi: jnp.where(
        (lam > 170) & (lam < 190), 100.0,
        -3000.0 + 800.0 * jnp.exp(-((lam - 60) / 15.0) ** 2))
    wind = lambda lam, phi, t: -1e-4 * jnp.cos(3.0 * jnp.pi * phi / 180.0)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, free_surface=SplitExplicitFreeSurface(substeps=12),
        coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer(),
        closure=ScalarDiffusivity(nu=1e4, kappa=1e3, nu_z=1e-3, kappa_z=1e-4,
                                  time_discretization="vertically_implicit"),
        immersed_boundary=GridFittedBottom(bathy),
        boundary_conditions={"u": FieldBCs(top=FluxBC(wind))})
    state0 = model.initial_state(
        b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    dt = jnp.float64(600.0)

    step = jax.jit(model.step)
    s_single = state0
    for _ in range(3):
        s_single = step(s_single, dt)

    dmodel = DistributedModel(model, make_mesh((2, 2)))
    s_dist = dmodel.scatter_state(state0)
    for _ in range(3):
        s_dist = dmodel.step(s_dist, dt)
    s_dist = dmodel.gather_state(s_dist)

    g = model.grid
    for name in ("u", "v", "b"):
        a = np.asarray(g.interior(s_single["solution"][name]))
        b = np.asarray(g.interior(s_dist["solution"][name]))
        assert np.allclose(a, b, atol=1e-14), name
    a = np.asarray(s_single["eta"])[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    b = np.asarray(s_dist["eta"])[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    assert np.allclose(a, b, atol=1e-14)


@needs8
def test_distributed_checkpoint_roundtrip(tmp_path):
    """Checkpoint/restore across mesh shapes (VERDICT r3 #10; reference
    checkpointer.jl:9-100 + run.jl:60-91): a checkpoint written under a
    (2,2) mesh restores on ONE device and continues identically, and a
    single-device checkpoint restores under the mesh — both matching an
    uninterrupted 10-step single-device run. Exercises the AB2 history
    (G_prev, previous_dt) through gather/scatter."""
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
    from clima_oceananigans_jl_tpu.output.checkpointer import (
        _flatten_state, restore_state)

    grid = RectilinearGrid(size=(16, 16, 8), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, PERIODIC),
                           dtype=jnp.float64)
    model = NonhydrostaticModel(grid, tracers=("c",))
    key = jax.random.PRNGKey(3)
    ku, kv, kc = jax.random.split(key, 3)
    state0 = model.initial_state(
        u=1e-2 * jax.random.normal(ku, grid.shape, jnp.float64),
        v=1e-2 * jax.random.normal(kv, grid.shape, jnp.float64),
        c=jax.random.normal(kc, grid.shape, jnp.float64))
    dt = jnp.float64(1e-3)
    step = jax.jit(model.step)
    # the model may rebuild the grid with scheme-sized halos; all state
    # arrays (and the gather stitching) use model.grid's halo convention
    mg = model.grid

    # the uninterrupted reference: 10 single-device steps
    s_ref = state0
    for _ in range(10):
        s_ref = step(s_ref, dt)

    mesh = make_mesh((2, 2))
    dmodel = DistributedModel(model, mesh)

    def check(s, atol=1e-10):
        assert int(s["clock"].iteration) == 10
        for name in ("u", "v", "w", "c"):
            a = np.asarray(mg.interior(s_ref["solution"][name]))
            b = np.asarray(mg.interior(s["solution"][name]))
            assert np.allclose(a, b, atol=atol), name
            ga = np.asarray(mg.interior(s_ref["G_prev"][name]))
            gb = np.asarray(mg.interior(s["G_prev"][name]))
            assert np.allclose(ga, gb, atol=atol), f"G_prev[{name}]"

    # -- save under the (2,2) mesh, restore on 1 device ------------------
    s_dist = dmodel.scatter_state(state0)
    for _ in range(5):
        s_dist = dmodel.step(s_dist, dt)
    path = tmp_path / "ckpt_mesh.npz"
    np.savez(path, **_flatten_state(dmodel.gather_state(s_dist)))

    template = step(state0, dt)  # full post-step state structure
    s = restore_state(template, str(path))
    assert float(s["previous_dt"]) == float(dt)
    for _ in range(5):
        s = step(s, dt)
    check(s)

    # -- save on 1 device, restore under the (2,2) mesh ------------------
    s_single = state0
    for _ in range(5):
        s_single = step(s_single, dt)
    path2 = tmp_path / "ckpt_single.npz"
    np.savez(path2, **_flatten_state(s_single))

    s2 = dmodel.scatter_state(restore_state(template, str(path2)))
    for _ in range(5):
        s2 = dmodel.step(s2, dt)
    check(dmodel.gather_state(s2))


def _collective_bytes(hlo_text):
    """(permute_bytes, permute_count, a2a_bytes, a2a_count) per chip per
    step, parsed from compiled HLO. all-to-alls are tuple-typed (one
    operand per destination shard); their bytes sum over tuple elements."""
    import re
    pb = pc = ab = ac = 0
    for m in re.finditer(
            r'= \(?([a-z0-9]+)\[([0-9,]*)\][^=]*?'
            r'(collective-permute|all-to-all)\(', hlo_text):
        dt, dims, op = m.groups()
        size = int(np.prod([int(d) for d in dims.split(',') if d])) if dims \
            else 1
        isz = {"f64": 8, "f32": 4, "c64": 8, "c128": 16}.get(dt, 8)
        if op == "collective-permute":
            pb += size * isz
            pc += 1
    # tuple-typed all-to-alls: count every element of the result tuple
    for m in re.finditer(r'= \(([^)]*)\) all-to-all\(', hlo_text):
        ac += 1
        for t in re.finditer(r'([a-z0-9]+)\[([0-9,]*)\]', m.group(1)):
            dt, dims = t.groups()
            isz = {"f64": 8, "f32": 4, "c64": 8, "c128": 16}.get(dt, 8)
            ab += int(np.prod([int(d) for d in dims.split(',') if d])) * isz
    return pb, pc, ab, ac


@needs8
def test_communication_volume_matches_scaling_model():
    """Regression pin for benchmark/SCALING.md §3's communication
    volumes: the per-device collective volumes of the compiled
    distributed steps must equal the closed-form model — any silent
    growth in exchanged fields or transpose volume fails loudly.

    Shallow water RK3 on a (2,2) mesh: 3 stages × 3 fields × 2 cut axes
    × 2 sides halo permutes, each H × (local+2H) × nz elements.
    Nonhydrostatic AB2: 9 exchanged fields (4 prognostic + 3 projection
    velocity fills + pNHS + pHY′) × 2 axes × 2 sides, plus the pencil-FFT
    transposes moving exactly 2× the per-chip complex rhs."""
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import (
        NonhydrostaticModel)
    from clima_oceananigans_jl_tpu.models.shallow_water import (
        ShallowWaterModel)
    from clima_oceananigans_jl_tpu import FLAT, WENO5
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer

    itemsize = 8  # f64 test suite

    # -- shallow water ----------------------------------------------------
    N = 64
    grid = RectilinearGrid(size=(N, N, 1), extent=(1e6, 1e6),
                           topology=(PERIODIC, PERIODIC, FLAT),
                           dtype=jnp.float64)
    model = ShallowWaterModel(grid=grid, gravitational_acceleration=9.81,
                              advection=WENO5())
    dm = DistributedModel(model, make_mesh((2, 2)))
    s = dm.initial_state(uh=lambda x, y, z: 0.1 * jnp.sin(2 * jnp.pi
                                                          * x / 1e6),
                         h=100.0)
    _ = dm.step(s, 1.0)
    txt = dm._sharded_step.lower(dm.stacked_grid, s,
                                 jnp.float64(1.0)).compile().as_text()
    pb, pc, ab, ac = _collective_bytes(txt)
    H = dm.local_grid.halo[0]
    loc = dm.local_grid.shape[0]
    slab = H * (loc + 2 * H) * 1 * itemsize
    assert pc == 3 * 3 * 2 * 2, pc
    assert pb == pc * slab, (pb, pc * slab)
    assert ac == 0 and ab == 0  # no elliptic solve in shallow water

    # -- nonhydrostatic + pencil-FFT projection ---------------------------
    grid = RectilinearGrid(size=(32, 32, 16), extent=(1., 1., 1.),
                           topology=(PERIODIC, PERIODIC, BOUNDED),
                           dtype=jnp.float64)
    model = NonhydrostaticModel(grid, advection=WENO5(),
                                buoyancy=BuoyancyTracer())
    dm = DistributedModel(model, make_mesh((2, 2)))
    s = dm.initial_state(u=lambda x, y, z: 0.01 * jnp.sin(2 * jnp.pi * x))
    _ = dm.step(s, jnp.float64(1e-3))
    txt = dm._sharded_step.lower(dm.stacked_grid, s,
                                 jnp.float64(1e-3)).compile().as_text()
    pb, pc, ab, ac = _collective_bytes(txt)
    g = dm.local_grid
    n_fields = 9
    assert pc == n_fields * 2 * 2, pc
    slab_x = g.halo[0] * (g.shape[1] + 2 * g.halo[1]) \
        * (g.shape[2] + 2 * g.halo[2]) * itemsize
    slab_y = g.halo[1] * (g.shape[0] + 2 * g.halo[0]) \
        * (g.shape[2] + 2 * g.halo[2]) * itemsize
    assert pb == n_fields * 2 * (slab_x + slab_y), \
        (pb, n_fields * 2 * (slab_x + slab_y))
    # pencil transposes: 8 all-to-alls (z→x pencil, x-fft→y pencil, and
    # back, for forward+inverse), each listing the FULL per-chip pencil
    # volume — 1 real (the rhs) + 7 complex
    vol = (32 * 32 * 16) // 4  # per-chip elements
    expect_ab = vol * (1 * itemsize + 7 * 2 * itemsize)
    assert ac == 8 and ab == expect_ab, (ac, ab, expect_ab)
