"""Immersed-boundary depth (VERDICT round-2 item 8): ImmersedGrid
wrapper, conditional near-solid advective fluxes, diffusive-flux zeroing
at immersed faces, immersed-aware reductions, PartialCellBottom
(reference: ImmersedBoundaries.jl, conditional_fluxes.jl,
immersed_reductions.jl, partial_cell_immersed_boundaries.jl)."""
import jax
import jax.numpy as jnp
import numpy as np

from clima_oceananigans_jl_tpu import (
    BOUNDED, PERIODIC, RectilinearGrid, WENO5, CENTER)
from clima_oceananigans_jl_tpu.immersed.immersed import (
    GridFittedBottom, ImmersedGrid, PartialCellBottom)
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
from clima_oceananigans_jl_tpu.models.hydrostatic import (
    HydrostaticFreeSurfaceModel as HydrostaticModel)
from clima_oceananigans_jl_tpu.utils.location import C, F


def _seamount(x, y):
    return -1.0 + 0.6 * jnp.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / 0.02)


def _bottom_model(**kw):
    g = RectilinearGrid(size=(16, 16, 16), x=(0, 1), y=(0, 1), z=(-1, 0),
                        topology=(PERIODIC, PERIODIC, BOUNDED),
                        dtype=jnp.float64)
    return NonhydrostaticModel(g, immersed_boundary=GridFittedBottom(_seamount),
                               **kw)


def test_immersed_grid_forwards_and_masks():
    model = _bottom_model(tracers=("c",))
    g = model.grid
    assert isinstance(g, ImmersedGrid)
    assert g.shape == (16, 16, 16) and g.topology[2] is BOUNDED
    assert g.all_regular and not g.curvilinear
    ib = g.immersed
    # corner-location mask: (F,F,C) is the OR of 4 adjacent centers
    m_ffc = np.asarray(ib.mask_for((F, F, C)))
    s = np.asarray(ib.solid_ccc)
    expect = s | np.roll(s, 1, 0) | np.roll(s, 1, 1) | np.roll(np.roll(s, 1, 0), 1, 1)
    assert (m_ffc == expect).all()


def test_conditional_advection_conserves_fluid_tracer():
    model = _bottom_model(advection=WENO5(), tracer_advection=WENO5(),
                          tracers=("c",))
    g = model.grid
    x, y, z = g.nodes(CENTER, with_halo=True)
    c0 = jnp.exp(-((x - 0.3) ** 2 + (y - 0.5) ** 2) / 0.02) * jnp.ones_like(z)
    u0 = 0.1 * jnp.ones(g.total_shape, g.dtype)
    state = model.initial_state(u=u0, c=c0)
    fluid_w = jnp.where(g.immersed.solid_ccc, 0.0, 1.0) * g.V(CENTER)
    total = lambda s: float(jnp.sum(g.interior(s["solution"]["c"] * fluid_w)))
    t0 = total(state)
    step = jax.jit(model.step)
    for _ in range(10):
        state = step(state, 1e-3)
    c = np.asarray(g.interior(state["solution"]["c"]))
    assert np.isfinite(c).all()
    assert abs(total(state) - t0) < 1e-9 * abs(t0)
    # masked-zero solid values must not leak through high-order stencils:
    # overshoot stays modest (pure WENO near a wall of zeros would ring)
    assert c.min() > -1e-3 and c.max() < 1.2


def test_diffusive_flux_zeroed_at_solid_faces():
    """A tracer uniform in the fluid must stay exactly uniform under pure
    diffusion — solid cells (masked to 0) must not act as Dirichlet-0."""
    from clima_oceananigans_jl_tpu.closures.scalar_diffusivity import (
        ScalarDiffusivity)
    model = _bottom_model(closure=ScalarDiffusivity(nu=1e-2, kappa=1e-2),
                          tracers=("c",))
    g = model.grid
    state = model.initial_state(c=1.0)
    step = jax.jit(model.step)
    for _ in range(5):
        state = step(state, 1e-3)
    c = np.asarray(g.interior(state["solution"]["c"]))
    fluid = ~np.asarray(g.interior(g.immersed.solid_ccc))
    np.testing.assert_allclose(c[fluid], 1.0, atol=1e-12)


def test_immersed_reductions_exclude_solid():
    from clima_oceananigans_jl_tpu.fields.field import (
        CenterField, average, integral, set_field)
    model = _bottom_model()
    g = model.grid
    f = set_field(CenterField(g), g, 2.5)
    avg = float(average(f, g))
    np.testing.assert_allclose(avg, 2.5, rtol=1e-12)
    vol = float(integral(set_field(CenterField(g), g, 1.0), g))
    fluid_v = float(jnp.sum(g.interior(
        jnp.where(g.immersed.solid_ccc, 0.0, 1.0)
        * jnp.broadcast_to(g.V(CENTER), g.total_shape))))
    np.testing.assert_allclose(vol, fluid_v, rtol=1e-12)
    assert vol < 1.0  # strictly less than the full box: solid excluded


def test_partial_cell_bottom_metrics_and_model():
    n = 16
    g = RectilinearGrid(size=(n, 4, 8), x=(0, 1), y=(0, 1), z=(-1, 0),
                        topology=(PERIODIC, PERIODIC, BOUNDED),
                        dtype=jnp.float64)
    bottom = lambda x, y: -1.0 + 0.45 * (x - x + 1) * jnp.sin(jnp.pi * x) ** 2
    model = HydrostaticModel(g, immersed_boundary=PartialCellBottom(bottom),
                             tracers=("c",))
    ig = model.grid
    assert isinstance(ig, ImmersedGrid)
    ib = ig.immersed
    # fluid column heights match the analytic depth (partial bottom cell)
    dz3 = np.asarray(ig.dz(CENTER) * jnp.where(ib.solid_ccc, 0.0, 1.0))
    Hz, Nz = ig.Hz, ig.Nz
    col = dz3[:, :, Hz:Hz + Nz].sum(-1)
    x, y, _ = ig.nodes(CENTER, with_halo=True)
    depth = np.broadcast_to(np.asarray(-bottom(x, y))[:, :, 0], col.shape)
    interior = (slice(ig.Hx, ig.Hx + ig.Nx), slice(ig.Hy, ig.Hy + ig.Ny))
    # exact wherever the sliver exceeds the minimum fraction (dz=0.125,
    # min sliver 0.025)
    err = np.abs(col[interior] - depth[interior])
    assert np.median(err) < 0.025 + 1e-12
    assert (col[interior] > 0).all()
    # the model runs and stays finite with the 3D vertical metrics
    state = model.initial_state(c=1.0)
    step = jax.jit(model.step)
    for _ in range(3):
        state = step(state, 10.0)
    for name, arr in state["solution"].items():
        assert np.isfinite(np.asarray(arr)).all(), name


def test_hydrostatic_immersed_runs_and_conserves():
    g = RectilinearGrid(size=(16, 16, 8), x=(0, 1e5), y=(0, 1e5), z=(-1e3, 0),
                        topology=(PERIODIC, PERIODIC, BOUNDED),
                        dtype=jnp.float64)
    ridge = lambda x, y: -1e3 + 400.0 * jnp.exp(-((x - 5e4) ** 2) / (1e4) ** 2)
    from clima_oceananigans_jl_tpu.advection.schemes import CenteredSecondOrder
    model = HydrostaticModel(g, immersed_boundary=GridFittedBottom(ridge),
                             tracers=("c",), tracer_advection=WENO5())
    x, y, z = model.grid.nodes(CENTER, with_halo=True)
    state = model.initial_state(
        u=0.1 * jnp.ones(model.grid.total_shape, model.grid.dtype),
        c=jnp.exp(-((x - 3e4) ** 2) / (1e4) ** 2) * jnp.ones_like(y + z))
    ig = model.grid
    fluid_w = jnp.where(ig.immersed.solid_ccc, 0.0, 1.0) * ig.V(CENTER)
    total = lambda s: float(jnp.sum(ig.interior(s["solution"]["c"] * fluid_w)))
    t0 = total(state)
    step = jax.jit(model.step)
    for _ in range(5):
        state = step(state, 50.0)
    assert np.isfinite(np.asarray(ig.interior(state["solution"]["c"]))).all()
    # the linear free surface exchanges tracer through z=0 (w_top ≠ 0
    # where the ridge blocks the flow), so the interior budget closes
    # only to O(η/H); strict conservation is covered by the
    # nonhydrostatic test above
    assert abs(total(state) - t0) < 1e-3 * abs(t0)


def test_implicit_free_surface_sees_immersed_depth():
    """The implicit free-surface operator uses the TRUE fluid column
    depth over bathymetry (column_depths is immersed-aware): a gravity
    wave crossing a ridge agrees with the explicit free surface stepped
    at the same small dt, and the wave slows over the ridge."""
    from clima_oceananigans_jl_tpu.models.free_surface import (
        ExplicitFreeSurface, ImplicitFreeSurface)
    from clima_oceananigans_jl_tpu import PERIODIC, FLAT, BOUNDED

    L, H = 1e5, 100.0
    ridge = lambda x, y: -H + 60.0 * jnp.exp(-((x - L / 2) / 8e3) ** 2)
    g = RectilinearGrid(size=(64, 1, 8), x=(0, L), y=(0, 1), z=(-H, 0),
                        topology=(PERIODIC, FLAT, BOUNDED), dtype=jnp.float64)

    def run(fs):
        model = HydrostaticModel(g, free_surface=fs, momentum_advection=None,
                                 immersed_boundary=GridFittedBottom(ridge))
        state = model.initial_state(
            eta=lambda x, y: 0.01 * jnp.exp(-((x - L / 4) / 6e3) ** 2))
        step = jax.jit(model.step)
        dt = jnp.float64(10.0)  # explicit-stable: c·dt/dx ≈ 0.2
        for _ in range(60):
            state = step(state, dt)
        gi = model.grid
        return np.asarray(state["eta"])[gi.Hx:gi.Hx + gi.Nx, gi.Hy, 0]

    eta_exp = run(ExplicitFreeSurface())
    eta_imp = run(ImplicitFreeSurface(solver_method="auto", tolerance=1e-12,
                                      maxiter=600))
    assert np.isfinite(eta_imp).all() and np.isfinite(eta_exp).all()
    # the implicit θ-scheme damps slightly but must track the explicit
    # phase — which it only does if the implicit operator carries the
    # IMMERSED column depth (with full H the ridge-crossing speed is
    # wrong by √(H/(H−60)) ≈ 1.6 and the fields decorrelate)
    corr = np.corrcoef(eta_imp, eta_exp)[0, 1]
    assert corr > 0.99, corr
    assert np.argmax(np.abs(eta_imp)) == np.argmax(np.abs(eta_exp))
    amp = np.abs(eta_imp).max() / np.abs(eta_exp).max()
    assert 0.85 < amp < 1.05, amp


def test_immersed_boundary_condition_flux_budget():
    """FieldBCs(immersed=FluxBC(q)) injects q through the immersed bottom
    faces (reference immersed_boundary_condition.jl per-face fluxes):
    the tracer budget gains exactly q·A_bottom·t."""
    from clima_oceananigans_jl_tpu import FieldBCs, FluxBC, CENTER

    Lx, Ly, H = 2.0, 3.0, 1.0
    g = RectilinearGrid(size=(8, 8, 16), x=(0, Lx), y=(0, Ly), z=(-H, 0),
                        topology=(PERIODIC, PERIODIC, BOUNDED),
                        dtype=jnp.float64)
    q = 0.7
    model = NonhydrostaticModel(
        g, tracers=("c",), advection=None,
        immersed_boundary=GridFittedBottom(-0.5),  # flat bottom mid-depth
        boundary_conditions={"c": FieldBCs(immersed=FluxBC(q))})
    gi = model.grid
    state = model.initial_state(c=1.0)
    dt, n = jnp.float64(1e-2), 40
    step = jax.jit(model.step)
    for _ in range(n):
        state = step(state, dt)
    vol = np.asarray(jnp.broadcast_to(gi.V(CENTER), gi.total_shape))
    fluid = ~np.asarray(gi.immersed.solid_ccc)
    sl = tuple(slice(h, h + s) for h, s in zip(gi.halo, gi.shape))
    total = (np.asarray(state["solution"]["c"]) * vol * fluid)[sl].sum()
    total0 = 1.0 * Lx * Ly * 0.5          # fluid half-domain
    expected = total0 + q * Lx * Ly * n * float(dt)
    assert np.isclose(total, expected, rtol=1e-12), (total, expected)


def test_discrete_form_immersed_bottom_drag():
    """FluxBC(fn, discrete=True): field-dependent flux through the
    immersed bottom — linear bottom drag q = −r·u decays the
    bottom-adjacent cell's momentum at exactly r/Δz (reference
    discrete_form boundary functions + ImmersedBoundaryCondition)."""
    from clima_oceananigans_jl_tpu import FieldBCs, FluxBC

    H, r = 1.0, 0.05
    g = RectilinearGrid(size=(4, 4, 16), x=(0, 1), y=(0, 1), z=(-H, 0),
                        topology=(PERIODIC, PERIODIC, BOUNDED),
                        dtype=jnp.float64)
    drag = lambda grid, t, fields: -r * fields["u"]
    model = NonhydrostaticModel(
        g, advection=None, coriolis=None,
        immersed_boundary=GridFittedBottom(-0.5),
        boundary_conditions={"u": FieldBCs(immersed=FluxBC(drag,
                                                           discrete=True))})
    gi = model.grid
    state = model.initial_state(u=0.3)
    dz = H / 16
    dt, n = jnp.float64(1e-2), 100
    step = jax.jit(model.step)
    for _ in range(n):
        state = step(state, dt)
    u = np.asarray(gi.interior(state["solution"]["u"])).mean((0, 1))
    # the bottom fluid cell (k=8) decays ~exp(−r t/Δz); cells above are
    # untouched (no viscosity)
    t = n * float(dt)
    assert abs(u[8] - 0.3 * np.exp(-r * t / dz)) < 0.01, u[8]
    assert np.allclose(u[9:], 0.3, atol=1e-12)
    assert np.allclose(u[:8], 0.0, atol=1e-12)  # solid cells masked
