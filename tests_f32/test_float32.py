"""float32 tier: advection / Poisson / stepping correctness at the
benchmark dtype with fp32-appropriate tolerances (the f64 suite lives in
tests/; the reference runs its suite in both dtypes)."""
import numpy as np
import jax
import jax.numpy as jnp

from clima_oceananigans_jl_tpu import (
    BOUNDED, FLAT, PERIODIC, RectilinearGrid, Simulation, WENO5,
    CenteredSecondOrder,
)
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
from clima_oceananigans_jl_tpu.models.shallow_water import ShallowWaterModel

DT = jnp.float32


def test_weno_advection_translates_profile_f32():
    """Uniform advection of a smooth tracer across one period returns it
    to the start (WENO5, fp32): L_inf error at the scheme's accuracy."""
    n = 64
    grid = RectilinearGrid(size=(n, 1, 1), x=(0, 1), y=(0, 1),
                           topology=(PERIODIC, FLAT, FLAT), dtype=DT)
    model = NonhydrostaticModel(grid, advection=CenteredSecondOrder(),
                                tracer_advection=WENO5(), tracers=("c",))
    c0 = lambda x, y, z: jnp.sin(2 * jnp.pi * x)
    state = model.initial_state(u=1.0, c=c0)
    dt = 0.25 / n
    steps = int(round(1.0 / dt))
    step = jax.jit(model.step)
    for _ in range(steps):
        state = step(state, jnp.asarray(dt, DT))
    g = model.grid
    c = np.asarray(g.interior(state["solution"]["c"])).ravel()
    x = np.asarray(g.nodes(("c", "c", "c"))[0]).ravel()
    err = np.abs(c - np.sin(2 * np.pi * x)).max()
    # quasi-AB2 temporal error dominates at CFL 0.25 (~1.5% after a full
    # period); the check guards against fp32-specific corruption
    assert err < 2.5e-2, err
    assert state["solution"]["c"].dtype == jnp.float32


def test_fft_poisson_divergence_free_f32():
    """After projection the velocity divergence is ~fp32 roundoff of the
    pre-projection divergence."""
    n = 32
    grid = RectilinearGrid(size=(n, n, n), extent=(1., 1., 1.),
                           topology=(PERIODIC, PERIODIC, BOUNDED), dtype=DT)
    model = NonhydrostaticModel(grid, advection=WENO5(),
                                buoyancy=BuoyancyTracer())
    key = jax.random.PRNGKey(0)
    ku, kv, kw = jax.random.split(key, 3)
    state = model.initial_state(
        u=jax.random.normal(ku, grid.shape, DT),
        v=jax.random.normal(kv, grid.shape, DT),
        w=jax.random.normal(kw, grid.shape, DT))
    from clima_oceananigans_jl_tpu.ops import operators as op
    sol = state["solution"]
    div = op.div_ccc(sol["u"], sol["v"], sol["w"], model.grid)
    r0 = float(jnp.abs(model.grid.interior(div)).max())  # O(n): raw noise
    state = jax.jit(model.step)(state, jnp.asarray(1e-3, DT))
    sol = state["solution"]
    div = op.div_ccc(sol["u"], sol["v"], sol["w"], model.grid)
    r = float(jnp.abs(model.grid.interior(div)).max())
    # the step's projection removes the divergence down to fp32 roundoff
    # of the O(r0) pressure-gradient cancellation
    assert r < 1e-4 * r0, (r, r0)


def test_nonhydrostatic_f32_matches_f64():
    """The benchmark configuration stepped in fp32 agrees with the same
    model stepped in fp64 (x64 switched on for that run only) at fp32
    tolerances over 3 steps."""
    n = 16
    sols = {}
    rng = np.random.default_rng(0)
    init = {k: s * rng.standard_normal((n, n, n))
            for k, s in (("u", 1e-2), ("v", 1e-2), ("b", 1e-4))}
    for dtype in (jnp.float32, jnp.float64):
        with jax.enable_x64(dtype == jnp.float64):
            grid = RectilinearGrid(size=(n, n, n), extent=(1., 1., 1.),
                                   topology=(PERIODIC, PERIODIC, BOUNDED),
                                   dtype=dtype)
            m = NonhydrostaticModel(grid, advection=WENO5(),
                                    buoyancy=BuoyancyTracer())
            s = m.initial_state(**{k: jnp.asarray(v, dtype)
                                   for k, v in init.items()})
            step = jax.jit(m.step)
            for _ in range(3):
                s = step(s, jnp.asarray(1e-3, dtype))
            sols[dtype] = {k: np.asarray(m.grid.interior(v), np.float64)
                           for k, v in s["solution"].items()}
    for k, ref in sols[jnp.float64].items():
        # fp32 round-off carried through 3 FFT projections
        scale = np.abs(ref).max()
        np.testing.assert_allclose(sols[jnp.float32][k], ref,
                                   rtol=0, atol=1e-5 * scale, err_msg=k)


def test_shallow_water_conservation_f32():
    """Mass is conserved to fp32 roundoff; energy does not grow."""
    n = 32
    grid = RectilinearGrid(size=(n, n, 1), extent=(1., 1., 1.),
                           topology=(PERIODIC, PERIODIC, FLAT), dtype=DT)
    model = ShallowWaterModel(grid=grid, gravitational_acceleration=10.0,
                              advection=WENO5())
    state = model.initial_state(
        uh=lambda x, y, z: 0.1 * jnp.sin(2 * jnp.pi * x) * jnp.cos(2 * jnp.pi * y),
        h=1.0)
    g = model.grid
    mass0 = float(jnp.sum(g.interior(state["solution"]["h"])))
    step = jax.jit(model.step)
    for _ in range(50):
        state = step(state, jnp.asarray(2e-3, DT))
    mass1 = float(jnp.sum(g.interior(state["solution"]["h"])))
    assert abs(mass1 - mass0) / mass0 < 1e-5
    assert state["solution"]["h"].dtype == jnp.float32
    assert bool(jnp.all(jnp.isfinite(state["solution"]["uh"])))


def test_simulation_loop_runs_f32():
    grid = RectilinearGrid(size=(16, 16, 4), extent=(1., 1., 1.),
                           topology=(PERIODIC, PERIODIC, BOUNDED), dtype=DT)
    model = NonhydrostaticModel(grid, advection=WENO5(),
                                buoyancy=BuoyancyTracer())
    state = model.initial_state(
        b=lambda x, y, z: 1e-4 * jnp.sin(2 * jnp.pi * x))
    sim = Simulation(model, state=state, dt=1e-3, stop_iteration=10)
    sim.run()
    assert sim.model_iteration() == 10
    assert bool(jnp.all(jnp.isfinite(sim.state["solution"]["b"])))
