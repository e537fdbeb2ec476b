"""Free-convection column: the three boundary-layer closures against the
classical mixed-layer scaling (reference
validation/vertical_mixing_closures — side-by-side closure comparison).

A resting, linearly stratified column is cooled at the surface with a
constant buoyancy flux B₀. Each closure (CATKE, convective adjustment,
Ri-based) must deepen the mixed layer like the zero-entrainment budget

    h(t) ≈ √(2(1+2A) B₀ t / N²),   A ≈ 0.2 (entrainment coefficient)

within a generous factor, keep the profile statically near-neutral in
the mixed layer, and conserve buoyancy up to the surface input.

Run: JAX_PLATFORMS=cpu python validation/vertical_mixing_closures.py
"""
import os, sys
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import (
    BOUNDED, FLAT, RectilinearGrid, FieldBCs, FluxBC, ScalarDiffusivity,
)
from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from clima_oceananigans_jl_tpu.models.free_surface import ImplicitFreeSurface
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.closures.vertical_mixing import (
    CATKEVerticalDiffusivity, ConvectiveAdjustmentVerticalDiffusivity,
    RiBasedVerticalDiffusivity)

nz, H = 64, 128.0
N2 = 1e-5
B0 = 1e-7  # surface buoyancy LOSS (cooling): flux out of the ocean
t_end = 12 * 3600.0
dt = 60.0

CLOSURES = [
    ("CATKE", CATKEVerticalDiffusivity()),
    ("convective_adjustment",
     ConvectiveAdjustmentVerticalDiffusivity(convective_kappa_z=1.0,
                                             background_kappa_z=1e-5)),
    ("Ri_based", RiBasedVerticalDiffusivity()),
]

h_exp = np.sqrt(2 * 1.4 * B0 * t_end / N2)
print(f"expected mixed-layer depth after {t_end/3600:.0f} h: {h_exp:.1f} m")

depths = {}
for name, closure in CLOSURES:
    grid = RectilinearGrid(size=(1, 1, nz), x=(0, 1), y=(0, 1), z=(-H, 0.0),
                           topology=(FLAT, FLAT, BOUNDED), dtype=jnp.float64)
    model = HydrostaticFreeSurfaceModel(
        grid=grid, buoyancy=BuoyancyTracer(), momentum_advection=None,
        tracer_advection=None, closure=closure,
        free_surface=ImplicitFreeSurface(solver_method="pcg"),
        boundary_conditions={"b": FieldBCs(top=FluxBC(B0))})
    g = model.grid
    init = {"b": lambda x, y, z: N2 * z}
    if "e" in model.tracer_names:
        init["e"] = 1e-7
    state = model.initial_state(**init)
    zc = np.asarray(g.coord(2, "c"))
    dz = H / nz
    b0 = np.asarray(g.interior(state["solution"]["b"]))[0, 0]
    step = jax.jit(model.step)
    steps = int(t_end / dt)
    for _ in range(steps):
        state = step(state, jnp.float64(dt))
    b = np.asarray(g.interior(state["solution"]["b"]))[0, 0]
    # mixed-layer depth: shallowest level where b returns to the initial
    # stratification (within 2%)
    mixed = np.abs(b - N2 * zc) > 0.02 * N2 * H
    h = -zc[mixed].min() if mixed.any() else 0.0
    depths[name] = h
    # buoyancy budget: ∫(b − b0)dz = −B0·t
    budget = (b - b0).sum() * dz
    print(f"{name:22s}: h = {h:6.1f} m  (h/h_exp = {h/h_exp:.2f})  "
          f"∫Δb dz / (−B0 t) = {budget / (-B0*t_end):.3f}")
    assert abs(budget / (-B0 * t_end) - 1.0) < 0.02, (name, budget)
    # interior of the mixed layer is much less stratified than ambient
    # (exclude the surface cells that carry the flux-injection gradient)
    inml = (zc > -0.6 * h) & (zc < -3 * dz)
    if inml.sum() > 3:
        grad = np.diff(b[inml]) / dz
        assert np.abs(grad).max() < 0.5 * N2, (name, np.abs(grad).max())

for name, h in depths.items():
    assert 0.5 * h_exp < h < 1.8 * h_exp, (name, h, h_exp)
print("PASS: all three closures deepen like the convective scaling")
