"""Accuracy gate for WENO5(bf16_smoothness=True): bfloat16 smoothness
indicators may only perturb the reconstruction within the weights' own
heuristic slack — bounded by the local candidate spread — and must keep
the scheme's convex-combination (non-oscillatory) structure and its
convergence on smooth fields."""
import jax
import jax.numpy as jnp
import numpy as np

from clima_oceananigans_jl_tpu import PERIODIC, FLAT, RectilinearGrid, WENO5
from clima_oceananigans_jl_tpu.advection.schemes import upwind_stream


def _stream(c, axis=0):
    sel = jnp.ones(c.shape, bool)  # left-biased everywhere
    return upwind_stream(c, sel, axis, to_f=True)


def test_bf16_smoothness_bounded_by_candidate_spread():
    """Pointwise: |rec_bf16 − rec_f32| ≤ spread of the candidate stencils
    (the weights are a convex combination; bf16 only moves the weights),
    and in smooth regions the perturbation is ~1% of the spread."""
    key = jax.random.PRNGKey(0)
    x = jnp.linspace(0, 2 * jnp.pi, 256, endpoint=False)
    smooth = jnp.sin(x) + 0.3 * jnp.cos(3 * x)
    rough = jnp.where(x < jnp.pi, 1.0, 0.0) + 0.1 * jax.random.normal(key, x.shape)
    for field in (smooth, rough):
        c = field.astype(jnp.float32)[:, None, None]
        a = _stream(c)
        rec32 = WENO5().stream_reconstruct(a)
        recbf = WENO5(bf16_smoothness=True).stream_reconstruct(a)
        # candidate reconstructions (the hull of the combination)
        a0, a1, a2, a3, a4 = a
        d10, d11, d12, d13 = a1 - a0, a2 - a1, a3 - a2, a4 - a3
        p0 = a2 + (5.0 * d11 - 2.0 * d10) / 6.0
        p1 = a2 + (2.0 * d12 + d11) / 6.0
        p2 = a2 + (4.0 * d12 - d13) / 6.0
        hi = jnp.maximum(p0, jnp.maximum(p1, p2))
        lo = jnp.minimum(p0, jnp.minimum(p1, p2))
        spread = np.asarray(hi - lo)
        diff = np.abs(np.asarray(recbf - rec32))
        assert np.all(diff <= spread + 1e-6), (diff.max(), spread.max())
        # convex-hull (ENO) property preserved under bf16 weights
        assert np.all(np.asarray(recbf) <= np.asarray(hi) + 1e-5)
        assert np.all(np.asarray(recbf) >= np.asarray(lo) - 1e-5)


def test_bf16_smoothness_matches_f64_on_smooth_fields():
    """On a smooth field the bf16-indicator reconstruction stays within a
    small multiple of the fp32 path's distance from the f64 truth."""
    x64 = jnp.linspace(0, 2 * np.pi, 128, endpoint=False).astype(jnp.float64)
    c64 = jnp.sin(x64)[:, None, None]
    rec64 = np.asarray(WENO5().stream_reconstruct(_stream(c64)))
    c32 = c64.astype(jnp.float32)
    err32 = np.abs(np.asarray(
        WENO5().stream_reconstruct(_stream(c32))).astype(np.float64) - rec64)
    errbf = np.abs(np.asarray(
        WENO5(bf16_smoothness=True).stream_reconstruct(_stream(c32))
    ).astype(np.float64) - rec64)
    # the interpolation target is O(1); both errors must be far below the
    # scheme's truncation error at n=128 (~(2pi/128)^5 ~ 3e-7 * f) and the
    # bf16 mode may not exceed a small multiple of the f32 error envelope
    assert err32.max() < 5e-6
    assert errbf.max() < max(10 * err32.max(), 2e-5), \
        (errbf.max(), err32.max())


def test_bf16_smoothness_full_model_close_and_stable():
    """3 AB2 steps of the benchmark configuration: the bf16-indicator run
    stays within a tight relative envelope of the plain fp32 run and
    produces finite fields."""
    from clima_oceananigans_jl_tpu import BOUNDED
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import (
        NonhydrostaticModel)

    n = 16
    sols = {}
    for bf in (False, True):
        grid = RectilinearGrid(size=(n, n, n), extent=(1., 1., 1.),
                               topology=(PERIODIC, PERIODIC, BOUNDED),
                               dtype=jnp.float32)
        m = NonhydrostaticModel(grid, advection=WENO5(bf16_smoothness=bf),
                                buoyancy=BuoyancyTracer())
        key = jax.random.PRNGKey(0)
        ku, kv, kb = jax.random.split(key, 3)
        s = m.initial_state(
            u=1e-2 * jax.random.normal(ku, grid.shape, grid.dtype),
            v=1e-2 * jax.random.normal(kv, grid.shape, grid.dtype),
            b=1e-4 * jax.random.normal(kb, grid.shape, grid.dtype))
        step = jax.jit(m.step)
        for _ in range(3):
            s = step(s, jnp.float32(1e-3))
        sols[bf] = {k: np.asarray(m.grid.interior(v))
                    for k, v in s["solution"].items()}
        for k, v in sols[bf].items():
            assert np.all(np.isfinite(v)), k
    for k in sols[True]:
        scale = np.abs(sols[False][k]).max() + 1e-12
        diff = np.abs(sols[True][k] - sols[False][k]).max()
        assert diff < 5e-3 * scale, (k, diff, scale)
