"""Stencil/operator identities (model: /root/reference/test/test_operators.jl)."""
import jax.numpy as jnp
import numpy as np

from clima_oceananigans_jl_tpu import (
    BOUNDED, PERIODIC, FLAT, RectilinearGrid, C, F, CENTER, U_LOC, V_LOC, W_LOC,
    CenterField, XFaceField, YFaceField, ZFaceField, set_field, fill_halos,
)
from clima_oceananigans_jl_tpu.ops import stencil as st
from clima_oceananigans_jl_tpu.ops import operators as op


def _grid(topo=(PERIODIC, PERIODIC, PERIODIC), n=(8, 8, 8)):
    return RectilinearGrid(size=n, extent=(2 * np.pi, 2 * np.pi, 2 * np.pi),
                           topology=topo, dtype=jnp.float64)


def test_difference_and_interp_identities():
    g = _grid()
    f = CenterField(g)
    f = set_field(f, g, lambda x, y, z: jnp.sin(x))
    d = st.dxf(f.data)  # onto faces
    i = st.ixf(f.data)
    x = g.nodes(CENTER, with_halo=True)[0]
    xf = g.nodes(U_LOC, with_halo=True)[0]
    dx = 2 * np.pi / 8
    expected_d = np.sin(np.asarray(x)) - np.sin(np.asarray(x) - dx)
    inter = g.interior(d)
    assert np.allclose(np.asarray(inter),
                       np.broadcast_to(expected_d[g.Hx:g.Hx + 8], inter.shape))


def test_derivative_second_order_convergence():
    errs = []
    for n in (16, 32):
        g = _grid(n=(n, 1, 1), topo=(PERIODIC, FLAT, FLAT))
        f = set_field(CenterField(g), g, lambda x, y, z: jnp.sin(x))
        df = op.ddx(f.data, g, CENTER)  # at faces
        xf = g.nodes(U_LOC, with_halo=True)[0]
        err = np.max(np.abs(np.asarray(g.interior(df - jnp.cos(xf)))))
        errs.append(err)
    rate = np.log2(errs[0] / errs[1])
    assert rate > 1.9


def test_divergence_of_uniform_flow_is_zero():
    g = _grid(topo=(PERIODIC, PERIODIC, BOUNDED))
    u = set_field(XFaceField(g), g, 1.0)
    v = set_field(YFaceField(g), g, 2.0)
    w = set_field(ZFaceField(g), g, 0.0)
    div = op.div_ccc(u.data, v.data, w.data, g)
    assert np.allclose(np.asarray(g.interior(div)), 0.0, atol=1e-12)


def test_divergence_theorem_periodic():
    # ∫ div(u) dV = 0 for periodic fields
    g = _grid()
    rng = np.random.default_rng(0)
    u = fill_halos(jnp.asarray(rng.standard_normal(g.total_shape)), g, U_LOC)
    v = fill_halos(jnp.asarray(rng.standard_normal(g.total_shape)), g, V_LOC)
    w = fill_halos(jnp.asarray(rng.standard_normal(g.total_shape)), g, W_LOC)
    div = op.div_ccc(u, v, w, g)
    vol = jnp.broadcast_to(g.V(CENTER), g.total_shape)
    total = float(jnp.sum(g.interior(div * vol)))
    assert abs(total) < 1e-10


def test_vorticity_of_solid_body_rotation():
    # u = -y, v = x → ζ = 2
    g = RectilinearGrid(size=(16, 16, 1), x=(-1, 1), y=(-1, 1),
                        topology=(BOUNDED, BOUNDED, FLAT), dtype=jnp.float64)
    u = set_field(XFaceField(g), g, lambda x, y, z: -y)
    v = set_field(YFaceField(g), g, lambda x, y, z: x)
    zeta = op.zeta3_ffc(u.data, v.data, g)
    # interior away from boundaries
    inner = np.asarray(zeta[g.Hx + 1: g.Hx + 15, g.Hy + 1: g.Hy + 15, :])
    assert np.allclose(inner, 2.0, atol=1e-10)


def test_laplacian_eigenfunction():
    g = _grid(n=(32, 1, 1), topo=(PERIODIC, FLAT, FLAT))
    f = set_field(CenterField(g), g, lambda x, y, z: jnp.sin(x))
    lap = op.laplacian(f.data, g)
    x = g.nodes(CENTER, with_halo=True)[0]
    err = np.max(np.abs(np.asarray(g.interior(lap + jnp.sin(x)))))
    assert err < 0.02  # 2nd-order: (2 sin(Δ/2)/Δ)² ≈ 1 - Δ²/12


def test_stretched_grid_derivative_is_exact_for_linear():
    faces = np.cumsum(np.concatenate([[0.0], np.random.default_rng(1).uniform(0.5, 2.0, 16)]))
    g = RectilinearGrid(size=(1, 1, 16), x=(0, 1), y=(0, 1), z=faces,
                        topology=(FLAT, FLAT, BOUNDED), dtype=jnp.float64)
    f = set_field(CenterField(g), g, lambda x, y, z: 3.0 * z + 1.0)
    dfdz = op.ddz(f.data, g, CENTER)  # at z-faces
    # interior faces (excluding boundary-adjacent ghosts)
    inner = np.asarray(dfdz[:, :, g.Hz + 1: g.Hz + 16])
    assert np.allclose(inner, 3.0, atol=1e-11)


def test_interp_to_moves_location():
    g = _grid()
    f = set_field(CenterField(g), g, lambda x, y, z: jnp.sin(x) * jnp.cos(y))
    out = op.interp_to(f.data, CENTER, (F, F, C))
    xf = g.nodes((F, F, C), with_halo=True)[0]
    yf = g.nodes((F, F, C), with_halo=True)[1]
    # 2-point interp of sin/cos attenuates by exactly cos(Δ/2) per axis
    d = 2 * np.pi / 8
    expected = (np.cos(d / 2) ** 2
                * np.sin(np.asarray(xf)) * np.cos(np.asarray(yf)))
    got = np.asarray(g.interior(out))
    assert np.allclose(got, np.broadcast_to(expected, g.total_shape)[
        g.Hx:g.Hx + 8, g.Hy:g.Hy + 8, g.Hz:g.Hz + 8], atol=1e-12)


def test_upwind_select_matches_two_sided_blend_bitwise():
    """transport()'s select-first upwinding (one sign-selected
    reconstruction) must reproduce the two-sided blend
    ((vel+|vel|)L + (vel−|vel|)R)/2 BIT-FOR-BIT — the IEEE identity the
    single-reconstruction upwinding relies on (advection/schemes.py
    stream_reconstruct)."""
    from clima_oceananigans_jl_tpu.advection.schemes import (
        WENO5, BoundsPreservingWENO5, transport, upwind_biased_product)
    rng = np.random.default_rng(7)
    for dtype in (jnp.float64, jnp.float32):
        c = jnp.asarray(rng.normal(size=(18, 16, 14)), dtype)
        vel = jnp.asarray(rng.normal(size=(18, 16, 14)), dtype)
        for sch in (WENO5(), BoundsPreservingWENO5()):
            for axis in (0, 1, 2):
                for to_f in (True, False):
                    new = transport(sch, vel, c, axis, to_f)
                    L, R = (sch.left_right_to_f(c, axis) if to_f
                            else sch.left_right_to_c(c, axis))
                    old = upwind_biased_product(vel, L, R)
                    assert np.array_equal(np.asarray(new), np.asarray(old)), (
                        dtype, type(sch).__name__, axis, to_f)


def test_vector_invariant_select_first_matches_two_sided_bitwise():
    """The WENOVectorInvariant vorticity term's select-first upwinding
    (one sign-selected stream through stream_reconstruct[_smooth]) must
    reproduce the two-sided blend upwind_biased_product(v̂, L, R) with
    L/R from lr_to_c_smooth / left_right-style evaluation BIT-FOR-BIT
    (vector_invariant.py U_dot_grad_u/v)."""
    from clima_oceananigans_jl_tpu.advection.schemes import (
        WENO5, upwind_biased_product, upwind_stream, shift)
    rng = np.random.default_rng(11)
    wn = WENO5()
    for dtype in (jnp.float64, jnp.float32):
        zeta = jnp.asarray(rng.normal(size=(18, 16, 14)), dtype)
        su = jnp.asarray(rng.normal(size=(18, 16, 14)), dtype)
        sv = jnp.asarray(rng.normal(size=(18, 16, 14)), dtype)
        vel = jnp.asarray(rng.normal(size=(18, 16, 14)), dtype)
        for axis in (0, 1):
            sel = vel >= 0
            # VelocityStencil (mean tangential-velocity smoothness)
            az = upwind_stream(zeta, sel, axis, False)
            ss = [upwind_stream(f, sel, axis, False) for f in (su, sv)]
            new = vel * wn.stream_reconstruct_smooth(az, ss)
            zl, zr = wn.lr_to_c_smooth(zeta, (su, sv), axis)
            old = upwind_biased_product(vel, zl, zr)
            assert np.array_equal(np.asarray(new), np.asarray(old)), (
                dtype, "velocity", axis)
            # VorticityStencil (ζ's own smoothness)
            new_v = vel * wn.stream_reconstruct(az)
            Lv, Rv = wn.left_right_to_c(zeta, axis)
            old_v = upwind_biased_product(vel, Lv, Rv)
            assert np.array_equal(np.asarray(new_v), np.asarray(old_v)), (
                dtype, "vorticity", axis)
