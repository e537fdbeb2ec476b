"""Advective flux divergences against a NumPy reference that walks the
flux axis index by index.

``advection/fluxes.py`` builds every flux divergence from whole-array
shifts (``jnp.roll``) and, for WENO5 on stretched axes, from closed-form
coefficient tables. The reference below reads each stencil cell by its
index instead, uses the textbook (Jiang–Shu) form of each scheme, and on
stretched axes derives the reconstruction coefficients and optimal weights
by solving the cell-average conditions directly. It is the plain
reference that any hand-written kernel for these operators is held to.

Cases: {Centered2, Centered4, UpwindBiased3, UpwindBiased5, WENO5} ×
{periodic-periodic-bounded, triply periodic, triply bounded} ×
{regular z, stretched z}, fp64, on a 12×10×8 grid with random data in the
halos too (so the boundary conditions play no part).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

from clima_oceananigans_jl_tpu import (
    BOUNDED, PERIODIC, RectilinearGrid, CenteredFourthOrder,
    CenteredSecondOrder, UpwindBiasedFifthOrder, UpwindBiasedThirdOrder, WENO5)
from clima_oceananigans_jl_tpu.advection.fluxes import (
    div_Uc, div_vu, div_vv, div_vw)
from clima_oceananigans_jl_tpu.utils.location import C, F

SIZE = (12, 10, 8)
HALO = 3
EPS = 1e-6  # WENO5's ε
SCHEMES = {
    "Centered2": (CenteredSecondOrder(), 1),
    "Centered4": (CenteredFourthOrder(), 2),
    "UpwindBiased3": (UpwindBiasedThirdOrder(), 2),
    "UpwindBiased5": (UpwindBiasedFifthOrder(), 3),
    "WENO5": (WENO5(), 3),
}
TOPOLOGIES = {"PPB": (PERIODIC, PERIODIC, BOUNDED),
              "PPP": (PERIODIC, PERIODIC, PERIODIC),
              "BBB": (BOUNDED, BOUNDED, BOUNDED)}


# -- uniform-coefficient reconstructions: a(k) is the k-th cell from the
#    flux point (a(-1) and a(0) straddle it) -------------------------------
def _weno_left(v):
    vm3, vm2, vm1, v0, vp1 = v
    p = ((2 * vm3 - 7 * vm2 + 11 * vm1) / 6,
         (-vm2 + 5 * vm1 + 2 * v0) / 6,
         (2 * vm1 + 5 * v0 - vp1) / 6)
    b = (13 / 12 * (vm3 - 2 * vm2 + vm1) ** 2 + 0.25 * (vm3 - 4 * vm2 + 3 * vm1) ** 2,
         13 / 12 * (vm2 - 2 * vm1 + v0) ** 2 + 0.25 * (vm2 - v0) ** 2,
         13 / 12 * (vm1 - 2 * v0 + vp1) ** 2 + 0.25 * (3 * vm1 - 4 * v0 + vp1) ** 2)
    return _weno_combine(p, b, (0.1, 0.6, 0.3))


def _weno_combine(p, b, d):
    alpha = [dk / (bk + EPS) ** 2 for dk, bk in zip(d, b)]
    return sum(ak * pk for ak, pk in zip(alpha, p)) / sum(alpha)


def _uniform(name, a):
    """(left, right) reconstructions (equal for centered schemes)."""
    if name == "Centered2":
        s = (a(-1) + a(0)) / 2
        return s, s
    if name == "Centered4":
        s = (9 * (a(-1) + a(0)) - (a(-2) + a(1))) / 16
        return s, s
    if name == "UpwindBiased3":
        return ((-a(-2) + 5 * a(-1) + 2 * a(0)) / 6,
                (-a(1) + 5 * a(0) + 2 * a(-1)) / 6)
    if name == "UpwindBiased5":
        return ((2 * a(-3) - 13 * a(-2) + 47 * a(-1) + 27 * a(0) - 3 * a(1)) / 60,
                (2 * a(2) - 13 * a(1) + 47 * a(0) + 27 * a(-1) - 3 * a(-2)) / 60)
    # WENO5: the right-biased value is the left one of the mirrored cells
    return (_weno_left([a(k) for k in (-3, -2, -1, 0, 1)]),
            _weno_left([a(k) for k in (2, 1, 0, -1, -2)]))


# -- stretched-axis WENO5 ---------------------------------------------------
def _cell_average_weights(X, edges):
    """w such that Σ w_j v̄_j is the value at X of the polynomial whose
    averages over the cells [edges[j], edges[j+1]] are v̄_j."""
    k = len(edges) - 1
    A = np.empty((k, k))
    for j in range(k):
        lo, hi = edges[j] - X, edges[j + 1] - X
        for m in range(k):
            A[j, m] = (hi ** (m + 1) - lo ** (m + 1)) / ((m + 1) * (hi - lo))
    # p(X) = c_0 and A c = v̄  ⇒  w = A⁻ᵀ e₀
    return np.linalg.solve(A.T, np.eye(k)[0])


def _smoothness(w0, w1, w2, kind):
    second = (w0 - 4 * w1 + 3 * w2, w0 - w2, 3 * w0 - 4 * w1 + w2)[kind]
    return 13 / 12 * (w0 - 2 * w1 + w2) ** 2 + 0.25 * second ** 2


def _stretched_weno(a, X, node):
    """(left, right) WENO5 with geometry-exact stencil coefficients and
    optimal weights; ``node(j)`` is the j-th node from the flux point
    (cell k spans [node(k), node(k+1)] and holds a(k))."""
    out = []
    for cells5, firsts, kinds in (((-3, -2, -1, 0, 1), (-3, -2, -1), (0, 1, 2)),
                                  ((-2, -1, 0, 1, 2), (0, -1, -2), (2, 1, 0))):
        q5 = _cell_average_weights(X, [node(k) for k in cells5 + (cells5[-1] + 1,)])
        ps, bs, embed = [], [], np.zeros((5, 3))
        for r, (k0, kind) in enumerate(zip(firsts, kinds)):
            cells = (k0, k0 + 1, k0 + 2)
            w = _cell_average_weights(X, [node(k) for k in cells + (k0 + 3,)])
            vals = [a(k) for k in cells]
            ps.append(sum(wj * v for wj, v in zip(w, vals)))
            bs.append(_smoothness(*vals, kind))
            embed[cells5.index(k0):cells5.index(k0) + 3, r] = w
        d = np.linalg.lstsq(embed, q5, rcond=None)[0]
        out.append(_weno_combine(ps, bs, d))
    return tuple(out)


def _nodes(grid, axis, to_f):
    """The axis' node positions (faces for cell data, centers for face
    data), continued two past each end; returns (array, offset)."""
    ax = grid._axes[axis]
    P = np.asarray(ax.cf if to_f else ax.cc, np.float64)
    if grid.topology[axis] is PERIODIC:  # P[j + n] = P[j] + extent
        n, m = ax.n, len(P)
        lo = P[n - 2:n] - ax.extent
        hi = P[m - n:m - n + 2] + ax.extent
    else:
        lo = P[0] - (P[1] - P[0]) * np.array([2.0, 1.0])
        hi = P[-1] + (P[-1] - P[-2]) * np.array([1.0, 2.0])
    return np.concatenate([lo, P, hi]), 2


# -- transport and divergences ----------------------------------------------
def _transport(name, vel, q, grid, axis, to_f):
    """vel·ψ at every flux point the interior divergence reads: faces
    H..H+N (to_f) or centers H−1..H+N−1; NaN elsewhere."""
    H, N = grid.halo[axis], grid.shape[axis]
    Nb = SCHEMES[name][1]
    o = 0 if to_f else 1
    stretched = name == "WENO5" and not grid._axes[axis].regular
    if stretched:
        P, off = _nodes(grid, axis, to_f)
    out = np.full(q.shape, np.nan)
    for i in (range(H, H + N + 1) if to_f else range(H - 1, H + N)):
        a = lambda k, i=i: np.take(q, i + k + o, axis=axis)  # noqa: E731
        if stretched:
            L, R = _stretched_weno(a, P[i + off], lambda k: P[i + k + off])
        else:
            L, R = _uniform(name, a)
        if grid.topology[axis] is BOUNDED and Nb > 1:
            # near a wall: second-order centered (the reference's
            # boundary buffer); left/right full order only where the
            # whole stencil is interior
            c2 = (a(-1) + a(0)) / 2
            centered = name.startswith("Centered")
            if centered and not H + Nb <= i <= H + N - Nb - 1:
                L = R = c2
            if not centered and not H + Nb <= i <= H + N - Nb:
                L = c2
            if not centered and not H + Nb - 1 <= i <= H + N - Nb - 1:
                R = c2
        v = np.take(vel, i, axis=axis)
        idx = [slice(None)] * 3
        idx[axis] = i
        out[tuple(idx)] = np.where(v > 0, v * L, v * R)
    return out


def _spacing(grid, axis, loc):
    ax = grid._axes[axis]
    d = np.asarray(ax.dc if loc[axis] is C else ax.df, np.float64)
    shape = [1, 1, 1]
    shape[axis] = d.size
    return d.reshape(shape)


def _area(grid, axis, loc):
    others = [a for a in range(3) if a != axis]
    return _spacing(grid, others[0], loc) * _spacing(grid, others[1], loc)


def _volume(grid, loc):
    return _spacing(grid, 0, loc) * _spacing(grid, 1, loc) * _spacing(grid, 2, loc)


def _interp(f, axis, onto_f):
    """Two-point mean onto faces (f[i−1], f[i]) or centers (f[i], f[i+1])."""
    return 0.5 * (f + np.roll(f, 1 if onto_f else -1, axis=axis))


def _divergence(grid, fluxes, loc):
    """Σ_axis δ(flux) / V at ``loc`` over the interior: forward difference
    where the flux sits on faces, backward where it sits on centers."""
    H, N = grid.halo, grid.shape
    out = 0.0
    for axis, (flux, to_f) in enumerate(fluxes):
        sl = [slice(h, h + n) for h, n in zip(H, N)]
        hi, lo = list(sl), list(sl)
        if to_f:
            hi[axis] = slice(H[axis] + 1, H[axis] + N[axis] + 1)
        else:
            lo[axis] = slice(H[axis] - 1, H[axis] + N[axis] - 1)
        out = out + flux[tuple(hi)] - flux[tuple(lo)]
    V = np.broadcast_to(_volume(grid, loc), flux.shape)
    return out / V[tuple(slice(h, h + n) for h, n in zip(H, N))]


def _reference(name, grid, u, v, w, c):
    T = functools.partial(_transport, name, grid=grid)
    Uc, Vc, Wc = (F, C, C), (C, F, C), (C, C, F)
    ref = {}
    ref["c"] = _divergence(grid, [
        (_area(grid, 0, Uc) * T(u, c, axis=0, to_f=True), True),
        (_area(grid, 1, Vc) * T(v, c, axis=1, to_f=True), True),
        (_area(grid, 2, Wc) * T(w, c, axis=2, to_f=True), True)], (C, C, C))
    ref["u"] = _divergence(grid, [
        (_area(grid, 0, (C, C, C)) * T(_interp(u, 0, False), u, axis=0, to_f=False), False),
        (_area(grid, 1, (F, F, C)) * T(_interp(v, 0, True), u, axis=1, to_f=True), True),
        (_area(grid, 2, (F, C, F)) * T(_interp(w, 0, True), u, axis=2, to_f=True), True)], Uc)
    ref["v"] = _divergence(grid, [
        (_area(grid, 0, (F, F, C)) * T(_interp(u, 1, True), v, axis=0, to_f=True), True),
        (_area(grid, 1, (C, C, C)) * T(_interp(v, 1, False), v, axis=1, to_f=False), False),
        (_area(grid, 2, (C, F, F)) * T(_interp(w, 1, True), v, axis=2, to_f=True), True)], Vc)
    ref["w"] = _divergence(grid, [
        (_area(grid, 0, (F, C, F)) * T(_interp(u, 2, True), w, axis=0, to_f=True), True),
        (_area(grid, 1, (C, F, F)) * T(_interp(v, 2, True), w, axis=1, to_f=True), True),
        (_area(grid, 2, (C, C, C)) * T(_interp(w, 2, False), w, axis=2, to_f=False), False)], Wc)
    return ref


@pytest.mark.parametrize("stretched", [False, True], ids=["regular_z", "stretched_z"])
@pytest.mark.parametrize("topo", sorted(TOPOLOGIES))
@pytest.mark.parametrize("name", sorted(SCHEMES))
def test_flux_divergence_matches_pointwise_reference(name, topo, stretched):
    rng = np.random.default_rng(7)
    z = (np.concatenate([[0.0], np.cumsum(rng.uniform(0.5, 1.5, SIZE[2]))])
         / SIZE[2] if stretched else (0.0, 1.0))
    grid = RectilinearGrid(size=SIZE, x=(0.0, 1.2), y=(0.0, 1.0), z=z,
                           topology=TOPOLOGIES[topo], halo=(HALO,) * 3,
                           dtype=jnp.float64)
    assert grid.z_regular is not stretched
    u, v, w, c = (rng.standard_normal(grid.total_shape) for _ in range(4))
    scheme = SCHEMES[name][0]
    ju, jv, jw, jc = map(jnp.asarray, (u, v, w, c))
    got = {"c": div_Uc(grid, scheme, ju, jv, jw, jc),
           "u": div_vu(grid, scheme, ju, jv, jw),
           "v": div_vv(grid, scheme, ju, jv, jw),
           "w": div_vw(grid, scheme, ju, jv, jw)}
    for field, ref in _reference(name, grid, u, v, w, c).items():
        g = np.asarray(grid.interior(got[field]))
        # fp64 round-off of a few dozen operations, relative to the
        # field's scale; a wrong tap or weight is off by O(1)
        np.testing.assert_allclose(g, ref, rtol=0,
                                   atol=1e-11 * np.abs(ref).max(),
                                   err_msg=f"{field} ({name}, {topo})")
