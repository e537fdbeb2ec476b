"""Metric-aware staggered finite-volume operators.

The array analog of the reference's src/Operators/ (derivative_operators.jl,
divergence_operators.jl, laplacian_operators.jl, vorticity_operators.jl):
whole-array expressions combining index-space stencils (ops/stencil.py)
with the grid's metric arrays. All location logic is static, resolved at
trace time from explicit ``loc`` triples; works for rectilinear and
curvilinear (lat-lon) grids through the grid metric protocol
(dx/dy/dz/Ax/Ay/Az/V as functions of the location triple).
"""
from __future__ import annotations

from ..utils.location import C, F, U_LOC, V_LOC, W_LOC, CENTER, flip
from . import stencil as st


def flip_loc(loc, axis):
    l = list(loc)
    l[axis] = flip(l[axis])
    return tuple(l)


def delta(f, axis, loc):
    """δ along `axis` of a field at `loc`; result at the flipped location."""
    return st.df(f, axis) if loc[axis] is C else st.dc(f, axis)


def interp(f, axis, loc):
    """2-point ℑ along `axis`; result at the flipped location."""
    return st.if_(f, axis) if loc[axis] is C else st.ic(f, axis)


def interp_to(f, from_loc, to_loc):
    """Interpolate a field to another location triple (2-point ℑ per axis)."""
    out = f
    cur = list(from_loc)
    for axis in range(3):
        if cur[axis] is not to_loc[axis]:
            out = interp(out, axis, tuple(cur))
            cur[axis] = to_loc[axis]
    return out


def dd(f, grid, axis, loc):
    """∂ along `axis` of a field at `loc`; result at the flipped location."""
    out_loc = flip_loc(loc, axis)
    return delta(f, axis, loc) / grid.spacing(axis, out_loc)


def ddx(f, grid, loc):
    return dd(f, grid, 0, loc)


def ddy(f, grid, loc):
    return dd(f, grid, 1, loc)


def ddz(f, grid, loc):
    return dd(f, grid, 2, loc)


def div_ccc(u, v, w, grid):
    """FV divergence at cell centers of a C-grid vector (u,v,w).

    Reference: divᶜᶜᶜ, src/Operators/divergence_operators.jl.
    """
    return (st.dxc(grid.Ax(U_LOC) * u)
            + st.dyc(grid.Ay(V_LOC) * v)
            + st.dzc(grid.Az(W_LOC) * w)) / grid.V(CENTER)


def div_xy_ccc(u, v, grid):
    """Horizontal FV divergence at centers (used by free-surface / w-from-continuity)."""
    return (st.dxc(grid.Ax(U_LOC) * u)
            + st.dyc(grid.Ay(V_LOC) * v)) / grid.V(CENTER)


def zeta3_ffc(u, v, grid):
    """Vertical vorticity ζ₃ at (F,F,C) (reference vorticity_operators.jl)."""
    return (st.dxf(grid.dy(V_LOC) * v)
            - st.dyf(grid.dx(U_LOC) * u)) / grid.Az((F, F, C))


def laplacian(c, grid, loc=CENTER, axes=(0, 1, 2)):
    """FV Laplacian ∇·∇c of a field at `loc` (usually centers); `axes`
    restricts the divergence (e.g. (0, 1) for the horizontal Laplacian
    of horizontal-formulation closures)."""
    areas = (grid.Ax, grid.Ay, grid.Az)
    out = 0.0
    for a in axes:
        fl = flip_loc(loc, a)
        out = out + delta(areas[a](fl) * dd(c, grid, a, loc), a, fl)
    return out / grid.V(loc)
