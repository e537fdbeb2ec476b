"""Stretched-grid WENO reconstruction coefficient tables.

On non-uniform axes the uniform 5th-order WENO stencil coefficients and
optimal (linear) weights are formally inconsistent; the reference
precomputes per-index reconstruction coefficients from the grid's node
positions (reference src/Advection/weno_fifth_order.jl:21-60, via the
classic finite-volume reconstruction formula of Shu's ENO/WENO lecture
notes).  This module computes the same tables as whole-axis
1D arrays derived from the grid's coordinate leaves with closed-form
Lagrange algebra (no linear solves), so the computation traces cleanly
under jit and constant-folds when the grid is a compile-time constant.

Derivation.  For cell-averaged data ``v̄_j`` over cells
``[y_j, y_{j+1}]`` the point value at ``X`` of the reconstruction
polynomial is ``v(X) = Σ_j c_j v̄_j`` with

    c_j = (y_{j+1} − y_j) · Σ_{m=j+1}^{k} L'_m(X)

where ``L_m`` is the Lagrange basis on the stencil's k+1 node
positions (differentiate the interpolant of the primitive function).
Optimal weights follow from matching the 5-cell reconstruction on the
cells appearing in only one 3-cell stencil.

The smoothness indicators retain the uniform Jiang–Shu formulas (the
reference's default on stretched grids as well); only the linear part
of the scheme — stencil reconstructions and optimal weights — is made
geometry-exact, which restores the design order on smoothly-stretched
meshes.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..grids.topology import FLAT, PERIODIC


def _recon_coeffs(X, nodes):
    """Coefficients c_j of the cell averages for the point value at X.

    ``nodes``: k+1 arrays of stencil node (cell-interface) positions;
    cell j spans [nodes[j], nodes[j+1]].  All arrays broadcast together.
    """
    k = len(nodes) - 1
    dL = []
    for m in range(k + 1):
        num = 0.0
        for l in range(k + 1):
            if l == m:
                continue
            prod = 1.0
            for q in range(k + 1):
                if q == m or q == l:
                    continue
                prod = prod * (X - nodes[q])
            num = num + prod
        den = 1.0
        for l in range(k + 1):
            if l != m:
                den = den * (nodes[m] - nodes[l])
        dL.append(num / den)
    # c_j = Δy_j · Σ_{m>j} L'_m(X)  (suffix sums of the dL)
    sufs = [0.0] * (k + 2)
    for m in range(k, -1, -1):
        sufs[m] = sufs[m + 1] + dL[m]
    return [(nodes[j + 1] - nodes[j]) * sufs[j + 1] for j in range(k)]


def _build_tables(P, to_f):
    """WENO5 tables from the 1D node-position array ``P`` (face
    coordinates for cell→face reconstruction ``to_f=True``; center
    coordinates for the dual face→center reconstruction, whose cells
    are the center-to-center intervals).

    Returns {"left": [...], "right": [...]} where each side lists, per
    stencil r, a tuple ``(d_r, [c_r0, c_r1, c_r2], [o0, o1, o2], kind)``:
    the optimal-weight array, the three coefficient arrays, the value
    shift offsets (result[i] uses data[i+o]), and the smoothness-formula
    kind (0: w0−4w1+3w2, 1: w0−w2, 2: 3w0−4w1+w2 second term).

    Table entry i targets position P[i] (face i / center i).  Entries
    whose stencil crosses the array ends wrap (jnp.roll) and are
    garbage there; ``weno5_tables`` pads P by three nodes on each side
    first, so every entry it returns is exact.
    """
    roll = lambda o: jnp.roll(P, -o) if o else P
    vshift = 0 if to_f else 1
    out = {}
    for side in ("left", "right"):
        per_r = []
        for r in range(3):
            if side == "left":
                noff = [-3 + r, -2 + r, -1 + r, r]
                kind = r
            else:
                noff = [-r, 1 - r, 2 - r, 3 - r]
                kind = 2 - r
            cj = _recon_coeffs(P, [roll(o) for o in noff])
            voff = [o + vshift for o in noff[:3]]
            per_r.append((cj, voff, kind))
        noff5 = [-3, -2, -1, 0, 1, 2] if side == "left" else [-2, -1, 0, 1, 2, 3]
        q = _recon_coeffs(P, [roll(o) for o in noff5])
        # cells unique to one stencil pin d0/d2 (cf. Shu): left — cell
        # i−3 only in r=0, cell i+1 only in r=2; right mirrored.
        if side == "left":
            d0 = q[0] / per_r[0][0][0]
            d2 = q[4] / per_r[2][0][2]
        else:
            d0 = q[4] / per_r[0][0][2]
            d2 = q[0] / per_r[2][0][0]
        d1 = 1.0 - d0 - d2
        out[side] = [(d,) + per_r[r] for r, d in enumerate((d0, d1, d2))]
    return out


def weno5_tables(grid, axis, to_f):
    """Per-axis WENO5 tables for ``grid`` (None on uniform/flat axes, or
    grids without 1D coordinate axes)."""
    axes = getattr(grid, "_axes", None)
    if axes is None:
        return None
    a = axes[axis]
    if a.topo is FLAT or a.regular:
        return None
    P = a.cf if to_f else a.cc
    if a.topo is PERIODIC:  # P[j + n] = P[j] + extent
        lo = P[a.n - _PAD:a.n] - a.extent
        hi = P[len(P) - a.n:len(P) - a.n + _PAD] + a.extent
    else:  # continue with the edge spacing, as the grid's halos do
        k = jnp.arange(1, _PAD + 1, dtype=P.dtype)
        lo = P[0] - (P[1] - P[0]) * k[::-1]
        hi = P[-1] + (P[-1] - P[-2]) * k
    tables = _build_tables(jnp.concatenate([lo, P, hi]), to_f)
    cut = lambda x: x[_PAD:_PAD + len(P)]
    return {side: [(cut(d), [cut(c) for c in cj], voff, kind)
                   for d, cj, voff, kind in per_r]
            for side, per_r in tables.items()}


#: nodes added on each side before the tables are built: the widest
#: stencil reaches three nodes past its target
_PAD = 3
