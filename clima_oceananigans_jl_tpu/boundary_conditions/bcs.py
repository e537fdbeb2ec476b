"""Boundary conditions and halo filling.

Array re-design of the reference's src/BoundaryConditions/:

* BC classifications Flux / Value (Dirichlet) / Gradient (Neumann) /
  Open / Periodic / Communication
  (boundary_condition_classifications.jl:1-68) become a small pytree
  ``BC(kind, value)`` whose ``kind`` is static and whose ``value`` may be
  a scalar, a boundary-plane array, or a callable evaluated on boundary
  nodes — so user conditions trace into the jitted step.
* ``fill_halos`` replaces ``fill_halo_regions!``
  (fill_halo_regions.jl:34-95): one functional pass of ``.at[]`` updates
  with static slices; periodic sides are wrap copies, bounded sides use
  mirror ghost-cell formulas exact on stretched grids (distances taken
  from the coordinate arrays).
* Flux BCs contribute to tendencies via ``apply_flux_bcs`` (sign
  convention of apply_flux_bcs.jl:95-160: positive left-boundary flux
  increases G in the adjacent cell, positive right-boundary flux
  decreases it).
* ``FULLY_CONNECTED`` axes (device-sharded sides) are skipped here; the
  distributed halo exchange (parallel/halo_exchange.py) fills them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..grids.topology import BOUNDED, FLAT, FULLY_CONNECTED, PERIODIC
from ..utils.location import C, F


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class BC:
    """One side's boundary condition. `kind` is static; `value` traces.
    ``discrete=True`` marks a field-dependent flux: ``value(grid, clock,
    fields) -> full-shape flux array`` (the reference's
    discrete_form/field_dependencies boundary functions, e.g. quadratic
    bottom drag q = -Cd |u| u)."""

    kind: str  # periodic | value | gradient | flux | open | communication
    value: Any = None
    discrete: bool = False

    def tree_flatten(self):
        if callable(self.value):
            return (), (self.kind, self.value, self.discrete)
        return (self.value,), (self.kind, None, self.discrete)

    @classmethod
    def tree_unflatten(cls, static, leaves):
        kind, fn, discrete = static
        return cls(kind, fn if fn is not None else leaves[0], discrete)


def Periodic():
    return BC("periodic")


def ValueBC(v):
    return BC("value", v)


def GradientBC(g):
    return BC("gradient", g)


def FluxBC(q=None, discrete=False):
    return BC("flux", q, discrete)


def OpenBC(v=0.0):
    return BC("open", v)


def CommunicationBC():
    return BC("communication")


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FieldBCs:
    """Per-side BCs for one field: (west, east, south, north, bottom, top)."""

    west: Optional[BC] = None
    east: Optional[BC] = None
    south: Optional[BC] = None
    north: Optional[BC] = None
    bottom: Optional[BC] = None
    top: Optional[BC] = None
    immersed: Any = None  # used by ImmersedBoundaryCondition

    def sides(self):
        return ((0, 0, self.west), (0, 1, self.east),
                (1, 0, self.south), (1, 1, self.north),
                (2, 0, self.bottom), (2, 1, self.top))

    def tree_flatten(self):
        return ((self.west, self.east, self.south, self.north,
                 self.bottom, self.top, self.immersed), ())

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves)


def default_bcs(grid, loc):
    """Defaults mirroring the reference's regularization: periodic on
    periodic axes; zero-flux for fields centered on a bounded axis;
    impenetrable (open, 0) for the wall-normal face-located component."""
    sides = {}
    names = (("west", "east"), ("south", "north"), ("bottom", "top"))
    for axis in range(3):
        topo = grid.topology[axis]
        dist = getattr(grid, "dist", (None, None, None))[axis]
        if topo is FULLY_CONNECTED and dist is not None:
            # distributed axis: defaults follow the GLOBAL topology (used
            # by edge shards after the neighbor exchange)
            topo = dist[2]
        for s in range(2):
            if topo is FLAT:
                bc = None
            elif topo is PERIODIC:
                bc = Periodic()
            elif topo is FULLY_CONNECTED:
                bc = CommunicationBC()
            elif loc[axis] is F:
                bc = OpenBC(0.0)
            else:
                bc = FluxBC()
            sides[names[axis][s]] = bc
    return FieldBCs(**sides)


def regularize_bcs(grid, loc, bcs=None):
    """Merge user BCs over the defaults (reference field_boundary_conditions.jl)."""
    out = default_bcs(grid, loc)
    if bcs is None:
        return out
    for name in ("west", "east", "south", "north", "bottom", "top", "immersed"):
        user = getattr(bcs, name, None)
        if user is not None:
            setattr(out, name, user)
    return out


def _bvalue(bc, grid, axis, side, loc, t):
    """Evaluate a BC's value on the boundary plane → broadcastable array/scalar."""
    v = bc.value
    if v is None:
        return jnp.zeros((), grid.dtype)
    if callable(v):
        nodes = list(grid.nodes(loc, with_halo=True))
        a = grid._axes[axis]
        # boundary position: left face (index h) or right face (index h+n, h ≥ 1)
        nodes[axis] = a.cf[a.h] if side == 0 else a.cf[a.h + a.n]
        coords = [nodes[i] for i in range(3) if i != axis]
        return v(*coords, t)
    v = jnp.asarray(v, grid.dtype)
    if v.ndim == 2:  # boundary-plane array on interior points → pad to halo shape
        full = list(grid.total_shape)
        plane_axes = [i for i in range(3) if i != axis]
        pads = []
        for i, ax in enumerate(plane_axes):
            h = grid.halo[ax]
            pads.append((h, full[ax] - h - v.shape[i]))
        v = jnp.pad(v, pads)
        shape = [1, 1, 1]
        for i, ax in enumerate(plane_axes):
            shape[ax] = full[ax]
        return v.reshape(shape)
    return v


def _axslice(data, axis, idx):
    sl = [slice(None)] * data.ndim  # rank-agnostic (2D free-surface fields)
    sl[axis] = idx
    return tuple(sl)


def _mirror_slab(data, axis, interior_idx):
    """Gather the mirror layers for a whole ghost slab in one op (a flip
    of a contiguous range when no clamping is needed, else a gather)."""
    idx = list(interior_idx)
    rev = list(reversed(idx))
    if rev == list(range(rev[0], rev[0] + len(rev))):  # contiguous descending
        sl = [slice(None)] * data.ndim
        sl[axis] = slice(rev[0], rev[0] + len(rev))
        return jnp.flip(data[tuple(sl)], axis=axis)
    return jnp.take(data, jnp.asarray(idx), axis=axis)


def _layer_shape(data, axis, n):
    shape = list(data.shape)
    shape[axis] = n
    return tuple(shape)


def _bounded_slab(data, grid, loc, axis, side, bc, t=0.0):
    """(slab, cut) for one bounded side: `slab` replaces array indices
    [0:cut) (side 0) or [cut:end) (side 1). slab=None → nothing to write."""
    N = grid.shape[axis]
    H = grid.halo[axis]
    ax = grid._axes[axis]
    face_loc = loc[axis] is F
    if bc is None or bc.kind in ("communication", "periodic"):
        return None, (H if side == 0 else H + N + (1 if face_loc else 0))
    kind = bc.kind
    # flux BCs fill by zero-gradient mirror and enter the tendency via
    # apply_flux_bcs — never evaluate their value here (a discrete-form
    # flux callable has the signature (grid, clock, fields), not (x,y,t))
    b = None if kind == "flux" else _bvalue(bc, grid, axis, side, loc, t)
    clampc = lambda i: min(max(i, H), H + N - 1)

    if not face_loc:
        if side == 0:
            ghosts = list(range(0, H))
            mirrors = [clampc(2 * H - 1 - g) for g in ghosts]
            cut = H
        else:
            ghosts = list(range(H + N, H + N + H))
            mirrors = [clampc(2 * (H + N) - 1 - g) for g in ghosts]
            cut = H + N
        slab = _mirror_slab(data, axis, mirrors)
        if kind == "value":
            slab = 2.0 * b - slab
        elif kind == "gradient":
            cc = ax.cc
            # ghost = mirror − b·(c_mirror − c_ghost) on the left;
            #       = mirror + b·(c_ghost − c_mirror) on the right
            dist = jnp.stack([cc[m] - cc[g] for g, m in zip(ghosts, mirrors)])
            shape = [1] * data.ndim  # rank-agnostic (2D free-surface fields)
            shape[axis] = H
            dist = dist.reshape(shape)
            slab = slab - b * dist
        # flux/default: zero-gradient mirror (slab as is)
        return jnp.broadcast_to(slab, _layer_shape(data, axis, H)), cut

    # face-located: boundary face at H (left) / H+N (right)
    bidx = H if side == 0 else H + N
    lo, hi = H, H + N
    if side == 0:
        ghosts = list(range(0, H))
    else:
        ghosts = list(range(bidx + 1, bidx + H))
    mirrors = [min(max(2 * bidx - g, lo), hi) for g in ghosts]
    if kind in ("open", "value"):
        bf = jnp.broadcast_to(b, _layer_shape(data, axis, 1))
        ghost = ((2.0 * b - _mirror_slab(data, axis, mirrors))
             if ghosts else None)
        if side == 0:
            parts = ([jnp.broadcast_to(ghost, _layer_shape(data, axis, len(ghosts))), bf]
                     if ghost is not None else [bf])
            return jnp.concatenate(parts, axis=axis), H + 1
        parts = ([bf, jnp.broadcast_to(ghost, _layer_shape(data, axis, len(ghosts)))]
                 if ghost is not None else [bf])
        return jnp.concatenate(parts, axis=axis), H + N
    # flux/default: zero-gradient mirror about the (untouched) boundary face
    if not ghosts:
        return None, (H if side == 0 else H + N + 1)
    slab = jnp.broadcast_to(_mirror_slab(data, axis, mirrors),
                            _layer_shape(data, axis, len(ghosts)))
    return slab, (H if side == 0 else H + N + 1)


def _fill_bounded_side(data, grid, loc, axis, side, bc, t=0.0):
    """Full-array single-side fill (used by the distributed edge overlay)."""
    slab, cut = _bounded_slab(data, grid, loc, axis, side, bc, t)
    if slab is None:
        return data
    sl = [slice(None)] * data.ndim
    if side == 0:
        sl[axis] = slice(cut, None)
        return jnp.concatenate([slab, data[tuple(sl)]], axis=axis)
    sl[axis] = slice(0, cut)
    return jnp.concatenate([data[tuple(sl)], slab], axis=axis)


def fill_halos_axis(data, grid, loc, axis, bc_left, bc_right, t=0.0):
    topo = grid.topology[axis]
    if topo is FLAT:
        return data
    N = grid.shape[axis]
    H = grid.halo[axis]
    S = lambda idx: _axslice(data, axis, idx)

    if topo in (PERIODIC,):
        # two in-place slab updates: XLA aliases the buffer and touches
        # only the halo slabs, where a concat re-materializes the whole
        # array
        data = data.at[S(slice(0, H))].set(data[S(slice(N, N + H))])
        return data.at[S(slice(N + H, N + 2 * H))].set(data[S(slice(H, 2 * H))])
    if topo is FULLY_CONNECTED:
        dist = getattr(grid, "dist", (None, None, None))[axis]
        if dist is None:
            return data  # filled by an external (multi-region) exchange
        from ..parallel.halo_exchange import exchange_axis, select_edge
        mesh_axis, n_shards, global_topo = dist
        data = exchange_axis(data, axis, H, mesh_axis, n_shards,
                             global_topo is PERIODIC)
        if global_topo is not PERIODIC:
            left = _fill_bounded_side(data, grid, loc, axis, 0, bc_left, t)
            data = select_edge(data, left, mesh_axis, n_shards, 0)
            right = _fill_bounded_side(data, grid, loc, axis, 1, bc_right, t)
            data = select_edge(data, right, mesh_axis, n_shards, 1)
        return data

    # bounded: in-place slab writes (both slabs computed from the
    # pre-update data; see the periodic branch for why not concat)
    left, cut0 = _bounded_slab(data, grid, loc, axis, 0, bc_left, t)
    right, cut1 = _bounded_slab(data, grid, loc, axis, 1, bc_right, t)
    if left is not None:
        data = data.at[S(slice(0, cut0))].set(left)
    if right is not None:
        data = data.at[S(slice(cut1, data.shape[axis]))].set(right)
    return data


def impose_cut_wall_faces(data, grid, loc, bcs=None, t=0.0):
    """The communication-free, interior-visible part of a cut-axis halo
    fill: re-impose open/value wall-FACE values on FULLY_CONNECTED axes
    whose global topology is bounded. The side-0 boundary face sits at
    interior index H — the only fill effect inside the interior region —
    so the halo-overlap deferred ``update_state`` applies just this
    (slab-sized writes gated on ``lax.axis_index``, no ppermutes) to keep
    post-step states bit-identical to the plain step's interiors."""
    from jax import lax
    if bcs is None:
        bcs = default_bcs(grid, loc)
    pairs = ((bcs.west, bcs.east), (bcs.south, bcs.north),
             (bcs.bottom, bcs.top))
    for axis in (0, 1, 2):
        if grid.topology[axis] is not FULLY_CONNECTED or loc[axis] is not F:
            continue
        dist = getattr(grid, "dist", (None, None, None))[axis]
        if dist is None:
            continue
        mesh_axis, n_shards, global_topo = dist
        if global_topo is PERIODIC:
            continue
        N, H = grid.shape[axis], grid.halo[axis]
        for side, bc in ((0, pairs[axis][0]), (1, pairs[axis][1])):
            if bc is None or bc.kind not in ("open", "value"):
                continue
            b = _bvalue(bc, grid, axis, side, loc, t)
            sl = [slice(None)] * data.ndim
            sl[axis] = slice(H if side == 0 else H + N,
                             (H if side == 0 else H + N) + 1)
            sl = tuple(sl)
            idx = lax.axis_index(mesh_axis)
            is_edge = (idx == 0) if side == 0 else (idx == n_shards - 1)
            slab = jnp.where(is_edge,
                             jnp.broadcast_to(jnp.asarray(b, data.dtype),
                                              data[sl].shape),
                             data[sl])
            data = data.at[sl].set(slab)
    return data


def fill_halos(data, grid, loc, bcs=None, t=0.0, axes=(0, 1, 2)):
    """Fill all halo regions of `data`. Periodic axes first (reference
    fill_halo_regions.jl:57-95 ordering) so corner halos end up consistent.
    `axes` restricts the fill (e.g. (0, 1) for z-reduced free-surface
    fields whose array has no z halo)."""
    if bcs is None:
        bcs = default_bcs(grid, loc)
    order = sorted((a for a in axes), key=lambda a: grid.topology[a] is not PERIODIC)
    pairs = ((bcs.west, bcs.east), (bcs.south, bcs.north), (bcs.bottom, bcs.top))
    for axis in order:
        data = fill_halos_axis(data, grid, loc, axis, *pairs[axis], t=t)
    return data


def apply_immersed_flux_bcs(G, grid, loc, bcs, t=0.0, fields=None):
    """Add a user flux through the IMMERSED bottom faces into the
    tendency (reference immersed_boundary_condition.jl — per-face user
    fluxes on the immersed boundary; here the bottom z-face of every
    fluid cell whose lower neighbour is solid, the GridFittedBottom
    surface). Sign convention matches a bottom FluxBC: positive flux
    adds to the field. Register as ``FieldBCs(immersed=FluxBC(q))``;
    q may be a constant, ``q(x, y, z, t)`` evaluated at cell centers
    along the boundary, or (``FluxBC(fn, discrete=True)``)
    ``fn(grid, t, fields)`` for field-dependent fluxes like bottom
    drag."""
    bc = getattr(bcs, "immersed", None)
    imm = getattr(grid, "immersed", None)
    if bc is None or imm is None:
        return G
    if bc.kind != "flux":
        raise ValueError("immersed boundary conditions support flux form "
                         "(the reference's ImmersedBoundaryCondition fluxes)")
    solid = imm.mask_for(tuple(loc))
    # fluid cell whose k−1 neighbour is solid → its bottom face is the
    # immersed boundary
    at_bottom = (~solid) & jnp.roll(solid, 1, axis=2)
    if bc.discrete and callable(bc.value):
        q = jnp.asarray(bc.value(grid, t, fields or {}), G.dtype)
    elif callable(bc.value):
        x, y, z = grid.nodes(loc, with_halo=True)
        q = jnp.asarray(bc.value(x, y, z, t), G.dtype)
    else:
        q = jnp.asarray(bc.value, G.dtype)
    contrib = q * grid.Az(loc) / grid.V(loc)
    return jnp.where(at_bottom, G + contrib, G)


def apply_flux_bcs(G, grid, loc, bcs, t=0.0, fields=None):
    """Add boundary-flux divergences into the tendency G (interior-sized
    contribution at the first/last interior cell of each bounded axis)."""
    if bcs is None:
        return G
    areas = (grid.Ax, grid.Ay, grid.Az)
    from ..ops.operators import flip_loc
    for axis, side, bc in bcs.sides():
        if bc is None or bc.kind != "flux" or bc.value is None:
            continue
        if grid.topology[axis] is not BOUNDED:
            continue
        N, H = grid.shape[axis], grid.halo[axis]
        i = H if side == 0 else H + N - 1
        if bc.discrete and callable(bc.value):
            # field-dependent flux (reference discrete_form BCs): the
            # function returns a full-shape array; take the boundary cell
            qf = jnp.asarray(bc.value(grid, t, fields or {}), G.dtype)
            q = qf[_axslice(qf, axis, i)]
        else:
            q = _bvalue(bc, grid, axis, side, loc, t)
        A = areas[axis](flip_loc(loc, axis))
        Vol = grid.V(loc)
        # pick the boundary-face metric / cell volume at the boundary cell
        bf = H if side == 0 else H + N
        Ab = A[_axslice(A, axis, min(bf, A.shape[axis] - 1))] if A.shape[axis] > 1 else A[_axslice(A, axis, 0)]
        Vb = Vol[_axslice(Vol, axis, i)] if Vol.shape[axis] > 1 else Vol[_axslice(Vol, axis, 0)]
        if hasattr(q, "ndim") and q.ndim == 3:
            q = q[_axslice(q, axis, 0)]
        contrib = q * Ab / Vb
        sgn = 1.0 if side == 0 else -1.0
        G = G.at[_axslice(G, axis, i)].add(sgn * contrib)
    return G
