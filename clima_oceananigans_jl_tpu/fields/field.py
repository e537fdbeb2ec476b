"""Fields: located arrays with halos and boundary conditions.

Array re-design of the reference's src/Fields/field.jl:16-30. A ``Field``
is a small pytree of ``(data, bcs)`` with static location ``loc``; the
grid is NOT stored in the field (models hold one grid; functions take it
explicitly) so jitted signatures stay small. ``data`` always includes
halos (shape ``grid.total_shape``).

``set`` mirrors the reference's ``set!`` (src/Fields/set!.jl): accepts a
scalar, an interior-shaped array, a with-halo array, or a callable
``f(x, y, z)`` evaluated on the field's nodes; halos are filled after.
Reductions are metric-weighted (src/Fields/field_reductions.jl).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..boundary_conditions.bcs import FieldBCs, fill_halos, regularize_bcs
from ..utils.location import C, CENTER, F, U_LOC, V_LOC, W_LOC


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class Field:
    data: jnp.ndarray
    loc: tuple = CENTER
    bcs: Optional[FieldBCs] = None

    def tree_flatten(self):
        return (self.data, self.bcs), (self.loc,)

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(leaves[0], static[0], leaves[1])

    def interior(self, grid):
        return grid.interior(self.data)

    def with_data(self, data):
        return Field(data, self.loc, self.bcs)

    def filled(self, grid, t=0.0):
        return self.with_data(fill_halos(self.data, grid, self.loc, self.bcs, t))

    # -- lazy expression building (AbstractOperations layer) -----------------
    def _binop(self, fn, other, reverse=False):
        from ..abstract_operations import BinaryOperation
        return (BinaryOperation(fn, other, self) if reverse
                else BinaryOperation(fn, self, other))

    def __add__(self, other):
        return self._binop(jnp.add, other)

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(jnp.subtract, other)

    def __rsub__(self, other):
        return self._binop(jnp.subtract, other, reverse=True)

    def __mul__(self, other):
        return self._binop(jnp.multiply, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(jnp.divide, other)

    def __rtruediv__(self, other):
        return self._binop(jnp.divide, other, reverse=True)

    def __pow__(self, n):
        from ..abstract_operations import UnaryOperation
        return UnaryOperation(lambda a: a ** n, self)

    def __neg__(self):
        from ..abstract_operations import UnaryOperation
        return UnaryOperation(jnp.negative, self)


def regularize_indices(grid, indices):
    """Normalize per-axis window specs (reference Fields/index slicing:
    field.jl `indices` views). Each entry: None/`slice(None)` (full axis),
    an int (single interior index), or a (start, stop) half-open interior
    range. Returns a tuple of `slice`s into the INTERIOR."""
    out = []
    indices = (None, None, None) if indices is None else indices
    for a, ix in enumerate(indices):
        n = grid.shape[a]
        if ix is None or ix == slice(None):
            out.append(slice(0, n))
        elif isinstance(ix, int):
            ix = ix % n
            out.append(slice(ix, ix + 1))
        else:
            start, stop = (ix.start or 0, ix.stop if ix.stop is not None
                           else n) if isinstance(ix, slice) else ix
            out.append(slice(max(0, start), min(n, stop)))
    return tuple(out)


def windowed(field: Field, grid, indices):
    """A windowed view of a field: the reference's
    ``Field(...; indices=(ix, iy, iz))`` (src/Fields/field.jl windowed
    fields). Returns a Field whose data is the interior WINDOW (no
    halos — windowed fields are diagnostic views, the reference also
    refuses to fill their halos) with the window recorded in ``.loc``'s
    companion attribute ``indices`` on the returned object."""
    sl_int = regularize_indices(grid, indices)
    sl = tuple(slice(h + s.start, h + s.stop)
               for h, s in zip(grid.halo, sl_int))
    out = Field(field.data[sl], field.loc, None)
    out.indices = sl_int
    return out


def new_field(grid, loc=CENTER, bcs=None, fill=0.0):
    bcs = regularize_bcs(grid, loc, bcs)
    return Field(jnp.full(grid.total_shape, fill, grid.dtype), loc, bcs)


def CenterField(grid, bcs=None):
    return new_field(grid, CENTER, bcs)


def XFaceField(grid, bcs=None):
    return new_field(grid, U_LOC, bcs)


def YFaceField(grid, bcs=None):
    return new_field(grid, V_LOC, bcs)


def ZFaceField(grid, bcs=None):
    return new_field(grid, W_LOC, bcs)


def set_field(field: Field, grid, value, t=0.0) -> Field:
    """Functional ``set!``: returns a new Field with halos filled.
    Accepts a scalar, interior/with-halo array, callable f(x,y,z),
    another Field, or a lazy AbstractOperation — the last two are the
    reference's broadcasting-onto-fields machinery (``u .= op``,
    src/Fields/broadcasting_abstract_operations.jl): the source is
    materialized and interpolated to this field's location."""
    from ..abstract_operations import Operand, compute
    from ..ops.operators import interp_to
    if isinstance(value, FunctionField):
        value = value.at_time(grid, t)
    if isinstance(value, Operand) and not isinstance(value, Field):
        value = compute(value, grid, t=t)
    if isinstance(value, Field):
        data = value.data
        if value.loc != field.loc:
            data = interp_to(data, value.loc, field.loc)
        return field.with_data(data).filled(grid, t)
    data = field.data
    if callable(value):
        x, y, z = grid.nodes(field.loc, with_halo=True)
        data = jnp.broadcast_to(
            jnp.asarray(value(x, y, z), grid.dtype), data.shape).astype(grid.dtype)
    elif np.isscalar(value) or (hasattr(value, "ndim") and value.ndim == 0):
        data = jnp.full_like(data, value)
    else:
        value = jnp.asarray(value, grid.dtype)
        if value.shape == data.shape:
            data = value
        elif value.shape == grid.shape:
            sl = tuple(slice(h, h + n) for h, n in zip(grid.halo, grid.shape))
            data = data.at[sl].set(value)
        else:
            data = jnp.broadcast_to(value, data.shape).astype(grid.dtype)
    out = field.with_data(data)
    return out.filled(grid, t)


# -- metric-weighted reductions ----------------------------------------------
def _reduction_weight(field, grid, dims):
    """Metric weight along the reduced dims; on an ImmersedGrid, solid
    cells at the field's location get zero weight (reference
    immersed_reductions.jl — reductions see only the fluid)."""
    w = jnp.ones((), grid.dtype)
    metrics = (grid.dx, grid.dy, grid.dz)
    for d in dims:
        w = w * metrics[d](field.loc)
    imm = getattr(grid, "immersed", None)
    if imm is not None:
        w = jnp.where(imm.mask_for(tuple(field.loc)), 0.0, w)
    return w


def integral(field: Field, grid, dims=(0, 1, 2)):
    """∫ f dV over interior (volume-weighted along the reduced dims)."""
    w = _reduction_weight(field, grid, dims)
    integrand = field.data * w
    return jnp.sum(grid.interior(integrand), axis=tuple(dims))


def average(field: Field, grid, dims=(0, 1, 2)):
    w = _reduction_weight(field, grid, dims)
    w = jnp.broadcast_to(w, field.data.shape)
    num = jnp.sum(grid.interior(field.data * w), axis=tuple(dims))
    den = jnp.sum(grid.interior(w), axis=tuple(dims))
    return num / den


def field_norm(field: Field, grid):
    v = grid.interior(field.data)
    return jnp.sqrt(jnp.mean(v * v))


# -- field tuples (reference src/Fields/field_tuples.jl) ----------------------
def VelocityFields(grid, bcs=None):
    bcs = bcs or {}
    return dict(u=XFaceField(grid, bcs.get("u")),
                v=YFaceField(grid, bcs.get("v")),
                w=ZFaceField(grid, bcs.get("w")))


def TracerFields(grid, names, bcs=None):
    bcs = bcs or {}
    return {name: CenterField(grid, bcs.get(name)) for name in names}


# -- interpolation / regridding (reference src/Fields/interpolate.jl, regrid!.jl)
def interpolate(field: Field, grid, x, y, z):
    """Trilinear interpolation of a field at arbitrary points (arrays or
    scalars) — reference `interpolate` (src/Fields/interpolate.jl)."""
    from ..particles.lagrangian import interpolate_field
    xs = jnp.atleast_1d(jnp.asarray(x, grid.dtype))
    ys = jnp.atleast_1d(jnp.asarray(y, grid.dtype))
    zs = jnp.atleast_1d(jnp.asarray(z, grid.dtype))
    out = interpolate_field(field.data, grid, field.loc, xs, ys, zs)
    return out[0] if jnp.ndim(x) == 0 else out


def regrid(field: Field, src_grid, dst_grid, t=0.0) -> Field:
    """Resample a field onto another grid by trilinear interpolation at the
    destination nodes (reference `regrid!`, conservative only for smooth
    fields)."""
    from ..particles.lagrangian import interpolate_field
    x, y, z = dst_grid.nodes(field.loc, with_halo=True)
    shape = dst_grid.total_shape
    X = jnp.broadcast_to(x, shape).ravel()
    Y = jnp.broadcast_to(y, shape).ravel()
    Z = jnp.broadcast_to(z, shape).ravel()
    vals = interpolate_field(field.data, src_grid, field.loc, X, Y, Z)
    out = new_field(dst_grid, field.loc)
    return set_field(out, dst_grid, vals.reshape(shape), t)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class FunctionField:
    """Lazily-evaluated analytic field f(x, y, z[, t]) on a grid location
    (reference src/Fields/function_field.jl); materialize with `.at_time`."""

    func: callable
    loc: tuple = CENTER
    time_dependent: bool = False

    def tree_flatten(self):
        return (), (self.func, self.loc, self.time_dependent)

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*static)

    def at_time(self, grid, t=0.0):
        x, y, z = grid.nodes(self.loc, with_halo=True)
        val = self.func(x, y, z, t) if self.time_dependent else self.func(x, y, z)
        return Field(jnp.broadcast_to(jnp.asarray(val, grid.dtype),
                                      grid.total_shape), self.loc)
