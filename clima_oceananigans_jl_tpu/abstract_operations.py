"""Lazy operations over fields: the diagnostics expression DAG.

Array re-design of the reference's src/AbstractOperations/
(AbstractOperations.jl:33, at.jl, computed_field.jl:35-84,
metric_field_reductions.jl): an expression tree of
Unary/Binary/Derivative/KernelFunction operations over ``Field``s, with
automatic 2-point interpolation to a common staggered location (the
``@at`` machinery). Under JAX the "kernel fusion" the reference gets
from inlining ``operand[i,j,k]`` falls out of XLA: ``compute`` traces
the whole tree into one fused expression.

Usage:
    u, v = model.fields(state)["u"], model.fields(state)["v"]
    omega = partial_x(v) - partial_y(u)        # lazy, at (F,F,C)
    field = compute(omega, grid)               # materialized Field
    Average(omega, dims=(0, 1)).compute(grid)  # metric-weighted
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import jax.numpy as jnp

from .fields.field import Field
from .ops import operators as op
from .ops.operators import flip_loc, interp_to
from .utils.location import C, CENTER, F


class Operand:
    """Mixin giving expression-building operators to fields/operations."""

    def __add__(self, other):
        return BinaryOperation(jnp.add, self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return BinaryOperation(jnp.subtract, self, other)

    def __rsub__(self, other):
        return BinaryOperation(jnp.subtract, other, self)

    def __mul__(self, other):
        return BinaryOperation(jnp.multiply, self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return BinaryOperation(jnp.divide, self, other)

    def __rtruediv__(self, other):
        return BinaryOperation(jnp.divide, other, self)

    def __pow__(self, n):
        return UnaryOperation(lambda a: a ** n, self)

    def __neg__(self):
        return UnaryOperation(jnp.negative, self)


@dataclasses.dataclass
class FieldOperand(Operand):
    field: Field

    @property
    def loc(self):
        return self.field.loc

    def evaluate(self, grid):
        return self.field.data


def _wrap(x):
    if isinstance(x, Field):
        return FieldOperand(x)
    if isinstance(x, Operand):
        return x
    return ConstantOperand(x)


@dataclasses.dataclass
class ConstantOperand(Operand):
    value: Any
    loc: tuple = CENTER

    def evaluate(self, grid):
        return jnp.asarray(self.value, grid.dtype)


@dataclasses.dataclass
class UnaryOperation(Operand):
    fn: Callable
    a: Any

    def __post_init__(self):
        self.a = _wrap(self.a)

    @property
    def loc(self):
        return self.a.loc

    def evaluate(self, grid):
        return self.fn(self.a.evaluate(grid))


@dataclasses.dataclass
class BinaryOperation(Operand):
    """fn(a, b) with b auto-interpolated to a's location (at.jl)."""

    fn: Callable
    a: Any
    b: Any
    target_loc: Optional[tuple] = None

    def __post_init__(self):
        self.a = _wrap(self.a)
        self.b = _wrap(self.b)

    @property
    def loc(self):
        if self.target_loc is not None:
            return self.target_loc
        if isinstance(self.a, ConstantOperand):
            return self.b.loc
        return self.a.loc

    def evaluate(self, grid):
        loc = self.loc
        av = self.a.evaluate(grid)
        bv = self.b.evaluate(grid)
        if not isinstance(self.a, ConstantOperand) and self.a.loc != loc:
            av = interp_to(av, self.a.loc, loc)
        if not isinstance(self.b, ConstantOperand) and self.b.loc != loc:
            bv = interp_to(bv, self.b.loc, loc)
        return self.fn(av, bv)


@dataclasses.dataclass
class GridMetric(Operand):
    """A grid metric as an expression operand (reference
    AbstractOperations/grid_metrics.jl: Δx/Δy/Δz/Az/volume used like
    fields, e.g. ``Integral(c * GridMetric('volume'))``). ``metric`` is
    one of dx, dy, dz, Ax, Ay, Az, volume."""

    metric: str
    at_loc: tuple = CENTER

    @property
    def loc(self):
        return self.at_loc

    def evaluate(self, grid):
        fn = {"dx": grid.dx, "dy": grid.dy, "dz": grid.dz, "Ax": grid.Ax,
              "Ay": grid.Ay, "Az": grid.Az, "volume": grid.V}[self.metric]
        return jnp.broadcast_to(fn(self.at_loc), grid.total_shape)


@dataclasses.dataclass
class MultiaryOperation(Operand):
    """fn(*args) with every argument auto-interpolated to a common
    location (reference AbstractOperations multiary_operations.jl,
    e.g. `+(a, b, c...)` at a target location)."""

    fn: Callable
    args: tuple
    target_loc: Optional[tuple] = None

    def __post_init__(self):
        self.args = tuple(_wrap(a) for a in self.args)

    @property
    def loc(self):
        if self.target_loc is not None:
            return self.target_loc
        for a in self.args:
            if not isinstance(a, ConstantOperand):
                return a.loc
        return CENTER

    def evaluate(self, grid):
        loc = self.loc
        vals = []
        for a in self.args:
            v = a.evaluate(grid)
            if not isinstance(a, ConstantOperand) and a.loc != loc:
                v = interp_to(v, a.loc, loc)
            vals.append(v)
        return self.fn(*vals)


@dataclasses.dataclass
class Derivative(Operand):
    a: Any
    axis: int

    def __post_init__(self):
        self.a = _wrap(self.a)

    @property
    def loc(self):
        return flip_loc(self.a.loc, self.axis)

    def evaluate(self, grid):
        return op.dd(self.a.evaluate(grid), grid, self.axis, self.a.loc)


def partial_x(f):
    """∂x at the flipped location (reference ∂x)."""
    return Derivative(f, 0)


def partial_y(f):
    return Derivative(f, 1)


def partial_z(f):
    return Derivative(f, 2)


@dataclasses.dataclass
class AtOperation(Operand):
    """Interpolate an operand to an explicit location (reference @at)."""

    a: Any
    target: tuple

    def __post_init__(self):
        self.a = _wrap(self.a)

    @property
    def loc(self):
        return self.target

    def evaluate(self, grid):
        return interp_to(self.a.evaluate(grid), self.a.loc, self.target)


def at(loc, f):
    return AtOperation(f, tuple(loc))


@dataclasses.dataclass
class KernelFunctionOperation(Operand):
    """User lambda of (grid, *args) → with-halo array at `loc`
    (reference kernel_function_operation.jl)."""

    fn: Callable
    loc: tuple = CENTER
    args: tuple = ()

    def evaluate(self, grid):
        return self.fn(grid, *self.args)


@dataclasses.dataclass
class ConditionalOperation(Operand):
    """where(cond, operand, other) (reference conditional_operations.jl)."""

    a: Any
    cond: Any
    other: Any = 0.0

    def __post_init__(self):
        self.a = _wrap(self.a)

    @property
    def loc(self):
        return self.a.loc

    def evaluate(self, grid):
        cond = self.cond(grid) if callable(self.cond) else self.cond
        return jnp.where(cond, self.a.evaluate(grid), self.other)


def compute(operand, grid, bcs=None, t=0.0):
    """Materialize an operation into a Field with filled halos
    (reference computed_field.jl Field(op) + compute!)."""
    from .boundary_conditions.bcs import fill_halos, regularize_bcs
    operand = _wrap(operand)
    data = jnp.broadcast_to(operand.evaluate(grid), grid.total_shape)
    bcs = regularize_bcs(grid, operand.loc, bcs)
    data = fill_halos(data, grid, operand.loc, bcs, t)
    return Field(data, operand.loc, bcs)


@dataclasses.dataclass
class Average:
    """Metric-weighted mean over dims (reference metric_field_reductions.jl)."""

    operand: Any
    dims: tuple = (0, 1, 2)

    def compute(self, grid):
        from .fields.field import average
        f = compute(self.operand, grid)
        return average(f, grid, self.dims)


@dataclasses.dataclass
class Integral:
    operand: Any
    dims: tuple = (0, 1, 2)

    def compute(self, grid):
        from .fields.field import integral
        f = compute(self.operand, grid)
        return integral(f, grid, self.dims)
