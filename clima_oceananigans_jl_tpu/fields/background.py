"""Background fields: a fixed (optionally time-dependent) environment the
prognostic fields perturb.

Array re-design of the reference's src/Fields/background_fields.jl
(BackgroundField :18-49): instead of per-point kernel closures, a
``BackgroundField`` is materialized as a whole with-halo array at the
prognostic field's staggered location each time the tendencies are
traced — a time-independent function constant-folds to a baked-in array
under jit, while a ``t``-dependent one re-evaluates with the traced clock
so it stays a single compiled step.
"""
from __future__ import annotations

import jax.numpy as jnp


class BackgroundField:
    """``BackgroundField(func, parameters=None)`` with
    ``func(x, y, z, t)`` (or ``func(x, y, z, t, parameters)`` when
    ``parameters`` is given), evaluated on the model grid at the matching
    field's location. Pass in a model's ``background_fields`` dict:

        B = BackgroundField(lambda x, y, z, t, N: N**2 * z, parameters=N)
        model = NonhydrostaticModel(..., background_fields={"b": B})
    """

    def __init__(self, func, parameters=None):
        self.func = func
        self.parameters = parameters

    def evaluate(self, grid, loc, t=0.0):
        x, y, z = grid.nodes(loc, with_halo=True)
        if self.parameters is not None:
            val = self.func(x, y, z, t, self.parameters)
        else:
            val = self.func(x, y, z, t)
        return jnp.broadcast_to(jnp.asarray(val, grid.dtype),
                                grid.total_shape).astype(grid.dtype)

    def __repr__(self):
        return (f"BackgroundField({getattr(self.func, '__name__', self.func)}"
                + (f", parameters={self.parameters!r})"
                   if self.parameters is not None else ")"))


def materialize_background(background_fields, grid, locs, t):
    """name -> with-halo array, evaluating BackgroundField entries at `t`.
    Plain callables are treated as ``f(x, y, z, t)`` (the reference's
    regularize_background_field, background_fields.jl:49); arrays pass
    through."""
    from ..utils.location import CENTER
    out = {}
    for name, f in (background_fields or {}).items():
        if callable(f) and not isinstance(f, BackgroundField):
            f = BackgroundField(f)
        if isinstance(f, BackgroundField):
            out[name] = f.evaluate(grid, locs.get(name, CENTER), t)
        else:
            out[name] = f
    return out
