"""Ensemble batching: vmap over a leading member axis.

Array replacement for the reference's ``slice_ensemble_model_mode.jl``
and ``single_column_model_mode.jl`` (ensemble×y×z grids for parameter
calibration): instead of packing members into a spatial axis, the state
pytree gains a leading member axis and the whole jitted step is ``vmap``ed
— XLA batches every kernel across members with zero model changes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def stack_states(states):
    """List of per-member states → one batched state (leading member axis)."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def member(batched_state, i):
    """Extract member i from a batched state."""
    return jax.tree_util.tree_map(lambda x: x[i], batched_state)


def ensemble_step(model, dt_per_member=False):
    """vmapped ``model.step``. With ``dt_per_member`` each member has its
    own Δt (a (M,) array); otherwise Δt is shared."""
    in_axes = (0, 0 if dt_per_member else None)
    return jax.jit(jax.vmap(model.step, in_axes=in_axes))


def ensemble_initial_state(model, members):
    """Build a batched state from per-member init kwargs.

    `members`: list of dicts passed to ``model.initial_state``."""
    return stack_states([model.initial_state(**kw) for kw in members])
