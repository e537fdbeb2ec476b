"""Step compilation: the one place a model's step is jitted.

``compile_step(model, donate=False)`` returns ``jax.jit(model.step)``
with the persistent compilation cache enabled. ``donate=True`` donates
the incoming state's buffers to the step's output, so a caller that
keeps no reference to the old state holds the state once instead of
twice.
"""
from __future__ import annotations

import jax


def compile_step(model, donate=False):
    """Jitted ``model.step(state, dt)``; donates ``state`` when asked."""
    from ..utils.compile_cache import enable_persistent_cache
    enable_persistent_cache()
    return jax.jit(model.step, donate_argnums=0 if donate else ())
