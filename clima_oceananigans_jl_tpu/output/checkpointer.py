"""Checkpointer: exact-restart snapshots of the full state pytree.

Port of the reference's src/OutputWriters/checkpointer.jl:9-100 +
Simulations/run.jl:60-91 pickup logic: snapshots include the prognostic
solution, the clock, AND the AB2 tendency history (G_prev, previous_dt),
so a restarted run continues bit-identically (verified by
test_checkpointer-style tests). Storage is one ``.npz`` per checkpoint
with flattened pytree paths as keys — no external deps, works for every
model's state dict.
"""
from __future__ import annotations

import glob
import os
import re

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.schedules import IterationInterval


def _flatten_state(state):
    flat = {}

    def rec(prefix, obj):
        if isinstance(obj, dict):
            for k, v in obj.items():
                rec(f"{prefix}/{k}", v)
        elif hasattr(obj, "time") and hasattr(obj, "iteration"):  # Clock
            flat[f"{prefix}/__clock_time"] = np.asarray(obj.time)
            flat[f"{prefix}/__clock_iteration"] = np.asarray(obj.iteration)
        else:
            flat[prefix] = np.asarray(obj)

    rec("state", state)
    return flat


def _unflatten_state(template, flat):
    from ..timesteppers.steppers import Clock

    def rec(prefix, obj):
        if isinstance(obj, dict):
            return {k: rec(f"{prefix}/{k}", v) for k, v in obj.items()}
        if hasattr(obj, "time") and hasattr(obj, "iteration"):
            return Clock(jnp.asarray(flat[f"{prefix}/__clock_time"]),
                         jnp.asarray(flat[f"{prefix}/__clock_iteration"]),
                         getattr(obj, "stage", 0))
        return jnp.asarray(flat[prefix])

    return rec("state", template)


class Checkpointer:
    """Writes `{prefix}_iteration{i}.npz` on a schedule; keeps `keep` files."""

    def __init__(self, schedule=None, dir=".", prefix="checkpoint", keep=2,
                 verbose=False):
        self.schedule = schedule or IterationInterval(1000)
        self.dir = dir
        self.prefix = prefix
        self.keep = keep
        self.verbose = verbose
        os.makedirs(dir, exist_ok=True)

    def checkpoint_path(self, iteration):
        return os.path.join(self.dir, f"{self.prefix}_iteration{iteration}.npz")

    def __call__(self, sim):
        self.write(sim)

    def write(self, sim):
        it = sim.model_iteration()
        path = self.checkpoint_path(it)
        np.savez(path, **_flatten_state(sim.state))
        if self.keep:
            existing = sorted(self._all(), key=self._iter_of)
            for old in existing[:-self.keep]:
                os.remove(old)

    def _all(self):
        return glob.glob(os.path.join(self.dir, f"{self.prefix}_iteration*.npz"))

    @staticmethod
    def _iter_of(path):
        m = re.search(r"_iteration(\d+)\.npz$", path)
        return int(m.group(1)) if m else -1

    def latest(self):
        paths = self._all()
        return max(paths, key=self._iter_of) if paths else None


def restore_state(template_state, path):
    """Load a checkpoint into the structure of `template_state`. Files
    written by older versions may record a ``__state_layout``: the
    natural (x, y, z) layout is the only one this version stores, and a
    file recording the transposed (x, z, y) layout is refused."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    layout = str(flat.pop("__state_layout", "natural"))
    if layout != "natural":
        raise ValueError(
            f"{path} stores its 3D fields in the {layout!r} layout; only "
            "checkpoints in the natural (x, y, z) layout can be restored")
    return _unflatten_state(template_state, flat)


def pickup_latest(sim, pickup=True):
    """Resolve + restore the latest checkpoint (run.jl:60-91). `pickup`
    may be True (latest), an iteration number, or an explicit path."""
    ckps = [w for w in sim.output_writers.values() if isinstance(w, Checkpointer)]
    if not ckps:
        return False
    ckp = ckps[0]
    if pickup is True:
        path = ckp.latest()
    elif isinstance(pickup, (int, np.integer)):
        path = ckp.checkpoint_path(int(pickup))
    else:
        path = pickup
    if path is None or not os.path.exists(path):
        return False
    sim.state = restore_state(sim.state, path)
    return True
