"""Simulation driver: the uncompiled outer loop around the jitted step.

Port of /root/reference/src/Simulations/ (simulation.jl:8-86, run.jl:86-140,
time_step_wizard.jl, nan_checker.jl, callback.jl): schedules, Δt alignment
with stop_time and scheduled activities, callbacks, output writers, NaN
checking, adaptive Δt. Everything here is host-side scalar logic; the only
device work per iteration is one jitted ``model.step`` call (plus any
diagnostics the user's callbacks compute).
"""
from __future__ import annotations

import logging
import time as _time
from collections import OrderedDict

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.schedules import IterationInterval, Schedule, TimeInterval

logger = logging.getLogger("clima_oceananigans_jl_tpu")


class Callback:
    def __init__(self, func, schedule=None):
        self.func = func
        self.schedule = schedule or IterationInterval(1)

    def __call__(self, sim):
        return self.func(sim)


class NaNChecker:
    """Stops the run when a monitored field goes NaN (reference
    Simulations/nan_checker.jl:4-63; auto-installed every 100 iterations)."""

    def __init__(self, fields=("h", "u", "w"), erroring=False):
        self.fields = fields
        self.erroring = erroring

    def __call__(self, sim):
        sol = sim.state["solution"] if "solution" in sim.state else sim.state.get("fields", {})
        for name in self.fields:
            if name in sol and bool(jnp.any(~jnp.isfinite(sol[name]))):
                msg = (f"time = {sim.model_time():.6g}, iteration = "
                       f"{sim.model_iteration()}: NaN found in field {name}. Aborting simulation.")
                if self.erroring:
                    raise FloatingPointError(msg)
                logger.error(msg)
                sim.running = False
                return


class TimeStepWizard:
    """Adaptive Δt targeting a CFL number (reference time_step_wizard.jl:4-70)."""

    def __init__(self, cfl=0.2, diffusive_cfl=np.inf, max_change=1.1,
                 min_change=0.5, max_dt=np.inf, min_dt=0.0):
        self.cfl = cfl
        self.diffusive_cfl = diffusive_cfl
        self.max_change = max_change
        self.min_change = min_change
        self.max_dt = max_dt
        self.min_dt = min_dt

    def __call__(self, sim):
        new_dt = self.cfl * float(sim.model.cell_advection_timescale(sim.state))
        if np.isfinite(self.diffusive_cfl):
            # clamp by the diffusion timescale too (reference
            # time_step_wizard.jl:44-52 new_time_step)
            diff_scale = float(sim.model.cell_diffusion_timescale(sim.state))
            new_dt = min(new_dt, self.diffusive_cfl * diff_scale)
        new_dt = min(self.max_change * sim.dt, new_dt)
        new_dt = max(self.min_change * sim.dt, new_dt)
        sim.dt = float(np.clip(new_dt, self.min_dt, self.max_dt))


class Simulation:
    """run!-style driver (reference Simulations/run.jl)."""

    def __init__(self, model, state=None, dt=None, stop_iteration=np.inf,
                 stop_time=np.inf, wall_time_limit=np.inf, verbose=False):
        if dt is None:
            raise ValueError("Simulation requires dt")
        self.model = model
        self.state = state if state is not None else model.initial_state()
        self.dt = float(dt)
        self.stop_iteration = stop_iteration
        self.stop_time = stop_time
        self.wall_time_limit = wall_time_limit
        self.callbacks = OrderedDict()
        self.output_writers = OrderedDict()
        self.diagnostics = OrderedDict()
        self.running = True
        self.initialized = False
        self.run_wall_time = 0.0
        self.verbose = verbose
        self.callbacks["nan_checker"] = Callback(NaNChecker(self._default_nan_fields()),
                                                 IterationInterval(100))
        from ..models.compile import compile_step
        self._compiled_step = compile_step(model)

    def _default_nan_fields(self):
        # monitor every prognostic field (reference nan_checker.jl checks a
        # field set, default all velocities+tracers); one fused jnp.isnan
        # reduction per field is cheap at the 100-iteration cadence
        return getattr(self.model, "prognostic_names", lambda: ())()

    # -- clock access ---------------------------------------------------------
    def model_time(self):
        return float(self.state["clock"].time)

    def model_iteration(self):
        return int(self.state["clock"].iteration)

    # -- stop criteria ----------------------------------------------------------
    def _check_stop(self):
        if self.model_iteration() >= self.stop_iteration:
            self.running = False
            logger.info("Simulation is stopping: model iteration %s ≥ stop_iteration %s",
                        self.model_iteration(), self.stop_iteration)
        if self.model_time() >= self.stop_time - 1e-12:
            self.running = False
            logger.info("Simulation is stopping: model time %.6g ≥ stop_time %.6g",
                        self.model_time(), self.stop_time)
        if self.run_wall_time >= self.wall_time_limit:
            self.running = False
            logger.info("Simulation is stopping: wall time limit exceeded")

    def aligned_dt(self):
        """Δt capped by schedule actuations and stop_time (run.jl:42-57)."""
        t = self.model_time()
        dt = self.dt
        for coll in (self.callbacks, self.output_writers, self.diagnostics):
            for item in coll.values():
                sched = getattr(item, "schedule", None)
                if isinstance(sched, Schedule):
                    dt = sched.aligned_time_step(t, dt)
        if np.isfinite(self.stop_time):
            dt = min(dt, max(self.stop_time - t, 0.0))
        return dt

    # -- activities --------------------------------------------------------------
    def _fire(self, initial=False):
        for coll in (self.diagnostics, self.callbacks, self.output_writers):
            for item in coll.values():
                sched = getattr(item, "schedule", None)
                fire = sched(self) if sched is not None else True
                if fire or initial:
                    item(self) if callable(item) else item.process(self)

    def _setup_time_averaging(self):
        """Writers scheduled with AveragedTimeInterval get their outputs
        auto-wrapped in WindowedTimeAverage accumulators (reference
        jld2_output_writer.jl time-averaging path)."""
        from ..output.writers import WindowedTimeAverage, _fetch
        from ..utils.schedules import AveragedTimeInterval
        for wname, writer in self.output_writers.items():
            sched = getattr(writer, "schedule", None)
            if not isinstance(sched, AveragedTimeInterval):
                continue
            for name, spec in list(writer.outputs.items()):
                if isinstance(spec, WindowedTimeAverage):
                    continue
                wta = WindowedTimeAverage(
                    (lambda sim, n=name, s=spec: _fetch(sim, n, s,
                                                        writer.indices)),
                    schedule=sched)
                writer.outputs[name] = wta
                self.diagnostics[f"_wta_{wname}_{name}"] = wta

    def initialize(self):
        self._setup_time_averaging()
        self._fire(initial=True)
        self.initialized = True

    # -- the loop -----------------------------------------------------------------
    def time_step(self):
        if not self.initialized:
            self.initialize()
        t0 = _time.monotonic()
        dt = self.aligned_dt()
        if dt <= 0:
            self.running = False
            return
        self.state = self._compiled_step(self.state, jnp.asarray(dt, self.model.grid.dtype))
        self._fire()
        self._check_stop()
        self.run_wall_time += _time.monotonic() - t0

    def run(self, pickup=False):
        if pickup:
            from ..output.checkpointer import pickup_latest
            restored = pickup_latest(self, pickup)
            if restored:
                logger.info("Picked up checkpoint at iteration %s", self.model_iteration())
        self.running = True
        self._check_stop()
        while self.running:
            self.time_step()
        return self.state
