"""Shallow-water model (conservative uh, vh, h formulation).

Array re-design of the reference's src/Models/ShallowWaterModels/
(shallow_water_model.jl:37-57, solution_and_tracer_tendencies.jl,
shallow_water_advection_operators.jl, rk3_substep_shallow_water_model.jl):
state is an immutable pytree, the full RK3 step is one jitted pure
function; no elliptic solve (pure hyperbolic + sources) which makes this
the minimum end-to-end slice of the framework.

Equations (conservative form):
  ∂t(uh) = −∇·(uh v) − g ∂x(h²/2) − f×(uh) + g h ∂x(hB) + Fuh + ν∇²(uh)
  ∂t(vh) = (y analog)
  ∂t(h)  = −∇·(uh, vh)
  ∂t(c)  = −∇·(U c) + c ∇·U + Fc + κ∇²c
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from ..advection.schemes import AdvectionScheme, WENO5, transport
from ..boundary_conditions.bcs import apply_flux_bcs, fill_halos, regularize_bcs
from ..closures.scalar_diffusivity import momentum_diffusion, tracer_diffusion
from ..fields.field import Field
from ..grids.topology import FLAT
from ..ops import stencil as st
from ..timesteppers.steppers import Clock, RK3_GAMMA, RK3_ZETA, rk3_substep
from ..utils.location import C, CENTER, F, U_LOC, V_LOC


def _ixyff(h):
    """ℑxyᶠᶠ: 4-point average of a centered field onto (F,F,·)."""
    return st.ixf(st.iyf(h))


def _core_tendencies(grid, scheme, tracer_scheme, g, uh, vh, h, tracers,
                     bathymetry=None):
    """Advection + pressure-gradient + mass tendencies, pure stencil math
    over any grid-metric provider: returns (Guh, Gvh, Gh, *Gtracers)."""
    u_cc = st.ixc(uh)
    v_ff = st.ixf(vh)
    flux_huu = grid.Ax(CENTER) * transport(scheme, u_cc, uh, 0, False, grid) / h
    flux_hvu = grid.Ay((F, F, C)) * transport(scheme, v_ff, uh, 1, True, grid) / _ixyff(h)
    div_mom_u = (st.dxf(flux_huu) + st.dyc(flux_hvu)) / grid.V(U_LOC)
    Guh = -div_mom_u - st.dxf(0.5 * g * h * h) / grid.dx(U_LOC)
    if bathymetry is not None:
        Guh = Guh + g * st.ixf(h) * st.dxf(bathymetry) / grid.dx(U_LOC)

    u_ff = st.iyf(uh)
    v_cc = st.iyc(vh)
    flux_huv = grid.Ax((F, F, C)) * transport(scheme, u_ff, vh, 0, True, grid) / _ixyff(h)
    flux_hvv = grid.Ay(CENTER) * transport(scheme, v_cc, vh, 1, False, grid) / h
    div_mom_v = (st.dxc(flux_huv) + st.dyf(flux_hvv)) / grid.V(V_LOC)
    Gvh = -div_mom_v - st.dyf(0.5 * g * h * h) / grid.dy(V_LOC)
    if bathymetry is not None:
        Gvh = Gvh + g * st.iyf(h) * st.dyf(bathymetry) / grid.dy(V_LOC)

    Gh = -(st.dxc(grid.Ax(U_LOC) * uh)
           + st.dyc(grid.Ay(V_LOC) * vh)) / grid.V(CENTER)
    outs = [Guh, Gvh, Gh]

    if tracers:
        # tracers ride the VELOCITY u = uh/h̄ˣ, not the transport
        # (reference transport_tracer_flux_x/y + c_div_U,
        # shallow_water_advection_operators.jl:88-145)
        u_vel = uh / st.ixf(h)
        v_vel = vh / st.iyf(h)
        div_U = (st.dxc(grid.Ax(U_LOC) * u_vel)
                 + st.dyc(grid.Ay(V_LOC) * v_vel)) / grid.V(CENTER)
        for c in tracers:
            fx = grid.Ax(U_LOC) * transport(tracer_scheme, u_vel, c, 0, True, grid)
            fy = grid.Ay(V_LOC) * transport(tracer_scheme, v_vel, c, 1, True, grid)
            div_Uc = (st.dxc(fx) + st.dyc(fy)) / grid.V(CENTER)
            outs.append(-div_Uc + c * div_U)
    return tuple(outs)


@jax.tree_util.register_pytree_node_class
class ShallowWaterModel:
    """Config container; all methods are pure functions of (state, Δt)."""

    def __init__(self, grid, gravitational_acceleration=9.80665,
                 advection: Optional[AdvectionScheme] = None,
                 tracer_advection: Optional[AdvectionScheme] = None,
                 coriolis=None, closure=None, bathymetry=None,
                 tracers=(), forcing=None, boundary_conditions=None,
                 formulation="conservative", particles=None):
        """``formulation``: "conservative" (prognostic uh, vh, h — the
        default) or "vector_invariant" (prognostic u, v, h; rotational
        momentum form, reference shallow_water_model.jl:37-57). In the
        vector-invariant form `advection` is a VectorInvariant config
        (vorticity scheme) and h is advected with `tracer_advection`."""
        if grid.topology[2] is not FLAT or grid.Nz != 1:
            raise ValueError("ShallowWaterModel requires a flat z-axis (size[2]=1)")
        if formulation not in ("conservative", "vector_invariant"):
            raise ValueError(f"unknown formulation {formulation!r}")
        self.formulation = formulation
        if formulation == "vector_invariant":
            from ..advection.vector_invariant import VectorInvariant
            self.advection = (advection if advection is not None
                              else VectorInvariant())
            self.tracer_advection = (tracer_advection
                                     if tracer_advection is not None else WENO5())
        else:
            self.advection = advection if advection is not None else WENO5()
            self.tracer_advection = (tracer_advection if tracer_advection is not None
                                     else self.advection)
        h_req = max(getattr(self.advection, "required_halo", 1),
                    self.tracer_advection.required_halo)
        self.grid = grid.with_halo((h_req, h_req, 0))
        self.g = gravitational_acceleration
        self.coriolis = coriolis
        self.closure = closure
        self.particles = particles  # LagrangianParticles or None
        self.bathymetry = bathymetry  # hB array at centers or None
        self.tracer_names = tuple(tracers)
        from ..forcings.forcing import regularize_forcing
        self.forcing = {k: regularize_forcing(k, v)
                        for k, v in (forcing or {}).items()}
        user_bcs = boundary_conditions or {}
        un, vn = self._momentum_names()
        self.bcs = {
            un: regularize_bcs(self.grid, U_LOC, user_bcs.get(un)),
            vn: regularize_bcs(self.grid, V_LOC, user_bcs.get(vn)),
            "h": regularize_bcs(self.grid, CENTER, user_bcs.get("h")),
        }
        for name in self.tracer_names:
            self.bcs[name] = regularize_bcs(self.grid, CENTER, user_bcs.get(name))

    def _momentum_names(self):
        return (("u", "v") if self.formulation == "vector_invariant"
                else ("uh", "vh"))

    # -- pytree -------------------------------------------------------------
    def tree_flatten(self):
        leaves = (self.grid, self.g, self.coriolis, self.closure,
                  self.bathymetry, self.bcs, self.particles)
        static = (self.advection, self.tracer_advection, self.tracer_names,
                  tuple(sorted(self.forcing)),
                  tuple(self.forcing[k] for k in sorted(self.forcing)),
                  self.formulation)
        return leaves, static

    @classmethod
    def tree_unflatten(cls, static, leaves):
        obj = object.__new__(cls)
        (obj.grid, obj.g, obj.coriolis, obj.closure,
         obj.bathymetry, obj.bcs, obj.particles) = leaves
        obj.advection, obj.tracer_advection, obj.tracer_names = static[:3]
        obj.forcing = dict(zip(static[3], static[4]))
        obj.formulation = static[5]
        return obj

    # -- state --------------------------------------------------------------
    def prognostic_names(self):
        return self._momentum_names() + ("h",) + self.tracer_names

    def initial_state(self, clock=None, h=1.0, **values):
        from ..fields.field import new_field, set_field
        g = self.grid
        sol = {}
        vals = dict(h=h)
        for n in self.prognostic_names():
            if n != "h":
                vals[n] = values.get(n, 0.0)
        locs = self._locs()
        for name in self.prognostic_names():
            f = new_field(g, locs[name], self.bcs[name])
            sol[name] = set_field(f, g, vals[name]).data
        clock = clock or Clock(jnp.zeros((), g.dtype), jnp.zeros((), jnp.int32))
        # RK3 carries no tendency history ACROSS steps (the ζ stages use
        # the within-step G only), so the state stores no G_prev: at
        # 16384² fp32 those 3 dead arrays would be 3.2 GB
        state = dict(solution=sol, clock=clock)
        if self.particles is not None:
            state["particles"] = self.particles
        return state

    def _locs(self):
        un, vn = self._momentum_names()
        locs = {un: U_LOC, vn: V_LOC, "h": CENTER}
        for n in self.tracer_names:
            locs[n] = CENTER
        return locs

    def fill_all_halos(self, sol, t=0.0):
        locs = self._locs()
        return {name: fill_halos(arr, self.grid, locs[name], self.bcs[name], t)
                for name, arr in sol.items()}

    # -- physics ------------------------------------------------------------
    def _vi_tendencies(self, state):
        """Vector-invariant tendencies (prognostic u, v, h): rotational
        momentum form with Bernoulli head; h and tracers advected by
        (u, v) with `tracer_advection` (reference
        shallow_water_advection_operators.jl:45-57,79,110-121,141-145)."""
        grid, g = self.grid, self.g
        sol = state["solution"]
        u, v, h = sol["u"], sol["v"], sol["h"]
        clock = state["clock"]
        zero_w = jnp.zeros_like(h)
        ts = self.tracer_advection

        Gu = -self.advection.U_dot_grad_u(grid, u, v, zero_w) \
            - g * st.dxf(h) / grid.dx(U_LOC)
        Gv = -self.advection.U_dot_grad_v(grid, u, v, zero_w) \
            - g * st.dyf(h) / grid.dy(V_LOC)
        if self.bathymetry is not None:
            Gu = Gu + g * st.dxf(self.bathymetry) / grid.dx(U_LOC)
            Gv = Gv + g * st.dyf(self.bathymetry) / grid.dy(V_LOC)
        if self.coriolis is not None:
            Gu = Gu - self.coriolis.x_f_cross_U(grid, u, v, zero_w)
            Gv = Gv - self.coriolis.y_f_cross_U(grid, u, v, zero_w)
        if self.closure is not None:
            Gu = Gu + momentum_diffusion(u, grid, U_LOC, self.closure)
            Gv = Gv + momentum_diffusion(v, grid, V_LOC, self.closure)

        def div_Uc_2d(c):
            fx = grid.Ax(U_LOC) * transport(ts, u, c, 0, True, grid)
            fy = grid.Ay(V_LOC) * transport(ts, v, c, 1, True, grid)
            return (st.dxc(fx) + st.dyc(fy)) / grid.V(CENTER)

        G = {"u": Gu, "v": Gv, "h": -div_Uc_2d(h)}
        if self.tracer_names:
            # c ∇·U compressibility correction (c_div_U, ref :141-145)
            div_U = (st.dxc(grid.Ax(U_LOC) * u)
                     + st.dyc(grid.Ay(V_LOC) * v)) / grid.V(CENTER)
            for name in self.tracer_names:
                c = sol[name]
                Gc = -div_Uc_2d(c) + c * div_U
                if self.closure is not None:
                    Gc = Gc + tracer_diffusion(c, grid, name, self.closure)
                G[name] = Gc

        fields = dict(sol)
        locs = self._locs()
        for name in self.prognostic_names():
            if name in self.forcing:
                G[name] = G[name] + self.forcing[name](grid, clock, fields)
            G[name] = apply_flux_bcs(G[name], grid, locs[name],
                                     self.bcs[name], clock.time)
        return G

    def tendencies(self, state):
        """G for every prognostic variable (reference
        solution_and_tracer_tendencies.jl)."""
        if self.formulation == "vector_invariant":
            return self._vi_tendencies(state)
        grid, g = self.grid, self.g
        sol = state["solution"]
        uh, vh, h = sol["uh"], sol["vh"], sol["h"]
        clock = state["clock"]
        scheme = self.advection
        tracer_arrays = [sol[n] for n in self.tracer_names]

        outs = _core_tendencies(grid, scheme, self.tracer_advection, g,
                                uh, vh, h, tracer_arrays, self.bathymetry)
        Guh, Gvh, Gh = outs[0], outs[1], outs[2]
        Gtracers = outs[3:]

        if self.coriolis is not None:
            zero_w = jnp.zeros_like(h)
            Guh = Guh - self.coriolis.x_f_cross_U(grid, uh, vh, zero_w)
            Gvh = Gvh - self.coriolis.y_f_cross_U(grid, uh, vh, zero_w)

        if self.closure is not None:
            Guh = Guh + momentum_diffusion(uh, grid, U_LOC, self.closure)
            Gvh = Gvh + momentum_diffusion(vh, grid, V_LOC, self.closure)

        G = dict(uh=Guh, vh=Gvh, h=Gh)

        for name, Gc in zip(self.tracer_names, Gtracers):
            if self.closure is not None:
                Gc = Gc + tracer_diffusion(sol[name], grid, name, self.closure)
            G[name] = Gc

        # user forcing + boundary fluxes
        fields = dict(sol)
        locs = self._locs()
        for name in self.prognostic_names():
            if name in self.forcing:
                G[name] = G[name] + self.forcing[name](grid, clock, fields)
            G[name] = apply_flux_bcs(G[name], grid, locs[name],
                                     self.bcs[name], clock.time)
        return G

    # -- stepping -----------------------------------------------------------
    def step(self, state, dt):
        """One RK3 step (reference runge_kutta_3.jl:81-130, minus the
        pressure correction which the SW system doesn't need)."""
        clock0 = state["clock"]
        G_prev = None
        for m, (gamma, zeta) in enumerate(zip(RK3_GAMMA, RK3_ZETA)):
            G = self.tendencies(state)
            sol = rk3_substep(state["solution"], G, G_prev, dt, gamma, zeta)
            stage_dt = (gamma + zeta) * dt
            clock = state["clock"].tick(stage_dt, stage=True)
            sol = self.fill_all_halos(sol, clock.time)
            state = dict(state, solution=sol, clock=clock)
            G_prev = G
        clock = Clock(clock0.time + dt, clock0.iteration + 1, 0)
        state = dict(state, clock=clock)
        p = state.get("particles")
        if p is not None:
            vels = self.velocities(state)
            fields = {nm: state["solution"][nm] for nm in self.tracer_names}
            state = dict(state, particles=p.step(self.grid, vels, dt, fields))
        return state

    def cell_diffusion_timescale(self, state):
        """min Δ²/max(ν, κ) over this model's closures (reference
        turbulence_closure_diagnostics.jl); +inf when nothing limits."""
        from ..closures.scalar_diffusivity import cell_diffusion_timescale
        return cell_diffusion_timescale(self.closure, self.grid, None,
                                        self.tracer_names)

    def cell_advection_timescale(self, state):
        """min(Δ / (|u| + √(gh))) — gravity-wave-aware CFL timescale."""
        sol = state["solution"]
        grid = self.grid
        h = sol["h"]
        cg = jnp.sqrt(self.g * jnp.abs(h))
        vels = self.velocities(state)
        u = jnp.abs(vels["u"]) + cg
        v = jnp.abs(vels["v"]) + cg
        tx = grid.interior(grid.dx(U_LOC) / jnp.maximum(u, 1e-30))
        ty = grid.interior(grid.dy(V_LOC) / jnp.maximum(v, 1e-30))
        return jnp.minimum(jnp.min(tx), jnp.min(ty))

    def velocities(self, state):
        """Diagnostic velocities (u = uh/h̄ˣ in the conservative form;
        prognostic in the vector-invariant form)."""
        sol = state["solution"]
        if self.formulation == "vector_invariant":
            return dict(u=sol["u"], v=sol["v"])
        return dict(u=sol["uh"] / st.ixf(sol["h"]),
                    v=sol["vh"] / st.iyf(sol["h"]))

    def fields(self, state):
        locs = self._locs()
        return {name: Field(arr, locs[name], self.bcs[name])
                for name, arr in state["solution"].items()}
