"""Nonhydrostatic (incompressible Boussinesq) model.

Array re-design of the reference's src/Models/NonhydrostaticModels/
(nonhydrostatic_model.jl:26-203, nonhydrostatic_tendency_kernel_functions.jl:44-73,
pressure_correction.jl, solve_for_pressure.jl, update_nonhydrostatic_model_state.jl):

  ∂t u = G_u − ∂x pNHS,  G_u = −∇·(vu) − f×u|_x − ∂x pHY′ + ∇·(ν∇u) + Fu
  ∂t w = G_w − ∂z pNHS,  G_w = −∇·(vw) − f×u|_z + ∇·(ν∇w) + Fw
  (buoyancy and ∂z pHY′ cancel exactly in G_w by construction of
   pHY′ = −∫ b̄ᶻ dz, reference update_hydrostatic_pressure.jl)
  ∂t c = −∇·(vc) + ∇·(κ∇c) + Fc
  ∇²pNHS = ∇·u*/Δt  (FFT / Fourier-tridiagonal eigenexpansion solve)

Time stepping: quasi-AB2 with Euler first step / on Δt change (χ carried
as an arithmetic select so the whole step stays one jitted function), or
RK3 with per-stage projection.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..advection.fluxes import div_Uc, div_vu, div_vv, div_vw
from ..advection.schemes import AdvectionScheme, CenteredSecondOrder
from ..boundary_conditions.bcs import (apply_flux_bcs,
                                       apply_immersed_flux_bcs,
                                       fill_halos, regularize_bcs)
from ..buoyancy.buoyancy import buoyancy_z_term, hydrostatic_pressure_anomaly
from ..closures.scalar_diffusivity import (compute_closure_diffusivities,
                                           momentum_diffusion, tracer_diffusion)
from ..closures.implicit_vertical_diffusion import implicit_step_fields
from ..fields.field import Field
from ..grids.topology import FLAT
from ..ops import operators as op
from ..ops import stencil as st
from ..solvers.fft_poisson import FFTPoissonSolver
from ..solvers.fourier_tridiagonal import FourierTridiagonalSolver
from ..timesteppers.steppers import (Clock, RK3_GAMMA, RK3_ZETA, ab2_substep,
                                     rk3_substep)
from ..utils.location import C, CENTER, F, U_LOC, V_LOC, W_LOC


def select_pressure_solver(grid):
    """Regular grid → FFT; stretched-z (regular x,y) → Fourier-tridiagonal
    (reference NonhydrostaticModels.jl:18-27); stretched x or y →
    multigrid-preconditioned CG (the eigen-solvers don't apply; the
    reference points such grids at its iterative solvers)."""
    if grid.all_regular:
        return FFTPoissonSolver.build(grid)
    if grid.hregular:
        return FourierTridiagonalSolver.build(grid)
    from ..solvers.stencil_matrix import MultigridPoissonSolver
    return MultigridPoissonSolver.build(grid, tolerance=1e-9, maxiter=200)


@jax.tree_util.register_pytree_node_class
class NonhydrostaticModel:
    def __init__(self, grid, advection=None, tracer_advection=None,
                 buoyancy=None, coriolis=None, stokes_drift=None,
                 closure=None, tracers=None, forcing=None,
                 background_fields=None, boundary_conditions=None,
                 timestepper="QuasiAdamsBashforth2", immersed_boundary=None,
                 particles=None):
        self.advection = advection if advection is not None else CenteredSecondOrder()
        self.tracer_advection = (tracer_advection if tracer_advection is not None
                                 else self.advection)
        # tracers: user list, expanded with buoyancy requirements
        names = list(tracers) if tracers is not None else []
        if buoyancy is not None:
            for t in buoyancy.required_tracers:
                if t not in names:
                    names.append(t)
        for cl in (closure if isinstance(closure, (tuple, list)) else (closure,)):
            for t in getattr(cl, "required_tracers", ()):
                if t not in names:
                    names.append(t)
        self.tracer_names = tuple(names)
        h_req = max(self.advection.required_halo,
                    self.tracer_advection.required_halo, 1)
        self.grid = grid.with_halo((h_req, h_req, h_req))
        self.buoyancy = buoyancy
        self.coriolis = coriolis
        self.stokes_drift = stokes_drift
        self.closure = closure
        from ..forcings.forcing import regularize_forcing
        self.forcing = {k: regularize_forcing(k, v)
                        for k, v in (forcing or {}).items()}
        self.background_fields = background_fields or {}
        self.timestepper = timestepper
        self.ab2_chi = 0.1
        # build immersed-boundary masks on the final (halo-inflated) grid
        # and wrap it (reference ImmersedBoundaryGrid) so advection sees
        # the conditional-flux masks
        if immersed_boundary is not None and hasattr(immersed_boundary, "build"):
            immersed_boundary = immersed_boundary.build(self.grid)
        self.immersed_boundary = immersed_boundary
        if immersed_boundary is not None:
            from ..immersed.immersed import ImmersedGrid
            self.grid = ImmersedGrid.wrap(self.grid, immersed_boundary)
        self.particles = particles  # LagrangianParticles or None
        self.pressure_solver = select_pressure_solver(self.grid)
        user_bcs = boundary_conditions or {}
        self.bcs = {
            "u": regularize_bcs(self.grid, U_LOC, user_bcs.get("u")),
            "v": regularize_bcs(self.grid, V_LOC, user_bcs.get("v")),
            "w": regularize_bcs(self.grid, W_LOC, user_bcs.get("w")),
        }
        for n in self.tracer_names:
            self.bcs[n] = regularize_bcs(self.grid, CENTER, user_bcs.get(n))
        self.pressure_bcs = regularize_bcs(self.grid, CENTER, None)

    # -- pytree ---------------------------------------------------------------
    def tree_flatten(self):
        leaves = (self.grid, self.buoyancy, self.coriolis, self.stokes_drift,
                  self.closure, self.bcs, self.pressure_bcs,
                  self.pressure_solver, self.background_fields,
                  self.immersed_boundary, self.particles)
        fk = tuple(sorted(self.forcing))
        static = (self.advection, self.tracer_advection, self.tracer_names,
                  self.timestepper, self.ab2_chi,
                  fk, tuple(self.forcing[k] for k in fk))
        return leaves, static

    @classmethod
    def tree_unflatten(cls, static, leaves):
        obj = object.__new__(cls)
        (obj.grid, obj.buoyancy, obj.coriolis, obj.stokes_drift, obj.closure,
         obj.bcs, obj.pressure_bcs, obj.pressure_solver,
         obj.background_fields, obj.immersed_boundary,
         obj.particles) = leaves
        (obj.advection, obj.tracer_advection, obj.tracer_names,
         obj.timestepper, obj.ab2_chi, fk, fv) = static
        obj.forcing = dict(zip(fk, fv))
        return obj

    # -- state ----------------------------------------------------------------
    def prognostic_names(self):
        return ("u", "v", "w") + self.tracer_names

    def _locs(self):
        locs = dict(u=U_LOC, v=V_LOC, w=W_LOC)
        for n in self.tracer_names:
            locs[n] = CENTER
        return locs

    def initial_state(self, clock=None, **values):
        from ..fields.field import new_field, set_field
        g = self.grid
        sol = {}
        locs = self._locs()
        for name in self.prognostic_names():
            f = new_field(g, locs[name], self.bcs[name])
            sol[name] = set_field(f, g, values.get(name, 0.0)).data
        clock = clock or Clock(jnp.zeros((), g.dtype), jnp.zeros((), jnp.int32))
        zeros = {k: jnp.zeros_like(v) for k, v in sol.items()}
        state = dict(solution=sol, clock=clock, G_prev=zeros,
                     pNHS=jnp.zeros(g.total_shape, g.dtype),
                     previous_dt=jnp.full((), -1.0, g.dtype))
        if self.particles is not None:
            state["particles"] = self.particles
        return self.update_state(state)

    def fill_all_halos(self, sol, t=0.0):
        locs = self._locs()
        return {name: fill_halos(arr, self.grid, locs[name], self.bcs[name], t)
                for name, arr in sol.items()}

    def _aux_state(self, state, sol):
        """Auxiliary recomputation (diffusivities, pHY′) from `sol` —
        the non-fill half of ``update_state``."""
        t = state["clock"].time
        state = dict(state, solution=sol)
        tr = {n: sol[n] for n in self.tracer_names}
        diff = compute_closure_diffusivities(self.closure, self.grid, sol,
                                             self.buoyancy, tr)
        if diff is not None:
            state = dict(state, diffusivities=diff)
        if self.buoyancy is not None:
            ph = hydrostatic_pressure_anomaly(self.buoyancy, self.grid, tr)
            ph = fill_halos(ph, self.grid, CENTER, self.pressure_bcs, t)
            state = dict(state, pHY=ph)
        return state

    def update_state(self, state):
        """Halo fills + auxiliary recomputation (reference
        update_nonhydrostatic_model_state.jl:14-37). Under
        ``halo_overlap`` (set by DistributedModel) the fills and aux are
        DEFERRED into the next step's ``tendencies_overlapped`` so the
        exchange collectives overlap the bulk tendency compute. The
        communication-FREE parts are not deferred, keeping every interior
        point bit-identical to the plain step's: local-axis fills (slab
        writes), cut-axis wall faces (``impose_cut_wall_faces``), and
        pointwise immersed masking with shard-local masks."""
        if getattr(self, "halo_overlap", False):
            from ..boundary_conditions.bcs import impose_cut_wall_faces
            t = state["clock"].time
            locs = self._locs()
            dist = getattr(self.grid, "dist", (None, None, None))
            local_axes = tuple(a for a in (0, 1, 2) if dist[a] is None)
            sol = {name: impose_cut_wall_faces(
                       fill_halos(arr, self.grid, locs[name],
                                  self.bcs[name], t, axes=local_axes),
                       self.grid, locs[name], self.bcs[name], t)
                   for name, arr in state["solution"].items()}
            state = dict(state, solution=sol)
            if self.immersed_boundary is not None:
                state = self.immersed_boundary.mask_state(self, state)
            return state
        t = state["clock"].time
        sol = self.fill_all_halos(state["solution"], t)
        state = dict(state, solution=sol)
        if self.immersed_boundary is not None:
            state = self.immersed_boundary.mask_state(self, state)
            sol = state["solution"]
        return self._aux_state(state, sol)

    def tendencies_overlapped(self, state):
        """Interior/edge-split tendencies for distributed runs — the
        analog of the reference's nonblocking-MPI overlap
        (halo_communication.jl:68-86 Isend/Irecv + interior kernels):

        1. issue the halo-exchange ppermutes (``fill_all_halos``),
        2. compute the FULL tendency field from the STALE-halo solution —
           no data dependency on the exchange, so XLA's scheduler runs
           the collectives concurrently with this bulk compute,
        3. recompute the H-cell-wide edge strips along each cut axis
           from the exchanged solution (tiny slab grids via
           ``grid.subgrid_along`` — coordinates stay absolute) and patch
           them in.

        The solution entering this function carries stale halos (see
        ``update_state``); returns ``(G, state_fresh)`` where
        ``state_fresh`` holds the exchanged solution + recomputed aux.
        Immersed boundaries are supported: masking is pointwise with the
        shard-local masks (no collectives), and the edge strips slice the
        masks through ``ImmersedGrid.subgrid_along``. Background fields
        materialize from (absolute) strip coordinates, so their cross
        terms get the same bulk/strip treatment as the primary advection.
        Particles remain unsupported (asserted at DistributedModel
        construction)."""
        import copy as _copy
        grid = self.grid
        t = state["clock"].time
        sol_stale = state["solution"]
        sol_fresh = self.fill_all_halos(sol_stale, t)
        if self.immersed_boundary is not None:
            # fill → mask → aux, exactly update_state's ordering
            sol_fresh = self.immersed_boundary.mask_state(
                self, dict(state, solution=sol_fresh))["solution"]
        state_fresh = self._aux_state(state, sol_fresh)
        # bulk pass: LOCAL fills (uncut axes — cheap copies, no
        # collectives) applied synchronously; only the exchanged cut-axis
        # halos stay stale, so every interior cell further than H from a
        # cut-axis shard edge is exact and the pass carries no data
        # dependency on the ppermutes
        local_axes = tuple(a for a in (0, 1, 2) if grid.dist[a] is None)
        locs = self._locs()
        sol_local = {name: fill_halos(arr, grid, locs[name], self.bcs[name],
                                      t, axes=local_axes)
                     for name, arr in sol_stale.items()}
        if self.immersed_boundary is not None:
            sol_local = self.immersed_boundary.mask_state(
                self, dict(state, solution=sol_local))["solution"]
        G = self.tendencies(dict(state_fresh, solution=sol_local))

        def _slc3(x, axis, start, size):
            if getattr(x, "ndim", 0) == 3:
                sl = [slice(None)] * 3
                sl[axis] = slice(start, start + size)
                return x[tuple(sl)]
            return x

        for axis in (0, 1):
            if grid.dist[axis] is None:
                continue
            H = grid.halo[axis]
            N = grid.shape[axis]
            for start_int in (0, N - H):  # first/last H interior cells
                gsub = grid.subgrid_along(axis, start_int, H)
                ms = _copy.copy(self)
                ms.grid = gsub
                if self.immersed_boundary is not None:
                    ms.immersed_boundary = gsub.immersed
                sub = {k: (jax.tree_util.tree_map(
                           lambda x: _slc3(x, axis, start_int, 3 * H), v)
                           if k in ("solution", "diffusivities", "pHY")
                           else v)
                       for k, v in state_fresh.items() if k != "particles"}
                Gs = ms.tendencies(sub)
                sl = [slice(None)] * 3
                sl[axis] = slice(start_int + H, start_int + 2 * H)
                ssl = [slice(None)] * 3
                ssl[axis] = slice(H, 2 * H)
                G = {name: G[name].at[tuple(sl)].set(Gs[name][tuple(ssl)])
                     for name in G}
        return G, state_fresh

    # -- tendencies -------------------------------------------------------------
    def tendencies(self, state):
        grid = self.grid
        sol = state["solution"]
        u, v, w = sol["u"], sol["v"], sol["w"]
        clock = state["clock"]
        scheme = self.advection
        G = {}

        Gu = -div_vu(grid, scheme, u, v, w)
        Gv = -div_vv(grid, scheme, u, v, w)
        Gw = -div_vw(grid, scheme, u, v, w)

        # background-field advection cross terms (reference tendency :61-63);
        # BackgroundField entries are materialized at the traced clock time
        # (time-independent ones constant-fold under jit)
        from ..fields.background import materialize_background
        bg = materialize_background(self.background_fields, grid,
                                    self._locs(), clock.time)
        if bg:
            bu = bg.get("u", jnp.zeros_like(u))
            bv = bg.get("v", jnp.zeros_like(v))
            bw = bg.get("w", jnp.zeros_like(w))
            Gu = Gu - div_vu(grid, scheme, u, v, w, U=(bu, bv, bw)) \
                    - div_vu(grid, scheme, bu, bv, bw, U=(u, v, w))
            Gv = Gv - div_vv(grid, scheme, u, v, w, U=(bu, bv, bw)) \
                    - div_vv(grid, scheme, bu, bv, bw, U=(u, v, w))
            Gw = Gw - div_vw(grid, scheme, u, v, w, U=(bu, bv, bw)) \
                    - div_vw(grid, scheme, bu, bv, bw, U=(u, v, w))

        if self.coriolis is not None:
            Gu = Gu - self.coriolis.x_f_cross_U(grid, u, v, w)
            Gv = Gv - self.coriolis.y_f_cross_U(grid, u, v, w)
            Gw = Gw - self.coriolis.z_f_cross_U(grid, u, v, w)

        if self.buoyancy is not None and "pHY" in state:
            ph = state["pHY"]
            Gu = Gu - st.dxf(ph) / grid.dx(U_LOC)
            Gv = Gv - st.dyf(ph) / grid.dy(V_LOC)
            # Gw: buoyancy − ∂z pHY′ ≡ 0 by construction (see module docstring)
            # tilted gravity: x/y components are direct tendency terms
            # (reference nonhydrostatic_tendency_kernel_functions.jl:70,127)
            from ..buoyancy.buoyancy import buoyancy_x_term, buoyancy_y_term
            tr_d = {n: sol[n] for n in self.tracer_names}
            bx = buoyancy_x_term(self.buoyancy, grid, tr_d)
            by = buoyancy_y_term(self.buoyancy, grid, tr_d)
            if bx is not None:
                Gu = Gu + bx
            if by is not None:
                Gv = Gv + by

        if self.stokes_drift is not None:
            Gu = Gu + self.stokes_drift.x_curl_Us_cross_U(grid, u, v, w, clock.time)
            Gv = Gv + self.stokes_drift.y_curl_Us_cross_U(grid, u, v, w, clock.time)
            Gw = Gw + self.stokes_drift.z_curl_Us_cross_U(grid, u, v, w, clock.time)
            Gu = Gu + self.stokes_drift.dt_us(grid, clock.time)
            Gv = Gv + self.stokes_drift.dt_vs(grid, clock.time)
            Gw = Gw + self.stokes_drift.dt_ws(grid, clock.time)

        diff = state.get("diffusivities")
        if self.closure is not None:
            Gu = Gu + momentum_diffusion(u, grid, U_LOC, self.closure, diff)
            Gv = Gv + momentum_diffusion(v, grid, V_LOC, self.closure, diff)
            Gw = Gw + momentum_diffusion(w, grid, W_LOC, self.closure, diff)

        G.update(u=Gu, v=Gv, w=Gw)

        ts = self.tracer_advection
        for name in self.tracer_names:
            c = sol[name]
            Gc = -div_Uc(grid, ts, u, v, w, c)
            # background cross terms (reference
            # nonhydrostatic_tendency_kernel_functions.jl:227-228):
            # background velocities advect c, AND the full velocity
            # advects the background tracer
            if bg and any(k in bg for k in ("u", "v", "w")):
                Gc = Gc - div_Uc(grid, ts,
                                 bg.get("u", jnp.zeros_like(u)),
                                 bg.get("v", jnp.zeros_like(v)),
                                 bg.get("w", jnp.zeros_like(w)), c)
            if bg and name in bg:
                Gc = Gc - div_Uc(grid, ts, u, v, w, bg[name])
            if self.closure is not None:
                Gc = Gc + tracer_diffusion(c, grid, name, self.closure, diff)
                closures = (self.closure if isinstance(self.closure, (tuple, list))
                            else (self.closure,))
                diffs = diff if isinstance(self.closure, (tuple, list)) else (diff,)
                for cl, d in zip(closures, diffs or (None,) * len(closures)):
                    if name == "e" and hasattr(cl, "tke_tendency"):
                        tr = {n: sol[n] for n in self.tracer_names}
                        Gc = Gc + cl.tke_tendency(grid, sol, d, tr)
            G[name] = Gc

        fields = dict(sol)
        locs = self._locs()
        for name in self.prognostic_names():
            if name in self.forcing:
                G[name] = G[name] + self.forcing[name](grid, clock, fields)
            G[name] = apply_flux_bcs(G[name], grid, locs[name],
                                     self.bcs[name], clock.time, fields)
            if self.immersed_boundary is not None:
                G[name] = apply_immersed_flux_bcs(G[name], grid, locs[name],
                                                  self.bcs[name], clock.time,
                                                  fields)

        if self.immersed_boundary is not None:
            G = {k: self.immersed_boundary.mask_tendency(self, k, g_arr)
                 for k, g_arr in G.items()}
        return G

    # -- pressure projection --------------------------------------------------
    def _fast_projection_ok(self):
        """Halo-free projection path: periodic x/y (divergence/gradient via
        rolls on interior views), regular spacing, single shard, no
        immersed masking, and w-wall BCs expressible as imposed values.
        All static metadata — resolves at trace time."""
        from ..grids.topology import BOUNDED, PERIODIC
        g = self.grid
        if not (g.all_regular
                and getattr(g, "dist", (None, None, None)) == (None, None, None)
                and g.topology[0] is PERIODIC and g.topology[1] is PERIODIC
                and g.topology[2] in (PERIODIC, BOUNDED)
                and self.immersed_boundary is None):
            return False
        if g.topology[2] is BOUNDED:
            for bc in (self.bcs["w"].bottom, self.bcs["w"].top):
                if bc is not None and bc.kind not in ("open", "value"):
                    return False
        return True

    def _wall_plane(self, bc, side, t):
        """w's wall-face BC value on the interior (Nx, Ny) plane."""
        from ..boundary_conditions.bcs import _bvalue
        g = self.grid
        if bc is None:
            return jnp.zeros((), g.dtype)
        val = jnp.asarray(_bvalue(bc, g, 2, side, W_LOC, t), g.dtype)
        if val.ndim == 0:
            return val
        k = g.Hz if side == 0 else g.Hz + g.Nz
        full = jnp.broadcast_to(val, g.total_shape)
        return full[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny, k]

    def project_velocities(self, state, dt):
        """Make (u,v,w) divergence-free (reference pressure_correction.jl:10-40,
        solve_for_pressure.jl:15-71); returns corrected state with pNHS.

        Fast path: the divergence and gradient-correction are evaluated on
        interior views with periodic rolls — no halo fills, no with-halo
        scratch: the projection needs no velocity or pNHS halos. pNHS is
        stored with zero halos (diagnostic only)."""
        grid = self.grid
        if self._fast_projection_ok():
            sol = dict(state["solution"])
            t = state["clock"].time
            ui, vi, wi, phi = self._fast_project_interior(
                grid.interior(sol["u"]), grid.interior(sol["v"]),
                grid.interior(sol["w"]), t, dt)
            sl = tuple(slice(h, h + n) for h, n in zip(grid.halo, grid.shape))
            sol["u"] = sol["u"].at[sl].set(ui)
            sol["v"] = sol["v"].at[sl].set(vi)
            sol["w"] = sol["w"].at[sl].set(wi)
            pNHS = jnp.zeros(grid.total_shape, grid.dtype).at[sl].set(phi)
            return dict(state, solution=sol, pNHS=pNHS)
        return self._project_velocities_general(state, dt)

    def _fast_project_interior(self, ui, vi, wi, t, dt):
        """The fast-path projection math on interior (Nx, Ny, Nz) views:
        divergence and gradient-correction via periodic rolls (bounded-z
        wall faces imposed explicitly). Returns the corrected
        (u, v, w) interiors and φ = pNHS interior."""
        from ..grids.topology import BOUNDED
        grid = self.grid
        ax = grid._axes
        ddx = float(ax[0].extent) / grid.Nx
        ddy = float(ax[1].extent) / grid.Ny
        ddz = float(ax[2].extent) / max(grid.Nz, 1)
        z_bounded = grid.topology[2] is BOUNDED
        if z_bounded:
            # impose wall-normal BC values exactly as fill_halos would
            # (open/value kinds set the wall faces themselves)
            bot = self._wall_plane(self.bcs["w"].bottom, 0, t)
            top = self._wall_plane(self.bcs["w"].top, 1, t)
            wi = wi.at[:, :, 0].set(bot)
            top_plane = jnp.zeros_like(wi[:, :, :1]) + (
                top[..., None] if top.ndim else top)
            dwdz = (jnp.concatenate([wi[:, :, 1:], top_plane], 2) - wi) / ddz
        else:
            dwdz = (jnp.roll(wi, -1, 2) - wi) / ddz
        div = ((jnp.roll(ui, -1, 0) - ui) / ddx
               + (jnp.roll(vi, -1, 1) - vi) / ddy + dwdz)
        phi = self.pressure_solver.solve(div / dt)
        gx = (phi - jnp.roll(phi, 1, 0)) / ddx
        gy = (phi - jnp.roll(phi, 1, 1)) / ddy
        if z_bounded:
            gz = jnp.concatenate(
                [jnp.zeros_like(phi[:, :, :1]),
                 phi[:, :, 1:] - phi[:, :, :-1]], 2) / ddz
        else:
            gz = (phi - jnp.roll(phi, 1, 2)) / ddz
        return ui - dt * gx, vi - dt * gy, wi - dt * gz, phi

    def _project_velocities_general(self, state, dt):
        """General path (bounded/stretched x-y, distributed, immersed):
        fill halos, whole-array stencils."""
        grid = self.grid
        # only the velocities need fresh halos for the divergence/correction
        t = state["clock"].time
        sol = dict(state["solution"])
        for name in ("u", "v", "w"):
            sol[name] = fill_halos(sol[name], grid, self._locs()[name],
                                   self.bcs[name], t)
        u, v, w = sol["u"], sol["v"], sol["w"]
        div = op.div_ccc(u, v, w, grid)
        rhs = grid.interior(div) / dt
        phi_int = self.pressure_solver.solve(rhs)
        pNHS = jnp.zeros(grid.total_shape, grid.dtype)
        sl = tuple(slice(h, h + n) for h, n in zip(grid.halo, grid.shape))
        pNHS = pNHS.at[sl].set(phi_int)
        pNHS = fill_halos(pNHS, grid, CENTER, self.pressure_bcs)
        gx = st.dxf(pNHS) / grid.dx(U_LOC)
        gy = st.dyf(pNHS) / grid.dy(V_LOC)
        gz = st.dzf(pNHS) / grid.dz(W_LOC)
        u = u - dt * gx
        v = v - dt * gy
        w = w - dt * gz
        sol = dict(sol, u=u, v=v, w=w)
        return dict(state, solution=sol, pNHS=pNHS)

    # -- stepping ---------------------------------------------------------------
    def step(self, state, dt):
        if self.timestepper == "RungeKutta3":
            return self._rk3_step(state, dt)
        return self._ab2_step(state, dt)

    def _ab2_step(self, state, dt):
        clock0 = state["clock"]
        euler = (clock0.iteration == 0) | (jnp.abs(state["previous_dt"] - dt) > 1e-14)
        if getattr(self, "halo_overlap", False):
            G, state = self.tendencies_overlapped(state)
        else:
            G = self.tendencies(state)
        sol = ab2_substep(state["solution"], G, state["G_prev"], dt,
                          self.ab2_chi, euler)
        sol = implicit_step_fields(sol, self.grid, self._locs(), self.closure,
                                   dt, state.get("diffusivities"), self.bcs,
                                   clock0.time)
        state = self.project_velocities(dict(state, solution=sol), dt)
        clock = clock0.tick(dt)
        state = dict(state, clock=clock, G_prev=G,
                     previous_dt=jnp.full((), 1.0, self.grid.dtype) * dt)
        return self._step_particles(self.update_state(state), dt)

    def _rk3_step(self, state, dt):
        clock0 = state["clock"]
        G_prev = None
        for gamma, zeta in zip(RK3_GAMMA, RK3_ZETA):
            if getattr(self, "halo_overlap", False):
                G, state = self.tendencies_overlapped(state)
            else:
                G = self.tendencies(state)
            sol = rk3_substep(state["solution"], G, G_prev, dt, gamma, zeta)
            stage_dt = (gamma + zeta) * dt
            sol = implicit_step_fields(sol, self.grid, self._locs(),
                                       self.closure, stage_dt,
                                       state.get("diffusivities"),
                                       self.bcs, clock0.time)
            state = dict(state, solution=sol)
            state = self.project_velocities(state, stage_dt)
            clock = state["clock"].tick(stage_dt, stage=True)
            state = dict(state, clock=clock)
            state = self.update_state(state)
            G_prev = G
        clock = Clock(clock0.time + dt, clock0.iteration + 1, 0)
        state = dict(state, clock=clock, G_prev=G_prev,
                     previous_dt=jnp.full((), 1.0, self.grid.dtype) * dt)
        return self._step_particles(state, dt)

    def _step_particles(self, state, dt):
        """Advect Lagrangian particles with the updated velocity field and
        sample tracked fields (reference: update_particle_properties!
        called inside time_step!, LagrangianParticleTracking.jl)."""
        p = state.get("particles")
        if p is None:
            return state
        sol = state["solution"]
        vels = {k: sol[k] for k in ("u", "v", "w")}
        fields = {n: sol[n] for n in self.tracer_names}
        return dict(state, particles=p.step(self.grid, vels, dt, fields))

    # -- diagnostics ---------------------------------------------------------------
    def cell_diffusion_timescale(self, state):
        """min Δ²/max(ν, κ) over this model's closures (reference
        turbulence_closure_diagnostics.jl); +inf when nothing limits."""
        from ..closures.scalar_diffusivity import cell_diffusion_timescale
        return cell_diffusion_timescale(self.closure, self.grid,
                                        state.get("diffusivities"),
                                        self.tracer_names)

    def cell_advection_timescale(self, state):
        sol = state["solution"]
        grid = self.grid
        scales = []
        for name, loc in (("u", U_LOC), ("v", V_LOC), ("w", W_LOC)):
            if grid.topology[("u", "v", "w").index(name)] is FLAT:
                continue
            axis = ("u", "v", "w").index(name)
            sp = grid.spacing(axis, loc)
            val = grid.interior(sp / jnp.maximum(jnp.abs(sol[name]), 1e-30))
            scales.append(jnp.min(val))
        return jnp.min(jnp.stack(scales))

    def fields(self, state):
        locs = self._locs()
        out = {name: Field(arr, locs[name], self.bcs[name])
               for name, arr in state["solution"].items()}
        out["pNHS"] = Field(state["pNHS"], CENTER, self.pressure_bcs)
        if "pHY" in state:
            out["pHY"] = Field(state["pHY"], CENTER, self.pressure_bcs)
        return out
