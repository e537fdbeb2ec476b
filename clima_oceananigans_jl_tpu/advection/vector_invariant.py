"""Vector-invariant (rotational-form) momentum advection.

Array re-design of /root/reference/src/Advection/vector_invariant_advection.jl:
the horizontal momentum advection is written

    U·∇u = −(ζ₃ + 0)·v̂ + w∂z(u)-term + ∂x K,   K = (ū²ˣ + v̄²ʸ)/2

with `EnergyConserving` / `EnstrophyConserving` discretizations of the
vorticity term (the default for lat-lon hydrostatic models, matching the
MITgcm vector-invariant scheme the reference cites).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..ops import stencil as st
from ..ops.operators import zeta3_ffc
from ..utils.location import C, F, U_LOC, V_LOC, CENTER


@dataclasses.dataclass(frozen=True)
class VectorInvariant:
    """scheme: 'enstrophy' (default), 'energy' conserving, 'weno'
    (upwinded WENO reconstruction of the vorticity along the transport
    direction with the vorticity's own smoothness — the reference's
    WENOVectorInvariant + VorticityStencil), or 'weno_velocity' (same
    candidates, but the nonlinear weights use the mean smoothness of the
    tangential velocities ℑy u and ℑx v — the reference's
    VelocityStencil, its WENOVectorInvariant default,
    weno_fifth_order.jl:405-440)."""

    scheme: str = "enstrophy"

    @property
    def required_halo(self):
        return 3 if self.scheme in ("weno", "weno_velocity") else 2

    def _weno(self):
        from .schemes import WENO5
        return WENO5()

    def U_dot_grad_u(self, grid, u, v, w):
        """U·∇u at (F,C,C)."""
        zeta = zeta3_ffc(u, v, grid)
        dx_v = grid.dx((C, F, C)) * v
        if self.scheme == "energy":
            vort = -st.iyc(zeta * st.ixf(dx_v)) / grid.dx(U_LOC)
        elif self.scheme in ("weno", "weno_velocity"):
            from .schemes import upwind_stream
            wn = self._weno()
            v_hat = st.ixf(st.iyc(dx_v)) / grid.dx(U_LOC)
            # select-first upwinding (see schemes.transport): pick the
            # upwind stencil streams by sign(v̂), reconstruct ONCE —
            # vel·where(sel, L, R) ≡ ((vel+|vel|)L + (vel−|vel|)R)/2 in
            # IEEE arithmetic at ~half the reconstruction arithmetic
            sel = v_hat >= 0
            az = upwind_stream(zeta, sel, 1, False)
            if self.scheme == "weno_velocity":
                smooths = (st.iyf(u), st.ixf(v))  # tangential vels at (F,F)
                ss = [upwind_stream(f, sel, 1, False) for f in smooths]
                rec = wn.stream_reconstruct_smooth(az, ss)
            else:
                rec = wn.stream_reconstruct(az)  # ζ's own smoothness
            vort = -v_hat * rec
        else:  # enstrophy conserving
            vort = -st.iyc(zeta) * st.ixf(st.iyc(dx_v)) / grid.dx(U_LOC)
        # vertical advection: ℑzᶜ( ℑxᶠ(Az w) ∂zᶠᶜᶠ u ) / Azᶠᶜᶜ
        az_w = grid.Az((C, C, F)) * w
        dz_u = st.dzf(u) / grid.dz((F, C, F))
        vadv = st.izc(st.ixf(az_w) * dz_u) / grid.Az(U_LOC)
        # Bernoulli head: ∂xᶠ K
        K = 0.5 * (st.ixc(u * u) + st.iyc(v * v))
        bern = st.dxf(K) / grid.dx(U_LOC)
        return vort + vadv + bern

    def U_dot_grad_v(self, grid, u, v, w):
        """U·∇v at (C,F,C)."""
        zeta = zeta3_ffc(u, v, grid)
        dy_u = grid.dy((F, C, C)) * u
        if self.scheme == "energy":
            vort = st.ixc(zeta * st.iyf(dy_u)) / grid.dy(V_LOC)
        elif self.scheme in ("weno", "weno_velocity"):
            from .schemes import upwind_stream
            wn = self._weno()
            u_hat = st.iyf(st.ixc(dy_u)) / grid.dy(V_LOC)
            sel = u_hat >= 0
            az = upwind_stream(zeta, sel, 0, False)
            if self.scheme == "weno_velocity":
                smooths = (st.iyf(u), st.ixf(v))
                ss = [upwind_stream(f, sel, 0, False) for f in smooths]
                rec = wn.stream_reconstruct_smooth(az, ss)
            else:
                rec = wn.stream_reconstruct(az)  # ζ's own smoothness
            vort = u_hat * rec
        else:
            vort = st.ixc(zeta) * st.iyf(st.ixc(dy_u)) / grid.dy(V_LOC)
        az_w = grid.Az((C, C, F)) * w
        dz_v = st.dzf(v) / grid.dz((C, F, F))
        vadv = st.izc(st.iyf(az_w) * dz_v) / grid.Az(V_LOC)
        K = 0.5 * (st.ixc(u * u) + st.iyc(v * v))
        bern = st.dyf(K) / grid.dy(V_LOC)
        return vort + vadv + bern
