"""Buoyancy models.

Array form of /root/reference/src/BuoyancyModels/:
* ``BuoyancyTracer`` — buoyancy b is a prognostic tracer (buoyancy_tracer.jl)
* ``SeawaterBuoyancy`` — b = g(α T − β S) with a ``LinearEquationOfState``
  (linear_equation_of_state.jl) or the TEOS-10 polynomial
  (nonlinear_equation_of_state.jl; see buoyancy/teos10.py)
* gravity tilting via ``gravity_unit_vector`` (buoyancy.jl) activates the
  x/y `dot_g_b` terms (g_dot_b.jl)

All provide ``buoyancy_perturbation(grid, tracers) -> b at (C,C,C)``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..ops import stencil as st


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BuoyancyTracer:
    """b is prognostic; requires a tracer named 'b'."""

    gravity_unit_vector: tuple = (0.0, 0.0, -1.0)

    required_tracers = ("b",)

    def buoyancy_perturbation(self, grid, tracers):
        return tracers["b"]

    def tree_flatten(self):
        return (), (self.gravity_unit_vector,)

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(static[0])


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class LinearEquationOfState:
    """ρ′ ∝ −α T + β S (reference linear_equation_of_state.jl)."""

    thermal_expansion: float = 1.67e-4
    haline_contraction: float = 7.80e-4

    def tree_flatten(self):
        return (self.thermal_expansion, self.haline_contraction), ()

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class SeawaterBuoyancy:
    """b = g (α T − β S) for the linear EOS; TEOS-10 via equation_of_state
    object providing ``density_anomaly(T, S, z)``
    (reference seawater_buoyancy.jl)."""

    gravitational_acceleration: float = 9.80665
    equation_of_state: object = LinearEquationOfState()
    constant_temperature: object = None
    constant_salinity: object = None
    gravity_unit_vector: tuple = (0.0, 0.0, -1.0)

    @property
    def required_tracers(self):
        names = []
        if self.constant_temperature is None:
            names.append("T")
        if self.constant_salinity is None:
            names.append("S")
        return tuple(names)

    def buoyancy_perturbation(self, grid, tracers):
        g = self.gravitational_acceleration
        T = tracers["T"] if self.constant_temperature is None else self.constant_temperature
        S = tracers["S"] if self.constant_salinity is None else self.constant_salinity
        eos = self.equation_of_state
        if isinstance(eos, LinearEquationOfState):
            return g * (eos.thermal_expansion * T - eos.haline_contraction * S)
        # nonlinear EOS: b = −g ρ′/ρ₀ evaluated pointwise
        zc = grid.nodes((_C, _C, _C), with_halo=True)[2]
        rho0 = getattr(eos, "reference_density", 1020.0)
        return -g * eos.density_anomaly(T, S, zc) / rho0

    def tree_flatten(self):
        return ((self.gravitational_acceleration, self.equation_of_state,
                 self.constant_temperature, self.constant_salinity),
                (self.gravity_unit_vector,))

    @classmethod
    def tree_unflatten(cls, static, leaves):
        return cls(*leaves, gravity_unit_vector=static[0])


from ..utils.location import C as _C  # noqa: E402  (used above at trace time)


def buoyancy_z_term(buoyancy, grid, tracers, w):
    """z_dot_g_b at (C,C,F): buoyancy interpolated to w points."""
    if buoyancy is None:
        return jnp.zeros_like(w)
    b = buoyancy.buoyancy_perturbation(grid, tracers)
    gz = buoyancy.gravity_unit_vector[2]
    return -gz * st.izf(b)


def buoyancy_x_term(buoyancy, grid, tracers):
    """x_dot_g_b at (F,C,C) for tilted gravity (reference g_dot_b.jl:
    ĝ_x·b with ĝ the *upward* unit vector; our stored gravity_unit_vector
    points down, hence the sign flip). Zero (None) when gravity is ẑ."""
    gx = buoyancy.gravity_unit_vector[0]
    if gx == 0.0:
        return None
    return -gx * st.ixf(buoyancy.buoyancy_perturbation(grid, tracers))


def buoyancy_y_term(buoyancy, grid, tracers):
    """y_dot_g_b at (C,F,C) for tilted gravity (see buoyancy_x_term)."""
    gy = buoyancy.gravity_unit_vector[1]
    if gy == 0.0:
        return None
    return -gy * st.iyf(buoyancy.buoyancy_perturbation(grid, tracers))


def hydrostatic_pressure_anomaly(buoyancy, grid, tracers):
    """pHY′ at centers from downward integration of z_dot_g_b = ĝ_z b̄ᶻ
    (reference update_hydrostatic_pressure.jl): with-halo array, halos
    zero-gradient filled by the caller. For tilted gravity only the
    vertical component enters pHY′; the x/y components are direct
    tendency terms (buoyancy_x_term / buoyancy_y_term)."""
    from ..utils.location import W_LOC
    b = buoyancy.buoyancy_perturbation(grid, tracers)
    gz = buoyancy.gravity_unit_vector[2]
    if gz != -1.0:
        b = -gz * b
    b_f = st.izf(b)                    # at (C,C,F): face k between centers k−1,k
    S = b_f * grid.dz(W_LOC)           # b̄(k)·Δzᶠ(k) at faces
    Nz, Hz = grid.Nz, grid.Hz
    S_int = S[:, :, Hz + 1:Hz + Nz + 1]  # faces 1..Nz
    ph_int = -jnp.flip(jnp.cumsum(jnp.flip(S_int, 2), 2), 2)
    return jnp.zeros(grid.total_shape, grid.dtype).at[:, :, Hz:Hz + Nz].set(ph_int)
