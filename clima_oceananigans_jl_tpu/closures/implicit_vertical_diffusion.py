"""Vertically-implicit diffusion: backward-Euler column solve.

Array analog of the reference's src/TurbulenceClosures/
vertically_implicit_diffusion_solver.jl:44-70: after the explicit
(advection + horizontal diffusion) substep, each prognostic field is
updated by solving

    (I − Δt ∂z κ ∂z) c^{n+1} = c*

column-wise. The tridiagonal bands are built from κ evaluated at the
staggered z-location opposite the field's (faces for z-centered fields,
centers for w), and the batched Thomas solve (solvers/tridiagonal.py —
two ``lax.scan``s with the full horizontal plane as the batch)
does the inversion. Zero-flux (Neumann) walls for z-centered fields;
zero-Dirichlet boundary faces for w.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..solvers.tridiagonal import solve_batched_tridiagonal
from ..utils.location import C, F


def _kappa_plane(kappa, grid, k_index, at_faces):
    """κ at one z level (face index or center index), broadcastable over (x,y)."""
    if callable(kappa):
        az = grid._axes[2]
        z = az.cf[k_index] if at_faces else az.cc[k_index]
        return kappa(z)
    k = jnp.asarray(kappa)
    if k.ndim == 0:
        return k
    if k.ndim == 1:  # 1D column profile, with-halo or interior+1 indexing
        return k[k_index]
    return k[:, :, k_index]  # 3D with-halo diffusivity array


def implicit_vertical_diffusion_step(data, grid, loc, kappa, dt,
                                     linear_coeff=None, bc_bottom=None,
                                     bc_top=None, t=0.0):
    """Solve (I − Δt(∂z κ ∂z + L)) out = data along z; returns with-halo
    array.

    `data`: with-halo (X, Y, Z) array. `kappa`: scalar, callable(z), 1D
    with-halo column, or 3D with-halo array, evaluated at z-faces for
    z-centered fields / z-centers for z-face fields. `linear_coeff`: an
    optional per-cell linear operator coefficient L ≤ 0 (with-halo 3D
    array at the field's own location) folded into the diagonal — used
    for CATKE's implicit dissipation Lᵉ = −Cᴰ√e/ℓ (reference
    vertically_implicit_diffusion_solver.jl + CATKE
    implicit_linear_coefficient).

    `bc_bottom`/`bc_top`: the field's wall BCs. Value (Dirichlet) and
    Gradient walls are folded INTO the solve (ghost = 2b_w − c and the
    prescribed-gradient flux respectively) — the reference's ivd solver
    hardwires zero-flux walls and so silently ignores Dirichlet walls
    under implicit diffusion; flux BCs stay explicit (they enter the
    tendency via apply_flux_bcs, like the reference)."""
    az = grid._axes[2]
    Nz, Hz = az.n, az.h
    if Nz == 1:
        return data
    dzc = az.dc  # cell widths (center spacing), with-halo 1D
    dzf = az.df  # center-to-center distances (face spacing), with-halo 1D

    def _bands(lower, upper, shape2):
        """Stack per-level band entries: (Nz,) 1D when every entry is a
        z-only scalar (the solver then broadcasts per-level scalars in
        the scan — no (X, Y, Nz) band materialization + transpose, ~6
        full-field passes saved per solve), else (X, Y, Nz)."""
        if all(x.ndim == 0 for x in lower + upper):
            return jnp.stack(lower), jnp.stack(upper), True
        return (jnp.stack([jnp.broadcast_to(x, shape2) for x in lower],
                          axis=-1),
                jnp.stack([jnp.broadcast_to(x, shape2) for x in upper],
                          axis=-1), False)

    if loc[2] is C:
        # unknowns at cell centers k = 0..Nz−1; κ at faces k = 0..Nz
        def kap(kidx):  # κ at face kidx (logical), broadcast over (x,y)
            return _kappa_plane(kappa, grid, Hz + kidx, True)

        lower = []
        upper = []
        for k in range(Nz):
            a_k = -dt * kap(k) / (dzc[Hz + k] * dzf[Hz + k]) if k > 0 else 0.0
            c_k = -dt * kap(k + 1) / (dzc[Hz + k] * dzf[Hz + k + 1]) if k < Nz - 1 else 0.0
            lower.append(jnp.asarray(a_k, data.dtype))
            upper.append(jnp.asarray(c_k, data.dtype))
        a, c, bands_1d = _bands(lower, upper, data.shape[:2])
        if linear_coeff is not None and bands_1d:
            a = jnp.broadcast_to(a.reshape(1, 1, -1), data.shape[:2] + (Nz,))
            c = jnp.broadcast_to(c.reshape(1, 1, -1), data.shape[:2] + (Nz,))
            bands_1d = False
        b = 1.0 - a - c
        if linear_coeff is not None:
            b = b - dt * linear_coeff[:, :, Hz: Hz + Nz]
        rhs = data[:, :, Hz: Hz + Nz]

        # fold Dirichlet/gradient walls into the wall rows
        def wall(bc, side):
            nonlocal a, b, c, rhs, bands_1d
            if bc is None or bc.kind not in ("value", "gradient"):
                return
            from ..boundary_conditions.bcs import _bvalue
            bw = jnp.asarray(_bvalue(bc, grid, 2, side, loc, t), data.dtype)
            if bw.ndim == 3:
                bw = bw[:, :, 0]
            kk = 0 if side == 0 else Nz - 1
            kface = 0 if side == 0 else Nz
            kap_w = kap(kface)
            dz_c = dzc[Hz + kk]
            if bc.kind == "value":
                # ghost = 2·b_w − c ⇒ wall flux = 2κ(c − b_w)/Δz_f
                dz_f = dzf[Hz + kface]
                coef = dt * 2.0 * kap_w / (dz_c * dz_f)
                if bands_1d and jnp.ndim(coef) == 0:
                    b = b.at[kk].add(coef)
                else:
                    if bands_1d:  # spatially-varying wall κ: promote
                        sh = data.shape[:2] + (Nz,)
                        a = jnp.broadcast_to(a.reshape(1, 1, -1), sh)
                        b = jnp.broadcast_to(b.reshape(1, 1, -1), sh)
                        c = jnp.broadcast_to(c.reshape(1, 1, -1), sh)
                        bands_1d = False
                    b = b.at[:, :, kk].add(
                        jnp.broadcast_to(coef, b.shape[:2]))
                rhs = rhs.at[:, :, kk].add(
                    jnp.broadcast_to(coef * bw, rhs.shape[:2]))
            else:  # prescribed wall gradient g: flux = κ·g (constant → RHS)
                sgn = -1.0 if side == 0 else 1.0
                rhs = rhs.at[:, :, kk].add(jnp.broadcast_to(
                    sgn * dt * kap_w * bw / dz_c, rhs.shape[:2]))

        wall(bc_bottom, 0)
        wall(bc_top, 1)
        sol = solve_batched_tridiagonal(a, b, c, rhs)
        return data.at[:, :, Hz: Hz + Nz].set(sol)

    # z-face-located (w): unknowns at interior faces k = 1..Nz−1, κ at centers;
    # boundary faces remain fixed (impenetrable walls ⇒ w = 0 there).
    def kapc(kidx):
        return _kappa_plane(kappa, grid, Hz + kidx, False)

    n = Nz - 1
    if n < 1:
        return data
    lower = []
    upper = []
    for j in range(n):
        k = j + 1  # face index
        a_k = -dt * kapc(k - 1) / (dzf[Hz + k] * dzc[Hz + k - 1]) if j > 0 else 0.0
        c_k = -dt * kapc(k) / (dzf[Hz + k] * dzc[Hz + k]) if j < n - 1 else 0.0
        lower.append(jnp.asarray(a_k, data.dtype))
        upper.append(jnp.asarray(c_k, data.dtype))
    a, c, _ = _bands(lower, upper, data.shape[:2])
    b = 1.0 - a - c
    rhs = data[:, :, Hz + 1: Hz + Nz]
    sol = solve_batched_tridiagonal(a, b, c, rhs)
    return data.at[:, :, Hz + 1: Hz + Nz].set(sol)


def _vertical_coefficient(closure, name, diffusivities):
    """κz for one field from a closure (scalar config or per-step field)."""
    if name in ("u", "v", "w"):
        if hasattr(closure, "vertical_nu"):
            return closure.vertical_nu(diffusivities)
        return closure.nu_z if closure.nu_z is not None else closure.nu
    if hasattr(closure, "vertical_kappa"):
        return closure.vertical_kappa(name, diffusivities)
    return closure.kappa_z_for(name)


def implicit_step_fields(solution, grid, locs, closure, dt, diffusivities=None,
                         bcs=None, t=0.0):
    """Apply the implicit vertical solve to every prognostic field
    (reference implicit_step!, quasi_adams_bashforth_2.jl:137-144).
    Closure tuples apply sequentially (operator splitting). ``bcs``
    (dict name → FieldBCs) folds Value/Gradient wall conditions into
    the solves."""
    if closure is None:
        return solution
    if isinstance(closure, (tuple, list)):
        diffusivities = diffusivities or (None,) * len(closure)
        for c, d in zip(closure, diffusivities):
            solution = implicit_step_fields(solution, grid, locs, c, dt, d,
                                            bcs, t)
        return solution
    if not getattr(closure, "vertically_implicit", False):
        return solution
    from ..ops import stencil as _st
    out = {}
    for name, data in solution.items():
        kz = _vertical_coefficient(closure, name, diffusivities)
        if hasattr(kz, "ndim") and kz.ndim == 3:
            # (C,C,F)-located diffusivity fields: move to the field's own
            # horizontal staggering
            if locs[name][0] is not C:
                kz = _st.ixf(kz)
            if locs[name][1] is not C:
                kz = _st.iyf(kz)
        lin = (closure.implicit_linear_coefficient(name, diffusivities)
               if hasattr(closure, "implicit_linear_coefficient") else None)
        fb = bcs.get(name) if bcs else None
        out[name] = implicit_vertical_diffusion_step(
            data, grid, locs[name], kz, dt, lin,
            bc_bottom=fb.bottom if fb else None,
            bc_top=fb.top if fb else None, t=t)
    return out
