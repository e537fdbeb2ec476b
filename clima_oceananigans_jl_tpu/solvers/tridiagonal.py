"""Batched tridiagonal (Thomas) solver along z.

Array analog of the reference's src/Solvers/batched_tridiagonal_solver.jl:
solves M φ = rhs column-wise for every (i, j), where M is tridiagonal with
lower/diagonal/upper bands (a, b, c). Bands may be 1D (z only) or 3D.

Implemented as two `lax.scan`s (forward elimination, back substitution)
over the z axis with the full (x, y) plane as the batch — each scan step
is one fused elementwise pass over an (Nx, Ny) slab.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _as3d(band, shape):
    band = jnp.asarray(band)
    if band.ndim == 1:
        return jnp.broadcast_to(band.reshape(1, 1, -1), shape)
    return jnp.broadcast_to(band, shape)


def solve_batched_tridiagonal(a, b, c, d):
    """Thomas algorithm along the last axis; a[...,0] and c[...,-1] ignored.

    a: lower band (a[k] multiplies φ[k-1])
    b: diagonal
    c: upper band (c[k] multiplies φ[k+1])
    d: right-hand side, shape (..., Nz)

    1D (z-only) bands stay 1D through the scan — each step then reads a
    per-level SCALAR that broadcasts against the (Nx, Ny) plane, instead
    of materializing + transposing three full (Nx, Ny, Nz) band arrays
    (~6 full-field passes of pure streaming for a constant-coefficient
    closure). Bit-identical: the per-element arithmetic is the same
    fused multiply-adds either way."""
    shape = d.shape
    a, b, c = (jnp.asarray(x) for x in (a, b, c))
    if d.ndim == 3 and a.ndim == 1 and b.ndim == 1 and c.ndim == 1:
        # z-only bands: shape (Nz, 1, 1) so scan steps yield (1, 1)
        # scalars that broadcast against the (Nx, Ny) plane
        a_t = a.reshape(-1, 1, 1)
        b_t = b.reshape(-1, 1, 1)
        c_t = c.reshape(-1, 1, 1)
    else:
        a = _as3d(a, shape) if d.ndim == 3 else jnp.broadcast_to(a, shape)
        b = _as3d(b, shape) if d.ndim == 3 else jnp.broadcast_to(b, shape)
        c = _as3d(c, shape) if d.ndim == 3 else jnp.broadcast_to(c, shape)
        a_t = jnp.moveaxis(a, -1, 0)
        b_t = jnp.moveaxis(b, -1, 0)
        c_t = jnp.moveaxis(c, -1, 0)
    d_t = jnp.moveaxis(d, -1, 0)

    def fwd(carry, xs):
        cp_prev, dp_prev = carry
        ak, bk, ck, dk = xs
        denom = bk - ak * cp_prev
        cp = ck / denom
        dp = (dk - ak * dp_prev) / denom
        return (cp, dp), (cp, dp)

    zeros = jnp.zeros_like(d_t[0])
    (_, _), (cp, dp) = jax.lax.scan(fwd, (zeros, zeros), (a_t, b_t, c_t, d_t))

    def bwd(phi_next, xs):
        cpk, dpk = xs
        phi = dpk - cpk * phi_next
        return phi, phi

    _, phi_rev = jax.lax.scan(bwd, zeros, (cp, dp), reverse=True)
    return jnp.moveaxis(phi_rev, 0, -1)
