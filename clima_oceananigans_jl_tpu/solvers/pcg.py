"""Matrix-free preconditioned conjugate-gradient solver.

Array analog of the reference's src/Solvers/preconditioned_conjugate_gradient_solver.jl:
``solve(A, b, x0)`` with a user linear operator ``A(x)`` (a jit-traceable
array function, e.g. the implicit free-surface operator including its halo
fills) and optional preconditioner ``M(r)``. The iteration is one
``lax.while_loop`` so the whole solve stays on-device; reductions are
plain ``jnp.sum`` which XLA turns into cross-replica ``psum`` when the
arrays are sharded.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def cg_solve(A, b, x0, M=None, reltol=1e-8, abstol=0.0, maxiter=200,
             axis_names=()):
    """Solve A x = b (A symmetric positive definite). Returns (x, iters, res²).

    `axis_names`: mesh axes to psum the inner products over when the solve
    runs inside a shard_map (each shard holds a block of x/b)."""
    if M is None:
        M = lambda r: r

    def dot(a, c):
        s = jnp.sum(a * c)
        for name in axis_names:
            s = jax.lax.psum(s, name)
        return s

    r0 = b - A(x0)
    z0 = M(r0)
    rho0 = dot(r0, z0)
    bnorm2 = dot(b, b)
    tol2 = jnp.maximum(reltol * reltol * bnorm2, abstol * abstol)

    def cond(carry):
        x, r, p, rho, it = carry
        return (dot(r, r) > tol2) & (it < maxiter)

    def body(carry):
        x, r, p, rho, it = carry
        Ap = A(p)
        alpha = rho / dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rho_new = dot(r, z)
        beta = rho_new / rho
        p = z + beta * p
        return (x, r, p, rho_new, it + 1)

    x, r, p, rho, it = jax.lax.while_loop(
        cond, body, (x0, r0, z0, rho0, jnp.zeros((), jnp.int32)))
    return x, it, dot(r, r)
