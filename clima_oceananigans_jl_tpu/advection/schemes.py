"""Advection schemes: reconstruction operators.

Array re-design of /root/reference/src/Advection/: each scheme provides
symmetric and left/right-biased reconstructions of a field onto the
staggered flux location along an axis, as whole-array shift expressions
(XLA fuses each flux evaluation into one stencil pass).

Schemes (reference files):
* CenteredSecondOrder   (centered_second_order.jl)
* CenteredFourthOrder   (centered_fourth_order.jl)
* UpwindBiasedFirstOrder (upwind_biased_first_order.jl)
* UpwindBiasedThirdOrder (upwind_biased_third_order.jl)
* UpwindBiasedFifthOrder (upwind_biased_fifth_order.jl)
* WENO5                  (weno_fifth_order.jl; uniform-grid JS weights)

Conventions: reconstructions "to F" produce a value at face i from
cell-centered data (face i sits between cells i-1 and i); "to C" produce
a value at center i from face data (center i sits between faces i and
i+1, so to-C formulas are the to-F formulas shifted by +1, exactly like
the reference's ``left_biased_interpolate_xᶜᵃᵃ(i+1, ...)`` pattern).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..grids.topology import BOUNDED
from ..ops.stencil import shift, ic, if_, i4c, i4f


@dataclasses.dataclass(frozen=True)
class AdvectionScheme:
    """Base: symmetric = 2nd-order centered."""

    #: extra halo cells needed beyond 1 (reference `boundary_buffer`)
    buffer: int = 0
    is_upwind: bool = False

    def sym_to_f(self, c, axis):
        return if_(c, axis)

    def sym_to_c(self, u, axis):
        return ic(u, axis)

    def left_to_f(self, c, axis):
        raise NotImplementedError

    def right_to_f(self, c, axis):
        raise NotImplementedError

    def left_to_c(self, u, axis):
        return shift(self.left_to_f(u, axis), 1, axis)

    def right_to_c(self, u, axis):
        return shift(self.right_to_f(u, axis), 1, axis)

    @property
    def required_halo(self):
        return max(1, self.buffer + 1)


@dataclasses.dataclass(frozen=True)
class CenteredSecondOrder(AdvectionScheme):
    buffer: int = 0


@dataclasses.dataclass(frozen=True)
class CenteredFourthOrder(AdvectionScheme):
    buffer: int = 1

    def sym_to_f(self, c, axis):
        return i4f(c, axis)

    def sym_to_c(self, u, axis):
        return i4c(u, axis)


@dataclasses.dataclass(frozen=True)
class UpwindBiasedFirstOrder(AdvectionScheme):
    buffer: int = 0
    is_upwind: bool = True

    def left_to_f(self, c, axis):
        return shift(c, -1, axis)

    def right_to_f(self, c, axis):
        return c


@dataclasses.dataclass(frozen=True)
class UpwindBiasedThirdOrder(AdvectionScheme):
    buffer: int = 1
    is_upwind: bool = True

    def left_to_f(self, c, axis):
        s = lambda n: shift(c, n, axis)
        return (2.0 * c + 5.0 * s(-1) - s(-2)) / 6.0

    def right_to_f(self, c, axis):
        s = lambda n: shift(c, n, axis)
        return (-s(1) + 5.0 * c + 2.0 * s(-1)) / 6.0


@dataclasses.dataclass(frozen=True)
class UpwindBiasedFifthOrder(AdvectionScheme):
    buffer: int = 2
    is_upwind: bool = True

    def left_to_f(self, c, axis):
        s = lambda n: shift(c, n, axis)
        return (2.0 * s(-3) - 13.0 * s(-2) + 47.0 * s(-1) + 27.0 * c - 3.0 * s(1)) / 60.0

    def right_to_f(self, c, axis):
        s = lambda n: shift(c, n, axis)
        return (2.0 * s(2) - 13.0 * s(1) + 47.0 * c + 27.0 * s(-1) - 3.0 * s(-2)) / 60.0


@dataclasses.dataclass(frozen=True)
class WENO5(AdvectionScheme):
    """5th-order WENO (Jiang & Shu smoothness weights). Uniform-grid
    constant coefficients on regular axes; on stretched axes
    ``transport`` supplies per-index stencil-coefficient and
    optimal-weight tables derived from the grid's node positions
    (reference weno_fifth_order.jl:21-60 stretched coefficient tuples;
    see advection/reconstruction_tables.py), evaluated via
    ``table_reconstruct``.

    ``fast_bf16=True`` evaluates the nonlinear reconstruction in
    bfloat16 and casts the result back — the smoothness weights are
    heuristic, so this trades ~3 decimal digits of the reconstruction
    for half the bytes of its operands. Off by default (benchmarks and
    parity tests run full fp32/fp64)."""

    buffer: int = 2
    is_upwind: bool = True
    eps: float = 1e-6
    fast_bf16: bool = False
    #: evaluate ONLY the Jiang-Shu smoothness indicators and the nonlinear
    #: weights in bfloat16, keeping the candidate reconstructions (the
    #: accuracy-carrying taps) in full precision. The indicators merely
    #: SELECT a convex combination of the candidates: perturbing them at
    #: bf16 granularity moves the weights within their own O(Δx²)
    #: heuristic slack, so the flux perturbation is bounded by the
    #: scheme's truncation error (accuracy-gated in
    #: tests/test_bf16_smoothness.py).
    bf16_smoothness: bool = False

    def left_to_f(self, c, axis):
        if self.fast_bf16:
            return self._weno_left(c.astype(jnp.bfloat16), axis).astype(c.dtype)
        return self._weno_left(c, axis)

    def right_to_f(self, c, axis):
        if self.fast_bf16:
            return self._weno_right(c.astype(jnp.bfloat16), axis).astype(c.dtype)
        return self._weno_right(c, axis)

    def _weno_left(self, v, axis):
        s = lambda n: shift(v, n, axis)
        vm3, vm2, vm1, v0, vp1 = s(-3), s(-2), s(-1), v, s(1)
        p0 = (2.0 * vm3 - 7.0 * vm2 + 11.0 * vm1) / 6.0
        p1 = (-vm2 + 5.0 * vm1 + 2.0 * v0) / 6.0
        p2 = (2.0 * vm1 + 5.0 * v0 - vp1) / 6.0
        b0 = (13.0 / 12.0) * (vm3 - 2 * vm2 + vm1) ** 2 + 0.25 * (vm3 - 4 * vm2 + 3 * vm1) ** 2
        b1 = (13.0 / 12.0) * (vm2 - 2 * vm1 + v0) ** 2 + 0.25 * (vm2 - v0) ** 2
        b2 = (13.0 / 12.0) * (vm1 - 2 * v0 + vp1) ** 2 + 0.25 * (3 * vm1 - 4 * v0 + vp1) ** 2
        return self._combine(p0, p1, p2, b0, b1, b2)

    def _weno_right(self, v, axis):
        s = lambda n: shift(v, n, axis)
        vp2, vp1, v0, vm1, vm2 = s(2), s(1), v, s(-1), s(-2)
        p0 = (2.0 * vp2 - 7.0 * vp1 + 11.0 * v0) / 6.0
        p1 = (-vp1 + 5.0 * v0 + 2.0 * vm1) / 6.0
        p2 = (2.0 * v0 + 5.0 * vm1 - vm2) / 6.0
        b0 = (13.0 / 12.0) * (vp2 - 2 * vp1 + v0) ** 2 + 0.25 * (vp2 - 4 * vp1 + 3 * v0) ** 2
        b1 = (13.0 / 12.0) * (vp1 - 2 * v0 + vm1) ** 2 + 0.25 * (vp1 - vm1) ** 2
        b2 = (13.0 / 12.0) * (v0 - 2 * vm1 + vm2) ** 2 + 0.25 * (3 * v0 - 4 * vm1 + vm2) ** 2
        return self._combine(p0, p1, p2, b0, b1, b2)

    def lr_to_f_smooth(self, c, smooths, axis):
        """Left/right reconstructions of ``c`` at faces whose nonlinear
        weights use the MEAN Jiang-Shu smoothness of the ``smooths``
        fields instead of ``c``'s own — the reference's VelocityStencil
        (weno_fifth_order.jl:405-440: βₖ = ½(βₖ(ℑy u) + βₖ(ℑx v)) while
        the candidate polynomials reconstruct the vorticity). Built on
        ``stream_reconstruct_smooth`` (the right-biased formulas are the
        left ones on the reflected streams), so the vector-invariant
        select-first path is bit-identical to this two-sided form."""
        s = lambda a, n: shift(a, n, axis)

        def stream(v, left):
            # left: cells i−3..i+1 at face i; right: the reflection
            # (−3,−2,−1,0,1) → (2,1,0,−1,−2)
            return ((s(v, -3), s(v, -2), s(v, -1), v, s(v, 1)) if left
                    else (s(v, 2), s(v, 1), v, s(v, -1), s(v, -2)))

        return tuple(
            self.stream_reconstruct_smooth(
                stream(c, left), [stream(f, left) for f in smooths])
            for left in (True, False))

    def lr_to_c_smooth(self, c, smooths, axis):
        """Face-located data reconstructed onto centers (shift-by-one of
        the to-faces formulas, like left_right_to_c)."""
        L, R = self.lr_to_f_smooth(c, smooths, axis)
        return shift(L, 1, axis), shift(R, 1, axis)

    def stream_reconstruct_smooth(self, a, smooth_streams):
        """Left-biased reconstruction of an upwind-ORDERED candidate
        stream ``a`` whose nonlinear weights use the MEAN Jiang-Shu
        smoothness of the upwind-ordered ``smooth_streams`` (the
        VelocityStencil of ``lr_to_f_smooth``, reference
        weno_fifth_order.jl:405-440). Same symmetry argument as
        ``stream_reconstruct``: the right-biased formulas are exactly
        the left ones on the reflected streams (candidates AND
        smoothness — the indicators square every reflected term), so
        feeding sign-selected streams through one evaluation reproduces
        the same-form two-sided upwind product bit-for-bit (and
        ``lr_to_f_smooth``'s explicit-form blend to fp reassociation)
        at ~half the arithmetic of evaluating both sides
        (tests/test_operators.py equivalence tests)."""
        a0, a1, a2, a3, a4 = a
        d10, d11, d12, d13 = a1 - a0, a2 - a1, a3 - a2, a4 - a3
        p0 = a2 + (5.0 * d11 - 2.0 * d10) / 6.0
        p1 = a2 + (2.0 * d12 + d11) / 6.0
        p2 = a2 + (4.0 * d12 - d13) / 6.0
        bs = []
        for v in smooth_streams:
            v0, v1, v2, v3, v4 = v
            e10, e11, e12, e13 = v1 - v0, v2 - v1, v3 - v2, v4 - v3
            e20, e21, e22 = e11 - e10, e12 - e11, e13 - e12
            bs.append((
                (13.0 / 12.0) * e20 * e20 + 0.25 * (e20 + 2.0 * e11) ** 2,
                (13.0 / 12.0) * e21 * e21 + 0.25 * (e11 + e12) ** 2,
                (13.0 / 12.0) * e22 * e22 + 0.25 * (e22 - 2.0 * e12) ** 2))
        b0 = sum(b[0] for b in bs) / len(bs)
        b1 = sum(b[1] for b in bs) / len(bs)
        b2 = sum(b[2] for b in bs) / len(bs)
        return self._combine(p0, p1, p2, b0, b1, b2)

    def _nl_weights(self, b0, b1, b2, d=(0.1, 0.6, 0.3)):
        """Un-normalized nonlinear weights gk = dk Π_{j≠k}(βj+ε)² — the
        single-division form: αk = dk/(βk+ε)² multiplied through by
        Π(βj+ε)² so the weights become polynomials (the caller keeps
        exactly one division).
        Evaluated in the βs' dtype (bf16 under ``bf16_smoothness``)."""
        eps = self.eps
        t0 = (b0 + eps) * (b0 + eps)
        t1 = (b1 + eps) * (b1 + eps)
        t2 = (b2 + eps) * (b2 + eps)
        return d[0] * (t1 * t2), d[1] * (t0 * t2), d[2] * (t0 * t1)

    def _combine(self, p0, p1, p2, b0, b1, b2, d=(0.1, 0.6, 0.3)):
        if self.bf16_smoothness and p0.dtype == jnp.float32:
            b0, b1, b2 = (b.astype(jnp.bfloat16) for b in (b0, b1, b2))
        g0, g1, g2 = self._nl_weights(b0, b1, b2, d)
        if g0.dtype != p0.dtype:
            g0, g1, g2 = (g.astype(p0.dtype) for g in (g0, g1, g2))
        num = g0 * p0 + g1 * p1 + g2 * p2
        den = g0 + g1 + g2
        return num / den

    def left_right_to_f(self, c, axis):
        """Both biased reconstructions at once with shared subexpressions:
        first/second differences (d1, d2) and the 13/12·d2² smoothness
        terms are common to the left and right stencils at a face —
        ~30% fewer operations than two independent evaluations. Bitwise
        equality with left_to_f/right_to_f is NOT guaranteed (float
        reassociation); both paths are 5th-order JS-WENO."""
        if self.fast_bf16:
            l, r = self._weno_lr(c.astype(jnp.bfloat16), axis)
            return l.astype(c.dtype), r.astype(c.dtype)
        return self._weno_lr(c, axis)

    def left_right_to_c(self, u, axis):
        l, r = self.left_right_to_f(u, axis)
        return shift(l, 1, axis), shift(r, 1, axis)

    def _weno_lr(self, c, axis):
        s = lambda a, n: shift(a, n, axis)
        d1 = c - s(c, -1)            # d1[i] = c[i] − c[i−1]
        d2 = s(d1, 1) - d1           # d2[i] = c[i+1] − 2c[i] + c[i−1]
        t = (13.0 / 12.0) * d2 * d2  # shared β leading term per cell
        d1m2, d1m1, d10, d1p1 = s(d1, -2), s(d1, -1), d1, s(d1, 1)
        d2m2, d2m1, d20, d2p1 = s(d2, -2), s(d2, -1), d2, s(d2, 1)
        tm2, tm1, t0_, tp1 = s(t, -2), s(t, -1), t, s(t, 1)
        cm1, c0, cp1 = s(c, -1), c, s(c, 1)

        # left at face i (cells i−3..i+1)
        b0L = tm2 + 0.25 * (d2m2 + 2.0 * d1m1) ** 2
        b1L = tm1 + 0.25 * (d1m1 + d10) ** 2
        b2L = t0_ + 0.25 * (d20 - 2.0 * d10) ** 2
        p0L = cm1 + (5.0 * d1m1 - 2.0 * d1m2) / 6.0
        p1L = cm1 + (2.0 * d10 + d1m1) / 6.0
        p2L = cm1 + (4.0 * d10 - d1p1) / 6.0

        # right at face i (cells i−2..i+2, mirrored)
        b0R = tp1 + 0.25 * (d2p1 - 2.0 * d1p1) ** 2
        b1R = t0_ + 0.25 * (d1p1 + d10) ** 2
        b2R = tm1 + 0.25 * (d2m1 + 2.0 * d10) ** 2
        p0R = c0 - (5.0 * d1p1 - 2.0 * s(d1, 2)) / 6.0
        p1R = c0 - (2.0 * d10 + d1p1) / 6.0
        p2R = c0 - (4.0 * d10 - d1m1) / 6.0

        return (self._combine(p0L, p1L, p2L, b0L, b1L, b2L),
                self._combine(p0R, p1R, p2R, b0R, b1R, b2R))

    def stream_reconstruct(self, a):
        """Left-biased reconstruction of an upwind-ORDERED 5-point stencil
        stream ``a = (a0..a4)`` (see ``upwind_stream``): the same
        Jiang-Shu arithmetic as ``_weno_lr``'s left branch, expressed in
        first/second differences of the stream. Because the right-biased
        formulas are exactly the left ones on the reflected stream (and
        the smoothness indicators square every reflected term), feeding
        the sign-selected stream through this single evaluation
        reproduces the two-sided upwind flux bit-for-bit at ~55% of the
        arithmetic (tests/test_operators.py upwind-select equivalence)."""
        if self.fast_bf16:
            out = self._weno_stream(tuple(x.astype(jnp.bfloat16) for x in a))
            return out.astype(a[0].dtype)
        return self._weno_stream(a)

    def _weno_stream(self, a):
        a0, a1, a2, a3, a4 = a
        d10, d11, d12, d13 = a1 - a0, a2 - a1, a3 - a2, a4 - a3
        if self.bf16_smoothness and a0.dtype == jnp.float32:
            # the whole indicator branch (second differences, βs, weights)
            # runs in bf16; only the final num/den accumulation returns
            # to f32 (see bf16_smoothness)
            e11, e12 = d11.astype(jnp.bfloat16), d12.astype(jnp.bfloat16)
            e20 = e11 - d10.astype(jnp.bfloat16)
            e21 = e12 - e11
            e22 = d13.astype(jnp.bfloat16) - e12
            b0 = (13.0 / 12.0) * e20 * e20 + 0.25 * (e20 + 2.0 * e11) ** 2
            b1 = (13.0 / 12.0) * e21 * e21 + 0.25 * (e11 + e12) ** 2
            b2 = (13.0 / 12.0) * e22 * e22 + 0.25 * (e22 - 2.0 * e12) ** 2
        else:
            d20, d21, d22 = d11 - d10, d12 - d11, d13 - d12
            b0 = (13.0 / 12.0) * d20 * d20 + 0.25 * (d20 + 2.0 * d11) ** 2
            b1 = (13.0 / 12.0) * d21 * d21 + 0.25 * (d11 + d12) ** 2
            b2 = (13.0 / 12.0) * d22 * d22 + 0.25 * (d22 - 2.0 * d12) ** 2
        p0 = a2 + (5.0 * d11 - 2.0 * d10) / 6.0
        p1 = a2 + (2.0 * d12 + d11) / 6.0
        p2 = a2 + (4.0 * d12 - d13) / 6.0
        return self._combine(p0, p1, p2, b0, b1, b2)

    def table_reconstruct(self, v, axis, tables, side):
        """Biased reconstruction using per-index coefficient tables
        (stretched axes; reconstruction_tables.weno5_tables). The
        smoothness indicators keep the uniform Jiang–Shu formulas with
        geometry-exact stencil polynomials and optimal weights."""
        if self.fast_bf16:
            out = self._table_eval(v.astype(jnp.bfloat16), axis, tables[side])
            return out.astype(v.dtype)
        return self._table_eval(v, axis, tables[side])

    def _table_eval(self, v, axis, side_tables):
        def bx(arr):
            shape = [1] * v.ndim
            shape[axis] = arr.shape[0]
            return arr.reshape(shape).astype(v.dtype)

        ps, bs, ds = [], [], []
        for d, cj, voff, kind in side_tables:
            w0, w1, w2 = (shift(v, o, axis) for o in voff)
            ps.append(bx(cj[0]) * w0 + bx(cj[1]) * w1 + bx(cj[2]) * w2)
            if kind == 0:
                t2 = w0 - 4.0 * w1 + 3.0 * w2
            elif kind == 1:
                t2 = w0 - w2
            else:
                t2 = 3.0 * w0 - 4.0 * w1 + w2
            bs.append((13.0 / 12.0) * (w0 - 2.0 * w1 + w2) ** 2 + 0.25 * t2 * t2)
            ds.append(bx(d))
        return self._combine(*ps, *bs, d=tuple(ds))


@dataclasses.dataclass(frozen=True)
class BoundsPreservingWENO5(WENO5):
    """WENO5 with a monotonicity-limited reconstruction: face values are
    clipped to the adjacent-cell range, in the spirit of the reference's
    positivity-preserving limiter
    (positivity_preserving_tracer_advection_operators.jl). This limits
    reconstruction overshoot and is bounds-preserving under a CFL
    restriction; it does not limit the fluxes themselves, so global
    [m, M] bounds are not strictly guaranteed at large CFL — use
    PositiveWENO5 for the reference's strict flux-level guarantee."""

    def _clip(self, rec, c, axis, to_f):
        if to_f:
            lo = jnp.minimum(shift(c, -1, axis), c)
            hi = jnp.maximum(shift(c, -1, axis), c)
        else:
            lo = jnp.minimum(c, shift(c, 1, axis))
            hi = jnp.maximum(c, shift(c, 1, axis))
        return jnp.clip(rec, lo, hi)

    def left_to_f(self, c, axis):
        return self._clip(super().left_to_f(c, axis), c, axis, True)

    def right_to_f(self, c, axis):
        return self._clip(super().right_to_f(c, axis), c, axis, True)

    def left_to_c(self, u, axis):
        return self._clip(super().left_to_c(u, axis), u, axis, False)

    def right_to_c(self, u, axis):
        return self._clip(super().right_to_c(u, axis), u, axis, False)

    def left_right_to_f(self, c, axis):
        l, r = super().left_right_to_f(c, axis)
        return (self._clip(l, c, axis, True), self._clip(r, c, axis, True))

    def left_right_to_c(self, u, axis):
        l, r = super().left_right_to_c(u, axis)
        return (self._clip(l, u, axis, False), self._clip(r, u, axis, False))


@dataclasses.dataclass(frozen=True)
class PositiveWENO5(WENO5):
    """WENO5 with the reference's FLUX-LEVEL bound-preserving limiter
    (PositiveWENO, positivity_preserving_tracer_advection_operators.jl:
    the Zhang-Shu limiter). Per cell and per axis, the cell's two OUTWARD
    face reconstructions are scaled toward the cell mean by

        θ = min(|hi − c|/|M − c|, |lo − c|/|m − c|, 1),
        M/m = max/min(p̃, c₊ᴸ, c₋ᴿ),  p̃ = (c − ω̂(c₋ᴿ + c₊ᴸ))/(1 − 2ω̂),

    ω̂ = 5/18 (the Gauss-Lobatto end weight), which keeps the
    divergence-form tracer update inside ``bounds`` under the scheme's
    CFL restriction — a strictly stronger guarantee than the
    reconstruction clip of BoundsPreservingWENO5."""

    bounds: tuple = (0.0, float("inf"))

    def limit_lr(self, c, L, R, axis):
        """(L, R) at faces → bound-preserving (L, R). ``L[i]`` is cell
        i−1's outward (rightgoing) reconstruction, ``R[i]`` is cell i's
        outward (leftgoing) one."""
        omega = 5.0 / 18.0
        eps = 1e-20
        lo, hi = self.bounds
        Lp1 = shift(L, 1, axis)    # cell i's outward value at face i+1
        p = (c - omega * (R + Lp1)) / (1.0 - 2.0 * omega)
        M = jnp.maximum(jnp.maximum(p, Lp1), R)
        m = jnp.minimum(jnp.minimum(p, Lp1), R)
        theta = jnp.minimum(jnp.abs((hi - c) / (M - c + eps)),
                            jnp.abs((lo - c) / (m - c + eps)))
        theta = jnp.minimum(theta, 1.0)
        Lp1_lim = theta * (Lp1 - c) + c
        R_lim = theta * (R - c) + c
        return shift(Lp1_lim, -1, axis), R_lim


def upwind_stream(c, sel, axis, to_f):
    """Sign-selected upwind 5-point stencil stream at the flux location:
    element k of the result is the k-th cell of the LEFT-biased stencil
    where ``sel`` (vel ≥ 0) and of the RIGHT-biased stencil otherwise,
    ordered so the left-biased formulas apply directly (the right-biased
    reconstruction is exactly the left one on the reflected stream —
    reference upwind_biased_reconstruction symmetry). ``to_f`` follows
    the to-faces/to-centers shift convention of the scheme methods."""
    s = lambda n: shift(c, n, axis)
    if to_f:
        left = (s(-3), s(-2), s(-1), c, s(1))
        right = (s(2), s(1), c, s(-1), s(-2))
    else:
        left = (s(-2), s(-1), c, s(1), s(2))
        right = (s(3), s(2), s(1), c, s(-1))
    return tuple(jnp.where(sel, l, r) for l, r in zip(left, right))


def upwind_biased_product(vel, left, right):
    """vel·ψ upwind product ((ũ+|ũ|)ψᴸ + (ũ−|ũ|)ψᴿ)/2
    (reference upwind_biased_advective_fluxes.jl:10). Includes the velocity
    factor, so the result is already the advective transport vel*ψ."""
    return 0.5 * ((vel + jnp.abs(vel)) * left + (vel - jnp.abs(vel)) * right)


def reduced_order_masks(grid, axis, scheme):
    """Static near-boundary masks for high-order reconstruction along a
    BOUNDED axis — the whole-array analog of the reference's
    topologically_conditional_interpolation.jl:17-21 buffer predicates.

    Returns None when no reduction applies (periodic/flat axis, or a
    scheme whose stencil already fits, required_halo ≤ 1); otherwise a
    (sym, left, right) triple of (lo, hi) *inclusive with-halo index
    bounds* of the region where the full-order stencil reads only
    interior (+first-ghost) cells. Outside, `transport` falls back to
    second-order centered interpolation, exactly like the reference.
    Bounds (not mask arrays): the select is an iota compare that XLA
    folds into the consuming fusion."""
    Nb = scheme.required_halo
    if Nb <= 1:
        return None
    topo = getattr(grid, "topology", None)
    if topo is None or topo[axis] is not BOUNDED:
        return None
    N = grid.shape[axis]
    H = grid.halo[axis]
    # reference outside_*_buffer (1-based face/center index i = idx-H+1):
    #   symmetric: Nb+1 ≤ i ≤ N-Nb;  left: Nb+1 ≤ i ≤ N+1-Nb;
    #   right: Nb ≤ i ≤ N-Nb
    return ((H + Nb, H + N - Nb - 1),
            (H + Nb, H + N - Nb),
            (H + Nb - 1, H + N - Nb - 1))


def _select_reduced(bounds, axis, hi_arr, lo_arr):
    """hi_arr inside [lo, hi] along `axis`, lo_arr outside (static bounds
    → the compare folds to a constant mask under XLA)."""
    import jax.lax as lax
    lo, hi = bounds
    idx = lax.broadcasted_iota(jnp.int32, hi_arr.shape, axis)
    return jnp.where((idx >= lo) & (idx <= hi), hi_arr, lo_arr)


def _immersed_clear(imm, data_loc, axis, to_f, buffer):
    """True where every cell the high-order stencil reads is fluid
    (the whole-array analog of the reference's conditional fluxes,
    conditional_fluxes.jl:1-193: stencils touching solid cells drop to
    the 2nd-order reconstruction; solid-adjacent faces carry zero
    velocity via the peripheral mask, so their fluxes vanish)."""
    solid = imm.mask_for(tuple(data_loc))
    lo, hi = (-(buffer + 1), buffer) if to_f else (-buffer, buffer + 1)
    near = solid
    for o in range(lo, hi + 1):
        if o:
            near = near | shift(solid, o, axis)
    return ~near


def transport(scheme, vel, c, axis, to_f, grid=None, data_loc=None):
    """Advective transport vel·ψ at the flux location along `axis`.

    `to_f=True`: flux face-located along axis (c centered there); else the
    reverse (c face-located, flux at centers). `vel` must already live at
    the flux location. When `grid` is given and the axis is BOUNDED,
    high-order reconstructions drop to second-order centered within
    `required_halo` cells of the walls (reference
    topologically_conditional_interpolation.jl). When `grid` carries an
    immersed boundary (ImmersedGrid) and `data_loc` names the advected
    field's location, stencils touching solid cells likewise drop to
    second order (conditional_fluxes.jl).
    """
    masks = reduced_order_masks(grid, axis, scheme) if grid is not None else None
    imm = getattr(grid, "immersed", None) if grid is not None else None
    clear = None
    if imm is not None and data_loc is not None and scheme.buffer > 0:
        clear = _immersed_clear(imm, data_loc, axis, to_f, scheme.buffer)
    if not scheme.is_upwind:
        hi = scheme.sym_to_f(c, axis) if to_f else scheme.sym_to_c(c, axis)
        if masks is not None:
            hi = _select_reduced(masks[0], axis, hi,
                                 if_(c, axis) if to_f else ic(c, axis))
        if clear is not None:
            hi = jnp.where(clear, hi, if_(c, axis) if to_f else ic(c, axis))
        return vel * hi
    tables = None
    if grid is not None and isinstance(scheme, WENO5):
        from .reconstruction_tables import weno5_tables
        tables = weno5_tables(grid, axis, to_f)
    if (tables is None and hasattr(scheme, "stream_reconstruct")
            and not (isinstance(scheme, PositiveWENO5) and to_f)):
        # select-first upwinding: pick the upwind stencil by sign(vel),
        # reconstruct ONCE. Bitwise-identical fluxes to the two-sided
        # blend — ((vel+|vel|)L + (vel−|vel|)R)/2 is exactly vel·L or
        # vel·R in IEEE arithmetic — at ~55% of the arithmetic.
        sel = vel >= 0
        a = upwind_stream(c, sel, axis, to_f)
        rec = scheme.stream_reconstruct(a)
        if isinstance(scheme, BoundsPreservingWENO5):
            rec = scheme._clip(rec, c, axis, to_f)
        if masks is not None:
            import jax.lax as lax
            lo_val = if_(c, axis) if to_f else ic(c, axis)
            idx = lax.broadcasted_iota(jnp.int32, rec.shape, axis)
            in_l = (idx >= masks[1][0]) & (idx <= masks[1][1])
            in_r = (idx >= masks[2][0]) & (idx <= masks[2][1])
            rec = jnp.where((sel & in_l) | (~sel & in_r), rec, lo_val)
        if clear is not None:
            rec = jnp.where(clear, rec, a[2])  # a[2] = 1st-order upwind
        return vel * rec
    if tables is not None:  # stretched axis: per-index coefficients
        L = scheme.table_reconstruct(c, axis, tables, "left")
        R = scheme.table_reconstruct(c, axis, tables, "right")
        if isinstance(scheme, BoundsPreservingWENO5):
            L = scheme._clip(L, c, axis, to_f)
            R = scheme._clip(R, c, axis, to_f)
    elif hasattr(scheme, "left_right_to_f"):  # shared-subexpression pair
        L, R = (scheme.left_right_to_f(c, axis) if to_f
                else scheme.left_right_to_c(c, axis))
    elif to_f:
        L, R = scheme.left_to_f(c, axis), scheme.right_to_f(c, axis)
    else:
        L, R = scheme.left_to_c(c, axis), scheme.right_to_c(c, axis)
    if masks is not None:
        lo = if_(c, axis) if to_f else ic(c, axis)
        L = _select_reduced(masks[1], axis, L, lo)
        R = _select_reduced(masks[2], axis, R, lo)
    if clear is not None:
        # near the immersed boundary drop to FIRST-ORDER UPWIND, not the
        # centered mean: collapsing L=R onto the centered value removes
        # all upwind dissipation in a (buffer+1)-cell band along the
        # boundary and lets dispersive wiggles grow without bound there
        # (the centered fallback of reference v0.76 conditional_fluxes.jl
        # shows the same; later Oceananigans upwinds near the boundary —
        # we follow the monotone variant)
        L1 = shift(c, -1, axis) if to_f else c
        R1 = c if to_f else shift(c, 1, axis)
        L = jnp.where(clear, L, L1)
        R = jnp.where(clear, R, R1)
    if isinstance(scheme, PositiveWENO5) and to_f:
        # flux-level Zhang-Shu limiting (applies to cell-centered tracers)
        L, R = scheme.limit_lr(c, L, R, axis)
    return upwind_biased_product(vel, L, R)
