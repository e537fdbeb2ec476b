"""Index-space stencil micro-ops.

Array analog of the reference's inlined difference/interpolation
operators (/root/reference/src/Operators/difference_operators.jl,
interpolation_operators.jl). Instead of per-point ``(i, j, k)`` functions,
each op is a whole-array expression built from static shifts, which XLA
fuses into a single pass over HBM.

Shift convention: ``shift(f, n, axis)[i] = f[i + n]``. Implemented with
``jnp.roll`` (a concat of two static slices): values wrapped across
the array edge land in the halo region, which is (a) exactly correct for
periodic topologies and (b) overwritten by the next halo fill otherwise.
Invariant: stencil ops consume arrays with *valid halos* and produce
arrays whose interior is valid; halos must be refilled before the result's
halo region is read (same contract as the reference's
``fill_halo_regions!`` discipline).

Naming follows the reference's superscript convention: ``_c`` = result at
centers (input at faces), ``_f`` = result at faces (input at centers).
"""
from __future__ import annotations

import jax.numpy as jnp


def shift(f, n, axis):
    """shift(f, n, axis)[i] = f[i + n] (wrap into halos)."""
    if n == 0:
        return f
    return jnp.roll(f, -n, axis=axis)


# -- differences: δ ---------------------------------------------------------
def dc(f, axis):
    """δ onto centers: out[i] = f[i+1] - f[i] (f face-located)."""
    return shift(f, 1, axis) - f


def df(f, axis):
    """δ onto faces: out[i] = f[i] - f[i-1] (f center-located)."""
    return f - shift(f, -1, axis)


# -- 2-point interpolations: ℑ ----------------------------------------------
def ic(f, axis):
    """ℑ onto centers: out[i] = (f[i+1] + f[i]) / 2 (f face-located)."""
    return 0.5 * (shift(f, 1, axis) + f)


def if_(f, axis):
    """ℑ onto faces: out[i] = (f[i] + f[i-1]) / 2 (f center-located)."""
    return 0.5 * (f + shift(f, -1, axis))


# axis-specific aliases for readability in tendency kernels
def dxc(f):
    return dc(f, 0)


def dxf(f):
    return df(f, 0)


def dyc(f):
    return dc(f, 1)


def dyf(f):
    return df(f, 1)


def dzc(f):
    return dc(f, 2)


def dzf(f):
    return df(f, 2)


def ixc(f):
    return ic(f, 0)


def ixf(f):
    return if_(f, 0)


def iyc(f):
    return ic(f, 1)


def iyf(f):
    return if_(f, 1)


def izc(f):
    return ic(f, 2)


def izf(f):
    return if_(f, 2)


# -- 4th-order interpolations (reference interpolation_operators.jl) --------
def i4c(f, axis):
    """4th-order ℑ onto centers: (9(f[i]+f[i+1]) − (f[i−1]+f[i+2]))/16."""
    return (9.0 * (f + shift(f, 1, axis))
            - (shift(f, -1, axis) + shift(f, 2, axis))) / 16.0


def i4f(f, axis):
    """4th-order ℑ onto faces: (9(f[i−1]+f[i]) − (f[i−2]+f[i+1]))/16."""
    return (9.0 * (shift(f, -1, axis) + f)
            - (shift(f, -2, axis) + shift(f, 1, axis))) / 16.0
