"""Staggered C-grid location system.

The reference encodes staggered locations at the type level
(``Center``/``Face`` in /root/reference/src/Grids/Grids.jl:1-14, used as
superscripts on every operator in src/Operators/). Here we make the
location an explicit, hashable static value carried alongside arrays:
every field has a ``loc = (X, Y, Z)`` triple with each entry ``C`` or
``F``, used to select metric arrays and boundary-condition formulas at
trace time (all branching is static under jit).
"""
from __future__ import annotations

import enum


class Loc(str, enum.Enum):
    """Location of a variable along one axis of the staggered C-grid."""

    C = "c"  # cell center
    F = "f"  # cell face (face i is the *left/lower* face of cell i)

    def __repr__(self) -> str:  # compact reprs in error messages
        return self.value


C = Loc.C
F = Loc.F

#: canonical locations for the prognostic velocity components (Arakawa C)
U_LOC = (F, C, C)
V_LOC = (C, F, C)
W_LOC = (C, C, F)
#: canonical location for tracers / pressure
CENTER = (C, C, C)


def flip(loc: Loc) -> Loc:
    return F if loc is C else C
