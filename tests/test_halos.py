"""Halo regions on the plain path: periodic fills against NumPy's wrap
padding, and each model's halo width against its schemes' stencils."""
import jax.numpy as jnp
import numpy as np
import pytest

from clima_oceananigans_jl_tpu import (
    BOUNDED, FLAT, PERIODIC, CenteredSecondOrder, RectilinearGrid,
    UpwindBiasedThirdOrder, WENO5)
from clima_oceananigans_jl_tpu.boundary_conditions.bcs import fill_halos
from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
from clima_oceananigans_jl_tpu.models.shallow_water import ShallowWaterModel
from clima_oceananigans_jl_tpu.utils.location import C, F


@pytest.mark.parametrize("halo", [1, 3, 4])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_periodic_fill_matches_numpy_wrap(axis, halo):
    """Filling one periodic axis rewrites exactly its two halo slabs, with
    the values np.pad(mode="wrap") gives, for centers and faces alike;
    everything else is left as it was."""
    size = (9, 8, 7)
    topo = [BOUNDED] * 3
    topo[axis] = PERIODIC
    grid = RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=tuple(topo), halo=(halo,) * 3,
                           dtype=jnp.float64)
    data = np.random.default_rng(axis * 10 + halo).standard_normal(grid.total_shape)
    interior = np.take(data, range(halo, halo + size[axis]), axis=axis)
    pad = [(0, 0)] * 3
    pad[axis] = (halo, halo)
    expected = np.pad(interior, pad, mode="wrap")
    for loc in ((C, C, C), tuple(F if a == axis else C for a in range(3))):
        got = np.asarray(fill_halos(jnp.asarray(data), grid, loc, None,
                                    axes=(axis,)))
        np.testing.assert_array_equal(got, expected, err_msg=str(loc))


SCHEMES = [(CenteredSecondOrder(), 1), (UpwindBiasedThirdOrder(), 2),
           (WENO5(), 3)]
SCHEME_IDS = ["Centered2", "UpwindBiased3", "WENO5"]


def _grid(topology, size=(8, 8, 4)):
    # built with a wider halo than any scheme needs: the model sets it
    return RectilinearGrid(size=size, extent=(1.0, 1.0, 1.0),
                           topology=topology, halo=(5, 5, 5),
                           dtype=jnp.float64)


@pytest.mark.parametrize("scheme,halo", SCHEMES, ids=SCHEME_IDS)
def test_nonhydrostatic_halo_is_the_scheme_halo(scheme, halo):
    model = NonhydrostaticModel(_grid((PERIODIC, PERIODIC, BOUNDED)),
                                advection=scheme)
    assert model.grid.halo == (halo, halo, halo)
    assert scheme.required_halo == halo


@pytest.mark.parametrize("scheme,halo", SCHEMES, ids=SCHEME_IDS)
def test_hydrostatic_halo_is_the_scheme_halo(scheme, halo):
    model = HydrostaticFreeSurfaceModel(_grid((PERIODIC, BOUNDED, BOUNDED)),
                                        momentum_advection=scheme,
                                        tracer_advection=scheme)
    assert model.grid.halo == (halo, halo, halo)


@pytest.mark.parametrize("scheme,halo", SCHEMES, ids=SCHEME_IDS)
def test_shallow_water_halo_is_the_scheme_halo(scheme, halo):
    model = ShallowWaterModel(grid=_grid((PERIODIC, PERIODIC, FLAT), (8, 8, 1)),
                              gravitational_acceleration=1.0, advection=scheme)
    assert model.grid.halo == (halo, halo, 0)
