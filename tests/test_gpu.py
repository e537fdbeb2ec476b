"""On-card checks: each model stepped in fp64 on the GPU agrees with the
same model stepped in fp64 on the host CPU, in one process.

Marked ``gpu``: they skip in the CPU run and run under
``pytest --gpu -m gpu tests/`` (which ``chip_smoke.py`` starts first).
The model set-ups and the tolerance are ``chip_smoke.py``'s own.
"""
import jax.numpy as jnp
import pytest

import chip_smoke as cs

SMALL = cs.FULL["small"]
SETUPS = {
    "nonhydrostatic": lambda: cs.nonhydrostatic(SMALL["nh"], jnp.float64),
    "hydrostatic": lambda: cs.hydrostatic(*SMALL["hydro"], jnp.float64),
    "shallow_water": lambda: cs.shallow_water(SMALL["sw"], jnp.float64),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(SETUPS))
def test_gpu_fp64_matches_cpu_fp64(name):
    cs.gpu_vs_cpu(name, SETUPS[name])


@pytest.mark.gpu
def test_fft_poisson_gpu_matches_cpu():
    """cuFFT against the CPU FFT on a 64³ periodic-periodic-bounded
    solve, fp64 (the nonhydrostatic pressure solve)."""
    import jax
    import numpy as np
    from clima_oceananigans_jl_tpu import BOUNDED, PERIODIC, RectilinearGrid
    from clima_oceananigans_jl_tpu.solvers.fft_poisson import FFTPoissonSolver

    def solve():
        g = RectilinearGrid(size=(64, 64, 64), extent=(1.0, 1.0, 1.0),
                            topology=(PERIODIC, PERIODIC, BOUNDED),
                            dtype=jnp.float64)
        rhs = jax.random.normal(jax.random.PRNGKey(0), g.shape, jnp.float64)
        return np.asarray(FFTPoissonSolver.build(g).solve(rhs - rhs.mean()))

    on_gpu = solve()
    with jax.default_device(jax.devices("cpu")[0]):
        on_cpu = solve()
    cs.compare("fft poisson 64^3 gpu vs cpu", {"phi": on_gpu},
               {"phi": on_cpu}, cs.TOL_GPU_CPU)
