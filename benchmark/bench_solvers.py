import sys
import bench_common
DEVICE = bench_common.setup()
import time, jax, jax.numpy as jnp, numpy as np
from clima_oceananigans_jl_tpu import PERIODIC, BOUNDED, RectilinearGrid
from clima_oceananigans_jl_tpu.solvers.fft_poisson import FFTPoissonSolver
from clima_oceananigans_jl_tpu.solvers.fourier_tridiagonal import FourierTridiagonalSolver

n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
grid = RectilinearGrid(size=(n, n, n), extent=(1., 1., 1.),
                       topology=(PERIODIC, PERIODIC, BOUNDED), dtype=jnp.float32)
rhs = jax.random.normal(jax.random.PRNGKey(0), grid.shape, jnp.float32)
rhs = rhs - rhs.mean()

fft = FFTPoissonSolver.build(grid)
ftr = FourierTridiagonalSolver.build(grid)

def bench(name, fn, reps=10):
    f = jax.jit(fn)
    out = f(rhs); jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = f(rhs)
    jax.block_until_ready(out)
    print(f"{name}: {(time.perf_counter()-t0)/reps*1e3:.2f} ms", flush=True)
    return out

a = bench("fft+dct solve", fft.solve)
b = bench("fourier-tridiagonal solve", ftr.solve)
print("solutions agree:", bool(jnp.allclose(a, b, atol=np.abs(np.asarray(a)).max()*2e-4)),
      float(jnp.abs(a - b).max()), float(jnp.abs(a).max()), flush=True)
