"""XLA's cost analysis of the compiled AB2 step: flops and bytes accessed,
and the time those would take at the card's published peaks."""
import sys
import bench_common
DEVICE = bench_common.setup()
import jax, jax.numpy as jnp
from clima_oceananigans_jl_tpu import PERIODIC, BOUNDED, RectilinearGrid, WENO5
from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
from clima_oceananigans_jl_tpu.models.compile import compile_step
from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel

n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
grid = RectilinearGrid(size=(n, n, n), extent=(1., 1., 1.),
                       topology=(PERIODIC, PERIODIC, BOUNDED), dtype=jnp.float32)
model = NonhydrostaticModel(grid, advection=WENO5(), buoyancy=BuoyancyTracer(),
                            timestepper="QuasiAdamsBashforth2")
state = jax.eval_shape(lambda: model.initial_state())
state = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), state)
comp = compile_step(model, donate=True).lower(state, jnp.float32(1e-4)).compile()
ca = comp.cost_analysis()
ca = ca[0] if isinstance(ca, (list, tuple)) else ca
flops = ca.get("flops", 0); ba = ca.get("bytes accessed", 0)
print(f"flops/step: {flops/1e9:.2f} G  bytes accessed: {ba/1e9:.2f} GB")
pk = bench_common.peak(DEVICE)
print(f"at {pk['hbm_bytes_per_s']/1e12:.2f} TB/s -> "
      f"{ba/pk['hbm_bytes_per_s']*1e3:.2f} ms;  at "
      f"{pk['fp32_flops_per_s']/1e12:.0f} TFLOP/s fp32 -> "
      f"{flops/pk['fp32_flops_per_s']*1e3:.2f} ms (published peaks)")
print("memory:", comp.memory_analysis())
