"""Smoke run of the three ocean models on NVIDIA GPUs, at full size.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # four GPUs: the DistributedModel path only

One GPU, in this order:

1. the card's name and power limit (``nvidia-smi``), before any JAX;
2. the tests marked ``gpu`` (``pytest --gpu -m gpu tests/``), in a child
   process that ends before this process initialises JAX, so only one
   process ever holds the card;
3. device check: JAX's default device must be a GPU;
4. nonhydrostatic 256³ (WENO5, BuoyancyTracer, quasi-AB2, periodic x/y,
   bounded z — the reference's benchmark configuration) in fp32 and fp64;
5. hydrostatic ¼° lat-lon (1440×600×24, VectorInvariant weno_velocity,
   WENO5 T and S, split-explicit 30 substeps, spherical Coriolis,
   stretched z) in fp32 and fp64;
6. shallow water (WENO5, RK3) at 16384² fp32, and 8192² in fp32 and fp64;
7. each fp32 run against the same model stepped in fp64 on the card;
8. small cases stepped in fp64 on the GPU and on ``jax.devices("cpu")``.

Every model is built through its constructor and stepped through
``models.compile.compile_step``, the path ``Simulation`` takes. For each
run it prints the compile seconds, ``compiled.memory_analysis()``, XLA's
bytes accessed, the wall time of the first step and of the next 3, each
ending in ``block_until_ready`` (a first reading, not a benchmark; the
first step carries one-time set-up on the card), and checks the
state is finite and of the grid's dtype. Any failure ends the script
with a non-zero exit code. Only when every phase passed does it print,
as its last line, ``{"ok": true, "device": {...}}``.

``--four`` runs the shallow-water and nonhydrostatic models as
``DistributedModel`` on a (2, 2) mesh of four GPUs (ppermute halo
exchange; all_to_all pencil FFT), compares each with the single-GPU step
of the same model, and prints every device's bytes in use.

Tolerances (relative max-norm error over the field's own max):

* fp32 against fp64 after 4 steps: ``TOL_F32`` = 1e-4. fp32 round-off
  (6e-8) carried through the FFT projection or 90 barotropic substeps
  lands near 1e-6; 1e-4 leaves room for the WENO weights' sensitivity
  and still catches any real difference.
* fp64 on the GPU against fp64 on the CPU: ``TOL_GPU_CPU`` = 1e-10; the
  two backends sum FFTs and reductions in a different order, which
  moves fp64 results by ~1e-15 per operation.
* four GPUs against one, fp64: ``TOL_SHARDED`` = 1e-10; the pencil FFT
  transposes and sums in another order than the single-device FFT.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

TOL_F32 = 1e-4
TOL_GPU_CPU = 1e-10
TOL_SHARDED = 1e-10
STEPS = 3  # timed steps after the first one


# -- device ---------------------------------------------------------------
def card_line():
    """``nvidia-smi``'s name and power limit of every card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def require_gpu(devices, count=1):
    """Raise unless ``devices`` holds at least ``count`` GPUs."""
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        raise RuntimeError(f"needs an NVIDIA GPU; JAX's default device is "
                           f"{platform}")
    if len(devices) < count:
        raise RuntimeError(f"needs {count} GPUs; JAX finds {len(devices)}")


# -- comparison -----------------------------------------------------------
def rel_errors(got, ref):
    """Per-field max|got − ref| / max|ref| (max|got| where ref ≡ 0)."""
    out = {}
    for k, r in ref.items():
        r = np.asarray(r, np.float64)
        g = np.asarray(got[k], np.float64)
        scale = np.abs(r).max()
        diff = np.abs(g - r).max()
        out[k] = float(diff / scale if scale > 0 else diff)
    return out


def compare(name, got, ref, tol):
    """Print each field's relative error beside ``tol``; raise if any
    exceeds it (NaN counts as exceeding)."""
    errs = rel_errors(got, ref)
    for k, e in errs.items():
        print(f"  {name} {k}: rel err {e:.3e} (tol {tol:.0e})", flush=True)
    bad = {k: e for k, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"{name}: fields beyond tolerance {tol}: {bad}")
    return errs


# -- the three configurations -------------------------------------------
def _noise(shape, dtype, seed, scale):
    import jax.numpy as jnp
    # drawn on the host in float32 and cast: the fp32 and fp64 runs, and
    # the GPU and CPU runs, start from the same values (jax.random's
    # normal transform rounds differently on the two backends)
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return jnp.asarray(np.float32(scale) * x, dtype)


def nonhydrostatic(n, dtype):
    """(model, state, dt): the reference's benchmark configuration."""
    import jax.numpy as jnp
    from clima_oceananigans_jl_tpu import BOUNDED, PERIODIC, RectilinearGrid, WENO5
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
    from clima_oceananigans_jl_tpu.models.nonhydrostatic import NonhydrostaticModel
    grid = RectilinearGrid(size=(n, n, n), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, BOUNDED), dtype=dtype)
    model = NonhydrostaticModel(grid, advection=WENO5(),
                                buoyancy=BuoyancyTracer(),
                                timestepper="QuasiAdamsBashforth2")
    state = model.initial_state(u=_noise(grid.shape, dtype, 1, 1e-2),
                                v=_noise(grid.shape, dtype, 2, 1e-2),
                                b=_noise(grid.shape, dtype, 3, 1e-4))
    return model, state, jnp.asarray(1e-4, dtype)


def hydrostatic(nx, ny, nz, dtype):
    """(model, state, dt): the lat-lon flagship at (nx, ny, nz)."""
    import jax.numpy as jnp
    from clima_oceananigans_jl_tpu import WENO5
    from clima_oceananigans_jl_tpu.advection.vector_invariant import VectorInvariant
    from clima_oceananigans_jl_tpu.buoyancy.buoyancy import BuoyancyTracer
    from clima_oceananigans_jl_tpu.coriolis.coriolis import HydrostaticSphericalCoriolis
    from clima_oceananigans_jl_tpu.grids.latlon import LatitudeLongitudeGrid
    from clima_oceananigans_jl_tpu.models.free_surface import SplitExplicitFreeSurface
    from clima_oceananigans_jl_tpu.models.hydrostatic import HydrostaticFreeSurfaceModel
    zf = -3000.0 * (1.0 - np.arange(nz + 1) / nz) ** 1.8
    grid = LatitudeLongitudeGrid(size=(nx, ny, nz), longitude=(0, 360),
                                 latitude=(-75, 75), z=zf, dtype=dtype)
    model = HydrostaticFreeSurfaceModel(
        grid, momentum_advection=VectorInvariant(scheme="weno_velocity"),
        tracer_advection=WENO5(), tracers=("T", "S"),
        free_surface=SplitExplicitFreeSurface(substeps=30),
        coriolis=HydrostaticSphericalCoriolis(), buoyancy=BuoyancyTracer())
    shape = model.grid.shape
    state = model.initial_state(
        u=_noise(shape, dtype, 1, 0.1), v=_noise(shape, dtype, 2, 0.1),
        T=lambda lam, phi, z: 10.0 + 5.0 * jnp.cos(jnp.deg2rad(phi)) + 1e-3 * z,
        S=lambda lam, phi, z: 35.0 + 0.1 * jnp.sin(jnp.deg2rad(2 * lam)),
        b=lambda lam, phi, z: 2e-5 * (z + 3000.0) / 3000.0)
    return model, state, jnp.asarray(600.0, dtype)


def shallow_water(n, dtype):
    """(model, state, dt): WENO5 shallow water on a doubly periodic square."""
    import jax.numpy as jnp
    from clima_oceananigans_jl_tpu import FLAT, PERIODIC, RectilinearGrid, WENO5
    from clima_oceananigans_jl_tpu.models.shallow_water import ShallowWaterModel
    grid = RectilinearGrid(size=(n, n, 1), x=(0, 2 * np.pi), y=(0, 2 * np.pi),
                           topology=(PERIODIC, PERIODIC, FLAT), dtype=dtype)
    model = ShallowWaterModel(grid=grid, gravitational_acceleration=10.0,
                              advection=WENO5())
    h = 1.0 + _noise(model.grid.shape, dtype, 4, 1e-3)
    state = model.initial_state(
        uh=lambda x, y, z: 0.1 * jnp.sin(x) * jnp.cos(y),
        vh=lambda x, y, z: -0.1 * jnp.cos(x) * jnp.sin(y), h=h)
    # Δt = 0.2 Δx / √(g h): an RK3 step well inside its stability limit
    return model, state, jnp.asarray(0.2 * (2 * np.pi / n) / np.sqrt(10.0), dtype)


def interiors(model, state):
    """Host copies of every prognostic interior (plus η when present)."""
    g = model.grid
    out = {k: np.asarray(g.interior(v)) for k, v in state["solution"].items()}
    if "eta" in state:
        e = np.asarray(state["eta"])
        out["eta"] = e[g.Hx:g.Hx + g.Nx, g.Hy:g.Hy + g.Ny]
    return out


# -- one run --------------------------------------------------------------
def run(name, build, steps=STEPS):
    """Build, compile, step once and then ``steps`` times; print the
    readings and return the final interiors (host arrays)."""
    import jax
    from clima_oceananigans_jl_tpu.models.compile import compile_step
    model, state, dt = build()
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    compiled = compile_step(model, donate=True).lower(state, dt).compile()
    t_compile = time.perf_counter() - t0
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    print(f"[{name}] compile {t_compile:.1f} s; XLA bytes accessed/step "
          f"{cost.get('bytes accessed', float('nan')):.6g}; flops/step "
          f"{cost.get('flops', float('nan')):.6g}", flush=True)
    print(f"[{name}] memory_analysis: {compiled.memory_analysis()}", flush=True)
    t0 = time.perf_counter()
    state = jax.block_until_ready(compiled(state, dt))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        state = compiled(state, dt)
    jax.block_until_ready(state)
    wall = time.perf_counter() - t0
    print(f"[{name}] first step {first * 1e3:.3f} ms; next {steps} steps "
          f"{wall * 1e3:.3f} ms wall ({wall / steps * 1e3:.3f} ms/step, "
          "first reading)", flush=True)
    out = interiors(model, state)
    for k, v in out.items():
        if v.dtype != np.dtype(model.grid.dtype):
            raise AssertionError(f"{name}: {k} is {v.dtype}, grid is "
                                 f"{np.dtype(model.grid.dtype)}")
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"{name}: {k} is not finite")
    print(f"[{name}] finite, dtype {np.dtype(model.grid.dtype)}", flush=True)
    return out


def fp32_vs_fp64(name, build):
    """``build(dtype)`` stepped in fp32 and fp64 on the card, compared."""
    import jax.numpy as jnp
    f32 = run(f"{name} fp32", lambda: build(jnp.float32))
    f64 = run(f"{name} fp64", lambda: build(jnp.float64))
    compare(f"{name} fp32 vs fp64", f32, f64, TOL_F32)


def gpu_vs_cpu(name, build):
    """``build()`` (fp64) stepped on the GPU and on the host CPU."""
    import jax
    on_gpu = run(f"{name} gpu", build)
    with jax.default_device(jax.devices("cpu")[0]):
        on_cpu = run(f"{name} cpu", build)
    compare(f"{name} gpu vs cpu", on_gpu, on_cpu, TOL_GPU_CPU)


def one_gpu(sizes):
    """The single-card phases (``sizes``: see ``FULL``)."""
    import jax.numpy as jnp
    n3, hyd, sw, sw_cmp, small = (sizes[k] for k in
                                  ("nh", "hydro", "sw", "sw_cmp", "small"))
    fp32_vs_fp64(f"nonhydrostatic {n3}^3", lambda d: nonhydrostatic(n3, d))
    fp32_vs_fp64("hydrostatic {}x{}x{}".format(*hyd),
                 lambda d: hydrostatic(*hyd, d))
    run(f"shallow water {sw}^2 fp32", lambda: shallow_water(sw, jnp.float32))
    fp32_vs_fp64(f"shallow water {sw_cmp}^2",
                 lambda d: shallow_water(sw_cmp, d))
    gpu_vs_cpu(f"nonhydrostatic {small['nh']}^3 fp64",
               lambda: nonhydrostatic(small["nh"], jnp.float64))
    gpu_vs_cpu("hydrostatic {}x{}x{} fp64".format(*small["hydro"]),
               lambda: hydrostatic(*small["hydro"], jnp.float64))
    gpu_vs_cpu(f"shallow water {small['sw']}^2 fp64",
               lambda: shallow_water(small["sw"], jnp.float64))


FULL = {"nh": 256, "hydro": (1440, 600, 24), "sw": 16384, "sw_cmp": 8192,
        "small": {"nh": 32, "hydro": (72, 30, 8), "sw": 64}}


# -- four GPUs ------------------------------------------------------------
def sharded_vs_single(name, build, devices):
    """``build()`` stepped as a DistributedModel on a (2, 2) mesh of
    ``devices`` and on ``devices[0]`` alone; compared."""
    import jax
    from clima_oceananigans_jl_tpu.parallel.distributed import (
        DistributedModel, make_mesh)
    with jax.default_device(devices[0]):
        single = run(f"{name} one device", build)
    model, state, dt = build()
    dmodel = DistributedModel(model, make_mesh((2, 2), devices))
    dstate = dmodel.scatter_state(state)
    del state
    jax.block_until_ready(dstate)
    used = {str(d): (d.memory_stats() or {}).get("bytes_in_use")
            for d in devices}
    print(f"[{name} 4 devices] bytes_in_use per device after scatter: {used}",
          flush=True)
    if devices[0].platform == "gpu" and not all(used.values()):
        raise AssertionError(f"{name}: a device holds no state: {used}")
    t0 = time.perf_counter()
    dstate = jax.block_until_ready(dmodel.step(dstate, dt))
    print(f"[{name} 4 devices] compile + first step "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    for _ in range(STEPS):
        dstate = dmodel.step(dstate, dt)
    jax.block_until_ready(dstate)
    wall = time.perf_counter() - t0
    print(f"[{name} 4 devices] next {STEPS} steps {wall * 1e3:.3f} ms wall "
          f"({wall / STEPS * 1e3:.3f} ms/step, first reading)", flush=True)
    sharded = interiors(model, dmodel.gather_state(dstate))
    compare(f"{name} 4 devices vs 1", sharded, single, TOL_SHARDED)


def four_gpus(devices, sw_n=8192, nh_n=256):
    import jax.numpy as jnp
    sharded_vs_single(f"shallow water {sw_n}^2 fp64",
                      lambda: shallow_water(sw_n, jnp.float64), devices)
    sharded_vs_single(f"nonhydrostatic {nh_n}^3 fp64",
                      lambda: nonhydrostatic(nh_n, jnp.float64), devices)


# -- main -----------------------------------------------------------------
def gpu_tests():
    """The tests marked gpu, in a child that ends before JAX starts here."""
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
           "--gpu", "-m", "gpu", os.path.join(REPO, "tests")]
    print("$ " + " ".join(cmd[1:]), flush=True)
    rc = subprocess.run(cmd, cwd=REPO).returncode
    if rc != 0:
        raise RuntimeError(f"gpu-marked tests failed (pytest exit {rc})")


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    args.add_argument("--four", action="store_true",
                      help="four GPUs: the DistributedModel path only")
    four = args.parse_args(argv).four
    if not os.path.isdir(os.path.join(REPO, "clima_oceananigans_jl_tpu")):
        raise RuntimeError(f"no package beside chip_smoke.py in {REPO}; run "
                           "it from a checkout of the repository")
    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and not {"cuda", "gpu"} & set(platforms.split(",")):
        raise RuntimeError(f"needs an NVIDIA GPU; JAX_PLATFORMS={platforms}")
    print(card_line(), flush=True)
    if not four:
        gpu_tests()
    import jax
    jax.config.update("jax_enable_x64", True)
    count = 4 if four else 1
    require_gpu(jax.devices(), count)
    from clima_oceananigans_jl_tpu.utils.compile_cache import (
        enable_persistent_cache)
    enable_persistent_cache()
    dev = jax.devices()[0]
    print(f"JAX: {dev.platform} {dev.device_kind} x{len(jax.devices())}",
          flush=True)
    if four:
        four_gpus(jax.devices()[:4])
    else:
        one_gpu(FULL)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # report the reason; exit non-zero, no ok line
        print(f"chip_smoke FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        raise
