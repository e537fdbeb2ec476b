"""Shared set-up of the benchmark scripts.

``setup()`` refuses to run unless JAX's default device is a GPU, turns
on the persistent compilation cache, and prints the card's name and
power limit; every script calls it before it builds a model.
``peak(device)`` returns the published peak rates of the device, keyed
by ``device_kind``; a device missing from the table is an error.
"""
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: published peaks, NVIDIA H100 SXM data sheet (dense, no sparsity), at
#: the full 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12,
                              "fp64_flops_per_s": 34e12},
}


def setup():
    """The GPU device, after the checks above; exits without a GPU."""
    import jax
    from clima_oceananigans_jl_tpu.utils.compile_cache import (
        enable_persistent_cache)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"{sys.argv[0]} needs a GPU; JAX's default device is "
                 f"{dev.platform}")
    enable_persistent_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"device: {dev.device_kind} x{len(jax.devices())}; card: {card}",
          flush=True)
    return dev


def peak(device):
    """Published peak rates of ``device`` (KeyError if not tabled)."""
    if device.device_kind not in PEAKS:
        raise KeyError(f"no published peaks for {device.device_kind!r}; "
                       "add them to benchmark/bench_common.py")
    return PEAKS[device.device_kind]
