"""Output writers / checkpointer / readers tests
(model: /root/reference/test/test_output_writers.jl, test_output_readers.jl,
test_checkpointer.jl — incl. the bit-identical-continuation test)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from clima_oceananigans_jl_tpu import (
    FLAT, PERIODIC, RectilinearGrid, Simulation, IterationInterval, WENO5,
)
from clima_oceananigans_jl_tpu.models.shallow_water import ShallowWaterModel
from clima_oceananigans_jl_tpu.output.writers import (
    HDF5OutputWriter, NetCDFOutputWriter, WindowedTimeAverage,
)
from clima_oceananigans_jl_tpu.output.checkpointer import Checkpointer
from clima_oceananigans_jl_tpu.output.readers import FieldDataset, FieldTimeSeries


def _sim(tmp_path, stop=6):
    grid = RectilinearGrid(size=(16, 16, 1), x=(0, 2 * np.pi), y=(0, 2 * np.pi),
                           topology=(PERIODIC, PERIODIC, FLAT), dtype=jnp.float64)
    model = ShallowWaterModel(grid=grid, gravitational_acceleration=10.0,
                              advection=WENO5())
    state = model.initial_state(
        uh=lambda x, y, z: 0.1 * jnp.sin(x), h=1.0)
    return Simulation(model, state=state, dt=1e-3, stop_iteration=stop)


def test_hdf5_writer_roundtrip(tmp_path):
    sim = _sim(tmp_path)
    path = str(tmp_path / "out.h5")
    sim.output_writers["fields"] = HDF5OutputWriter(
        dict(h="h", uh="uh"), path, schedule=IterationInterval(2))
    sim.run()
    ts = FieldTimeSeries(path, "h")
    assert len(ts) >= 3                 # it 0 (initial fire), 2, 4, 6
    assert ts[0].shape == (16, 16, 1)
    ds = FieldDataset(path)
    assert set(ds.keys()) == {"h", "uh"}
    assert np.allclose(ds["h"][0], 1.0)
    # disk backend matches memory backend
    ts_disk = FieldTimeSeries(path, "uh", backend="disk")
    assert np.allclose(ts_disk[1], ts[1].shape and FieldTimeSeries(path, "uh")[1])


def test_netcdf_classic_writer(tmp_path):
    sim = _sim(tmp_path)
    path = str(tmp_path / "out.nc")
    w = NetCDFOutputWriter(dict(h="h"), path, schedule=IterationInterval(3),
                           format="classic")
    sim.output_writers["nc"] = w
    sim.run()
    w.close()
    from scipy.io import netcdf_file
    with netcdf_file(path, "r") as f:
        assert "h" in f.variables
        assert f.variables["h"].shape[0] >= 2
        assert np.allclose(f.variables["h"][0], 1.0)


def test_netcdf4_writer(tmp_path):
    """Default NetCDF4 backend: HDF5 container with dimension scales,
    openable by any HDF5/NetCDF-4 reader."""
    sim = _sim(tmp_path)
    path = str(tmp_path / "out4.nc")
    w = NetCDFOutputWriter(dict(h="h", uh="uh"), path,
                           schedule=IterationInterval(3))
    sim.output_writers["nc"] = w
    sim.run()
    w.close()
    import h5py
    with h5py.File(path, "r") as f:
        assert "_NCProperties" in f.attrs           # NetCDF-4 marker
        h = f["h"]
        assert h.shape[0] >= 2 and h.shape[1:] == (16, 16, 1)
        assert np.allclose(h[0], 1.0)
        # dimension scales are attached (time + spatial dims)
        assert h.dims[0][0] is not None
        assert f["time"].shape[0] == h.shape[0]


def test_netcdf4_compressed_large_grid(tmp_path):
    """Gzip-compressed write of a large-ish slab: compressed file is
    substantially smaller than the raw payload (the reference's
    compression kwarg, netcdf_output_writer.jl)."""
    import h5py

    class _FakeSim:
        def model_time(self):
            return 0.0

    path = str(tmp_path / "big.nc")
    field = np.zeros((512, 512, 4), dtype=np.float32)
    field[100:200, 100:200] = 1.0                 # compressible payload
    w = NetCDFOutputWriter(dict(c=lambda s: field), path, compression=4)
    w.write(_FakeSim())
    w.write(_FakeSim())
    w.close()
    raw_bytes = 2 * field.nbytes
    assert os.path.getsize(path) < raw_bytes / 10
    with h5py.File(path, "r") as f:
        assert f["c"].compression == "gzip"
        assert np.array_equal(f["c"][1], field)


def test_windowed_time_average(tmp_path):
    sim = _sim(tmp_path, stop=10)
    wta = WindowedTimeAverage(
        lambda s: s.model.grid.interior(s.state["solution"]["h"]))
    sim.diagnostics["h_avg"] = wta
    path = str(tmp_path / "avg.h5")
    sim.output_writers["avg"] = HDF5OutputWriter(
        dict(h_avg=wta), path, schedule=IterationInterval(5))
    sim.run()
    ts = FieldTimeSeries(path, "h_avg")
    assert np.all(np.isfinite(ts.data))


def test_checkpoint_exact_continuation(tmp_path):
    """Run 10 steps ≡ run 5 + checkpoint + restore + 5 (bit identical —
    the reference's test_checkpointer.jl invariant)."""
    sim_a = _sim(tmp_path, stop=10)
    sim_a.run()
    ref = {k: np.asarray(v) for k, v in sim_a.state["solution"].items()}

    sim_b = _sim(tmp_path, stop=5)
    ckp = Checkpointer(schedule=IterationInterval(5), dir=str(tmp_path / "ckp"))
    sim_b.output_writers["checkpointer"] = ckp
    sim_b.run()

    sim_c = _sim(tmp_path, stop=10)
    sim_c.output_writers["checkpointer"] = ckp
    sim_c.run(pickup=True)
    assert sim_c.model_iteration() == 10
    for k, v in sim_c.state["solution"].items():
        assert np.array_equal(np.asarray(v), ref[k]), k  # bit identical


def test_pickup_by_iteration_and_path(tmp_path):
    sim = _sim(tmp_path, stop=4)
    ckp = Checkpointer(schedule=IterationInterval(2), dir=str(tmp_path / "c2"),
                       keep=10)
    sim.output_writers["checkpointer"] = ckp
    sim.run()
    sim2 = _sim(tmp_path, stop=10)
    sim2.output_writers["checkpointer"] = ckp
    from clima_oceananigans_jl_tpu.output.checkpointer import pickup_latest
    assert pickup_latest(sim2, 2)
    assert sim2.model_iteration() == 2
    assert pickup_latest(sim2, ckp.checkpoint_path(4))
    assert sim2.model_iteration() == 4


class _TinySim:
    """Minimal sim stand-in driving a WindowedTimeAverage by hand."""

    def __init__(self):
        self.t = 0.0
        self.val = 0.0

    def model_time(self):
        return self.t


def test_windowed_time_average_matches_hand_integral():
    """Regression vs a hand-computed right-Riemann windowed integral
    (the reference's accumulate_result!, windowed_time_average.jl:135-150:
    result = Σ f(tₖ)·Δtₖ / Σ Δtₖ with f sampled at the NEW time), incl.
    the AveragedTimeInterval window/stride gating and the documented
    snapshot fallback when fired before any accumulation."""
    from clima_oceananigans_jl_tpu.utils.schedules import AveragedTimeInterval

    # -- plain accumulate-every-step average -----------------------------
    sim = _TinySim()
    wta = WindowedTimeAverage(lambda s: np.array([s.val]))
    dts = [0.5, 0.25, 0.25, 1.0]
    vals = [1.0, 2.0, 3.0, 4.0, 5.0]
    sim.val = vals[0]
    wta(sim)  # first call only seeds the integration time
    num = 0.0
    for dt, v in zip(dts, vals[1:]):
        sim.t += dt
        sim.val = v
        wta(sim)
        num += dt * v
    expected = num / sum(dts)
    assert np.allclose(wta.result(), expected, rtol=0, atol=0), \
        (wta.result(), expected)

    # result() resets the accumulator: a second immediate fire falls back
    # to the latest snapshot (documented edge semantics)
    assert np.allclose(wta.result(), vals[-1])

    # -- AveragedTimeInterval: trailing window + stride -------------------
    sched = AveragedTimeInterval(10.0, window=4.0, stride=2)
    sim = _TinySim()
    wta = WindowedTimeAverage(lambda s: np.array([s.val]), schedule=sched)
    # f(t) = t; steps of 1: window [6, 10], stride 2 keeps every other
    # collected sample. Samples inside the window land at t = 6..10.
    samples = []
    for k in range(11):
        sim.t = float(k)
        sim.val = float(k)
        wta(sim)
        if sched.collecting(sim.t):
            samples.append((sim.t, sim.val))
    kept = samples[::2]  # stride 2 over the in-window collection sequence
    num = sum((t1 - t0) * v1
              for (t0, _v0), (t1, v1) in zip(kept[:-1], kept[1:]))
    den = kept[-1][0] - kept[0][0]
    assert np.allclose(wta.result(), num / den), (wta.result(), num / den)


def _write_checkpoint_with_layout(tmp_path, layout):
    """A one-step shallow-water checkpoint whose file records ``layout``
    the way older versions stored it."""
    grid = RectilinearGrid(size=(8, 8, 1), extent=(1.0, 1.0, 1.0),
                           topology=(PERIODIC, PERIODIC, FLAT))
    model = ShallowWaterModel(grid=grid, gravitational_acceleration=1.0)
    s = model.initial_state(h=lambda x, y, z: 1.0 + 0.1 * jnp.sin(2 * jnp.pi * x))
    s = jax.jit(model.step)(s, 1e-3)
    path = str(tmp_path / "old.npz")
    from clima_oceananigans_jl_tpu.output.checkpointer import _flatten_state
    np.savez(path, __state_layout=np.asarray(layout), **_flatten_state(s))
    return model, s, path


def test_restore_ignores_natural_layout_record(tmp_path):
    from clima_oceananigans_jl_tpu.output.checkpointer import restore_state
    model, s, path = _write_checkpoint_with_layout(tmp_path, "natural")
    restored = restore_state(model.initial_state(), path)
    for k, v in s["solution"].items():
        np.testing.assert_array_equal(np.asarray(restored["solution"][k]),
                                      np.asarray(v))


def test_restore_refuses_transposed_layout(tmp_path):
    from clima_oceananigans_jl_tpu.output.checkpointer import restore_state
    model, _s, path = _write_checkpoint_with_layout(tmp_path, "xzy")
    with pytest.raises(ValueError, match="xzy"):
        restore_state(model.initial_state(), path)
