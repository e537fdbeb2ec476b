"""Schedule-driven output writers.

Port of the reference's src/OutputWriters/:
* ``HDF5OutputWriter`` — the JLD2 analog (JLD2 is an HDF5 container), one
  group per output time holding every output array
  (jld2_output_writer.jl:17).
* ``NetCDFOutputWriter`` — CF-ish dims/coords via scipy's NetCDF3 writer
  (netcdf_output_writer.jl:12).
* ``WindowedTimeAverage`` — accumulates Σ w·Δt between schedule firings
  (windowed_time_average.jl:101-121), usable as any writer's output.

Outputs are a dict ``name -> spec`` where spec is a Field name (resolved
through ``model.fields(state)``), a callable ``spec(sim) -> array``, or a
``WindowedTimeAverage``. Data is fetched as interior arrays (halos
stripped), device→host copied once per firing.
"""
from __future__ import annotations

import json
import os

import jax.numpy as jnp
import numpy as np

from ..utils.schedules import IterationInterval, Schedule, TimeInterval


def _fetch(sim, name, spec, indices=None):
    """Resolve one output spec to a numpy interior array (optionally a
    window of it — the reference writers' ``indices`` kwarg,
    jld2_output_writer.jl / netcdf_output_writer.jl slicing)."""
    if isinstance(spec, WindowedTimeAverage):
        return np.asarray(spec.result())
    if callable(spec):
        out = spec(sim)
    else:
        fields = sim.model.fields(sim.state)
        field = fields[name if spec is None else spec]
        grid = sim.model.grid
        data = field.data
        if indices is not None:
            from ..fields.field import regularize_indices
            win = regularize_indices(grid, indices)
            sl = tuple(slice(h + s.start, h + s.stop) if data.shape[a] > 1
                       else slice(None)
                       for a, (h, s) in enumerate(zip(grid.halo, win)))
        else:
            sl = tuple(slice(h, h + n) if data.shape[a] > 1 else slice(None)
                       for a, (h, n) in enumerate(zip(grid.halo, grid.shape)))
        out = data[sl]
    return np.asarray(out)


class AbstractOutputWriter:
    def __init__(self, outputs, schedule=None, verbose=False, indices=None):
        self.outputs = {k: (None if isinstance(v, str) and v == k else v)
                        for k, v in outputs.items()}
        self.schedule = schedule or IterationInterval(1)
        self.verbose = verbose
        self.indices = indices

    def __call__(self, sim):
        self.write(sim)

    def write(self, sim):  # pragma: no cover - abstract
        raise NotImplementedError


class HDF5OutputWriter(AbstractOutputWriter):
    """`file[f"timeseries/{name}/{i}"]` layout mirroring JLD2OutputWriter."""

    def __init__(self, outputs, filepath, schedule=None, overwrite=True,
                 verbose=False, indices=None):
        super().__init__(outputs, schedule, verbose, indices)
        self.filepath = filepath
        self._count = 0
        if overwrite and os.path.exists(filepath):
            os.remove(filepath)
        os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)

    def write(self, sim):
        import h5py
        i = self._count
        with h5py.File(self.filepath, "a") as f:
            f[f"timeseries/t/{i}"] = sim.model_time()
            f[f"timeseries/iteration/{i}"] = sim.model_iteration()
            for name, spec in self.outputs.items():
                f[f"timeseries/{name}/{i}"] = _fetch(sim, name, spec,
                                                     self.indices)
        self._count += 1


class NetCDFOutputWriter(AbstractOutputWriter):
    """NetCDF writer with an unlimited time dimension.

    Two backends:
    * ``format="netcdf4"`` (default) — HDF5-based NetCDF4 via h5py,
      following the NetCDF-4 conventions (dimension scales attached to
      each variable, ``_NCProperties`` root attribute) so the files open
      with netCDF4-python/xarray/ncdump. Supports gzip ``compression``
      (the reference's NetCDFOutputWriter compression kwarg,
      netcdf_output_writer.jl:60) and scales to large grids — variables
      are chunked per time slice.
    * ``format="classic"`` — NetCDF3 via scipy (no compression, 32-bit
      offsets; kept for environments without HDF5)."""

    def __init__(self, outputs, filepath, schedule=None, overwrite=True,
                 verbose=False, indices=None, format="netcdf4",
                 compression=0):
        super().__init__(outputs, schedule, verbose, indices)
        self.filepath = filepath
        self.format = format
        self.compression = int(compression)
        self._initialized = False
        if overwrite and os.path.exists(filepath):
            os.remove(filepath)
        os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)

    def _init_file(self, sim, sample):
        if self.format == "classic":
            return self._init_classic(sim, sample)
        return self._init_nc4(sim, sample)

    def _init_classic(self, sim, sample):
        from scipy.io import netcdf_file
        f = netcdf_file(self.filepath, "w")
        f.createDimension("time", None)
        tvar = f.createVariable("time", "d", ("time",))
        tvar.units = "seconds"
        self._dims = {}
        for name, arr in sample.items():
            dims = ["time"]
            for a, letter in enumerate("xyz"):
                if arr.ndim > a:
                    dim = f"{letter}{arr.shape[a]}"
                    if dim not in self._dims:
                        f.createDimension(dim, arr.shape[a])
                        self._dims[dim] = True
                    dims.append(dim)
            f.createVariable(name, "d", tuple(dims))
        self._f = f
        self._tvar = tvar
        self._count = 0
        self._initialized = True

    def _init_nc4(self, sim, sample):
        """NetCDF-4 structure in an HDF5 container: every dimension is an
        HDF5 dimension scale named like a NetCDF dim, attached to the data
        variables; the _NCProperties attribute marks the file as NetCDF-4
        so standard readers accept it."""
        import h5py
        f = h5py.File(self.filepath, "w")
        f.attrs["_NCProperties"] = np.bytes_(
            b"version=2,netcdf=4.9.0,hdf5=1.12.0")
        # unlimited time dimension scale
        tvar = f.create_dataset("time", shape=(0,), maxshape=(None,),
                                dtype="f8")
        tvar.make_scale("time")
        tvar.attrs["units"] = np.bytes_(b"seconds")
        self._dims = {"time": tvar}
        kw = ({"compression": "gzip", "compression_opts": self.compression}
              if self.compression else {})
        self._vars = {}
        for name, arr in sample.items():
            dims, dim_names = [tvar], ["time"]
            for a, letter in enumerate("xyz"):
                if arr.ndim > a:
                    dname = f"{letter}{arr.shape[a]}"
                    if dname not in self._dims:
                        d = f.create_dataset(dname, data=np.arange(
                            arr.shape[a], dtype="f8"))
                        d.make_scale(dname)
                        self._dims[dname] = d
                    dims.append(self._dims[dname])
                    dim_names.append(dname)
            shape = (0,) + arr.shape
            v = f.create_dataset(name, shape=shape,
                                 maxshape=(None,) + arr.shape,
                                 chunks=(1,) + arr.shape, dtype=arr.dtype,
                                 **kw)
            for axis, scale in enumerate(dims):
                v.dims[axis].attach_scale(scale)
            v.attrs["DIMENSION_LABELS"] = np.array(
                [n.encode() for n in dim_names], dtype=object)
            self._vars[name] = v
        self._f = f
        self._tvar = tvar
        self._count = 0
        self._initialized = True

    def write(self, sim):
        sample = {name: _fetch(sim, name, spec, self.indices)
                  for name, spec in self.outputs.items()}
        if not self._initialized:
            self._init_file(sim, sample)
        i = self._count
        if self.format == "classic":
            self._tvar[i] = sim.model_time()
            for name, arr in sample.items():
                self._f.variables[name][i] = arr
            self._f.flush()
        else:
            self._tvar.resize((i + 1,))
            self._tvar[i] = sim.model_time()
            for name, arr in sample.items():
                v = self._vars[name]
                v.resize((i + 1,) + v.shape[1:])
                v[i] = arr
            self._f.flush()
        self._count += 1

    def close(self):
        if self._initialized:
            self._f.close()


class WindowedTimeAverage:
    """Time mean of an output accumulated every model iteration between
    firings of `schedule` (reference windowed_time_average.jl). Register
    it in ``sim.diagnostics`` so it accumulates each step; pass the same
    object as a writer output."""

    def __init__(self, fetch, schedule=None):
        self.fetch = fetch          # callable(sim) -> jnp/np array
        self.schedule = IterationInterval(1)  # accumulate every iteration
        self.output_schedule = schedule
        self._sum = None
        self._wsum = 0.0
        self._last_t = None
        self._last_val = None
        self._n_seen = 0

    def __call__(self, sim):
        from ..utils.schedules import AveragedTimeInterval
        t = sim.model_time()
        out_sched = self.output_schedule
        if isinstance(out_sched, AveragedTimeInterval):
            # only collect inside the trailing window, every stride-th
            # sample (reference windowed_time_average.jl:101-121)
            self._n_seen += 1
            if not out_sched.collecting(t):
                if self._last_val is None:
                    # keep a snapshot so the initial forced actuation of
                    # the writer has something to record
                    self._last_val = np.asarray(self.fetch(sim))
                self._last_t = None  # restart integration at window entry
                return
            if (self._n_seen - 1) % out_sched.stride:
                return
        val = np.asarray(self.fetch(sim))
        self._last_val = val
        if self._last_t is None or self._sum is None:
            self._sum = np.zeros_like(val)
            self._wsum = 0.0
        else:
            dt = t - self._last_t
            self._sum = self._sum + dt * val
            self._wsum += dt
        self._last_t = t

    def result(self):
        if self._wsum == 0.0:
            # fired before any accumulation (or right after a reset):
            # fall back to the latest instantaneous fetch
            if getattr(self, "_last_val", None) is None:
                raise RuntimeError("WindowedTimeAverage.result() called "
                                   "before any sample was accumulated")
            return self._last_val
        out = self._sum / self._wsum
        self._sum = np.zeros_like(self._sum)
        self._wsum = 0.0
        return out
