"""Output readers: FieldTimeSeries readback.

Port of the reference's src/OutputReaders/field_time_series.jl:16-56:
``FieldTimeSeries(path, name)`` loads every saved time of one output from
an ``HDF5OutputWriter`` file into a (Nt, ...) array with ``times``,
either eagerly (``backend="memory"``) or lazily per index
(``backend="disk"``, the reference's ``OnDisk``).
"""
from __future__ import annotations

import numpy as np


class FieldTimeSeries:
    def __init__(self, path, name, backend="memory"):
        import h5py
        self.path = path
        self.name = name
        self.backend = backend
        with h5py.File(path, "r") as f:
            idx = sorted(f[f"timeseries/{name}"].keys(), key=int)
            self._indices = idx
            self.times = np.asarray([f[f"timeseries/t/{i}"][()] for i in idx])
            self.iterations = np.asarray(
                [f[f"timeseries/iteration/{i}"][()] for i in idx])
            if backend == "memory":
                self._data = np.stack(
                    [np.asarray(f[f"timeseries/{name}/{i}"]) for i in idx])
            else:
                self._data = None
                self.shape_t = np.asarray(f[f"timeseries/{name}/{idx[0]}"]).shape

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, n):
        if self._data is not None:
            return self._data[n]
        import h5py
        with h5py.File(self.path, "r") as f:
            return np.asarray(f[f"timeseries/{self.name}/{self._indices[n]}"])

    @property
    def data(self):
        if self._data is not None:
            return self._data
        return np.stack([self[n] for n in range(len(self))])


class FieldDataset:
    """All outputs in a file as FieldTimeSeries (reference field_dataset.jl)."""

    def __init__(self, path, backend="memory"):
        import h5py
        with h5py.File(path, "r") as f:
            names = [k for k in f["timeseries"].keys()
                     if k not in ("t", "iteration")]
        self.fields = {n: FieldTimeSeries(path, n, backend) for n in names}

    def __getitem__(self, name):
        return self.fields[name]

    def keys(self):
        return self.fields.keys()
