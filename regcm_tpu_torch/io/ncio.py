"""NetCDF I/O engine.

Replaces the reference's typed output-stream system
(``Share/mod_ncstream.F90:55-146``, ``Main/mpplib/mod_ncout.F90``) with a
compact writer. Files are NetCDF-3 classic (scipy backend — no external
netCDF-C dependency); HDF5-backed NetCDF-4 reference inputs are read via
h5py when encountered.

A copy of ``regcm_tpu/io/ncio.py`` (JAX-free), held equal to it by
``tests/test_torch_shared.py``; writers consume host numpy arrays.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
from scipy.io import netcdf_file


class NCWriter:
    """Append-capable NetCDF-3 writer with an unlimited time dimension.

    append=True reopens an existing file and continues its record
    dimension (the reference's doing_restart stream reopen,
    Main/mod_output.F90:99)."""

    def __init__(self, path: str, dims: Dict[str, int],
                 attrs: Optional[Dict[str, str]] = None,
                 append: bool = False):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.vars: Dict[str, object] = {}
        if append and os.path.exists(path):
            self.f = netcdf_file(path, "a", version=2)
            tv = self.f.variables["time"]
            self.vars["time"] = tv
            self.nrec = tv.shape[0] if tv.shape and tv.shape[0] else 0
            return
        self.f = netcdf_file(path, "w", version=2)
        self.f.createDimension("time", None)
        for name, size in dims.items():
            self.f.createDimension(name, size)
        for k, v in (attrs or {}).items():
            setattr(self.f, k, v)
        self.nrec = 0
        tv = self.f.createVariable("time", "d", ("time",))
        tv.units = "hours since 1949-12-01 00:00:00 UTC"
        tv.calendar = "gregorian"
        self.vars["time"] = tv

    def bind_time_var(self, name: str):
        """Attach an existing variable (append mode)."""
        self.vars[name] = self.f.variables[name]
        return self.vars[name]

    def def_static(self, name: str, dims: Sequence[str], data,
                   units: str = "", long_name: str = "",
                   standard_name: str = ""):
        v = self.f.createVariable(name, "f", tuple(dims))
        if units:
            v.units = units
        if long_name:
            v.long_name = long_name
        if standard_name:
            v.standard_name = standard_name
        v[:] = np.asarray(data, dtype=np.float32)
        return v

    def def_time_var(self, name: str, dims: Sequence[str],
                     units: str = "", long_name: str = "",
                     standard_name: str = ""):
        v = self.f.createVariable(name, "f", ("time",) + tuple(dims))
        if units:
            v.units = units
        if long_name:
            v.long_name = long_name
        if standard_name:
            v.standard_name = standard_name
        self.vars[name] = v
        return v

    def write_record(self, time_hours: float, fields: Dict[str, np.ndarray]):
        n = self.nrec
        self.vars["time"][n] = time_hours
        for name, data in fields.items():
            self.vars[name][n] = np.asarray(data, dtype=np.float32)
        self.nrec += 1

    def close(self):
        self.f.close()


def read_nc(path: str, with_attrs: bool = False):
    """Read all variables of a NetCDF file into a dict (optionally with
    per-variable attribute dicts).

    NetCDF-3 via scipy; NetCDF-4/HDF5 (e.g. reference-generated DOMAIN/
    ICBC files) via h5py.
    """
    try:
        f = netcdf_file(path, "r", mmap=False)
        out = {k: np.array(v.data) for k, v in f.variables.items()}
        if with_attrs:
            attrs = {k: dict(v._attributes)
                     for k, v in f.variables.items()}
            f.close()
            return out, attrs
        f.close()
        return out
    except Exception:
        pass
    import h5py

    out: Dict[str, np.ndarray] = {}
    attrs: Dict[str, dict] = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                key = name.split("/")[-1]
                out[key] = obj[()]
                attrs[key] = {k: v for k, v in obj.attrs.items()}
        f.visititems(visit)
    if with_attrs:
        return out, attrs
    return out
