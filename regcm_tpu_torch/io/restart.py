"""Checkpoint/restart (SAV files), torch twin of ``regcm_tpu/io/restart.py``.

Equivalent of ``Main/mod_savefile.F90`` (``write_savefile`` :764,
``read_savefile`` :564): the full prognostic and physics state is dumped
so that a restarted run reproduces the uninterrupted run bit for bit.

The format is the JAX package's, so that each package reads the other's
files: NetCDF-3 64-bit offset, one float64 variable per non-empty state
field, the boundary pair's fields prefixed ``bdy_``, and the attributes
``date_seconds``, ``calendar``, ``nstep`` and ``xbctime``. The writer
takes a NamedTuple of the whole domain's tensors or arrays; the reader
returns numpy arrays of the whole domain, which the driver cuts to a
rank's block.

One attribute more, which the JAX package's reader ignores:
``solar_date_seconds``, the date at which the model computed the day's
solar forcing. The solar constant moves within a day and the forcing is
computed once a day, at the day's first step, so a run restarted in
mid-day needs that date to continue bit for bit.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
from scipy.io import netcdf_file

from ..utils.calendar import Date


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def write_savefile(path: str, state, date: Date, nstep: int,
                   xbctime: float, bdy=None, solar_date: Date = None):
    """Write ``state`` and the live boundary pair ``bdy`` (BdyState or
    MolochBdy; the reference SAV carries b0/bt and the input cursor,
    Main/mod_savefile.F90:46-48) to ``path``, with the date of the day's
    solar forcing ``solar_date``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    f = netcdf_file(path, "w", version=2)
    f.history = "regcm_tpu restart (SAV)"
    f.date_seconds = date.to_seconds()   # full second precision
    f.calendar = date.calendar
    f.nstep = nstep
    f.xbctime = float(xbctime)
    if solar_date is not None:
        f.solar_date_seconds = solar_date.to_seconds()
    dims = set()

    def dims_for(shape):
        names = []
        for s in shape:
            key = f"d{s}"
            if key not in dims:
                f.createDimension(key, s)
                dims.add(key)
            names.append(key)
        return tuple(names)

    def put(name, arr):
        arr = _host(arr)
        if arr.size == 0:
            # zero-size fields (the ntr=0 tracers) have no NetCDF-3 form;
            # the reader keeps the model's own template for them
            return
        v = f.createVariable(name, "d", dims_for(arr.shape))
        v[:] = arr

    for name in state._fields:
        put(name, getattr(state, name))
    if bdy is not None:
        f.bdy_class = type(bdy).__name__
        for name in bdy._fields:
            val = getattr(bdy, name)
            if val is not None:
                put(f"bdy_{name}", val)
    f.close()


def read_savefile(path: str
                  ) -> Tuple[dict, Date, int, float, dict, Optional[Date]]:
    """(state fields, date, nstep, xbctime, boundary fields, solar date)
    of a SAV file, the fields as native-order float64 numpy arrays; the
    solar date None in a file without one (the JAX package's)."""
    f = netcdf_file(path, "r", mmap=False)
    fields, bdy_fields = {}, {}
    for name in f.variables:
        arr = np.array(f.variables[name].data, dtype=np.float64)
        if name.startswith("bdy_"):
            bdy_fields[name[4:]] = arr
        else:
            fields[name] = arr
    cal = f.calendar.decode() if isinstance(f.calendar, bytes) \
        else f.calendar
    date = Date.from_seconds(int(f.date_seconds), cal)
    solar = getattr(f, "solar_date_seconds", None)
    solar = None if solar is None else Date.from_seconds(int(solar), cal)
    nstep = int(f.nstep)
    xbctime = float(f.xbctime)
    f.close()
    return fields, date, nstep, xbctime, bdy_fields, solar
