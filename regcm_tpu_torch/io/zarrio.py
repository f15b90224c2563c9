"""Sharded Zarr-v2 output engine.

The reference writes flagship-scale output through parallel NetCDF
(``Share/mod_ncstream.F90:118-146``, enabled by
``do_parallel_netcdf_out``, ``Main/mpplib/mod_runparams.F90:201``):
every MPI rank writes its own hyperslab and no rank ever materializes
the full grid.  The TPU-native equivalent here is a Zarr-v2 directory
store whose chunk grid **is** the device mesh's shard grid: each
``jax.Array`` shard writes its own chunk file straight from its
device buffer (``arr.addressable_shards``), so

- no full-grid host buffer is ever allocated for a sharded field, and
- under multi-host each host writes only its addressable shards —
  the same disjoint-hyperslab contract as the reference's parallel
  NetCDF create/write.

The store is plain Zarr v2 (``.zarray``/``.zattrs``/``.zgroup`` JSON +
raw C-order uncompressed chunk files), readable by any zarr client;
``read_zarr`` below is a self-contained reader for tests and tools.

``ZarrWriter`` mirrors the :class:`~regcm_tpu.io.ncio.NCWriter` API
(def_static / def_time_var / bind_time_var / write_record / close) so
:class:`~regcm_tpu.io.output.OutputStreams` can switch backends with a
single flag.  Unlike the NetCDF-3 writer, record variables may receive
*device* arrays (sharded or not); numpy input degrades to a
single-chunk write.

A copy of ``regcm_tpu/io/zarrio.py`` (JAX-free), held equal to it by
``tests/test_torch_shared.py``. The port hands it numpy arrays; under a
``DomainMesh`` the output streams write each rank's block as its chunk
through ``_ZArray._init_grid`` and ``_ZArray._put_chunk``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_FILL = 0.0


def _write_json(path: str, obj) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class _ZArray:
    """One Zarr-v2 array directory (lazy: the chunk grid is fixed by
    the first record written, so it can match the shard grid of the
    live device arrays)."""

    def __init__(self, root: str, name: str, attrs: Dict,
                 time_dim: bool, dtype: str = "<f4"):
        self.dir = os.path.join(root, name)
        self.name = name
        self.time_dim = time_dim
        self.dtype = dtype
        self.attrs = dict(attrs)
        self.shape: Optional[list] = None    # global shape (no time)
        self.chunks: Optional[list] = None
        self.nrec = 0
        meta = os.path.join(self.dir, ".zarray")
        if os.path.exists(meta):
            with open(meta) as f:
                z = json.load(f)
            if time_dim:
                self.nrec = z["shape"][0]
                self.shape = z["shape"][1:]
                self.chunks = z["chunks"][1:]
            else:
                self.shape = z["shape"]
                self.chunks = z["chunks"]
        else:
            os.makedirs(self.dir, exist_ok=True)

    # -- metadata ------------------------------------------------------
    def _flush_meta(self):
        shape = ([self.nrec] if self.time_dim else []) + list(self.shape)
        chunks = ([1] if self.time_dim else []) + list(self.chunks)
        _write_json(os.path.join(self.dir, ".zarray"), {
            "zarr_format": 2, "shape": shape, "chunks": chunks,
            "dtype": self.dtype, "compressor": None,
            "fill_value": _FILL, "order": "C", "filters": None})
        if self.attrs:
            _write_json(os.path.join(self.dir, ".zattrs"), self.attrs)

    def _init_grid(self, shape: Sequence[int],
                   chunks: Sequence[int]):
        self.shape = list(shape)
        self.chunks = list(chunks)
        self._flush_meta()

    # -- chunk IO ------------------------------------------------------
    def _chunk_path(self, trec: Optional[int],
                    coords: Sequence[int]) -> str:
        parts = ([str(trec)] if self.time_dim else []) \
            + [str(c) for c in coords]
        return os.path.join(self.dir, ".".join(parts) or "0")

    def _put_chunk(self, trec: Optional[int], coords: Sequence[int],
                   data: np.ndarray):
        """Write one chunk file, padding edge chunks to full chunk
        shape (Zarr v2 stores edge chunks full-size)."""
        data = np.asarray(data, dtype=self.dtype)
        if list(data.shape) != list(self.chunks):
            pad = [(0, c - s) for c, s in zip(self.chunks, data.shape)]
            data = np.pad(data, pad, constant_values=_FILL)
        with open(self._chunk_path(trec, coords), "wb") as f:
            f.write(data.tobytes(order="C"))

    # -- public write paths -------------------------------------------
    def write(self, trec: Optional[int], value) -> None:
        """Write one (record of the) array.  ``value`` may be a numpy
        array or a jax.Array; sharded device arrays are written one
        chunk file per shard with no global gather."""
        shards = getattr(value, "addressable_shards", None)
        if shards is not None and len(shards) > 1:
            self._write_sharded(trec, value, shards)
        else:
            arr = np.asarray(value)
            if self.shape is None:
                self._init_grid(arr.shape, arr.shape)
            self._put_chunk(trec, [0] * arr.ndim, arr)
        if self.time_dim:
            self.nrec = max(self.nrec, (trec or 0) + 1)
            self._flush_meta()

    def _write_sharded(self, trec, value, shards):
        if self.shape is None:
            # chunk grid := shard grid (GSPMD tiles are
            # ceil(dim/nshards) with the last tile short — exactly
            # Zarr's edge-chunk convention)
            gshape = list(value.shape)
            starts = [sorted({(s.index[d].start or 0)
                              for s in shards})
                      for d in range(value.ndim)]
            chunks = [(st[1] - st[0]) if len(st) > 1 else gshape[d]
                      for d, st in enumerate(starts)]
            self._init_grid(gshape, chunks)
        seen = set()
        for s in shards:
            coords = tuple((s.index[d].start or 0) // self.chunks[d]
                           for d in range(value.ndim))
            if coords in seen:       # replicated copy of same tile
                continue
            seen.add(coords)
            self._put_chunk(trec, coords, np.asarray(s.data))


class ZarrWriter:
    """Drop-in ``NCWriter`` replacement backed by a Zarr-v2 store.

    ``dims`` is kept for API compatibility and recorded as group
    attributes (a Zarr store has no named dimensions); per-variable
    dimension names go to each array's ``_ARRAY_DIMENSIONS`` attr
    (the xarray convention), so tooling can label axes.
    """

    def __init__(self, path: str, dims: Dict[str, int],
                 attrs: Optional[Dict[str, str]] = None,
                 append: bool = False):
        self.path = path
        self.dims = dict(dims)
        os.makedirs(path, exist_ok=True)
        _write_json(os.path.join(path, ".zgroup"), {"zarr_format": 2})
        gattrs = dict(attrs or {})
        gattrs["dimensions"] = {k: int(v) for k, v in dims.items()}
        _write_json(os.path.join(path, ".zattrs"), gattrs)
        self.vars: Dict[str, _ZArray] = {}
        self._time = _ZArray(path, "time", {
            "units": "hours since 1949-12-01 00:00:00 UTC",
            "calendar": "gregorian",
            "_ARRAY_DIMENSIONS": ["time"]}, time_dim=True,
            dtype="<f8")
        if self._time.shape is None:
            self._time._init_grid([], [])
        self.nrec = self._time.nrec if append else 0
        self._tdims: Dict[str, Tuple[str, ...]] = {}

    def _mkvar(self, name, dims_, units, long_name, standard_name,
               time_dim):
        attrs = {"_ARRAY_DIMENSIONS":
                 (["time"] if time_dim else []) + list(dims_)}
        if units:
            attrs["units"] = units
        if long_name:
            attrs["long_name"] = long_name
        if standard_name:
            attrs["standard_name"] = standard_name
        v = _ZArray(self.path, name, attrs, time_dim=time_dim)
        self.vars[name] = v
        return v

    def def_static(self, name, dims_, data, units="", long_name="",
                   standard_name=""):
        v = self._mkvar(name, dims_, units, long_name, standard_name,
                        time_dim=False)
        v.write(None, np.asarray(data, dtype=np.float32))
        return v

    def def_time_var(self, name, dims_, units="", long_name="",
                     standard_name=""):
        return self._mkvar(name, dims_, units, long_name,
                           standard_name, time_dim=True)

    def bind_time_var(self, name: str):
        """Append mode: reattach an existing array."""
        v = _ZArray(self.path, name, {}, time_dim=True)
        self.vars[name] = v
        return v

    def write_record(self, time_hours: float, fields: Dict):
        n = self.nrec
        self._time.shape = []      # scalar per record
        self._time.chunks = []
        self._time._put_chunk(n, [], np.float64(time_hours))
        self._time.nrec = n + 1
        self._time._flush_meta()
        for name, data in fields.items():
            self.vars[name].write(n, data)
        self.nrec += 1

    def close(self):
        pass


def read_zarr(path: str, with_attrs: bool = False):
    """Assemble every array of a Zarr-v2 directory store into numpy
    (self-contained test/tools reader; trims edge-chunk padding)."""
    out: Dict[str, np.ndarray] = {}
    attrs: Dict[str, dict] = {}
    for name in sorted(os.listdir(path)):
        adir = os.path.join(path, name)
        meta = os.path.join(adir, ".zarray")
        if not os.path.isdir(adir) or not os.path.exists(meta):
            continue
        with open(meta) as f:
            z = json.load(f)
        shape, chunks = z["shape"], z["chunks"]
        dt = np.dtype(z["dtype"])
        arr = np.full(shape, z.get("fill_value") or 0.0,
                      dtype=dt)
        for fn in os.listdir(adir):
            if fn.startswith("."):
                continue
            coords = [int(c) for c in fn.split(".")]
            raw = np.fromfile(os.path.join(adir, fn), dtype=dt)
            if not shape:
                out[name] = raw.reshape(())[()]
                break
            raw = raw.reshape(chunks)
            sel = tuple(slice(c * ch, min((c + 1) * ch, s))
                        for c, ch, s in zip(coords, chunks, shape))
            trim = tuple(slice(0, sl.stop - sl.start) for sl in sel)
            arr[sel] = raw[trim]
        else:
            out[name] = arr
        za = os.path.join(adir, ".zattrs")
        if os.path.exists(za):
            with open(za) as f:
                attrs[name] = json.load(f)
        else:
            attrs[name] = {}
    if with_attrs:
        return out, attrs
    return out
