"""Model output streams (ATM / SRF / RAD / STS / LAK / SUB / SLABOC / CHE
/ OPT), torch twin of ``regcm_tpu/io/output.py``.

The reference's stream system (stream ids
``Main/mpplib/mod_ncout.F90:143-152``, variable inventory
``Main/mpplib/mod_outvars.F90``, packing ``Main/mod_output.F90:73``) with
the JAX package's CF/CORDEX variable names, units, statics and file
names:

- ATM: ua/va (earth-rotated with uvrot2d, ``Main/mod_output.F90:263``),
  ta, hus, clw (+clr/cli/cls for the 5-species schemes), wa (omega on
  the sigma-p cores, the half-level w on MOLOCH), ps, tke (the TKE PBL
  schemes on the sigma-p cores);
- SRF: ts, tpr/prcv, evspsbl, hfss, uvdrag, rsns, rlns, ps, and scv,
  smu, smr, tlef with BATS (the subcell means with nsg > 1);
- RAD: rsns, rlns, tendh;
- STS: daily statistics (tgmax/tgmin, pcpavg/pcpmax, psavg/psmin,
  sund) accumulated on the device every step and written at each day
  boundary;
- LAK (lakemod=1, sigma-p cores): lake surface temperature, ice, snow
  and the tlake profile;
- SUB (nsg > 1): per-subcell BATS fields;
- SLABOC (islab_ocean=1): the slab SST and the restoring q-flux;
- CHE (ichem=1, sigma-p cores): each tracer's mixing ratio, the column
  burdens and the accumulated emission, dry and wet deposition, every
  chemfrq hours;
- OPT (ichem=1 with the aerosol direct effect, sigma-p cores): the
  visible-band aerosol extinction and optical depth, every chemfrq
  hours. Its interface pressures take the hPa surface pressure times
  1000, as the JAX package's writer does (ten times the pressure in
  Pa: ROADMAP Queue 3), so that the two packages' records agree.

A record is formed on the device from the state, packed into one tensor
of (y, x) planes and copied to the host once per alarm; a writer thread
encodes and writes it while the model steps on. Under a ``DomainMesh``
the NetCDF records are gathered to rank 0, which alone writes; with the
Zarr backend every rank writes its own block as the record's chunk and
rank 0 the store's metadata, statics and time axis.

``append=True`` reopens existing streams and appends records
(``doing_restart``, ``Main/mod_output.F90:99``), so an interrupted and
restarted chain produces the uninterrupted run's files.
"""
from __future__ import annotations

import os
import queue
import threading
from typing import Dict

import numpy as np
import torch
from scipy.io import netcdf_file

from ..chem.optics import sw_aerosol_mixture
from ..chem.species import build_species
from ..dynamics.hydrostatic import level_sum
from ..utils.calendar import Date
from .ncio import NCWriter
from .zarrio import ZarrWriter, _ZArray


_EPOCH = Date(1949, 12, 1)     # the time axis' origin


def _hours_since_epoch(date: Date) -> float:
    ref = Date(1949, 12, 1, calendar=date.calendar)
    return (date - ref) / 3600.0


def _mean0(a):
    """Mean over the leading axis, added in order (numpy's order for a
    non-innermost axis)."""
    out = a[0]
    for i in range(1, a.shape[0]):
        out = out + a[i]
    return out / a.shape[0]


class _Remote:
    """A NetCDF stream on a rank that does not write (rank 0 writes the
    gathered records): it counts the records."""

    def __init__(self, nrec: int):
        self.nrec = nrec

    def def_static(self, *args, **kw):
        pass

    def def_time_var(self, *args, **kw):
        pass

    def bind_time_var(self, *args, **kw):
        pass

    def write_record(self, hours, rec):
        self.nrec += 1

    def close(self):
        pass


class _ZarrBlocks:
    """A Zarr store written block by block under a DomainMesh: every rank
    writes its block of a record as one chunk (the last row and column
    of blocks one short of the interior cut, which Zarr's edge-chunk
    padding fills); rank 0 writes the metadata, the statics and the time
    axis through ``ZarrWriter``. The other ranks open the arrays when
    they first write, after rank 0 has made the store."""

    def __init__(self, path, dims, attrs, append, mesh, shape2d, nrec):
        self.path = path
        self.mesh = mesh
        self.shape2d = tuple(shape2d)
        self.meta = ZarrWriter(path, dims, attrs, append=append) \
            if mesh.rank == 0 else None
        self.nrec = nrec
        self.arrays: Dict[str, _ZArray] = {}

    def def_static(self, *args, **kw):
        if self.meta is not None:
            self.meta.def_static(*args, **kw)

    def def_time_var(self, name, *args, **kw):
        if self.meta is not None:
            self.arrays[name] = self.meta.def_time_var(name, *args, **kw)

    def bind_time_var(self, name):
        if self.meta is not None:
            self.arrays[name] = self.meta.bind_time_var(name)

    def write_record(self, hours, rec):
        n = self.nrec
        m = self.mesh
        for name, block in rec.items():
            v = self.arrays.get(name)
            if v is None:
                v = self.arrays[name] = _ZArray(self.path, name, {},
                                                time_dim=True)
            lead = list(block.shape[:-2])
            if v.chunks is None:
                shape = lead + list(self.shape2d)
                chunks = lead + [m.ly, m.lx]
                if self.meta is not None:
                    v._init_grid(shape, chunks)
                else:
                    v.shape, v.chunks = shape, chunks
            v._put_chunk(n, [0] * len(lead) + [m.py, m.px], block)
            if self.meta is not None:
                v.nrec = max(v.nrec, n + 1)
                v._flush_meta()
        if self.meta is not None:
            self.meta.write_record(hours, {})      # the time axis
        self.nrec = n + 1

    def close(self):
        pass


class OutputStreams:
    """The output streams of a ``Model`` run (ATM/SRF/RAD/STS and, as the
    configuration asks, LAK, SUB, SLABOC)."""

    def __init__(self, model, outdir: str, domname: str = "domain",
                 append: bool = False, async_write: bool = True,
                 backend: str = "netcdf"):
        if backend not in ("netcdf", "zarr"):
            raise ValueError(f"unknown output backend '{backend}'")
        self.model = model
        self.outdir = outdir
        self.backend = backend
        self.mesh = mesh = model.mesh
        self.lead = mesh is None or mesh.rank == 0
        g = model.grid
        iy, jx, kz = g.iy, g.jx, g.kz
        dev, dt = model.device, model.dtype
        # the interior cut of a record's planes: (iy-1, jx-1) of the whole
        # domain, or of the rank's block in a Zarr chunk (the last row
        # and column of blocks drop one)
        if mesh is not None and backend == "zarr":
            self._cut = (mesh.ly - (mesh.py == mesh.ny - 1),
                         mesh.lx - (mesh.px == mesh.nx - 1))
        else:
            self._cut = (iy - 1, jx - 1)
        self._wq = None
        if async_write:
            # encoding and disk I/O on a worker thread, so that an alarm
            # overlaps the next steps; close() drains the queue
            self._wq = queue.Queue(maxsize=16)

            def _worker():
                while True:
                    item = self._wq.get()
                    if item is None:
                        return
                    writer, hours, rec = item
                    try:
                        writer.write_record(hours, rec)
                    finally:
                        self._wq.task_done()

            self._wthread = threading.Thread(target=_worker, daemon=True)
            self._wthread.start()
        if self.lead:
            os.makedirs(outdir, exist_ok=True)
        self.nqx = getattr(model.core, "nqx", 2)
        self.has_tke = model.cfg.physics.ibltyp in (2, 4) \
            and model.idynamic != 3
        physics = model.core.physics
        self.has_bats = physics is not None \
            and getattr(physics, "land_scheme", "") == "bats1e"
        self.has_lake = model.cfg.physics.lakemod == 1 \
            and model.idynamic != 3
        self.nnsg = getattr(physics, "nnsg", 1) if physics is not None \
            else 1
        dims = {"iy": iy - 1, "jx": jx - 1, "kz": kz}
        if self.has_lake:
            dims["ndpmax"] = int(model.state.tlak.shape[0])
        date0 = model.start_date
        tag = f"{date0.year:04d}{date0.month:02d}{date0.day:02d}"
        attrs = {"title": "regcm_tpu model output",
                 "projection": model.cfg.geo.iproj,
                 "experiment": domname}

        def full(name, fill):
            a = np.asarray(g.extras.get(name, np.full((iy, jx), fill)),
                           dtype=np.float64)
            if a.shape != (iy, jx):       # an interior-extent array
                a = np.pad(a, ((0, iy - a.shape[0]), (0, jx - a.shape[1])),
                           mode="edge")
            return torch.as_tensor(model._local(a), dtype=dt, device=dev)
        # wind rotation (uvrot2d): model grid -> earth-relative
        self.rotcos = full("rotcos", 1.0)
        self.rotsin = full("rotsin", 0.0)
        # the record counts in append mode, as rank 0's files hold them
        # chemistry's streams: CHE with the tracers, OPT with the aerosol
        # direct effect's optics too
        self.ntr = getattr(model.core, "ntr", 0)
        self.aertab = getattr(physics, "aertab", None) if self.ntr else None
        if self.ntr and model.idynamic == 3:
            raise NotImplementedError(
                "the CHE and OPT streams read the sigma-p cores' tracers "
                "(chi_a, ps_a), in the JAX package too: there is none on "
                "MOLOCH to port")
        streams = ["ATM", "SRF", "RAD", "STS"] \
            + ["LAK"] * self.has_lake + ["CHE"] * bool(self.ntr) \
            + ["SUB"] * (self.nnsg > 1) \
            + ["OPT"] * (self.aertab is not None) \
            + ["SLABOC"] * (model.cfg.physics.islab_ocean == 1)
        paths = {s: os.path.join(
            outdir, f"{domname}_{s}.{tag}00."
            + ("zarr" if backend == "zarr" else "nc")) for s in streams}
        counts = {s: 0 for s in streams}
        if append and self.lead:
            for s, p in paths.items():
                if backend == "zarr":
                    counts[s] = _ZArray(p, "time", {}, time_dim=True).nrec \
                        if os.path.exists(p) else 0
                elif os.path.exists(p):
                    with netcdf_file(p, "r", mmap=False) as f:
                        counts[s] = f.variables["time"].shape[0]
        if mesh is not None and append:
            box = [counts]
            torch.distributed.broadcast_object_list(
                box, src=mesh.peer(0, 0), group=mesh.group)
            counts = box[0]

        def mk(stream):
            p = paths[stream]
            if mesh is not None and backend == "zarr":
                w = _ZarrBlocks(p, dims, attrs, append, mesh,
                                (iy - 1, jx - 1), counts[stream])
            elif not self.lead:
                return _Remote(counts[stream])
            elif backend == "zarr":
                w = ZarrWriter(p, dims, attrs, append=append)
            else:
                w = NCWriter(p, dims, attrs, append=append)
            if not append:
                w.def_static("sigma", ("kz",), g.hsigma, "1",
                             "sigma at model layers")
                w.def_static("xlat", ("iy", "jx"),
                             g.xlat[:iy - 1, :jx - 1], "degrees_north",
                             "Latitude", "latitude")
                w.def_static("xlon", ("iy", "jx"),
                             g.xlon[:iy - 1, :jx - 1], "degrees_east",
                             "Longitude", "longitude")
                w.def_static("topo", ("iy", "jx"),
                             g.ht[:iy - 1, :jx - 1] / 9.80665, "m",
                             "Surface elevation", "surface_altitude")
            return w

        def tv(w, name, dims_, units, lname, sname=""):
            if append:
                w.bind_time_var(name)
            else:
                w.def_time_var(name, dims_, units, lname, sname)

        k3, k2 = ("kz", "iy", "jx"), ("iy", "jx")
        self.atm = mk("ATM")
        tv(self.atm, "ua", k3, "m s-1", "Eastward wind", "eastward_wind")
        tv(self.atm, "va", k3, "m s-1", "Northward wind", "northward_wind")
        tv(self.atm, "ta", k3, "K", "Air temperature", "air_temperature")
        tv(self.atm, "hus", k3, "kg kg-1", "Specific humidity",
           "specific_humidity")
        tv(self.atm, "clw", k3, "kg kg-1", "Cloud liquid water",
           "mass_fraction_of_cloud_liquid_water_in_air")
        if self.nqx == 5:
            tv(self.atm, "clr", k3, "kg kg-1", "Rain water mixing ratio")
            tv(self.atm, "cli", k3, "kg kg-1", "Cloud ice mixing ratio")
            tv(self.atm, "cls", k3, "kg kg-1", "Snow mixing ratio")
        if self.has_tke:
            tv(self.atm, "tke", k3, "m2 s-2", "Turbulent kinetic energy")
        tv(self.atm, "wa", k3, "hPa s-1", "Pressure vertical velocity",
           "lagrangian_tendency_of_air_pressure")
        tv(self.atm, "ps", k2, "hPa", "Surface pressure",
           "surface_air_pressure")

        self.srf = mk("SRF")
        tv(self.srf, "ts", k2, "K", "Ground temperature",
           "surface_temperature")
        tv(self.srf, "tpr", k2, "kg m-2 s-1", "Total precipitation flux",
           "precipitation_flux")
        tv(self.srf, "prcv", k2, "kg m-2 s-1",
           "Convective precipitation flux", "convective_precipitation_flux")
        tv(self.srf, "evspsbl", k2, "kg m-2 s-1", "Surface moisture flux",
           "water_evaporation_flux")
        tv(self.srf, "hfss", k2, "W m-2", "Surface sensible heat flux",
           "surface_upward_sensible_heat_flux")
        tv(self.srf, "uvdrag", k2, "kg m-2 s-1",
           "Surface drag stress coefficient")
        tv(self.srf, "rsns", k2, "W m-2", "Surface absorbed shortwave",
           "surface_net_downward_shortwave_flux")
        tv(self.srf, "rlns", k2, "W m-2", "Surface net longwave",
           "surface_net_downward_longwave_flux")
        tv(self.srf, "ps", k2, "hPa", "Surface pressure",
           "surface_air_pressure")
        if self.has_bats:
            tv(self.srf, "scv", k2, "kg m-2", "Snow amount",
               "surface_snow_amount")
            tv(self.srf, "smu", k2, "kg m-2", "Upper-layer soil water",
               "lwe_thickness_of_soil_moisture_content")
            tv(self.srf, "smr", k2, "kg m-2", "Root-zone soil water")
            tv(self.srf, "tlef", k2, "K", "Canopy leaf temperature")

        self.rad = mk("RAD")
        tv(self.rad, "rsns", k2, "W m-2", "Surface absorbed shortwave",
           "surface_net_downward_shortwave_flux")
        tv(self.rad, "rlns", k2, "W m-2", "Surface net longwave",
           "surface_net_downward_longwave_flux")
        tv(self.rad, "tendh", k3, "K s-1", "Radiative heating rate")

        # STS daily statistics (sts_* of mod_outvars.F90)
        self.sts = mk("STS")
        for nm, units, ln in (
                ("tgmax", "K", "Daily max ground temperature"),
                ("tgmin", "K", "Daily min ground temperature"),
                ("pcpavg", "kg m-2 s-1", "Daily mean precipitation"),
                ("pcpmax", "kg m-2 s-1", "Daily max precipitation rate"),
                ("psavg", "hPa", "Daily mean surface pressure"),
                ("psmin", "hPa", "Daily min surface pressure"),
                ("sund", "s", "Daily sunshine duration")):
            tv(self.sts, nm, k2, units, ln)

        self.lak = None
        if self.has_lake:
            self.lak = mk("LAK")
            tv(self.lak, "tg", k2, "K", "Lake surface temperature")
            tv(self.lak, "ice", k2, "m", "Lake ice thickness")
            tv(self.lak, "scv", k2, "kg m-2", "Snow on lake ice")
            tv(self.lak, "tlake", ("ndpmax", "iy", "jx"), "degC",
               "Lake temperature profile")

        # CHE stream (che stream id, Main/mpplib/mod_ncout.F90:143-152):
        # mixing ratios per tracer, burdens, emission/deposition totals
        self.che = None
        if self.ntr:
            self.chnames = build_species(model.cfg.chem.chemsimtype).names
            dims["ntr"] = self.ntr
            self.che = mk("CHE")
            nk = ("ntr", "iy", "jx")
            for nm in self.chnames:
                tv(self.che, f"mixrat_{nm.lower()}", k3, "kg kg-1",
                   f"{nm} mixing ratio")
            tv(self.che, "burden", nk, "kg m-2",
               "Instantaneous column tracer burden")
            tv(self.che, "emflx_acc", nk, "kg m-2",
               "Accumulated surface emission")
            tv(self.che, "ddflx_acc", nk, "kg m-2",
               "Accumulated dry deposition")
            tv(self.che, "wdflx_acc", nk, "kg m-2",
               "Accumulated wet deposition")
            self._dsig = torch.as_tensor(np.asarray(g.dsigma), dtype=dt,
                                         device=dev)[:, None, None]

        # SUB stream: per-subcell surface fields when nsg > 1
        self.sub = None
        if self.nnsg > 1:
            dims["nnsg"] = self.nnsg
            self.sub = mk("SUB")
            nk = ("nnsg", "iy", "jx")
            tv(self.sub, "tg_sub", nk, "K",
               "Subgrid ground (subsoil) temperature")
            tv(self.sub, "tlef_sub", nk, "K", "Subgrid leaf temperature")
            tv(self.sub, "scv_sub", nk, "kg m-2",
               "Subgrid snow water equivalent")
            tv(self.sub, "smu_sub", nk, "kg m-2",
               "Subgrid upper-layer soil water")

        # OPT stream (opt stream id): the aerosol extinction at the
        # visible band and the column optical depth
        self.opt = None
        if self.aertab is not None:
            self.opt = mk("OPT")
            tv(self.opt, "aext8", k3, "m-1",
               "Aerosol extinction coefficient (visible)")
            tv(self.opt, "aod", k2, "1",
               "Aerosol column optical depth (visible)",
               "atmosphere_optical_thickness_due_to_ambient_aerosol"
               "_particles")
            self._sigf = torch.as_tensor(np.asarray(g.sigma), dtype=dt,
                                         device=dev)[:, None, None]

        # SLABOC stream: the slab ocean's SST and restoring q-flux
        self.slaboc = None
        if model.cfg.physics.islab_ocean == 1:
            self.slaboc = mk("SLABOC")
            tv(self.slaboc, "sst", k2, "K", "Slab-ocean prognostic SST",
               "sea_surface_temperature")
            tv(self.slaboc, "qflx_restore", k2, "W m-2",
               "SST restoring heat flux")
        if mesh is not None:
            # the other ranks open rank 0's Zarr arrays on their first
            # write: the store exists from here on
            torch.distributed.barrier(mesh.group)

        self._last_rain = 0.0
        self._last_rainc = 0.0
        self._sts_reset()
        self._sts_day = None

    # -- record hand-off -------------------------------------------------
    def _emit(self, writer, rec: Dict[str, torch.Tensor]):
        """Hand a record of (..., ly, lx) device tensors of one dtype to
        ``writer``: the planes packed into one tensor, gathered to rank 0
        (NetCDF under a mesh), copied to the host once, cut to the
        interior and queued for the writer thread."""
        m = self.model
        names = list(rec)
        planes = [rec[k].reshape((-1,) + tuple(rec[k].shape[-2:]))
                  for k in names]
        flat = torch.cat(planes) if len(planes) > 1 else planes[0]
        if self.mesh is not None and self.backend == "netcdf":
            flat = self.mesh.gather(flat, dst=0)
            if flat is None:
                writer.write_record(None, None)
                return
        host = flat.cpu().numpy()
        ny, nx = self._cut
        out, i = {}, 0
        for k, p in zip(names, planes):
            n = p.shape[0]
            out[k] = host[i:i + n].reshape(
                tuple(rec[k].shape[:-2]) + host.shape[-2:])[..., :ny, :nx]
            i += n
        self._put(writer, _hours_since_epoch(m.date), out)

    def _put(self, writer, hours, rec):
        if self._wq is None:
            writer.write_record(hours, rec)
        else:
            self._wq.put((writer, hours, rec))

    def _ps(self, s):
        """Surface pressure (hPa) of the state."""
        m = self.model
        if m.idynamic == 3:
            return m.core.mkslice(s.t, s.pai, s.qx, s.u, s.v,
                                  s.w)["ps2d"] / 100.0
        return (s.ps_a + m.grid.ptop) * 10.0

    # -- STS accumulation --------------------------------------------------
    def _sts_reset(self):
        self._sts_n = 0
        self._sts = {}

    def sts_accumulate(self):
        """Per-step daily-statistics accumulation on the device; writes
        the day's record first when the date has moved to a new day. Call
        once a model step."""
        m = self.model
        day = (m.date.year, m.date.month, m.date.day)
        if self._sts_day is None:
            self._sts_day = day
        if day != self._sts_day:
            self.write_sts()
            self._sts_day = day
        s = m.state
        tg, ps, rain = s.tg, self._ps(s), s.rainnc + s.rainc
        if not self._sts:
            self._sts = dict(tgmax=tg, tgmin=tg, psmin=ps,
                             _ps=torch.zeros_like(ps), _rain0=rain,
                             _rainprev=rain, pcpmax=torch.zeros_like(tg),
                             sund=torch.zeros_like(tg))
        a = self._sts
        dtsec = max(m.dtsec, 1.0)
        rate = (rain - a["_rainprev"]) / dtsec
        self._sts = dict(
            tgmax=torch.maximum(a["tgmax"], tg),
            tgmin=torch.minimum(a["tgmin"], tg),
            psmin=torch.minimum(a["psmin"], ps), _ps=a["_ps"] + ps,
            _rain0=a["_rain0"], _rainprev=rain,
            pcpmax=torch.maximum(a["pcpmax"], rate),
            sund=a["sund"] + (s.swsfc > 120.0).to(tg.dtype) * dtsec)
        self._sts_n += 1

    def write_sts(self):
        """The day's STS record (written by ``sts_accumulate`` at the day
        boundary; call it to write a partial day)."""
        if not self._sts:
            return
        d = self._sts
        n = max(self._sts_n, 1)
        secs = n * self.model.dtsec
        self._emit(self.sts, {
            "tgmax": d["tgmax"], "tgmin": d["tgmin"],
            "pcpavg": (d["_rainprev"] - d["_rain0"]) / secs,
            "pcpmax": d["pcpmax"], "psavg": d["_ps"] / n,
            "psmin": d["psmin"], "sund": d["sund"]})
        self._sts_reset()

    # -- per-alarm writers ---------------------------------------------------
    def _atm_record(self) -> Dict[str, torch.Tensor]:
        """The ATM record of the current state on the device (the rank's
        block, before the interior cut)."""
        m = self.model
        s = m.state
        dec = m.core.decoupled(s)
        u, v = dec["u"], dec["v"]
        rec = dict(ua=u * self.rotcos - v * self.rotsin,
                   va=v * self.rotcos + u * self.rotsin,
                   ta=dec["t"], hus=dec["qv"], clw=dec["qc"], ps=dec["ps"])
        if m.idynamic == 3:
            # the zita core: resolved w on half levels
            rec["wa"] = 0.5 * (s.w[:-1] + s.w[1:])
            if self.nqx == 5:
                rec.update(clr=s.qx[2], cli=s.qx[3], cls=s.qx[4])
            return rec
        rps = 1.0 / s.ps_a
        if self.nqx == 5:
            rec.update(clr=s.qx_a[2] * rps[None], cli=s.qx_a[3] * rps[None],
                       cls=s.qx_a[4] * rps[None])
        if self.has_tke:
            rec["tke"] = s.tke_a[:m.grid.kz]
        om = getattr(m, "last_diags", {}).get("omega")
        rec["wa"] = om * 10.0 if om is not None else torch.zeros_like(
            s.t_a)
        return rec

    def write_atm(self):
        self._emit(self.atm, self._atm_record())

    def write_srf(self):
        m = self.model
        s = m.state
        rain = s.rainnc + s.rainc
        frq = max(m.cfg.out.srffrq * 3600.0, 1.0)
        rec = {"ts": s.tg, "tpr": (rain - self._last_rain) / frq,
               "prcv": (s.rainc - self._last_rainc) / frq,
               "evspsbl": s.qfx, "hfss": s.hfx, "uvdrag": s.uvdrag,
               "rsns": s.swsfc, "rlns": s.lwsfc, "ps": self._ps(s)}
        self._last_rain, self._last_rainc = rain, s.rainc
        if self.has_bats:
            # with nsg > 1 the pack is per subcell: SRF carries the
            # subcell mean, SUB the subcells
            agg = _mean0 if self.nnsg > 1 else (lambda a: a)
            rec.update(scv=agg(s.bats[4]), smu=agg(s.bats[6]),
                       smr=agg(s.bats[7]), tlef=agg(s.bats[1]))
        self._emit(self.srf, rec)

    def write_rad(self):
        s = self.model.state
        self._emit(self.rad, dict(rsns=s.swsfc, rlns=s.lwsfc,
                                  tendh=s.heatrt))

    def write_lak(self):
        if self.lak is None:
            return
        s = self.model.state
        self._emit(self.lak, {"tg": s.tlak[0] + 273.15, "ice": s.lakice,
                              "scv": s.laksnow, "tlake": s.tlak})

    def write_che(self):
        """CHE record: the decoupled tracer mixing ratios, the column
        burdens Σ chi·Δσ·1000/g (added in level order) and the emission
        and deposition totals."""
        if self.che is None:
            return
        s = self.model.state
        chi = s.chi_a / s.ps_a[None, None]
        rec = {f"mixrat_{nm.lower()}": chi[n]
               for n, nm in enumerate(self.chnames)}
        rec["burden"] = level_sum(torch.movedim(
            s.chi_a * self._dsig[None], 1, 0)) * 1000.0 / 9.80665
        rec.update(emflx_acc=s.chemdiag[0], ddflx_acc=s.chemdiag[1],
                   wdflx_acc=s.chemdiag[2])
        self._emit(self.che, rec)

    def write_opt(self):
        """OPT record: the visible-band (interval 8) extinction profile
        and column optical depth of the aerosol mixture (aeroppt → opt
        stream), on the layers' hydrostatic thickness from the decoupled
        T and qv."""
        if self.opt is None:
            return
        m = self.model
        s = m.state
        kz = m.grid.kz
        ptop = m.cfg.ptop_cb * 1000.0
        dec = m.core.decoupled(s)
        ly, lx = s.ps_a.shape
        pint = self._sigf * (dec["ps"] * 1000.0 - ptop)[None] + ptop
        chi = torch.clamp(s.chi_a / torch.clamp(s.ps_a, min=1e-10)[None, None],
                          min=0.0)
        aer = sw_aerosol_mixture(
            chi.reshape(self.ntr, kz, ly * lx).transpose(1, 2),
            pint.reshape(kz + 1, ly * lx).T, self.aertab)
        ivis = min(8, aer.tauxar.shape[-1] - 1)
        tau = aer.tauxar[:, 1:, ivis].T.reshape(kz, ly, lx)
        tv = dec["t"] * (1.0 + 0.608 * dec["qv"])
        dz = torch.clamp(287.0 * tv / 9.80665 * torch.log(
            torch.clamp(pint[1:], min=1.0) / torch.clamp(pint[:-1], min=1.0)),
            min=1.0)
        self._emit(self.opt, {"aext8": tau / dz, "aod": level_sum(tau)})

    def write_slaboc(self):
        """SLABOC record: the slab SST over the ocean and the restoring
        q-flux recomputed diagnostically (update_slabocean,
        mod_slabocean.F90:95)."""
        if self.slaboc is None:
            return
        m = self.model
        s = m.state
        sp = m.cfg.slaboc
        ocmask = m.core.grid_lndocn < 0.5
        mlcp = sp.mixed_layer_depth * 4.0e6
        restore = ocmask if sp.do_restore_sst else torch.zeros_like(ocmask)
        qflx = torch.where(restore, (m.core.sst - s.tg) * mlcp
                           / (sp.sst_restore_timescale * 86400.0), 0.0)
        self._emit(self.slaboc, {"sst": torch.where(ocmask, s.tg, 0.0),
                                 "qflx_restore": qflx})

    def write_sub(self):
        """SUB record: per-subcell BATS fields."""
        if self.sub is None:
            return
        b = self.model.state.bats
        self._emit(self.sub, {"tg_sub": b[0], "tlef_sub": b[1],
                              "scv_sub": b[4], "smu_sub": b[6]})

    def close(self):
        """Drain the writer thread and close the files (every rank of a
        mesh, together)."""
        if self._wq is not None:
            self._wq.join()
            self._wq.put(None)
            self._wthread.join()
            self._wq = None
        for w in (self.atm, self.srf, self.rad, self.sts, self.lak,
                  self.che, self.sub, self.opt, self.slaboc):
            if w is not None:
                w.close()
        if self.mesh is not None:
            torch.distributed.barrier(self.mesh.group)
