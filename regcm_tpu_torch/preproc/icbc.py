"""ICBC preprocessor (the ``icbc`` executable equivalent).

Mirrors ``PreProc/ICBC/icbc.F90:37-389``: produces 6-hourly initial and
boundary condition files (u, v, t, qv, ps, ts on model sigma levels) for
the run window. Sources:

- real reanalysis/GCM archives (ERA/NNRP/... readers of
  ``PreProc/ICBC/mod_era5.F90`` etc.) — later-round ports;
- synthetic analytic states (``synthetic_fields``): standard atmosphere
  + optional geostrophically-balanced zonal jet, so the model runs the
  full ICBC-driven pipeline without external datasets.

File schema follows the reference ICBC NetCDF (read by
``Main/mod_ncio.F90:835`` read_icbc).

A copy of ``regcm_tpu/preproc/icbc.py``: ``synthetic_fields`` takes the
saturation mixing ratio from the port's ``utils.thermo`` on float64 host
tensors, and the command line makes synthetic files only (the reanalysis
and GCM readers are not ported). ``tests/test_torch_shared.py`` holds
the records of both packages' files equal.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.params import RegCMConfig
from ..utils import constants as c
from ..utils.calendar import Date
from ..utils.vertical import sigma_levels
from ..io.ncio import NCWriter, read_nc


def synthetic_fields(cfg: RegCMConfig, topo: np.ndarray,
                     date: Date, jet: float = 0.0) -> Dict[str, np.ndarray]:
    """Analytic ICBC fields on the model grid at one time.

    jet: peak zonal wind (m/s) of a mid-latitude jet (in thermal-wind
    balance is NOT enforced here — the model's relaxation assimilates).
    """
    iy, jx, kz = cfg.dim.iy, cfg.dim.jx, cfg.dim.kz
    sf, sh, _ = sigma_levels(kz, cfg.dim.dsmax, cfg.dim.dsmin)
    ptop = cfg.ptop_cb * 1000.0
    z = np.pad(topo, ((0, 1), (0, 1)), mode="edge")       # (iy, jx)
    tbar = 0.5 * (c.stdt + np.maximum(c.stdt - c.lrate * z, c.tiso))
    ps = 101325.0 * np.exp(-c.egrav * z / (c.rgas * tbar))  # Pa
    pstar = (ps - ptop) / 1000.0                           # cb
    p = sh[:, None, None] * (ps - ptop)[None] + ptop       # Pa half lev
    zlev = -c.rgas * 260.0 / c.egrav * np.log(p / 101325.0)
    t = np.maximum(c.stdt - c.lrate * zlev, c.tiso)
    from ..utils.thermo import pfwsat
    qv = np.minimum(0.5 * pfwsat(torch.as_tensor(t),
                                 torch.as_tensor(p)).numpy(), 0.015)
    u = np.zeros_like(t)
    v = np.zeros_like(t)
    if jet != 0.0:
        yy = np.linspace(-1.0, 1.0, iy)[None, :, None]
        zfac = np.clip((1.0 - sh) * 3.0, 0.0, 1.0)[:, None, None]
        u = jet * np.exp(-(yy / 0.5) ** 2) * zfac * np.ones((kz, iy, jx))
    ts = np.maximum(c.stdt - c.lrate * z, c.tiso)
    return dict(u=u, v=v, t=t, qv=qv, ps=ps, ts=ts, pstar=pstar)


class ICBCWriter:
    """6-hourly ICBC file for one run window (mod_write equivalent)."""

    def __init__(self, path: str, cfg: RegCMConfig):
        iy, jx, kz = cfg.dim.iy, cfg.dim.jx, cfg.dim.kz
        self.w = NCWriter(path, dims={"iy": iy, "jx": jx, "kz": kz},
                          attrs={"title": "regcm_tpu ICBC",
                                 "projection": cfg.geo.iproj})
        for name, dims, units, lname in (
                ("u", ("kz", "iy", "jx"), "m s-1", "Zonal wind"),
                ("v", ("kz", "iy", "jx"), "m s-1", "Meridional wind"),
                ("t", ("kz", "iy", "jx"), "K", "Temperature"),
                ("qv", ("kz", "iy", "jx"), "kg kg-1",
                 "Water vapour mixing ratio"),
                ("ps", ("iy", "jx"), "Pa", "Surface pressure"),
                ("ts", ("iy", "jx"), "K", "Surface temperature")):
            self.w.def_time_var(name, dims, units, lname)

    def append(self, date: Date, fields: Dict[str, np.ndarray]):
        hours = (date - Date(1949, 12, 1, calendar=date.calendar)) / 3600.0
        self.w.write_record(hours, {k: fields[k] for k in
                                    ("u", "v", "t", "qv", "ps", "ts")})

    def close(self):
        self.w.close()


def generate_synthetic_icbc(cfg: RegCMConfig, topo: np.ndarray,
                            path: str, jet: float = 0.0) -> str:
    """icbc main-program equivalent over [gdate1, gdate2]."""
    d0 = Date.from_int(cfg.globdat.gdate1, cfg.globdat.calendar)
    d1 = Date.from_int(cfg.globdat.gdate2, cfg.globdat.calendar)
    w = ICBCWriter(path, cfg)
    d = d0
    while d <= d1:
        w.append(d, synthetic_fields(cfg, topo, d, jet=jet))
        d = d.add_hours(cfg.globdat.ibdyfrq)
    w.close()
    return path


class ICBCReader:
    """Reads ICBC files (read_icbc, Main/mod_ncio.F90:835,
    variable binding :642-672).

    Handles both this package's files and reference-preprocessor
    (``PreProc/ICBC/mod_write.F90``) files: variables ps/ts/u/v/t/qv
    with layout (time, kz, iy, jx); reference files store ps in hPa
    (mod_write.F90:168) and time with an arbitrary "hours/days since"
    epoch — both converted on read."""

    def __init__(self, path: str, calendar: str = "gregorian"):
        self.data, self.attrs = read_nc(path, with_attrs=True)
        self.calendar = calendar
        times = np.asarray(self.data["time"], dtype=np.float64)
        # decode the epoch from the units attribute (CF style)
        tunits = self.attrs.get("time", {}).get("units", "")
        if isinstance(tunits, bytes):
            tunits = tunits.decode()
        scale = 3600.0
        epoch = Date(1949, 12, 1, calendar=calendar)
        if tunits:
            parts = tunits.split("since")
            if len(parts) == 2:
                unit = parts[0].strip().lower()
                scale = {"hours": 3600.0, "days": 86400.0,
                         "seconds": 1.0,
                         "minutes": 60.0}.get(unit, 3600.0)
                dstr = parts[1].strip().split()[0]
                try:
                    y, mo, dy = [int(x) for x in dstr.split("-")[:3]]
                    epoch = Date(y, mo, dy, calendar=calendar)
                except Exception:
                    pass
        ref = Date(1949, 12, 1, calendar=calendar)
        off_h = (epoch - ref) / 3600.0
        self.times = times * (scale / 3600.0) + off_h
        # ps units: reference ICBC writes hPa (mod_write.F90:168)
        ps = np.asarray(self.data["ps"])
        punits = self.attrs.get("ps", {}).get("units", "")
        if isinstance(punits, bytes):
            punits = punits.decode()
        if punits in ("hPa", "mb", "millibar") or np.nanmax(ps) < 2000.0:
            self.data["ps"] = ps * 100.0

    def record_at(self, date: Date) -> Dict[str, np.ndarray]:
        hours = (date - Date(1949, 12, 1, calendar=self.calendar)) / 3600.0
        idx = int(np.argmin(np.abs(self.times - hours)))
        return {k: self.data[k][idx] for k in
                ("u", "v", "t", "qv", "ps", "ts")}, idx

    def nrec(self):
        return len(self.times)


def main(argv=None):
    """CLI: synthetic ICBC over the namelist's window (the reference's
    dattyp readers, PreProc/ICBC/icbc.F90:273-345, are not ported)."""
    import argparse
    ap = argparse.ArgumentParser(description="icbc preprocessor")
    ap.add_argument("namelist")
    ap.add_argument("--domain", default=None)
    ap.add_argument("--jet", type=float, default=0.0)
    ap.add_argument("--synthetic", action="store_true",
                    help="ignore dattyp, make analytic ICBC")
    args = ap.parse_args(argv)
    cfg = RegCMConfig.from_file(args.namelist)
    if not args.synthetic:
        raise SystemExit(
            f"dattyp {cfg.globdat.dattyp.strip()!r}: regcm_tpu_torch makes "
            "synthetic ICBC only (--synthetic); the reanalysis and GCM "
            "readers are not ported (ROADMAP.md Queue 1, item 14)")
    if args.domain and os.path.exists(args.domain):
        topo = read_nc(args.domain)["topo"]
    else:
        from .terrain import synthetic_topo
        topo, _, _ = synthetic_topo(cfg)
    out = f"{cfg.terrain.domname}_ICBC.{cfg.globdat.gdate1}.nc"
    generate_synthetic_icbc(cfg, topo, out, jet=args.jet)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
