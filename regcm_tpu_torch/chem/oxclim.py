"""Prescribed oxidant climatology (ioxclim=1): OH, HO2, O3, NO3, H2O2
fields for the sulfur chemistry (``oxcl``,
``Main/chemlib/mod_che_bdyco.F90:66,98-100``; file schema
``mod_che_ncio.F90:105`` OXBC variables OH/HO2/O3/NO3/H2O2).

The reference reads monthly OXBC NetCDF produced by ``chem_icbc`` from
the MOZART climatology.  When such a file exists next to the run's
input directory it is used; otherwise an analytic zonal-mean annual
climatology stands in (documented deviation — the MOZART archive is
not distributed with the source tree).  Magnitudes follow standard
tropospheric values: OH ~1e6 molec/cm³ daytime mean peaking in the
tropical mid-troposphere (Spivakovsky et al. 2000), H2O2 ~1 ppbv in
the boundary layer decaying upward, O3 ~40 ppbv troposphere.

Units at the two chemsox use sites (mod_che_sox.F90:95,169): OH in
molec/cm³, H2O2 in mol/mol.
"""
from __future__ import annotations

import numpy as np

IOX_OH, IOX_HO2, IOX_O3, IOX_NO3, IOX_H2O2 = 0, 1, 2, 3, 4
NOXCL = 5


def analytic_oxidants(xlat: np.ndarray, sigma_mid: np.ndarray):
    """(noxcl, kz, iy, jx) annual-mean oxidant fields.

    xlat (iy, jx) degrees; sigma_mid (kz) mid-level sigma (≈ p/ps).
    OH/HO2/NO3 in molec/cm³ (daytime-mean; chemsox applies the
    1.99/0.01 day-night factor), O3/H2O2 in mol/mol.
    """
    kz = len(sigma_mid)
    iy, jx = xlat.shape
    lat = np.abs(np.asarray(xlat))
    sig = np.asarray(sigma_mid)[:, None, None]
    latw = np.cos(np.radians(lat))[None] ** 2          # tropics-peaked

    # OH: ~1.5e6 tropics BL, mid-trop max, →2e5 near tropopause
    oh = (1.5e6 * latw + 2.0e5) * np.exp(-((sig - 0.55) / 0.45) ** 2)
    oh = np.maximum(oh, 5.0e4)
    # HO2 ~ 20× OH
    ho2 = 20.0 * oh
    # O3: 40 ppbv troposphere rising toward the model top
    o3 = (40.0e-9 + 160.0e-9 * np.maximum(0.25 - sig, 0.0) / 0.25
          * np.ones((1, iy, jx)))
    # NO3: night-time oxidant, ~1e8 molec/cm³ BL over land latitudes
    no3 = 1.0e8 * latw * sig ** 2 + 1.0e6
    # H2O2: ~1 ppbv BL, halved by 500 hPa
    h2o2 = 1.0e-9 * latw * sig ** 2 + 5.0e-11
    out = np.stack([oh, ho2,
                    np.broadcast_to(o3, (kz, iy, jx)),
                    no3, h2o2])
    return out


def load_oxidants(cfg, grid, sigma_mid):
    """OXBC file when present (reference schema), else the analytic
    climatology.  Returns (noxcl, kz, iy, jx) float array."""
    import os
    dirglob = getattr(cfg.globdat, "dirglob", ".")
    dom = getattr(cfg.terrain, "domname", "domain")
    # reference naming: <domname>_OXBC.<time>.nc (mod_che_ncio:1173)
    cands = []
    if os.path.isdir(dirglob):
        cands = sorted(f for f in os.listdir(dirglob)
                       if f.startswith(f"{dom}_OXBC"))
    if cands:
        from scipy.io import netcdf_file
        with netcdf_file(os.path.join(dirglob, cands[0]), "r") as nc:
            names = ["OH", "HO2", "O3", "NO3", "H2O2"]
            arrs = [np.array(nc.variables[n][0]).astype(float)
                    for n in names]
        return np.stack(arrs)
    return analytic_oxidants(grid.xlat, sigma_mid)
