"""Chemical ICBC preprocessor (the ``chem_icbc`` executable
equivalent, PreProc/ICBC/chem_icbc.F90 + mod_ch_icbc_clim.F90 +
mod_ae_icbc.F90).

The reference horizontally/vertically interpolates a MOZART-4 monthly
climatology (``OXIGLOB/mz4_19990401.nc``) — and MERRA aerosol fields
for the AE path — onto the domain, writing one CHBC record per
boundary time.  Those archives cannot ship with this package, so when
no climatology file is available we synthesize a zonally-symmetric
monthly background per tracer kind (documented deviation, PARITY
§chem): inflow boundaries then carry climatological non-clean air into
the model's CHBC relaxation (mod_che_bdyco nudge_chi) instead of the
clean-air default.

Every profile is (a) latitude-modulated, (b) decays with sigma like
the reference fields do with pressure, and (c) carries a mild seasonal
cycle so the month-interpolation machinery is exercised.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..config.params import RegCMConfig
from ..utils.calendar import Date
from ..utils.vertical import sigma_levels
from ..io.ncio import NCWriter, read_nc
from ..chem.species import build_species

# surface background mixing ratios (kg/kg) per tracer kind; gas-phase
# values follow the MOZART species map of mod_ch_icbc_clim.F90:248-340
_GAS_BG = {
    "O3": 6.0e-8, "NO": 5.0e-11, "NO2": 1.0e-10, "HNO3": 1.0e-10,
    "N2O5": 1.0e-11, "H2O2": 1.0e-9, "CH4": 1.0e-6, "CO": 1.0e-7,
    "SO2": 5.0e-10, "DMS": 1.0e-10, "PAR": 1.0e-9, "C2H6": 5.0e-10,
    "ETH": 1.0e-10, "TOL": 5.0e-11, "XYL": 2.0e-11, "ISOP": 2.0e-10,
    "PAN": 1.0e-10, "HCHO": 2.0e-10, "ALD2": 1.0e-10, "CH3OH": 5.0e-10,
    "AONE": 2.0e-10, "MGLY": 2.0e-11,
}
_KIND_BG = {"dust": 2.0e-9, "sslt": 1.0e-9, "carb": 2.0e-10,
            "so2": 5.0e-10, "pollen": 0.0, "gas": 1.0e-12}


def climatic_chi(spec, sigma: np.ndarray, xlat: np.ndarray,
                 month: int) -> np.ndarray:
    """(ntr, kz, iy, jx) climatological mixing ratios for one month."""
    kz = sigma.shape[0]
    sg = sigma[:, None, None]
    lat = xlat[None]
    seas = np.cos(2.0 * np.pi * (month - 7) / 12.0)
    out = np.zeros((spec.ntr, kz) + xlat.shape)
    for it, (name, kind) in enumerate(zip(spec.names, spec.kind)):
        if kind == "dust":
            # subtropical dust belts, shallow layer
            horiz = (np.exp(-((lat - 22.0) / 18.0) ** 2)
                     * (1.0 + 0.3 * seas)
                     + np.exp(-((lat + 22.0) / 18.0) ** 2)
                     * (1.0 - 0.3 * seas))
            prof = _KIND_BG["dust"] * sg ** 4 * horiz
        elif kind == "sslt":
            horiz = 0.5 + 0.5 * np.cos(np.deg2rad(lat)) ** 2
            prof = _KIND_BG["sslt"] * sg ** 5 * horiz
        elif kind in ("carb",):
            horiz = np.exp(-((lat - 10.0) / 30.0) ** 2)
            prof = _KIND_BG["carb"] * sg ** 3 * horiz
        elif kind == "so2":
            nh = 1.0 + 0.5 * np.tanh(lat / 20.0)
            base = _GAS_BG["SO2"] if name.upper().startswith("SO2") \
                else 3.0e-10
            prof = base * sg ** 3 * nh * (1.0 + 0.2 * seas)
        elif kind == "pollen":
            prof = np.zeros_like(sg * lat)
        else:                                    # gas
            base = _GAS_BG.get(name.upper(), _KIND_BG["gas"])
            if name.upper() == "O3":
                # tropospheric background + stratospheric ramp
                prof = base * (0.6 + 0.4 * np.abs(np.sin(
                    np.deg2rad(lat)))) + 5.0e-6 * (1.0 - sg) ** 4
                prof = prof * (1.0 + 0.1 * seas * np.sign(lat))
            elif name.upper() in ("CH4", "CO"):
                nh = 1.0 + 0.1 * np.tanh(lat / 30.0)
                prof = base * nh * (0.4 + 0.6 * sg)
            else:
                prof = base * sg ** 2 * np.ones_like(lat)
        out[it] = prof
    return out


class CHBCWriter:
    """CHBC file: chi(ntr, kz, iy, jx) per boundary time (the
    reference writes per-species variables via mod_wrtoxd; one stacked
    variable keeps the reader trivial)."""

    def __init__(self, path: str, cfg: RegCMConfig, ntr: int,
                 names: List[str]):
        iy, jx, kz = cfg.dim.iy, cfg.dim.jx, cfg.dim.kz
        self.w = NCWriter(path, dims={"iy": iy, "jx": jx, "kz": kz,
                                      "ntr": ntr},
                          attrs={"title": "regcm_tpu CHBC",
                                 "tracers": " ".join(names)})
        self.w.def_time_var("chi", ("ntr", "kz", "iy", "jx"),
                            "kg kg-1", "Tracer mixing ratio")

    def append(self, date: Date, chi: np.ndarray):
        hours = (date - Date(1949, 12, 1,
                             calendar=date.calendar)) / 3600.0
        self.w.write_record(hours, {"chi": chi})

    def close(self):
        self.w.close()


def generate_chem_icbc(cfg: RegCMConfig, path: str,
                       xlat: Optional[np.ndarray] = None) -> str:
    """chem_icbc main program over [gdate1, gdate2]: month-interpolated
    climatology at every boundary time (get_ch_icbc_clim's month-middle
    weighting, mod_ch_icbc_clim.F90:190-246)."""
    spec = build_species(cfg.chem.chemsimtype)
    if spec is None or spec.ntr == 0:
        raise ValueError(
            f"chemsimtype {cfg.chem.chemsimtype!r} has no tracers")
    if xlat is None:
        from ..core.grid import build_grid
        xlat = np.asarray(build_grid(cfg).xlat)
    _, sh, _ = sigma_levels(cfg.dim.kz, cfg.dim.dsmax, cfg.dim.dsmin)
    d0 = Date.from_int(cfg.globdat.gdate1, cfg.globdat.calendar)
    d1 = Date.from_int(cfg.globdat.gdate2, cfg.globdat.calendar)
    w = CHBCWriter(path, cfg, spec.ntr, spec.names)
    cache: Dict[int, np.ndarray] = {}
    d = d0
    while d <= d1:
        # month-middle interpolation weights (:190-206)
        mid = Date(d.year, d.month, 15, calendar=d.calendar)
        if d >= mid:
            m1, m2 = d.month, d.month % 12 + 1
            r1 = mid
            ny, nm = (d.year + (d.month == 12)), d.month % 12 + 1
            r2 = Date(ny, nm, 15, calendar=d.calendar)
        else:
            m1, m2 = (d.month - 2) % 12 + 1, d.month
            py, pm = (d.year - (d.month == 1)), (d.month - 2) % 12 + 1
            r1 = Date(py, pm, 15, calendar=d.calendar)
            r2 = mid
        for m in (m1, m2):
            if m not in cache:
                cache[m] = climatic_chi(spec, sh, xlat, m)
        f1 = (d - r1) / max(r2 - r1, 1.0)
        chi = cache[m1] * (1.0 - f1) + cache[m2] * f1
        w.append(d, chi)
        d = d.add_hours(cfg.globdat.ibdyfrq)
    w.close()
    return path


class CHBCReader:
    """Reads CHBC files for the driver's boundary relaxation."""

    def __init__(self, path: str, calendar: str = "gregorian"):
        self.data, self.attrs = read_nc(path, with_attrs=True)
        self.calendar = calendar
        self.names = str(self.attrs.get("global", {}).get(
            "tracers", "")).split()
        self.times = np.asarray(self.data["time"], dtype=np.float64)

    def record_at(self, date: Date):
        hours = (date - Date(1949, 12, 1,
                             calendar=self.calendar)) / 3600.0
        idx = int(np.argmin(np.abs(self.times - hours)))
        return np.asarray(self.data["chi"][idx]), idx

    def nrec(self):
        return len(self.times)
