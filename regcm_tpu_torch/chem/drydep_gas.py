"""Gas-phase dry deposition — Zhang, Brook & Vet (2003) big-leaf
resistance scheme (``stomtresis``/``drydep_gas``,
``Main/chemlib/mod_che_drydep.F90:795-1442``), torch twin of
``regcm_tpu/chem/drydep_gas.py``.

Deposition velocity vd = 1/(Ra + Rb + Rc) with
- Ra from the shared aerodynamic-resistance routine,
- Rb the quasi-laminar layer per gas diffusivity,
- Rc the canopy resistance combining stomatal (sunlit/shaded PAR
  split, temperature / VPD / water-stress factors), cuticle, in-canopy
  aerodynamic + ground pathways, with rain/dew wetness and snow
  adjustments.

Constant tables (per-BATS-landuse LAI and resistances, per-gas
diffusivity/mesophyll/scaling) live in ``_drydep_gas_data.py``
(generated from the reference's data statements).  The per-point
Fortran branch ladder becomes dense `torch.where` masking.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils import constants as c
from . import _drydep_gas_data as T
from .deposition import _mn, _mx

RAINTHR = 0.1        # rainfall threshold (mod_che_drydep.F90:68)
_DAIR = 0.369 * 29.0 + 6.29
_DH2O = 0.369 * 18.0 + 6.29

# gas table rows (1-based in the reference) used by drydep_gas
# (:862-875): SO2, NO2, O3, H2O2, HNO3, PAN, HCHO, ALD2, CH3OH
GAS_ROW = {"SO2": 0, "NO2": 2, "O3": 3, "H2O2": 4, "HNO3": 5,
           "PAN": 9, "HCHO": 13, "ALD2": 14, "CH3OH": 22,
           # CB6 species names sharing the same table rows
           "SDIO": 0, "NDOX": 2, "OZN": 3, "HPOX": 4, "NTRC": 5,
           "PACN": 9, "FORM": 13, "AALD": 14, "MEOH": 22}




def lai_now(mpos) -> tuple:
    """Per-class LAI linearly interpolated to the fractional month
    position ``mpos`` (month + (day-15)/30, i.e. mid-month nodes — the
    equivalent of drydep_gas :822-841). Returns numpy ((22,) lai_f,
    laimin, laimax)."""
    lai = np.asarray(T.LAI[:, :12])
    x = (float(mpos) - 1.0) % 12.0
    m0 = int(np.floor(x))
    frac = x - m0
    m1 = (m0 + 1) % 12
    f = (1.0 - frac) * lai[:, m0] + frac * lai[:, m1]
    return np.maximum(f, 0.0), np.asarray(T.LAI[:, 13]), \
        np.asarray(T.LAI[:, 14])


def stomtresis(lai_f, laimin, laimax, lcov, gas_rows, ustar, prec,
               snow, srad, ts, t2, rh, coszen):
    """Surface (Rc) and quasi-laminar (Rb) resistances, s/m.

    All met inputs (iy, jx); lcov int array (1-22, water→14);
    gas_rows: static tuple of gas-table row indices.
    Returns (ngas, iy, jx) rc, rb.
    """
    tt = lambda tab: torch.as_tensor(np.asarray(tab), dtype=ustar.dtype,
                                     device=ustar.device)
    g = lambda tab: tt(tab)[lcov - 1]
    tmaxk = g(T.TMAX) + c.tzero
    tmink = g(T.TMIN) + c.tzero
    ust = _mx(ustar, 1e-3)
    mu = _mx(coszen, 1e-3)

    # ---- stomatal resistance (PAR sunlit/shaded split) -------------
    active = ((srad >= 0.1) & (ts < tmaxk) & (ts > tmink)
              & (lai_f > 0.001) & (coszen > 0.01))
    rdu = 600.0 * torch.exp(-0.185 / mu) * mu
    rdv = 0.4 * (600.0 - rdu) * mu
    ww1 = -torch.log(mu) / 2.302585
    ww2 = -1.195 + 0.4459 * ww1 - 0.0345 * ww1 ** 2
    ww3 = 1320.0 * torch.pow(10.0, ww2)
    rdm = (720.0 * torch.exp(-0.06 / mu) - ww3) * mu
    rdn = 0.6 * (720.0 - rdm - ww3) * mu
    rv = _mx(0.1, rdu + rdv)
    rn = _mx(0.01, rdm + rdn)
    ratio = _mn(0.9, srad / (rv + rn))
    sv = ratio * rv
    fv = _mn(0.99, (0.901 - ratio) / 0.7)
    fvv = torch.clamp(rdu / rv * (1.0 - fv ** 0.6667), min=0.01)
    pardir = fvv * sv
    pardif = sv - pardir
    dense = (lai_f > 2.5) & (srad > 200.0)
    pshad = torch.where(
        dense,
        pardif * torch.exp(-0.5 * lai_f ** 0.8)
        + 0.07 * pardir * (1.1 - 0.1 * lai_f) * torch.exp(-mu),
        pardif * torch.exp(-0.5 * _mx(lai_f, 0.0) ** 0.7)
        + 0.07 * pardir * (1.1 - 0.1 * lai_f) * torch.exp(-mu))
    psun = torch.where(dense,
                     pardir ** 0.8 * 0.5 / mu + pshad,
                     pardir * 0.5 / mu + pshad)
    pshad = _mx(pshad, 1e-6)
    psun = _mx(psun, 1e-6)
    rsmin = g(T.RSMINZ)
    rshad = rsmin + g(T.BRS) * rsmin / pshad
    rsun = rsmin + g(T.BRS) * rsmin / psun
    xp = 0.5 * lai_f / mu
    fsun = torch.where(xp < 25.0, 2.0 * mu * (1.0 - torch.exp(-xp)), 0.0)
    fshad = lai_f - fsun
    gspar = _mx(fsun / rsun + fshad / rshad, 1e-10)
    temps = ts - c.tzero
    topt, tmaxc, tminc = g(T.TOPT), g(T.TMAX), g(T.TMIN)
    bt = (tmaxc - topt) / _mx(topt - tminc, 1e-6)
    gt = _mx((tmaxc - temps) / _mx(tmaxc - topt, 1e-6),
                     1e-6) ** bt
    gt = gt * (temps - tminc) / _mx(topt - tminc, 1e-6)
    gt = torch.clamp(gt, min=1e-3)
    es = 6.108 * torch.exp(17.27 * (ts - c.tzero) / (ts - 35.86))
    d0 = es * (1.0 - rh) / 10.0
    gd = torch.clamp(1.0 - g(T.BVPD) * d0, 0.1, 1.0)
    psi = -0.72 - 0.0013 * srad
    gw = torch.clamp((psi - g(T.PSI2))
                  / (g(T.PSI1) - g(T.PSI2)), 0.1, 1.0)
    rst = 1.0 / (gspar * gt * gd * gw)
    # inactive points keep the reference's -999 sentinel semantics via
    # total stomatal blocking (wst=1)
    # ---- wetness state ---------------------------------------------
    dq = _mx(0.622 / 1000.0 * es * (1.0 - rh) * 1000.0, 1e-4)
    usmin = 1.5 / dq * 0.1
    is_rain = (ts > c.tzero) & (prec > RAINTHR)
    is_dew = (~is_rain) & (ts > c.tzero) & (ust < usmin)
    wet = is_rain | is_dew
    wst = torch.where(wet & (srad > 200.0),
                    _mn((srad - 200.0) / 800.0, 0.5), 0.0)
    wst = torch.where(active, wst, 1.0)

    # ---- in-canopy aerodynamic + ground resistances ----------------
    rac = (g(T.RAC1) + (lai_f - laimin)
           / (laimax - laimin + 1e-10) * (g(T.RAC2) - g(T.RAC1)))
    rac = rac * _mx(lai_f, 1e-6) ** 0.25 / ust ** 2
    water = lcov == 14
    cold = ts < 272.15
    rgo_t = g(T.RGO)
    rgo_f = torch.where(
        cold & ~water,
        _mn(rgo_t * 2.0, rgo_t * torch.exp(0.2 * (272.15 - ts))),
        rgo_t)
    rgs_t = g(T.RGS)
    rgs_f = torch.where(
        lcov == 12,
        _mx(rgs_t, 100.0),
        torch.where(is_rain & ~water, 50.0,
                  torch.where(is_dew & ~water, 100.0,
                            torch.where(cold & ~water,
                                      _mn(rgs_t * 2.0, rgs_t
                                                  * torch.exp(0.2 * (272.156 - ts))),
                                      rgs_t))))

    # ---- cuticle resistances ---------------------------------------
    sq = torch.sqrt(_mx(lai_f, 1e-6))
    l4 = _mx(lai_f, 1e-6) ** 0.25
    rcutdo, rcutds, rcutwo = g(T.RCUTDO), g(T.RCUTDS), g(T.RCUTWO)
    no_cut = rcutdo <= -1.0
    ryx = torch.exp(0.2 * (272.156 - ts))
    dry_o = _mx(rcutdo / torch.exp(3.0 * rh) / l4 / ust, 100.0)
    dry_s = _mx(rcutds / torch.exp(3.0 * rh) / l4 / ust, 100.0)
    rcuto_f = torch.where(
        is_rain, rcutwo / sq / ust,
        torch.where(is_dew, rcutwo / sq / ust,
                  torch.where(cold, _mn(dry_o * 2.0, dry_o * ryx),
                            dry_o)))
    rcuts_f = torch.where(
        is_rain, _mx(50.0 / sq / ust, 20.0),
        torch.where(is_dew, _mx(100.0 / sq / ust, 20.0),
                  torch.where(cold, _mn(dry_s * 2.0, dry_s * ryx),
                            dry_s)))
    rcuto_f = torch.where(no_cut, 1e25, rcuto_f)
    rcuts_f = torch.where(no_cut, 1e25, rcuts_f)

    # ---- snow adjustment -------------------------------------------
    fsnow = torch.clamp(snow / g(T.SDMAX), 0.0, 1.0)
    rsnows = torch.clamp(70.0 * (275.15 - ts), 100.0, 500.0)
    has_snow = fsnow > 1e-4
    rcuts_f = torch.where(
        has_snow,
        1.0 / ((1.0 - fsnow) / rcuts_f + fsnow / rsnows), rcuts_f)
    rcuto_f = torch.where(
        has_snow,
        1.0 / ((1.0 - fsnow) / rcuto_f + fsnow / 2000.0), rcuto_f)
    fsnow2 = _mn(1.0, fsnow * 2.0)
    rgs_f = torch.where(
        has_snow, 1.0 / ((1.0 - fsnow2) / rgs_f + fsnow2 / rsnows),
        rgs_f)
    rgo_f = torch.where(
        has_snow, 1.0 / ((1.0 - fsnow2) / rgo_f + fsnow2 / 2000.0),
        rgo_f)

    # ---- per-gas Rb + Rc -------------------------------------------
    rows = np.asarray(gas_rows)
    mw = tt(T.MW[rows])[:, None, None]
    rm = tt(T.RM[rows])[:, None, None]
    alpha = tt(T.ALPHAZ[rows])[:, None, None]
    beta = tt(T.BETAZ[rows])[:, None, None]
    dgas = 0.369 * mw + 6.29
    di = (0.001 * ts[None] ** 1.75
          * torch.sqrt((29.0 + mw) / mw / 29.0)
          / (_DAIR ** (1.0 / 3.0) + dgas ** (1.0 / 3.0)) ** 2)
    tsm = 0.5 * (ts + t2)[None]
    vi = 145.8e-4 * tsm ** 1.5 / (tsm + 110.4)
    rb = 5.0 / ust[None] * (vi / di) ** (2.0 / 3.0)
    dvh2o = (0.001 * ts ** 1.75 * math.sqrt(47.0 / (29.0 * 18.0))
             / (_DAIR ** (1.0 / 3.0) + _DH2O ** (1.0 / 3.0)) ** 2)
    rstom = rst[None] * dvh2o[None] / di + rm
    rcut = 1.0 / (alpha / rcuts_f[None] + beta / rcuto_f[None])
    rg = 1.0 / (alpha / rgs_f[None] + beta / rgo_f[None])
    rc = ((1.0 - wst[None]) / rstom + 1.0 / (rac[None] + rg)
          + 1.0 / rcut)
    rc = _mx(10.0, 1.0 / rc)
    return rc, rb


def gas_drydep_velocity(spec_gas_names, lcov, mpos, ustar,
                        resa, prec, snow, srad, ts, t2, rh, coszen):
    """(ngas, iy, jx) deposition velocities m/s for the named gases
    (drydep_gas :846-876): vd = 1/(Ra+Rb+Rc).  ``mpos`` is the
    fractional month position (a number)."""
    rows = tuple(GAS_ROW[n] for n in spec_gas_names)
    tt = lambda a: torch.as_tensor(a, dtype=ustar.dtype, device=ustar.device)
    lf, lmin, lmax = lai_now(mpos)
    lai_f = tt(lf)[lcov - 1]
    laimin = tt(lmin)[lcov - 1]
    laimax = tt(lmax)[lcov - 1]
    rc, rb = stomtresis(lai_f, laimin, laimax, lcov, rows, ustar,
                        prec, snow, srad, ts, t2, rh, coszen)
    return 1.0 / (resa[None] + rb + rc)
