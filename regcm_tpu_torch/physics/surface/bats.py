"""BATS1e land surface model, torch twin of
``regcm_tpu/physics/surface/bats.py``.

Vegetation/soil/snow physics of the reference ``Main/batslib/``:
parameter tables (``mod_bats_param``), drag (``mod_bats_drag``), canopy
energy balance (``mod_bats_leaftemp``), force-restore soil temperature,
snow and three-layer hydrology (``mod_bats_bndry``) and two-band surface
albedo (``mod_bats_albedo``), dense over the (iy, jx) grid and masked by
the land mask. The static tables and ``soil_static`` /
``bats_init_state`` are numpy; the per-step physics runs on tensors.
Persistent state: packed (NBATS, iy, jx), see ``BATS_FIELDS``.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from ...utils import constants as c

from ...utils.thermo import pfesat, pfqsat, pfqsdt

# ---- constants (Share/mod_constants.F90) -----------------------------
CSOILC = 4.0e-3
DEWMAX = 0.1
DEWMAXI = 1.0 / DEWMAX
TRSMX0 = 2.0e-4
RMAX0 = 2.0e4
DRAIN = 4.0e-4
MINWRAT = 1.0e-4
ZLND = 0.01
ZSNO = 0.00040
WTUR = 0.1
CH2O = 4.186e6
CSNW = 0.49 * CH2O
CWS = 1.0 / 0.49
MINSIGF = 0.001
RAINSNOWTEMP = 2.2
XKPERI = 1.4e-6
T3PERM = 271.0
SNAL0, SNAL1 = 0.95, 0.65

# ---- landuse tables (mod_bats_param.F90:74-364, 22 classes) ----------
MFCV = np.array([0.85, 0.80, 0.80, 0.80, 0.80, 0.99, 0.80, 0.00, 0.60,
                 0.80, 0.10, 0.00, 0.80, 0.00, 0.00, 0.80, 0.80, 0.80,
                 0.80, 0.80, 0.05, 0.40])
SEASF = np.array([0.60, 0.10, 0.10, 0.30, 0.30, 0.50, 0.30, 0.00, 0.20,
                  0.60, 0.10, 0.00, 0.40, 0.00, 0.00, 0.20, 0.30, 0.20,
                  0.40, 0.40, 0.05, 0.15])
ROUGH = np.array([0.10, 0.03, 1.00, 1.00, 1.00, 1.00, 0.30, 0.005,
                  0.03, 0.10, 0.03, 0.005, 0.10, 0.0002, 0.0004, 0.25,
                  0.10, 1.00, 0.50, 0.30, 2.00, 1.00])
DISPLA = np.array([0., 0., 9., 9., 0., 18., 0., 0., 0., 0., 0., 0., 0.,
                   0., 0., 0., 0., 0., 0., 0., 6., 2.5])
RSMIN = np.array([45., 200., 200., 200., 200., 80., 200., 200., 200.,
                  200., 200., 200., 200., 200., 200., 200., 200., 200.,
                  200., 200., 120., 60.])
XLA = np.array([6., 2., 6., 6., 6., 6., 3., 0., 2., 4., 1., 0., 4., 0.,
                0., 4., 4., 5., 4., 1., 1., 2.])
XLAI0 = np.array([0.5, 0.5, 5., 1., 1., 6., 1., 0., 0.5, 2., 0.5, 0.,
                  2., 0., 0., 3., 1., 3., 0.5, 1., 0.5, 1.])
SAI = np.array([0.5, 4., 2., 2., 2., 2., 2., 0.5, 0.5, 2., 2., 2., 2.,
                2., 2., 2., 2., 2., 2., 2., 0.5, 0.5])
SQRTDI = np.array([10.] + [5.] * 21)
FCL = np.array([0.02, 0.02, 0.06, 0.06, 0.06, 0.06, 0.02, 0.02, 0.02,
                0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.02, 0.06,
                0.02, 0.02, 0.02, 0.02])
DEPUV = np.full(22, 100.0)
DEPRV = np.array([1000., 1000., 1500., 1500., 2000., 1500., 1000.,
                  1000., 1000., 1000., 1000., 1000., 1000., 1000.,
                  1000., 1000., 1000., 2000., 2000., 2000., 1000.,
                  1000.])
DEPTV = np.full(22, 3000.0)
KOLSOL = np.array([6, 4, 5, 5, 5, 5, 5, 1, 4, 4, 2, 1, 6, 6, 6, 5, 4,
                   5, 5, 5, 4, 4]) - 1
SOLOUR = np.array([0.16, 0.15, 0.10, 0.09, 0.08, 0.07, 0.06, 0.05])
ALBVGS = np.array([0.10, 0.10, 0.04, 0.04, 0.06, 0.04, 0.08, 0.20,
                   0.10, 0.08, 0.17, 0.80, 0.06, 0.07, 0.07, 0.05,
                   0.08, 0.05, 0.06, 0.06, 0.02, 0.06])
ALBVGL = np.array([0.30, 0.30, 0.20, 0.20, 0.26, 0.20, 0.30, 0.40,
                   0.30, 0.28, 0.34, 0.60, 0.18, 0.20, 0.20, 0.23,
                   0.28, 0.23, 0.18, 0.18, 0.15, 0.18])
ROOTF = np.array([0.30, 0.80, 0.67, 0.67, 0.50, 0.80, 0.80, 0.90,
                  0.90, 0.30, 0.80, 0.50, 0.50, 0.50, 0.50, 0.50,
                  0.50, 0.50, 0.50, 0.50, 0.90, 0.50])
LNDEMISS = np.array([0.983, 0.983, 0.983, 0.987, 0.981, 0.981, 0.983,
                     0.965, 0.987, 0.985, 0.970, 0.993, 0.992, 0.992,
                     0.992, 0.983, 0.972, 0.983, 0.981, 0.991, 0.970,
                     0.972])
SEASEMI = np.array([0.005, 0.002, 0.000, 0.004, 0.004, 0.000, 0.002,
                    0.000, 0.000, 0.002, 0.000, 0.000, 0.000, 0.000,
                    0.000, 0.000, 0.004, 0.002, 0.004, 0.000, 0.000,
                    0.001])
SLMO = np.array([0.50, 0.50, 0.50, 0.50, 0.50, 0.50, 0.50, 0.01, 0.50,
                 0.50, 0.10, 0.50, 0.90, 1.00, 1.00, 0.50, 0.30, 0.50,
                 0.50, 0.80, 0.10, 0.50])
# ---- texture tables (17 classes) -------------------------------------
XMOPOR = np.array([0.13, 0.26, 0.39, 0.42, 0.45, 0.48, 0.51, 0.54,
                   0.57, 0.60, 0.63, 0.66, 0.66, 0.00, 0.10, 0.45,
                   0.45])
XMOSUC = np.array([10., 20., 30., 200., 200., 200., 200., 200., 200.,
                   200., 100., 200., 200., 0., 10., 200., 200.])
XMOHYD = np.array([0.0200, 0.0800, 0.0320, 0.0130, 0.0089, 0.0063,
                   0.0045, 0.0032, 0.0022, 0.0016, 0.0011, 0.0008,
                   0.0200, 0.0000, 0.0008, 0.0063, 0.0063])
XMOWIL = np.array([0.095, 0.128, 0.161, 0.266, 0.300, 0.332, 0.378,
                   0.419, 0.455, 0.487, 0.516, 0.542, 0.542, 0.000,
                   0.095, 0.332, 0.332])
XMOFC = np.array([0.404, 0.477, 0.547, 0.614, 0.653, 0.688, 0.728,
                  0.763, 0.794, 0.820, 0.845, 0.866, 0.866, 0.000,
                  0.404, 0.688, 0.688])
BEE = np.array([3.5, 4.0, 4.5, 5.0, 5.5, 6.0, 6.8, 7.6, 8.4, 9.2,
                10.0, 10.8, 10.8, 0.0, 3.5, 6.0, 6.0])
SKRAT = np.array([1.70, 1.50, 1.30, 1.20, 1.10, 1.00, 0.95, 0.90,
                  0.85, 0.80, 0.75, 0.70, 0.70, 0.00, 1.70, 1.00,
                  1.00])

BATS_FIELDS = ("tgbrd", "tlef", "taf", "ldew", "sncv", "snag",
               "ssw", "rsw", "tsw", "gwet")
NBATS = len(BATS_FIELDS)


class BatsOut(NamedTuple):
    sent: torch.Tensor
    evpr: torch.Tensor
    drag: torch.Tensor
    tgrd: torch.Tensor
    bats: torch.Tensor       # packed (NBATS, iy, jx) persistent state
    sigf: torch.Tensor
    emiss: torch.Tensor
    t2m: torch.Tensor
    q2m: torch.Tensor


def soil_static(lveg: np.ndarray, ltex: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-point static soil/vegetation constants (soilbc,
    mod_bats_bndry.F90:51-100). lveg/ltex are 1-based class indices."""
    lv = np.clip(lveg.astype(int) - 1, 0, 21)
    lt = np.clip(ltex.astype(int) - 1, 0, 16)
    porsl = XMOPOR[lt]
    xkmx = XMOHYD[lt]
    bsw = BEE[lt]
    with np.errstate(divide="ignore", invalid="ignore"):
        bfc = 5.8 - bsw * (0.8 + 0.12 * (bsw - 4.0)
                           * np.log10(np.maximum(1.0e2 * xkmx, 1e-10)))
        phi0 = XMOSUC[lt]
        dmax = bsw * phi0 * xkmx / np.maximum(porsl, 1e-10)
        dmin = 1.0e-3
        dmnor = 1550.0 * dmin / np.maximum(dmax, 1e-10)
        tweak1 = (bsw * (bsw - 6.0) + 10.3) \
            / np.maximum(bsw * bsw + 40.0 * bsw, 1e-10)
        ck = (1.0 + dmnor) * tweak1 * 0.23 / 0.02356
        evmx0 = 1.02 * dmax * ck / np.sqrt(DEPUV[lv] * DEPRV[lv])
    return dict(
        lv=lv, lt=lt, porsl=porsl, xkmx=np.maximum(xkmx, 1e-10),
        bsw=bsw, bfc=bfc,
        evmx0=np.nan_to_num(evmx0),
        gwmx0=DEPUV[lv] * porsl, gwmx1=DEPRV[lv] * porsl,
        gwmx2=DEPTV[lv] * porsl, wiltr=XMOWIL[lt], relfc=XMOFC[lt],
        texrat=SKRAT[lt], freza=0.15 * DEPRV[lv],
        frezu=0.15 * DEPUV[lv],
        depuv=DEPUV[lv], deprv=DEPRV[lv], deptv=DEPTV[lv],
        albvgs=ALBVGS[lv], albvgl=ALBVGL[lv],
        rough=ROUGH[lv], displa=DISPLA[lv], rsmin=RSMIN[lv],
        xla=XLA[lv], xlai0=XLAI0[lv], sai=SAI[lv], sqrtdi=SQRTDI[lv],
        fc=FCL[lv], rootf=ROOTF[lv], mfcv=MFCV[lv], seasf=SEASF[lv],
        lndemiss=LNDEMISS[lv], seasemi=SEASEMI[lv],
        solour=SOLOUR[KOLSOL[lv]], slmo=SLMO[lv],
        is_ice=(lv + 1 == 12), is_tundra=(lv + 1 == 9),
        is_bog=(lv + 1 == 13), is_irrig=(lv + 1 == 10),
        is_water_albedo=((lv + 1 >= 12) & (lv + 1 <= 15)))


def soil_static_tensors(ss: Dict[str, np.ndarray], device=None,
                        dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """``soil_static`` on the device: bool fields stay bool, the rest
    take ``dtype``."""
    return {k: torch.as_tensor(v, device=device,
                               dtype=torch.bool if v.dtype == bool
                               else dtype)
            for k, v in ss.items() if k not in ("lv", "lt")}


def fseas_fn(temp):
    """Seasonal vegetation factor (fseas, mod_bats_leaftemp.F90:752-785)."""
    return torch.clamp(
        1.0 - 0.0016 * torch.clamp(298.0 - temp, min=0.0) ** 2, min=0.0)


def bats_init_state(ss, landmask, tg):
    """Cold-start packed BATS state (initbats): soil water at slmo ×
    capacity; leaf/subsoil T = ground T. numpy in, numpy out."""
    tg = np.broadcast_to(np.asarray(tg), ss["slmo"].shape)
    z = np.zeros_like(ss["slmo"], dtype=float)
    st = dict(
        tgbrd=tg, tlef=tg, taf=tg,
        ldew=z, sncv=np.where(tg < 263.0, 10.0, 0.0),
        snag=z, ssw=ss["slmo"] * ss["gwmx0"],
        rsw=ss["slmo"] * ss["gwmx1"], tsw=ss["slmo"] * ss["gwmx2"],
        gwet=ss["slmo"] + z)
    return np.stack([np.broadcast_to(st[k], ss["slmo"].shape)
                     for k in BATS_FIELDS])


def _depth(sncv, snag, lncl, rough):
    """Snow cover partitioning (depth, mod_bats_drag.F90:181-204)."""
    age = 1.0 - 1.0 / (1.0 + snag)
    densi = 0.01 / (1.0 + 3.0 * age)
    scrat = sncv * densi
    wt = 0.1 * scrat / rough
    wt = wt / (1.0 + wt)
    sigf = (1.0 - wt) * lncl
    scvk = scrat / (0.1 + scrat)
    rhosw = 0.10 * (1.0 + 3.0 * age)
    return scrat, wt, sigf, scvk, rhosw


def _nz(x):
    """x with exact zeros replaced by 1 (guarded divisor)."""
    return torch.where(x == 0, 1.0, x)


def vecbats(sts, qs, usw, vsw, zh, rhs, sfcp, prcp, swflx, lwflx,
            abswveg, czenith, tgrd_in, bats_in, ss, lndmsk, dtbat):
    """One BATS surface step over the dense grid (vecbats → interf(1),
    soilbc, bndry; mod_bats_common.F90:318-336).

    sts lowest-level air T; qs specific humidity; zh level height; rhs
    surface air density; sfcp surface pressure (Pa); prcp total
    precipitation rate (kg/m2/s); swflx absorbed solar (W/m2); lwflx
    NET UPWARD longwave (W/m2); abswveg solar absorbed by vegetation.
    bats_in packed (NBATS, iy, jx) state; ss ``soil_static_tensors``.
    Returns BatsOut (masked to land points)."""
    tgrd = tgrd_in
    (tgbrd, tlef, taf, ldew, sncv, snag, ssw, rsw, tsw,
     gwet) = (bats_in[i] for i in range(NBATS))
    one = sts.new_tensor(1.0)

    # ---- interf(1): seasonal cover + snow partition -------------------
    aseas = fseas_fn(tgbrd)
    lncl = ss["mfcv"] - ss["seasf"] * aseas
    emiss = ss["lndemiss"] - ss["seasemi"] * aseas
    scrat, wt, sigf, scvk, rhosw = _depth(sncv, snag, lncl, ss["rough"])
    veg = sigf > MINSIGF

    htvp = torch.where((tgrd < c.tzero) | (sncv > 0.0),
                       sts.new_tensor(c.wlhs), c.wlhv)
    tm = sts - RAINSNOWTEMP
    watu = torch.clamp(ssw / ss["gwmx0"], MINWRAT, 1.0)
    watr = torch.clamp(rsw / ss["gwmx1"], MINWRAT, 1.0)
    watt = torch.clamp(tsw / ss["gwmx2"], MINWRAT, 1.0)

    # ---- dragc (mod_bats_drag.F90:52-113) -----------------------------
    zlglnd = torch.log(zh / ZLND)
    zlgsno = torch.log(zh / ZSNO)
    zlgdis = torch.log(torch.clamp(
        (zh - ss["displa"]) / torch.clamp(ss["rough"], min=1e-4), min=1.1))
    frav = sigf
    fras = lncl * wt + (1.0 - lncl) * scvk
    frab = (1.0 - lncl) * (1.0 - scvk)
    cdb = (c.vonkar / zlglnd) ** 2
    cds = (c.vonkar / zlgsno) ** 2
    cdv = (c.vonkar / zlgdis) ** 2
    cdrn = frav * cdv + frab * cdb + fras * cds
    zatild = (zh - ss["displa"]) * sigf + zh * (1.0 - sigf)
    ribn = zatild * c.egrav * (sts - sigf * taf
                               - (1.0 - sigf) * tgrd) / sts
    dthdz = (1.0 - sigf) * tgrd + sigf * taf - sts
    u1 = torch.where(ribn <= 0.0,
                     WTUR + 2.0 * torch.sqrt(torch.clamp(dthdz, min=0.0)),
                     WTUR)
    ribd = usw ** 2 + vsw ** 2 + u1 ** 2
    vspda = torch.sqrt(ribd)
    ribd = torch.where(vspda < 1.0, 1.0, ribd)
    vspda = torch.clamp(vspda, min=1.0)
    rib = ribn / ribd
    cdr = torch.where(rib < 0.0,
                      cdrn * (1.0 + 24.5 * torch.sqrt(cdrn
                                                      * torch.abs(rib))),
                      cdrn / (1.0 + 11.5 * rib))
    cdr = torch.maximum(cdr, torch.clamp(0.25 * cdrn, min=6.0e-4))
    cdrx = cdr

    qgrd = pfqsat(tgrd, sfcp)

    # ---- bare land (bndry 3., mod_bats_bndry.F90:203-230) -------------
    qsatd_b = pfqsdt(tgrd, sfcp) * gwet
    rai = cdrx * vspda * rhs
    cgrnds_b = rai * c.cpd
    cgrndl_b = rai * qsatd_b
    delq_b = (qs - qgrd) * gwet
    delt_b = sts - tgrd
    evpr_b = -rai * delq_b
    sent_b = -cgrnds_b * delt_b
    tlef = torch.where(veg, tlef, sts)
    uaf_b = vspda

    # ---- vegetation: leaf water + drip (4.1-4.2) ----------------------
    ldew = torch.where(veg,
                       torch.clamp(ldew + dtbat * sigf * prcp, min=0.0), 0.0)
    xlai = ss["xla"] + (ss["xlai0"] - ss["xla"]) * (1.0 - aseas)
    rlai = xlai + ss["sai"]
    xlsai = xlai + ss["sai"]
    vegt = sigf * xlsai
    xrun = ldew - DEWMAX * vegt
    etrrun = torch.where(veg & (xrun > 0.0) & (tm >= c.tzero), xrun, 0.0)
    sdrop = torch.where(veg & (xrun > 0.0) & (tm < c.tzero), xrun, 0.0)
    ldew = torch.where(veg & (xrun > 0.0), DEWMAX * vegt, ldew)

    # ---- lftemp iteration (mod_bats_leaftemp.F90:93-309) --------------
    vpdc = torch.full_like(sts, 10.0)
    sgtg3 = emiss * c.sigm * tgrd ** 3
    flneto = torch.where(veg, 4.0 * sgtg3 * (tlef - tgrd), 0.0)
    swsi = swflx / max(1.0 - 0.2, 1e-3)          # incident estimate
    fracd = 0.3                                   # diffuse fraction

    def stomat(vpdc, tlef_l):
        g, difzen, rilmax = 0.5, 2.0, 4.0
        bseas = fseas_fn(tlef_l)
        rmini = ss["rsmin"] / RMAX0
        fsold = fracd * swsi * ss["fc"]
        fsol0 = (1.0 - fracd) * swsi * ss["fc"]
        cz = torch.clamp(czenith, min=1.0e-3)
        rl = torch.clamp(rlai, min=1e-3)
        trup = torch.exp(-torch.clamp(g * rl / (rilmax * cz), max=30.0))
        trupd = torch.exp(-torch.clamp(difzen * g * rl / rilmax, max=30.0))
        rad_il = (1.0 - trup) * fsol0 * rilmax / rl
        radd_il = (1.0 - trupd) * fsold * rilmax / rl
        radfi = 0.0
        for _ in range(4):
            radfi = radfi + (rmini + rad_il + radd_il) \
                / (1.0 + rad_il + radd_il)
            rad_il = trup * rad_il
            radd_il = trupd * radd_il
        radf = rilmax / radfi
        vpdf = 1.0 / torch.clamp(1.0 - vpdc * 0.025, min=0.3)
        seas = 1.0 / (rmini + bseas)
        rs = torch.clamp(ss["rsmin"] * radf * seas * vpdf, max=RMAX0)
        return torch.where(czenith > 1.0e-3, rs, ss["rsmin"])

    lftrs = stomat(vpdc, tlef)
    # frawat
    fwet = torch.where(ldew > 0.0,
                       torch.clamp(((DEWMAXI / torch.clamp(vegt, min=1e-4))
                                    * ldew) ** (2.0 / 3.0), max=1.0), 0.0)
    fdry = (1.0 - fwet) * xlai / torch.clamp(xlsai, min=1e-4)
    # root
    trsmx = TRSMX0 * sigf
    bneg = -ss["bsw"]
    wmli = 1.0 / (ss["wiltr"] ** bneg - 1.0)
    wlttb = torch.clamp((watr ** bneg - 1.0) * wmli, max=1.0)
    wltub = torch.clamp((watu ** bneg - 1.0) * wmli, max=1.0)
    etrc = trsmx * (1.0 - (1.0 - ss["rootf"]) * wlttb
                    - ss["rootf"] * wltub)
    efpr_r = trsmx * ss["rootf"] * (1.0 - wltub)
    efpr = torch.where(etrc < 1.0e-12, one,
                       efpr_r / torch.clamp(etrc, min=1.0e-12))
    etrc = torch.clamp(etrc, min=1.0e-12)
    eg = pfesat(tlef)
    qsatl = pfqsat(tlef, sfcp, eg)

    uaf = vspda * torch.sqrt(cdr)

    def condch(cdr_l, vspda_l, uaf_l):
        cf = 0.01 * ss["sqrtdi"] / torch.sqrt(torch.clamp(uaf_l, min=1e-3))
        wta = sigf * cdr_l * vspda_l
        wtlh = cf * uaf_l * vegt
        wtg = CSOILC * uaf_l * sigf
        wtshi = 1.0 / torch.clamp(wta + wtlh + wtg, min=1e-20)
        wtl0 = wtlh * wtshi
        wtg0 = wtg * wtshi
        wtgl = wtl0 + wtg0
        wta0 = 1.0 - wtgl
        wtga = wta0 + wtg0
        return cf, wta, wtlh, wtg, wtl0, wtg0, wtgl, wta0, wtga

    (cf, wta, wtlh, wtg, wtl0, wtg0, wtgl, wta0,
     wtga) = condch(cdr, vspda, uaf)

    def condcq(wta, wtlh, wtg, rpp_l, gwet_l):
        rgr = gwet_l
        wtlq = wtlh * rpp_l
        wtgq = wtg * rgr
        wtsqi = 1.0 / torch.clamp(wta + wtlq + wtgq, min=1e-20)
        wtgq0 = wtgq * wtsqi
        wtlq0 = wtlq * wtsqi
        wtglq = wtgq0 + wtlq0
        wtaq0 = 1.0 - wtglq
        wtgaq = wtaq0 + wtgq0
        return rgr, wtlq, wtgq, wtsqi, wtgq0, wtlq0, wtglq, wtaq0, wtgaq

    (rgr, wtlq, wtgq, wtsqi, wtgq0, wtlq0, wtglq, wtaq0,
     wtgaq) = condcq(wta, wtlh, wtg, torch.ones_like(sts), gwet)

    efeb = torch.zeros_like(sts)
    for itr in range(11):           # iter = 0..itmax (itmax=10)
        # lfdrag
        tkb = wta0 * sts + wtl0 * tlef + wtg0 * tgrd
        dlstaf = sts - sigf * tkb - (1.0 - sigf) * tgrd
        dthdz_l = (1.0 - sigf) * tgrd + sigf * tkb - sts
        u1l = torch.where((dlstaf <= 0.0) & (dthdz_l > c.dlowval),
                          WTUR + 2.0 * torch.sqrt(
                              torch.clamp(dthdz_l, min=0.0)), WTUR)
        ribd_l = usw ** 2 + vsw ** 2 + u1l ** 2
        vspda_l = torch.clamp(torch.sqrt(ribd_l), min=1.0)
        ribd_l = torch.where(torch.sqrt(ribd_l) < 1.0, 1.0, ribd_l)
        rib1 = c.egrav * zatild / (ribd_l * sts)
        rib_l = rib1 * dlstaf
        cdr_uns = cdrn * (1.0 + 24.5 * torch.sqrt(
            torch.clamp(-cdrn * rib_l, min=0.0)))
        sqrtf = torch.clamp(torch.sqrt(torch.clamp(
            -cdrn / torch.where(rib_l == 0, -1.0, rib_l), min=0.0)),
            max=11.5 / 12.25)
        cdrd_uns = cdrn * 12.25 * wtl0 * rib1 * sigf * sqrtf
        ribi = 1.0 / (1.0 + 11.5 * rib_l)
        cdr_st = cdrn * ribi
        cdrd_st = cdr_st * ribi * 11.5 * rib1 * wtl0 * sigf
        cdrmin = torch.clamp(cdrn * 0.25, min=6.0e-4)
        lim = cdr_st < cdrmin
        cdr_st = torch.where(lim, cdrmin, cdr_st)
        cdrd_st = torch.where(lim, 0.0, cdrd_st)
        cdr_v = torch.where(rib_l < 0.0, cdr_uns, cdr_st)
        cdrd = torch.where(rib_l < 0.0, cdrd_uns, cdrd_st)
        cdr = torch.where(veg, cdr_v, cdr)
        vspda = torch.where(veg, vspda_l, vspda)
        # condch
        uaf = vspda * torch.sqrt(cdr)
        (cf, wta, wtlh, wtg, wtl0, wtg0, wtgl, wta0,
         wtga) = condch(cdr, vspda, uaf)
        lftra = 1.0 / torch.clamp(cf * uaf, min=1e-10)
        cn1 = wtlh * rhs
        df = cn1 * c.cpd
        # stomatal decrease + updated qsat of leaf
        rppdry = lftra * fdry / (lftrs + lftra)
        rpp = rppdry + fwet
        eg1 = eg
        eg = pfesat(tlef)
        qsatl = qsatl * eg / torch.clamp(eg1, min=1e-10)
        # canopy evapotranspiration
        if itr == 0:
            (rgr, wtlq, wtgq, wtsqi, wtgq0, wtlq0, wtglq, wtaq0,
             wtgaq) = condcq(wta, wtlh, wtg, rpp, gwet)
        epss = 1.0e-10
        efpot = cn1 * (wtgaq * qsatl - wtgq0 * qgrd - wtaq0 * qs)
        etr = torch.where(efpot > 0.0,
                          efpot * lftra * fdry / (lftrs + lftra), 0.0)
        rpp = torch.where(efpot > 0.0,
                          torch.minimum(rpp, (etr + ldew / dtbat)
                                        / _nz(efpot) - epss), one)
        # supply limit
        over = (efpot >= 0.0) & (etr >= etrc)
        rppdry2 = rppdry / torch.clamp(etr / etrc, min=1e-10)
        lftrs = torch.where(over, lftra * (fdry / torch.clamp(
            rppdry2, min=1e-10) - 1.0), lftrs)
        etr = torch.where(over, etrc, etr)
        rpp2 = torch.minimum(rppdry2 + fwet,
                             (etr + ldew / dtbat) / _nz(efpot) - epss)
        rpp = torch.where(over, rpp2, rpp)
        rppq = c.wlhv * rpp
        efe_new = rppq * efpot
        efe = torch.where(efe_new * efeb < 0.0, 0.1 * efe_new, efe_new)
        efeb = efe
        etr = torch.where(veg, etr, etrc)
        (rgr, wtlq, wtgq, wtsqi, wtgq0, wtlq0, wtglq, wtaq0,
         wtgaq) = condcq(wta, wtlh, wtg, rpp, gwet)
        # deriv
        qsatld = pfqsdt(tlef, sfcp)
        xkb = cdrd / torch.clamp(cdr, min=1e-10)
        hfl = df * (wtga * tlef - wtg0 * tgrd - wta0 * sts)
        dcd = cn1 * rppq * wtgaq * qsatld + (1.0 - wtgaq) * efe * xkb \
            + (1.0 - wtga) * hfl * xkb
        dcd = torch.clamp(dcd, 0.0, 500.0)
        # leaf temperature Newton step
        dcn = dcd * tlef
        sgtg3 = emiss * c.sigm * tgrd ** 3
        sf1 = sigf * (abswveg - lwflx - (1.0 - sigf) * flneto
                      + 4.0 * sgtg3 * tgrd)
        sf2 = 4.0 * sigf * sgtg3 + df * wtga + dcd
        tbef = tlef
        tlef_new = (sf1 + df * (wta0 * sts + wtg0 * tgrd) - efe + dcn) \
            / torch.clamp(sf2, min=1e-10)
        dels = torch.clamp(tlef_new - tbef, -1.0, 1.0)
        tlef = torch.where(veg, tbef + dels, tlef)
        # vapor pressure deficit for stomat
        qcan = wtlq0 * qsatl + qgrd * wtgq0 + qs * wtaq0
        vpdc = (1.0 - rpp) * (qsatl - qcan) * 1000.0 / c.ep2
        lftrs = torch.where(veg, stomat(vpdc, tlef), lftrs)

    # ---- post-iteration canopy fluxes (lftemp 4.-5.5) -----------------
    ldew = torch.where(veg, ldew + (etr - efe / c.wlhv) * dtbat, ldew)
    taf = torch.where(veg, wtg0 * tgrd + wta0 * sts + wtl0 * tlef, tgrd)
    delt_v = wtgl * sts - (wtl0 * tlef + wtg0 * tgrd)
    delq_v = wtglq * qs - (wtlq0 * qsatl + wtgq0 * qgrd)
    sgtg3 = emiss * c.sigm * tgrd ** 3
    flnet = torch.where(veg, sgtg3 * (tlef - tgrd) * 4.0, 0.0)
    xxkb = torch.clamp(ss["rough"], max=1.0)
    vakb = (1.0 - sigf) * vspda + sigf * (xxkb * uaf
                                          + (1.0 - xxkb) * vspda)
    wtg2 = (1.0 - sigf) * cdr * vakb
    fbare = wtg2 * (tgrd - sts)
    qbare = wtg2 * (qgrd - qs)
    fseng_v = c.cpd * rhs * (wtg * ((wta0 + wtl0) * tgrd
                                    - wta0 * sts - wtl0 * tlef)
                             + fbare)
    fevpg_v = rhs * rgr * (wtg * ((wtaq0 + wtlq0) * qgrd
                                  - wtaq0 * qs - wtlq0 * qsatl)
                           + qbare)
    qsatdg = pfqsdt(tgrd, sfcp) * rgr
    cgrnds_v = rhs * c.cpd * (wtg * (wta0 + wtl0) + wtg2)
    cgrndl_v = rhs * qsatdg * ((wta + wtlq) * wtg * wtsqi + wtg2)
    sent_v = c.cpd * rhs * (-wta * delt_v + fbare)
    evpr_v = rhs * (-wta * delq_v + rgr * qbare)

    # merge bare/vegetated
    fseng = torch.where(veg, fseng_v, sent_b)
    fevpg = torch.where(veg, fevpg_v, evpr_b)
    cgrnds = torch.where(veg, cgrnds_v, cgrnds_b)
    cgrndl = torch.where(veg, cgrndl_v, cgrndl_b)
    cgrnd = cgrnds + cgrndl * htvp
    sent = torch.where(veg, sent_v, sent_b)
    evpr = torch.where(veg, evpr_v, evpr_b)
    uaf = torch.where(veg, uaf, uaf_b)
    delq = torch.where(veg, delq_v, delq_b)

    # ---- tgrund: force-restore soil temperatures ----------------------
    xnu = 2.0 * math.pi / 86400.0
    xnua = xnu / 365.0
    xdtime = dtbat * xnu
    dtimea = dtbat * xnua
    xdt2 = 0.5 * xdtime

    def fsk(x):
        return (2.9e-7 * x + 4.0e-9) / (((1.0 - 0.6 * x) * x + 0.09)
                                        * (0.23 + x))

    def fsc(x):
        return (0.23 + x) * 4.186e6

    swtrtd = watu * ss["porsl"]
    frozen = 0.85 * torch.clamp(0.25 * (c.tzero - tgrd), max=1.0)
    skd = torch.where(tgrd < c.tzero, sts.new_tensor(XKPERI),
                      fsk(swtrtd) * ss["texrat"])
    rscsd = torch.where(tgrd < c.tzero,
                        fsc(swtrtd * (1.0 - 0.51 * frozen)), fsc(swtrtd))
    swtrta = watr * ss["porsl"]
    froze2 = 0.85 * torch.clamp(0.25 * (c.tzero - tgbrd), max=1.0)
    ska = torch.where(tgbrd < c.tzero, sts.new_tensor(XKPERI),
                      fsk(swtrta) * ss["texrat"])
    rscsa = torch.where(tgbrd < c.tzero,
                        fsc(swtrta * (1.0 - 0.51 * froze2)), fsc(swtrta))
    depdiu = torch.sqrt(2.0 * skd / xnu)
    bcoef = xdtime * depdiu / (rscsd * skd)
    snowy = scrat > 0.001
    wtd = torch.exp(-torch.clamp(2.0 * scrat / depdiu, max=25.0))
    rscss = CSNW * rhosw
    sks = 7.0e-7 * CWS * rhosw
    bcoefs = torch.sqrt(2.0 * sks / xnu) / torch.clamp(rscss * sks,
                                                       min=1e-10)
    wtds = (1.0 - wtd) * scvk
    bcoefd = torch.sqrt(2.0 * skd / xnu) / (rscsd * skd)
    bcoef = torch.where(snowy,
                        xdtime * (wtds * bcoefs + (1.0 - wtds) * bcoefd),
                        bcoef)
    depdiu = torch.where(snowy,
                         wtds * torch.sqrt(2.0 * sks / xnu)
                         + (1.0 - wtds) * depdiu, depdiu)
    depann = torch.sqrt(2.0 * ska / xnua)
    snowy2 = scrat > 0.02
    wtax = torch.exp(-torch.clamp(2.0 * scrat / depann, max=25.0))
    wtas = (1.0 - wtax) * scvk
    depann = torch.where(snowy2,
                         wtas * torch.sqrt(2.0 * sks / xnua)
                         + (1.0 - wtas) * depann, depann)
    deprat = depann / torch.clamp(depdiu, min=1e-10)

    def fct1(x):
        return c.wlhf * 0.25 * 1.414 / x

    cc = torch.where((tgrd < c.tzero) & (tgrd > c.tzero - 4.0),
                     1.0 + torch.clamp(ssw - ss["frezu"], min=0.0)
                     * fct1(ss["depuv"] * 1e-3 * rscsd), one)
    fct2 = torch.where((tgbrd < c.tzero) & (tgbrd > c.tzero - 4.0),
                       torch.clamp(rsw - ss["freza"], min=0.0)
                       * fct1(ss["deprv"] * 1e-3 * rscsa), 0.0)
    fct2 = torch.where(ss["is_ice"], 1000.0 * fct2, fct2)
    rnet = swflx - sigf * (abswveg - flnet) \
        - (1.0 - sigf) * (lwflx - sigf * flneto)
    hs = rnet - fseng - fevpg * htvp
    bb = bcoef * hs + xdtime * tgbrd
    # snowmelt
    cder = bcoef * cgrnd
    sm = torch.where(
        sncv > 0.0,
        (bb + (cc - xdt2 + cder) * tgrd - (cc + xdt2 + cder) * c.tzero)
        / (bcoef * c.wlhf), 0.0)
    sm = torch.minimum(torch.clamp(sm, min=0.0), sncv / dtbat)
    bb = bb - bcoef * c.wlhf * sm
    # surface soil temperature update
    tbef = tgrd
    tg_new = (bb + (cc - xdt2 + cder) * tgrd) / (cc + xdt2 + cder)
    tg_new = torch.minimum(torch.maximum(tg_new, tbef - 10.0), tbef + 10.0)
    tinc = tg_new - tbef
    sent = sent + tinc * cgrnds
    evpr = evpr + tinc * cgrndl
    fevpg = fevpg + tinc * cgrndl
    tgrd = tg_new
    # subsoil temperature
    c31 = 0.5 * dtimea * (1.0 + deprat)
    c41 = dtimea * deprat
    tgb_perm = ((1.0 - c31 + fct2) * tgbrd + c41 * tgrd
                + dtimea * T3PERM) / (1.0 + c31 + fct2)
    c3t = 0.5 * dtimea * deprat
    c4t = dtimea * deprat
    tgb_norm = ((1.0 - c3t + fct2) * tgbrd + c4t * tgrd) \
        / (1.0 + c3t + fct2)
    tgbrd = torch.where(ss["is_tundra"] | ss["is_ice"], tgb_perm, tgb_norm)

    # ---- snow (mod_bats_bndry.F90:597-681) ----------------------------
    evaps = scvk * fevpg
    evapw = fevpg - evaps
    pw = torch.where(tm >= c.tzero, prcp * (1.0 - sigf), 0.0)
    psn = torch.where(tm >= c.tzero, 0.0, prcp * (1.0 - sigf))
    sold = sncv
    sncv = sncv + dtbat * (psn - evaps - sm) + sdrop
    gone = sncv < c.dlowval
    sncv = torch.where(gone, 0.0, sncv)
    snag = torch.where(gone, 0.0, snag)
    arg = 5.0e3 * (1.0 / c.tzero - 1.0 / torch.clamp(tgrd, min=100.0))
    age1 = torch.exp(torch.clamp(arg, max=10.0))
    age2 = torch.exp(torch.clamp(10.0 * arg, -25.0, 0.0))
    tage = age1 + age2 + 0.3
    dela = 1.0e-6 * dtbat * tage
    dels = 0.1 * torch.clamp(sncv - sold, min=0.0)
    snag_new = (snag + dela) * (1.0 - dels)
    snag = torch.where(sncv > 0.0,
                       torch.where(snag_new < c.dlowval, 0.0, snag_new),
                       snag)
    snag = torch.where(sncv > 800.0, 0.0, snag)

    # ---- water: 3-layer hydrology (mod_bats_bndry.F90:383-573) --------
    xkmxr = torch.where(tgbrd > c.tzero, ss["xkmx"], 0.0)
    permafrost = ss["is_tundra"] | ss["is_ice"]
    xkmx1 = torch.where(permafrost, 0.0, ss["xkmx"])
    xkmx2 = torch.where(permafrost, 0.0, sts.new_tensor(DRAIN))
    evmxr = ss["evmx0"] * xkmxr / ss["xkmx"]
    evmxt = ss["evmx0"] * xkmx1 / ss["xkmx"]
    b = ss["bsw"]
    bfac = watr ** (3.0 + ss["bfc"]) * watu ** (b - ss["bfc"] - 1.0)
    bfac2 = watt ** (2.0 + ss["bfc"]) * watr ** (b - ss["bfc"])
    wfluxc = evmxr * (ss["depuv"] / ss["deprv"]) ** 0.4 * bfac
    wflux1 = wfluxc * (watr - watu)
    wflux2 = evmxt * torch.sqrt(ss["depuv"] / ss["deprv"]) * bfac2 \
        * (watt - watr)
    b1 = b + 0.5
    b2 = b + 2.5
    b3 = 2.0 * b + 3.0
    rsubss = xkmxr * watr ** b1 * watu ** b2
    rsubsr = xkmx1 * watt ** b1 * watr ** b2
    rsubst = torch.clamp(xkmx2 * watt ** b3, min=0.0)
    bog = ss["is_bog"]
    rsubst = torch.where(bog, 0.0, rsubst)
    rsubss = torch.where(bog, 0.0, rsubss)
    rsubsr = torch.where(bog, 0.0, rsubsr)
    wflux1 = wflux1 - rsubss
    wflux2 = wflux2 - rsubsr
    gwatr = pw + sm + etrrun / dtbat - evapw
    wata = 0.5 * (watu + watr)
    srnof = torch.where(tgrd < c.tzero,
                        torch.clamp(wata, max=1.0)
                        * torch.clamp(gwatr, min=0.0),
                        torch.clamp(wata ** 4, max=1.0)
                        * torch.clamp(gwatr, min=0.0))
    irrig = ss["is_irrig"] & (watr < ss["relfc"])
    srnof = srnof + torch.where(
        irrig | bog,
        torch.clamp((rsw - ss["relfc"] * ss["gwmx1"]) / dtbat, max=0.0),
        0.0)
    srnof = torch.clamp(srnof, min=0.0)
    gwatr2 = gwatr - efpr * etr
    infil = torch.clamp(gwatr2 - srnof, min=0.0)
    ssw = ssw + dtbat * (infil + wflux1)
    ssw = ssw / (1.0 + dtbat * wfluxc / ss["gwmx0"])
    ssw = torch.maximum(ssw, ss["gwmx0"] * MINWRAT)
    rsw = rsw + dtbat * (infil + wflux2)
    rsw = torch.maximum(rsw, ss["gwmx1"] * MINWRAT)
    tsw = tsw + dtbat * (infil - rsubst)
    tsw = torch.maximum(tsw, ss["gwmx2"] * MINWRAT)
    # capacity overflow cascade
    dw0 = torch.clamp(ssw - ss["gwmx0"], min=0.0)
    ssw = ssw - dw0
    rsw = rsw + dw0
    dw1 = torch.clamp(rsw - ss["gwmx1"], min=0.0)
    rsw = rsw - dw1
    tsw = tsw + dw1
    tsw = torch.minimum(tsw, ss["gwmx2"])
    # wetness factor
    vakb2 = (1.0 - sigf) * vspda + sigf * (xxkb * uaf
                                           + (1.0 - xxkb) * vspda)
    wtg2c = (1.0 - sigf) * cdrx * vakb2
    rap = rhs * (CSOILC * uaf * sigf * (qgrd + delq - qs)
                 + wtg2c * (qgrd - qs))
    bfac_w = watr ** (3.0 + ss["bfc"]) \
        * watu ** (ss["bsw"] - ss["bfc"] - 1.0)
    est0 = ss["evmx0"] * bfac_w * watu
    gwet_new = torch.clamp(torch.clamp(est0, min=0.0)
                           / torch.clamp(rap, min=1.0e-14), max=1.0)
    gwet = scvk + gwet_new * (1.0 - scvk)

    drag = cdrx * vspda * rhs
    fact = torch.log(zh * 0.5) / torch.log(zh / ZLND)
    t2m = sts - (sts - tgrd) * fact
    q2m = qs - delq * fact

    m = lndmsk > 0.5
    new = (tgbrd, tlef, taf, ldew, sncv, snag, ssw, rsw, tsw, gwet)
    out_state = torch.stack([torch.where(m, v, bats_in[i])
                             for i, v in enumerate(new)])
    return BatsOut(
        sent=torch.where(m, sent, 0.0),
        evpr=torch.where(m, evpr, 0.0),
        drag=torch.where(m, drag, 0.0),
        tgrd=torch.where(m, tgrd, tgrd_in),
        bats=out_state,
        sigf=torch.where(m, sigf, 0.0),
        emiss=torch.where(m, emiss, 0.985),
        t2m=torch.where(m, t2m, sts), q2m=torch.where(m, q2m, qs))


def bats_albedo(czenith, tgbrd, ssw, sncv, snag, ss, lndmsk):
    """Two-band direct/diffuse land albedo (albedo,
    mod_bats_albedo.F90:77-228). Returns (swdiral, lwdiral, swdifal,
    lwdifal), zero over ocean (the caller blends)."""
    aseas = fseas_fn(tgbrd)
    lncl = ss["mfcv"] - ss["seasf"] * aseas
    scrat, wt, sigf, scvk, rhosw = _depth(sncv, snag, lncl, ss["rough"])
    czeta = torch.clamp(czenith, min=0.0)

    albs = ss["albvgs"]
    albl = ss["albvgl"]
    # bare soil albedo with moisture dependence
    wet = ssw / ss["depuv"]
    alwet = torch.minimum(torch.clamp(11.0 - 40.0 * wet, min=0.0) * 0.01,
                          ss["solour"])
    albg = ss["solour"] + alwet
    albgs, albgl = albg, 2.0 * albg
    albgsd, albgld = albgs, albgl
    albsd, albld = albs, albl
    # ice sheet
    ice = ss["is_ice"]
    albgs = torch.where(ice, 0.8, albgs)
    albgsd = torch.where(ice, 0.8, albgsd)
    albgl = torch.where(ice, 0.55, albgl)
    albgld = torch.where(ice, 0.55, albgld)
    # inland water / swamp classes 13-15
    water = ss["is_water_albedo"] & ~ice
    albg_w = 0.05 / (czeta + 0.15)
    albgs = torch.where(water, albg_w, albgs)
    albgsd = torch.where(water, albg_w, albgsd)
    albgl = torch.where(water, albg_w, albgl)
    albgld = torch.where(water, albg_w, albgld)
    # snow correction
    age = 1.0 - 1.0 / (1.0 + snag)
    dfalbs = SNAL0 * (1.0 - 0.2 * age)
    sl, sli = 2.0, 0.5
    cff = torch.clamp((1.0 + sli) / (1.0 + 2.0 * sl * czeta) - sli,
                      min=0.0)
    dralbs = dfalbs + 0.4 * cff * (1.0 - dfalbs)
    dfalbl = SNAL1 * (1.0 - 0.5 * age)
    dralbl = dfalbl + 0.4 * cff * (1.0 - dfalbl)
    snowy = sncv > 0.0
    vegsnow = snowy & (lncl > 0.001)
    albl = torch.where(vegsnow, (1.0 - wt) * albl + dralbl * wt, albl)
    albld = torch.where(vegsnow, (1.0 - wt) * albld + dfalbl * wt, albld)
    albs = torch.where(vegsnow, (1.0 - wt) * albs + dralbs * wt, albs)
    albsd = torch.where(vegsnow, (1.0 - wt) * albsd + dfalbs * wt, albsd)
    albgs = torch.where(snowy, (1.0 - scvk) * albgs + dralbs * scvk, albgs)
    albgl = torch.where(snowy, (1.0 - scvk) * albgl + dralbl * scvk, albgl)
    albgsd = torch.where(snowy, (1.0 - scvk) * albgsd + dfalbs * scvk,
                         albgsd)
    albgld = torch.where(snowy, (1.0 - scvk) * albgld + dfalbl * scvk,
                         albgld)
    swdiral = (1.0 - lncl) * albgs + lncl * albs
    lwdiral = (1.0 - lncl) * albgl + lncl * albl
    swdifal = (1.0 - lncl) * albgsd + lncl * albsd
    lwdifal = (1.0 - lncl) * albgld + lncl * albld
    m = lndmsk > 0.5
    return (torch.where(m, swdiral, 0.0), torch.where(m, lwdiral, 0.0),
            torch.where(m, swdifal, 0.0), torch.where(m, lwdifal, 0.0))
