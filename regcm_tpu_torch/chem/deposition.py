"""Aerosol dry deposition, gravitational settling and wet scavenging.

TPU re-derivations of ``Main/chemlib/mod_che_drydep.F90``
(aerodyresis :929, drydep_aero :363) and ``mod_che_wetdep.F90``
(wetdepa :649, blcld, cas), torch twin of
``regcm_tpu/chem/deposition.py``: the reference's per-(i)-slab column
loops over land-use categories (luc=1) are dense whole-grid algebra, the
`cvmgt` branches `torch.where`; the column sums of the wet-deposition
flux are added in level order (``level_sum``).

Land-use tables (Zhang et al. 2001 collection parameters mapped to
BATS classes) are the reference's published constants
(``Main/chemlib/mod_che_param.F90:82-131``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..dynamics.hydrostatic import level_sum
from ..utils import constants as c

BOLTZK = 1.3806504e-23
VONKAR = 0.4
STDPMB = 1013.25
# Sutherland viscosity + mean-free-path constants (mod_che_drydep:45-60)
A1, A2, A3 = 1.458e-6, 1.5, 110.4
C1, C2, C3, C4 = 6.54e-8, 1.818e-5, 1.013e5, 293.15
AA1, AA2, AA3 = 1.257, 0.4, 1.1

# Zhang 2001 parameters per BATS landuse class (mod_che_param.F90)
AEST = np.array([1.20, 1.20, 1.00, 1.10, 0.80, 0.60, 1.20, 50.00,
                 50.00, 1.20, 50.00, 50.00, 2.00, 100.00, 100.00,
                 1.30, 1.30, 0.80, 1.20, 2.00, 1.50, 1.50])
AGAM = np.array([0.54, 0.54, 0.56, 0.56, 0.56, 0.58, 0.54, 0.54,
                 0.54, 0.54, 0.54, 0.54, 0.54, 0.50, 0.50, 0.54,
                 0.54, 0.56, 0.54, 0.54, 0.56, 0.56])
ARYE = np.array([2.0, 2.0, 2.0, 2.0, 5.0, 5.0, 5.0, 0.0001, 0.0001,
                 2.0, 0.0001, 0.0001, 10.0, 0.0001, 0.0001, 10.0,
                 10.0, 5.0, 2.0, 10.0, 10.0, 10.0])
AST = np.array([3.0, 3.0, 2.0, 3.0, 8.0, 5.0, 2.0, 3.0, 0.0, 0.0,
                10.0, 0.0, 0.0, 10.0, 0.0, 0.0, 10.0, 5.0, 3.0, 10.0,
                10.0, 10.0])
# roughness length per class (crough, mod_che_param.F90:56-63)
CROUGH = np.array([0.1000, 0.0300, 1.0000, 1.0000, 1.0000, 1.0000,
                   0.3000, 0.0050, 0.0300, 0.1000, 0.0300, 0.0050,
                   0.1000, 0.0002, 0.0004, 0.2500, 0.1000, 1.0000,
                   0.5000, 0.3000, 2.0000, 1.0000])
# soil porosity per texture (cxmopor) + class→texture map (ciexsol)
CXMOPOR = np.array([0.33, 0.36, 0.39, 0.42, 0.45, 0.48, 0.51, 0.54,
                    0.57, 0.60, 0.63, 0.66])
CIEXSOL = np.array([6, 6, 6, 6, 7, 8, 6, 1, 6, 6, 5, 12, 6, 6, 6, 6,
                    5, 6, 6, 6, 12, 8])
CDEPUV = 100.0                    # mm (superficial soil-layer depth)



def _mx(a, b):
    """jnp.maximum of two tensors or a tensor and a number."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    return torch.maximum(a, b) if isinstance(b, torch.Tensor) \
        else torch.clamp(a, min=b)


def _mn(a, b):
    """jnp.minimum of two tensors or a tensor and a number."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    return torch.minimum(a, b) if isinstance(b, torch.Tensor) \
        else torch.clamp(a, max=b)


def _clip(a, lo, hi):
    """jnp.clip with number bounds (None: unbounded)."""
    return torch.clamp(a, min=lo, max=hi)


def aerodyresis(zeff, wind10, temp10, sutemp, rh10, srad, water):
    """Aerodynamic resistance + friction velocity above the canopy
    (aerodyresis, mod_che_drydep.F90:929-1105). Dense; `water` is the
    ivegcov==0 mask. Returns (ustar m/s, ra s/m)."""
    z10 = 10.0
    ww = _mx(wind10, 1.0)
    ptemp2 = temp10 + z10 * 0.0098

    # -- water branch (Garratt 1977 + Businger stability) --------------
    es = 6.108 * torch.exp(17.27 * (temp10 - c.tzero) / (temp10 - 35.86))
    vp = rh10 * es
    wvpm = c.ep2 * vp / (STDPMB - vp)
    vptemp = ptemp2 * (1.0 + 0.61 * wvpm)
    tsw = sutemp
    vps = 6.108 * torch.exp(17.27 * (tsw - c.tzero) / (tsw - 35.86))
    qs = c.ep2 * vps / (STDPMB - vps)
    tsv = tsw * (1.0 + 0.61 * qs)
    dthv = vptemp - tsv
    cun = 7.5e-4 + 6.7e-5 * ww
    mol_w = torch.where(torch.abs(dthv) > 1.0e-6,
                      vptemp * cun ** 1.5 * ww ** 2
                      / (5.096e-3 * torch.where(torch.abs(dthv) > 1e-6,
                                              dthv, 1e-6)),
                      9999.0)
    mol_w = torch.where((mol_w > 0.0) & (mol_w < 5.0), 5.0, mol_w)
    mol_w = torch.where((mol_w > -5.0) & (mol_w < 0.0), -5.0, mol_w)
    zdl = z10 / mol_w
    x = (1.0 - 15.0 * _mn(zdl, 0.0)) ** 0.25
    psiu_un = (2.0 * torch.log(0.5 * (1.0 + x))
               + torch.log(0.5 * (1.0 + x * x))
               - 2.0 * torch.atan(x) + 0.5 * np.pi)
    y = torch.sqrt(1.0 - 9.0 * _mn(zdl, 0.0))
    psit_un = 2.0 * 0.74 * torch.log((1.0 + y) / 2.0)
    psiu = torch.where(zdl < 0.0, psiu_un, -4.7 * zdl)
    psit = torch.where(zdl < 0.0, psit_un, psiu)
    z0water = 0.000002 * ww ** 2.5
    ustar_w = VONKAR * ww / (torch.log(z10 / z0water) - psiu)
    zz0_w = z0water

    # -- land branch (Louis 1979 bulk Richardson) ----------------------
    rib = c.egrav * z10 * (ptemp2 - sutemp) \
        / (sutemp * ww ** 2)
    rib = torch.where((srad > 0.0) & (rib > 0.0), 1.0e-15, rib)
    dtemp = ptemp2 - sutemp
    dtemp = torch.where(torch.abs(dtemp) < 1e-10,
                      torch.sign(dtemp + 1e-30) * 1e-10, dtemp)
    tbar = 0.5 * (ptemp2 + sutemp)
    zz0_l = _mx(zeff, 1e-6)
    ratioz = z10 / zz0_l
    logratio = torch.log(ratioz)
    asq = 0.16 / logratio ** 2
    aa = asq * 9.4 * torch.sqrt(ratioz)
    cm = 7.4 * aa
    ch = 5.3 * aa
    sq = torch.sqrt(torch.abs(rib))
    fm = torch.where(rib <= 0.0,
                   1.0 - 9.4 * rib / (1.0 + cm * sq),
                   1.0 / (1.0 + 4.7 * rib) ** 2)
    fh = torch.where(rib <= 0.0,
                   1.0 - 9.4 * rib / (1.0 + ch * sq), fm)
    ustarsq = asq * ww ** 2 * fm
    utstar = asq * ww * dtemp * fh / 0.74
    ustar_l = torch.sqrt(ustarsq)
    thstar_l = utstar / _mx(ustar_l, 1e-10)
    mol_l = tbar * ustarsq / (VONKAR * c.egrav
                              * torch.where(torch.abs(thstar_l) > 1e-20,
                                          thstar_l, 1e-20))

    ustar = torch.where(water, ustar_w, ustar_l)
    mol = torch.where(water, mol_w, mol_l)
    zz0 = torch.where(water, zz0_w, zz0_l)
    kui = 1.0 / (VONKAR * _mx(ustar, 1e-10))
    zl = z10 / mol
    ra_stable = kui * (0.74 * torch.log(z10 / zz0) + 4.7 * zl)
    ra_unst = kui * 0.74 * (
        torch.log(z10 / zz0)
        - 2.0 * torch.log((1.0 + torch.sqrt(1.0 - 9.0
                                        * _mn(zl, 0.0)))
                        * 0.5))
    ra = torch.where(zl >= 0.0, ra_stable, ra_unst)
    return ustar, _clip(ra, 0.99, 999.9)


class DrydepOut(NamedTuple):
    pdepv: torch.Tensor      # (nbin, kz, iy, jx) settling velocity (m/s)
    ddepv: torch.Tensor      # (nbin, iy, jx) surface dry-dep velocity


def drydep_aero(bin_diam, rhop, throw, roarow, ph, ivegcov,
                ustar, ra) -> DrydepOut:
    """Settling + surface deposition velocities for an aerosol bin set
    (drydep_aero, mod_che_drydep.F90:363-575). bin_diam effective
    diameters (µm); throw/roarow/ph (kz, iy, jx) T/ρ/p."""
    nbin = bin_diam.shape[0]
    avesize = (bin_diam * 0.5) * 1.0e-6               # radius m
    az = avesize[:, None, None, None]
    amu = (A1 * throw ** A2) / (throw + A3)
    amfp = C1 * (amu / C2) * (C3 / ph) * torch.sqrt(throw / C4)
    prii = 2.0 / 9.0 * c.egrav / amu
    priiv = prii * (rhop[:, None, None, None] - roarow[None])
    cfac = 1.0 + amfp[None] / az * (AA1 + AA2 * torch.exp(-AA3 * az
                                                        / amfp[None]))
    taurel = priiv * az ** 2 * cfac * c.regrav
    pdepv = taurel * c.egrav                          # (nbin,kz,iy,jx)

    kz = throw.shape[0]
    # surface-layer Schmidt number per bin
    anu = amu[kz - 1] / roarow[kz - 1]
    amob = 6.0 * np.pi * amu[kz - 1][None] * az[:, 0] / cfac[:, kz - 1]
    pdiff = BOLTZK * throw[kz - 1][None] / amob
    schm = anu[None] / pdiff                          # (nbin, iy, jx)

    # landuse lookup (ivegcov==0 → water class 14, >20 → 20)
    lcov = torch.where(ivegcov == 0, 14,
                     _mn(ivegcov, 20)) - 1    # 0-based
    tab = lambda a: torch.as_tensor(a, dtype=throw.dtype,
                                    device=throw.device)[lcov]
    ast, agam, aest, arye = tab(AST), tab(AGAM), tab(AEST), tab(ARYE)

    tau_s = taurel[:, kz - 1]
    st_veg = tau_s * ustar[None] * c.regrav / _mx(ast, 1e-10)
    st_smooth = tau_s * ustar[None] ** 2 / anu[None]
    st = torch.where(ast[None] > 0.0, st_veg, st_smooth)
    eb = torch.where(ast[None] > 0.0, schm ** (-agam[None]),
                   schm ** (-0.5))
    eim = _clip((st / (st + aest[None])) ** 2, 1.0e-8, 0.6)
    ein = torch.where(arye[None] > 0.001,
                    _clip(2.0 * ((1000.0 * avesize[:, None, None])
                                    / _mx(arye[None], 1e-10))
                             ** 1.5, 1.0e-8, 0.5),
                    1.0e-8)
    r1 = _mx(torch.exp(-torch.sqrt(st)), 0.4)
    rs = 3.0 * ustar[None] * (eb + eim + ein) * r1
    rs = 1.0 / _clip(rs, 1.0e-5, 1.0e5)
    ddepv = 1.0 / (ra[None] + rs) + pdepv[:, kz - 1]
    return DrydepOut(pdepv=pdepv, ddepv=ddepv)


def settling_tend(chib, psb, pdepv, ddepv, dzq, rhob, twt1, twt2, dt):
    """Settling + surface dry-deposition tendency on the coupled tracer
    field (drydep_aero tendency block, mod_che_drydep.F90:684-775,
    idynamic 1/2 branch; exponential form for stability).

    chib (ntr, kz, iy, jx) coupled p*·chi; returns (chiten coupled /s,
    drydep flux kg/m²/s per tracer)."""
    ntr, kz = chib.shape[0], chib.shape[1]
    rdt = 1.0 / dt
    mintr = 1.0e-30
    # interface settling-flux proxies: our wk[j] (j=0..kz-2) is the
    # interface between layers j and j+1 (= reference wk(k) with
    # 1-based k=j+2)
    # twt1/twt2 arrive (kz, 1, 1) from the core
    wk = torch.where(chib[:, :-1] > mintr,
                   (twt1[None, 1:] * chib[:, 1:]
                    + twt2[None, 1:] * chib[:, :-1]) * rdt,
                   0.0)                                    # (ntr,kz-1,…)
    expo = lambda v, dz: 1.0 - torch.exp(-v / dz[None] * dt)
    # interior layers kk=1..kz-2 (ref k=2..kz-1): both exponentials use
    # the LAYER thickness dzq(kk); settling velocities at kk+1 / kk
    st_int = (wk[:, 1:] * expo(pdepv[:, 2:kz], dzq[1:kz - 1])
              - wk[:, :-1] * expo(pdepv[:, 1:kz - 1], dzq[1:kz - 1]))
    # surface layer kz-1: deposition with ddepv minus incoming settling
    edep = 1.0 - torch.exp(-ddepv / dzq[kz - 1][None] * dt)
    st_sfc = (_mx(chib[:, kz - 1], 0.0) * rdt * edep
              - wk[:, kz - 2] * expo(pdepv[:, kz - 1:kz],
                                     dzq[kz - 1:kz])[:, 0])
    chiten = torch.cat([torch.zeros_like(chib[:, :1]), -st_int,
                        -st_sfc[:, None]], dim=1)
    # dry-deposition mass flux diagnostic (kg/m²/s, decoupled)
    ddflx = (chib[:, kz - 1] - st_sfc * dt * 0.5) / psb[None] \
        * rhob[kz - 1][None] * ddepv
    return chiten, ddflx


def wetdep_tend(chib, psb, t, wl, fracloud, fracum, remrat, kcumtop,
                kcumbot, strappt, convppt_sfc, pdepv, bin_diam, rhop,
                sol, dzq, rhob, dt, ichremlsc=1, ichremcvc=1,
                remcum=1.0e-3):
    """Wet removal: large-scale rainout, convective rainout, and
    below-cloud washout (wetdepa + blcld + cas,
    mod_che_wetdep.F90:649-1157).

    chib coupled (ntr, kz, iy, jx); t K; wl cloud water g/m³;
    remrat large-scale removal rate (1/s); strappt below-cloud
    large-scale precip rate (mm/s, 3-D); convppt_sfc surface
    convective rate (mm/s, 2-D); kcumtop/bot 0-based cumulus bounds
    (kcumtop<0 → no cumulus). Returns (chiten coupled, wet-dep flux
    kg/m²/s)."""
    ntr, kz, iy, jx = chib.shape
    clmin = 0.01
    solv = sol[:, None, None, None]

    chiten = torch.zeros_like(chib)
    # --- large-scale rainout ------------------------------------------
    if ichremlsc:
        arg = torch.where(fracloud > 1e-10, remrat / _mx(
            fracloud, 1e-10) * dt, 0.0)
        efac = torch.where(arg < 25.0, torch.exp(-_mn(arg, 25.0))
                         - 1.0, -1.0)
        wetrem = torch.where(
            (wl[None] > clmin) & (remrat[None] > 0.0)
            & (fracloud[None] > 0.0),
            fracloud[None] * solv * chib * efac[None], 0.0)
        chiten = chiten + wetrem / dt
    else:
        wetrem = torch.zeros_like(chib)

    # --- convective rainout (in-cumulus column) -----------------------
    if ichremcvc:
        karr = torch.arange(kz, device=chib.device)[None, :, None, None]
        incum = ((karr >= _mx(kcumtop, 0)[None, None])
                 & (kcumtop[None, None] >= 0))
        wetrem_cvc = torch.where(
            incum, fracum[None] * solv * chib
            * (math.exp(-remcum * dt) - 1.0), 0.0)
        chiten = chiten + wetrem_cvc / dt
    else:
        wetrem_cvc = torch.zeros_like(chib)

    # --- below-cloud washout ------------------------------------------
    # pseudo-3d convective precip profile: ramp 0→sfc rate over the
    # upper half of the cumulus column (wetdepa :820-840)
    karr = torch.arange(kz, device=chib.device)[:, None, None]
    nk = _mx(kcumbot - kcumtop + 1, 1)
    nkh = _mx(nk // 2, 1)
    npos = karr - _mx(kcumtop, 0) + 1
    frac_prof = _clip(npos.to(chib.dtype) / nkh.to(chib.dtype)[None],
                      0.0, 1.0)
    totppt = torch.where((kcumtop[None] >= 0) & (npos > 0),
                       frac_prof * convppt_sfc[None], 0.0)
    if ichremlsc:
        totppt = totppt + strappt
    wetdep = _blcld(bin_diam, rhop, t, rhob, totppt, pdepv)
    wtend = chib * (1.0 - torch.exp(-wetdep * dt)) / dt
    wtend = torch.where(totppt[None] > 1e-20, wtend, 0.0)
    chiten = chiten - wtend

    # wet-deposition surface flux (kg/m²/s, positive down)
    wflx = level_sum(torch.movedim((-(wetrem + wetrem_cvc) / dt + wtend)
                                   * dzq[None] * rhob[None], 1, 0)) \
        / psb[None]
    return chiten, wflx


def _blcld(bin_diam, rhop, t, rho, totppt, pdepv):
    """Below-cloud scavenging rate (s⁻¹): collection efficiency `cas`
    + rain/snow washout formulas (blcld, mod_che_wetdep.F90)."""
    rhsize = (bin_diam * 0.5 * 1.0e-6)[:, None, None, None]
    rhopv = rhop[:, None, None, None]
    tl = t - c.tzero
    amu = (A1 * t ** A2) / (t + A3)
    anu = amu / rho

    # collector properties by phase
    rrm_rain = 0.35 * (_mx(totppt, 0.0) * 3600.0) ** 0.25 \
        * 1.0e-3
    vpr = torch.where(tl > 0.0, 3.0,
                    torch.where(tl >= -8.0, 0.50,
                              torch.where(tl >= -25.0, t.new_tensor(0.57), 1.80)))
    rrm = torch.where(tl > 0.0, _mx(rrm_rain, 1e-6),
                    torch.where(tl >= -8.0, 10.0e-6,
                              torch.where(tl >= -25.0, t.new_tensor(100.0e-6),
                                        1000.0e-6)))
    alpha = torch.where(tl >= -8.0, 1.0,
                      torch.where(tl >= -25.0, t.new_tensor(0.5), 2.0 / 3.0))

    # particle Schmidt number (with Cunningham slip); p from ρ·R·T
    pres = rho * c.rgas * t
    amfp = C1 * (amu / C2) * (C3 / pres) * torch.sqrt(t / C4)
    cfaca = 1.0 + amfp[None] / rhsize * (
        AA1 + AA2 * torch.exp(-AA3 * rhsize / amfp[None]))
    amob = 6.0 * np.pi * amu[None] * rhsize / cfaca
    pdiff = BOLTZK * t[None] / amob
    schm = anu[None] / pdiff

    re = rrm * vpr * rho / amu
    st = 2.0 * pdepv * c.regrav * (vpr[None] - pdepv) \
        / (2.0 * rrm[None])
    rr = rhsize / rrm[None]
    amuw = 1.002e-3
    vr = amuw / amu
    sstar = (1.2 + (1.0 / 12.0) * torch.log(1.0 + re)) \
        / (1.0 + torch.log(1.0 + re))
    colimp = torch.where(
        st > sstar[None],
        _clip((st - sstar[None])
                 / _mx(st - sstar[None] + 2.0 / 3.0, 1e-10),
                 0.0, None) ** 1.5
        * torch.sqrt(1000.0 / rhopv), 0.0)
    colef_rain = (4.0 / (re[None] * schm)
                  * (1.0 + 0.4 * torch.sqrt(re[None]) * schm ** (1.0 / 3.0)
                     + 0.16 * torch.sqrt(re[None] * schm))
                  + 4.0 * rr * (1.0 / vr[None]
                                + (1.0 + 2.0 * torch.sqrt(re[None])) * rr)
                  + colimp)
    colef_snow = ((1.0 / schm) ** alpha[None]
                  + (1.0 - torch.exp(-(1.0 + torch.sqrt(re[None]))
                                   * rr ** 2)) + colimp)
    colef = torch.where(tl[None] > 0.0, colef_rain, colef_snow)
    colef = _clip(colef, 0.0, 1.0)
    colef = torch.where(totppt[None] > 1e-15, colef, 0.0)

    dm = torch.where(tl > 0.0, _mx(rrm_rain, 1e-6),
                   torch.where(tl >= -8.0, 3.8e-5,
                             torch.where(tl >= -25.0, t.new_tensor(2.7e-5), 1.4e-4)))
    bc = torch.where(tl > 0.0, t.new_tensor(0.5), 0.8)
    wdep = bc[None] * totppt[None] * 1.0e-3 * colef / dm[None]
    return torch.where(totppt[None] > 1e-20, wdep, 0.0)
