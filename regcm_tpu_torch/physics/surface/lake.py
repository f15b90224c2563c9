"""Hostetler 1-D lake model (lakemod=1), torch twin of
``regcm_tpu/physics/surface/lake.py`` (``Main/ocnlib/mod_ocn_lake.F90``,
Hostetler et al. 1991-95, Henderson-Sellers 1985 eddy diffusion).

Every grid cell carries a 1 m-resolution water temperature profile
``tlak`` (``nlak`` layers, its depth from the DOMAIN lake-depth field),
the ice thickness and snow cover, masked by ``lakmsk``; the lake points
return the lake surface temperature and fluxes (``lakedrv`` :203-367).
The convective mixer (``lakemixer`` :632-669) is a loop down the
profile on (iy, jx) planes, in the reference's cascade order; the
ice-surface secant solve (``lakeice`` :740-757) runs its 10 iterations
masked. ``init_lake`` is a numpy copy of the JAX package's. Layer 0 is
``SURF`` = 1 m thick, every other layer ``DZ`` = 1 m.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ...utils import constants as c
from ...utils.thermo import pfqsat

SURF = 1.0          # surface layer thickness (m) (:41)
DZ = 1.0            # grid spacing (m) (:43)
ICEMINH = 0.01      # minimum ice thickness (m) (Share/mod_constants)
HREF = 2.0 * ICEMINH
STEEPF = 1.0
ZLND = 0.01
ZOCE = 0.00023
ZSNO = 0.00040
WTUR = 0.1
AAREA = 0.02        # lead fraction (mod_constants aarea)
AGE3 = 0.3          # dirt/soot snow-age term (BATS age3)
CPW = 4186.0        # specific heat of water (J/kg/K)
EMSW = 0.97         # water emissivity
HDMW = 1.39e-7      # molecular diffusion of heat in water (m2/s)
# lakeice constants (:679-705)
ISURF = 0.6
LAMI1, LAMI2 = 1.5, 20.0
LAMS1, LAMS2 = 6.0, 20.0
KICE, KSNOW = 2.3, 0.31
QW = 1.389
LFUS = 334.0e3
CDICE = 0.001
RHOSNOW = 330.0     # rhosnow (kg/m3)
RHOICE = 917.0
RHOSNOWP = 0.10     # rhosnowp used in snow melt (Mg units in ref)
SLAKE_TROP, BLAKE_TROP = 26.0, 22.0


class LakeOut(NamedTuple):
    tlak: torch.Tensor      # (nlak, iy, jx) water T profile (°C)
    lakhi: torch.Tensor     # ice thickness state hi (m)
    lakice: torch.Tensor    # average ice (aveice, m; 0 = ice free)
    laksnow: torch.Tensor   # snow cover (mm w.e.)
    laksnag: torch.Tensor   # snow age
    tg: torch.Tensor        # lake surface temperature (K)
    sent: torch.Tensor      # sensible heat flux (W/m2, + upward)
    evpr: torch.Tensor      # evaporation (kg/m2/s)
    drag: torch.Tensor      # rho·Cd·V


def lake_layers(physics) -> int:
    """Lake profile depth in the state: ``lake_ndpmax`` 1 m layers (100
    unless set) with the Hostetler model on (``physics.lakemod == 1``),
    else one dummy layer."""
    if physics.lakemod == 1:
        return int(physics.extras.get("lake_ndpmax", 100))
    return 1


def init_lake(dhlake: np.ndarray, xlat: np.ndarray, tg: np.ndarray,
              nlak: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Initial profile/eta/depth-index (initlake, :96-201). Returns
    (tlak(nlak,iy,jx) °C, eta(iy,jx), idep(iy,jx) int)."""
    idep = np.clip(np.maximum(2.0, np.minimum(dhlake, float(nlak)))
                   / DZ, 2, nlak).astype(np.int32)
    eta = np.where(idep < 5, -1.20,
                   np.where(idep < 10, -0.80,
                            np.where(idep < 40, -0.60,
                                     np.where(idep < 100, -0.40,
                                              -0.20))))
    iy, jx = dhlake.shape
    tlak = np.zeros((nlak, iy, jx))
    k = np.arange(nlak)[:, None, None]
    # extratropical: start near ground T, -0.1 °C per layer below 2
    t1 = np.clip(tg - c.tzero + 1.0, 4.0, 20.0)
    tex = np.clip(t1[None] - 0.1 * np.maximum(k - 1, 0), 4.0, 20.0)
    # tropical: warm surface, thermocline 20-40 m (:170-194)
    ttr = np.where(k <= 19, SLAKE_TROP,
                   np.where(k <= 38,
                            SLAKE_TROP - (k - 19) / 20.0
                            * (SLAKE_TROP - BLAKE_TROP), BLAKE_TROP))
    tlak = np.where(np.abs(xlat)[None] > 25.0, tex,
                    np.broadcast_to(ttr, (nlak, iy, jx)))
    return tlak, eta, idep


def _density(t):
    """Water density (°C input; :528)."""
    return 1000.0 * (1.0 - 1.9549e-5 * torch.abs(t - 4.0) ** 1.68)


def _lakeeddy(karr, dtlake, u2, xl, tprof, kmask):
    """Eddy diffusivity profile (lakeeddy, :506-592)."""
    demin = HDMW
    demax = 0.99 * 0.50 * DZ * DZ / dtlake
    dnsty = _density(tprof)
    ks = torch.where(torch.abs(xl) > 25.0,
                     6.6 * torch.sqrt(torch.abs(torch.sin(xl * c.degrad)))
                     * torch.clamp(u2, min=0.01) ** (-1.84), 0.001)
    zmax = torch.ceil(SURF + 40.0 / (c.vonkar * ks))
    ws = 0.0012 * u2
    z = SURF + karr * DZ                       # depth of layer k's bottom
    dn_dn = torch.cat([dnsty[1:], dnsty[-1:]], dim=0)
    dpdz = (dn_dn - dnsty) / torch.where(karr == 0, SURF, torch.full_like(karr, DZ))
    n2 = (dpdz / dnsty) * c.egrav
    rad = torch.clamp(
        1.0 + 40.0 * n2 * ((c.vonkar * z)
                           / (ws * torch.exp(-ks * z))) ** 2, min=0.0)
    ri = (-1.0 + torch.sqrt(rad)) / 20.0
    de = demin + c.vonkar * ws * z * torch.exp(-ks * z) \
        / (1.0 + 37.0 * ri ** 2)
    de = torch.where((z >= zmax) | (ks * z > 12.0)
                     | (torch.abs(n2) < c.dlowval), demin, de)
    de = torch.clamp(de, demin, demax)
    de = torch.where(kmask, de, demin)
    return de, dnsty


def _laketemp(karr, dtlake, fsw, flw, qe, qh, eta, tprof, de, dnsty,
              kmask, kbot):
    """Heat transfer update (laketemp, :594-630)."""
    # shortwave absorbed between the layer tops (Beer's law)
    ztop = torch.where(karr == 0, 0.0, SURF + (karr - 1) * DZ)
    zbot = torch.where(karr == 0, SURF, SURF + karr * DZ)
    thick = torch.where(karr == 0, SURF, torch.full_like(karr, DZ))
    ez = torch.exp(eta[None] * ztop)
    sw = fsw[None] * (ez - torch.exp(eta[None] * zbot)) \
        / (thick * dnsty * CPW)
    # the surface layer takes the non-penetrative fluxes too
    dt1 = torch.cat([sw[:1] + ((flw + qe + qh)
                               / (SURF * dnsty[0] * CPW))[None], sw[1:]])
    # the bottom layer absorbs all the remaining SW
    swbot = fsw * torch.gather(ez.expand_as(tprof), 0, kbot[None])[0]
    dnb = torch.gather(dnsty, 0, kbot[None])[0]
    atbot = karr == kbot[None]
    dt1 = dt1 + torch.where(atbot, (swbot / (DZ * dnb * CPW))[None] - sw,
                            0.0)
    # diffusion
    t_up = torch.cat([tprof[:1], tprof[:-1]], dim=0)
    t_dn = torch.cat([tprof[1:], tprof[-1:]], dim=0)
    de_up = torch.cat([de[:1], de[:-1]], dim=0)
    flux_up = de_up * (t_up - tprof)
    flux_dn = de * (tprof - t_dn)
    dt2 = (flux_up - flux_dn) / DZ
    dt2 = torch.where(karr == 0, -de[0:1] * (tprof[0:1] - tprof[1:2]) / SURF,
                      dt2)
    dt2 = torch.where(atbot, de_up * (t_up - tprof) / DZ, dt2)
    tnew = tprof + (dt1 + dt2) * dtlake
    return torch.where(kmask, tnew, tprof)


def _lakemixer(tprof, kmask, kbot):
    """Convective mixing cascade (lakemixer, :632-669): down the profile,
    any statically unstable pair averages its 3-layer window. A loop on
    (iy, jx) planes; layer k's window holds layers k-1, k, k+1."""
    nlak = tprof.shape[0]
    vol = [SURF] + [DZ] * (nlak - 1)
    tt = list(tprof.unbind(0))
    for k in range(1, nlak - 1):
        active = (_density(tt[k]) > _density(tt[k + 1])) & (k + 1 <= kbot)
        wsum = vol[k - 1] + vol[k] + vol[k + 1]
        tav = (tt[k - 1] * vol[k - 1] + tt[k] * vol[k]
               + tt[k + 1] * vol[k + 1]) / wsum
        for j in (k - 1, k, k + 1):
            tt[j] = torch.where(active, tav, tt[j])
    return torch.where(kmask, torch.stack(tt), tprof)


def _eomb(x):
    """Vapour pressure over water (mb) from T in °C (:807-814)."""
    tr1 = 1.0 - c.tboil / (x + c.tzero)
    return c.stdpmb * torch.exp(13.3185 * tr1 - 1.976 * tr1 ** 2
                                - 0.6445 * tr1 ** 3 - 0.1299 * tr1 ** 4)


def _lakeice(dtx, fsw, ld, tac, u2, ea, hs0, hi0, aveice0, prec, ps,
             tprof, dens):
    """Ice and snow growth and the surface temperature (lakeice,
    :671-796); hs, hi and aveice in m, prec in mm, ps in Pa. Returns
    (hs, hi, aveice, evl, tprof)."""
    # snowfall and the Patterson-Hamblin snow-to-ice conversion
    snowing = (tac <= 0.0) & (aveice0 > 0.0)
    hs = torch.where(snowing, hs0 + prec * 1e-2, hs0)
    ds = hi0 * (c.rhoh2o - RHOICE) / RHOSNOW
    conv = torch.clamp(hs - ds, min=0.0)
    hi = hi0 + torch.where(snowing, conv, 0.0)
    hs = torch.where(snowing, hs - conv, hs)
    hs = torch.where(hs < c.dlowval, 0.0, hs)

    t0 = tprof[0]
    tf = 0.0
    khat = (KICE * hs + KSNOW * hi) / (KICE * KSNOW)
    theta = CPW * dens * CDICE * u2
    psi = c.wlhv * dens * CDICE * u2 * c.ep2 / (ps * 1e-2)
    evl = psi * (_eomb(t0) - ea) / (c.wlhv * dens)
    # penetrating radiation (:734-739, with the reference's literal
    # second-band expression)
    qpen = fsw * 0.7 * ((1.0 - torch.exp(-LAMS1 * hs)) / (KSNOW * LAMS1)
                        + torch.exp(-LAMS1 * hs)
                        * (1.0 - torch.exp(-LAMI1 * hi))
                        / (KICE * LAMI1)) \
        + fsw * 0.3 * ((1.0 - np.exp(-LAMS2)) / (KSNOW * LAMS2)
                       + (-LAMS2 * hs) * (1.0 - torch.exp(-LAMI2 * hi))
                       / (KICE * LAMI2))

    def f(x):
        return (-ld + EMSW * c.sigm * (x + c.tzero) ** 4
                + psi * (_eomb(x) - ea) + theta * (x - tac) - fsw) \
            - 1.0 / khat * (qpen + tf - x)

    # masked secant iteration (maxiter=10)
    t1 = torch.full_like(t0, -50.0)
    done = torch.zeros_like(t0, dtype=torch.bool)
    t2 = t1
    ta, tb_, fa, fb = t0, t1, f(t0), f(t1)
    for _ in range(10):
        dfb = fb - fa
        t2n = tb_ - (tb_ - ta) * fb / torch.where(torch.abs(dfb) < 1e-12,
                                                  1e-12, dfb)
        stop = ((t2n - tb_) / torch.where(torch.abs(tb_) < 1e-6, 1e-6, tb_)
                < 0.001) | (t2n > 0.0)
        t2 = torch.where(done, t2, t2n)
        done = done | stop
        ta = torch.where(done, ta, tb_)
        fa = torch.where(done, fa, fb)
        tb_ = torch.where(done, tb_, t2n)
        fb = torch.where(done, fb, f(t2n))
    t0n = t2

    melt_flux = (-ld + EMSW * c.sigm * (tf + c.tzero) ** 4
                 + psi * (_eomb(torch.zeros_like(t0)) - ea)
                 + theta * (tf - tac) - fsw) \
        - 1.0 / khat * (tf - t0n + qpen)
    warm = t0n >= tf
    # melt the snow first (ds ≤ 0), then the ice
    ds_m = torch.clamp(dtx * melt_flux / (RHOSNOWP * LFUS), max=0.0)
    hs_warm = torch.clamp(hs + ds_m * 10.0, min=0.0)
    di_m = torch.clamp(dtx * melt_flux / (RHOICE * LFUS), max=0.0)
    hi_warm = hi + torch.where((hs_warm < c.dlowval) & (aveice0 > 0.0),
                               di_m, 0.0)
    # freezing growth
    q0 = -ld + EMSW * c.sigm * (t0n + c.tzero) ** 4 \
        + psi * (_eomb(t0n) - ea) + theta * (t0n - tac) - fsw
    qpen2 = fsw * 0.7 * (1.0 - torch.exp(-(LAMS1 * hs + LAMI1 * hi))) \
        + fsw * 0.3 * (1.0 - torch.exp(-(LAMS2 * hs + LAMI2 * hi)))
    di_f = dtx * (q0 - QW - qpen2) / (RHOICE * LFUS)
    hi_cold = hi + di_f
    hs = torch.where(warm, hs_warm, hs)
    hi = torch.where(warm, hi_warm, hi_cold)

    gone = hi <= ICEMINH
    aveice = torch.where(gone, 0.0, hi)
    hi = torch.where(gone, ICEMINH, hi)
    hs = torch.where(gone, 0.0, hs)
    tsfc = torch.where(gone, (hi * t0n + (ISURF - hi) * tprof[1]) / ISURF,
                       torch.clamp(t0n, max=0.0))
    return hs, hi, aveice, evl, torch.cat([tsfc[None], tprof[1:]])


def _bulk_drag(cdrn, br):
    """BATS stability-corrected drag coefficient with its floor."""
    cdr = torch.where(br < 0.0,
                      cdrn * (1.0 + 24.5 * torch.sqrt(cdrn * torch.abs(br))),
                      cdrn / (1.0 + 11.5 * br))
    return torch.maximum(cdr, torch.clamp(0.25 * cdrn, min=6.0e-4))


def lakedrv(tatm, qv, usw, vsw, za, rswf, rlwf, prcp, sent_in, evpr_in,
            rhox, sfps, tlak, lakhi, lakice, laksnow, laksnag, tg_in,
            eta, idep, lakmsk, xlat, dtlake):
    """One lake step over the whole grid (lakedrv, :203-367).

    rswf absorbed SW at the surface (W/m2, down +); rlwf net downward LW
    (W/m2); sent_in/evpr_in the previous step's sensible flux (+up) and
    evaporation, which feed the water heat budget; sfps in Pa. Points
    off the lake pass through unchanged."""
    nlak = tlak.shape[0]
    # layer numbers in the profile's dtype, as depths are formed from them
    karr = torch.arange(nlak, device=tlak.device,
                        dtype=tlak.dtype)[:, None, None]
    kbot = idep.to(torch.int64) - 1
    kmask = karr <= kbot[None]

    tc = tatm - c.tzero
    vl = torch.sqrt(usw ** 2 + vsw ** 2)
    fswx = rswf
    # rlwf is the NET DOWNWARD longwave (the suite's convention); the
    # reference passes flwx = −rlwf with its net-upward storage
    flwx = rlwf
    prec = prcp * dtlake
    hsen = -sent_in
    qe = -evpr_in * c.wlhv

    # 2 m wind from the log profile (:446)
    u2 = torch.clamp(vl * np.log(2.0 / 0.001)
                     / torch.log(torch.clamp(za, min=2.5) / 0.001), min=0.5)

    openwater = (lakice < ICEMINH) & (tlak[0] > -0.001)

    # open water: eddy diffusion, temperature, mixing
    de, dnsty = _lakeeddy(karr, dtlake, u2, xlat, tlak, kmask)
    t_open = _laketemp(karr, dtlake, fswx, flwx, qe, hsen, eta, tlak, de,
                       dnsty, kmask, kbot)
    t_open = _lakemixer(t_open, kmask, kbot)

    # ice
    ea = qv * 88.0 / (c.ep2 + 0.378 * qv)
    hs, hi, aveice, ev_new, t_ice = _lakeice(
        dtlake, fswx, rlwf + EMSW * c.sigm * (tlak[0] + c.tzero) ** 4,
        tc, u2, ea, laksnow * 1e-2, lakhi, lakice, prec, sfps, tlak,
        rhox)
    t_ice = _lakemixer(t_ice, kmask, kbot)

    tlak_new = torch.where(openwater[None], t_open, t_ice)
    hi_new = torch.where(openwater, ICEMINH, hi)
    ice_new = torch.where(openwater, 0.0, aveice)
    snow_new = torch.where(openwater, 0.0, hs * 1e2)

    tgl = tlak_new[0] + c.tzero

    # surface fluxes from the new lake temperature
    qs = qv / (1.0 + qv)
    qgrd_mr = pfqsat(tgl, sfps)
    qgrd = qgrd_mr / (1.0 + qgrd_mr)
    delt = tatm - tgl
    delq = qs - qgrd
    icefree = ice_new <= ICEMINH

    # ice-free: BATS bulk over the water roughness (:272-288)
    ribd = usw ** 2 + vsw ** 2 + WTUR ** 2
    vspda = torch.sqrt(ribd)
    cdrn_w = (c.vonkar / torch.log(za / ZOCE)) ** 2
    br = za * c.egrav * (delt / tatm) / ribd
    drag_w = _bulk_drag(cdrn_w, br) * vspda * rhox
    evpr_w = -drag_w * delq
    sent_w = -drag_w * c.cpd * delt

    # iced: snow-age dependent drag and the lead fraction (:289-351)
    sold = laksnow
    arg = 5.0e3 * (1.0 / c.tzero - 1.0 / torch.clamp(tgl, min=200.0))
    age1 = torch.exp(arg)
    age2 = torch.exp(torch.clamp(10.0 * arg, max=0.0))
    age = age1 + age2 + AGE3
    dela = 1.0e-6 * dtlake * age
    dels = 0.1 * torch.clamp(snow_new - sold, min=0.0)
    snag = (laksnag + dela) * (1.0 - dels)
    snag = torch.where((snow_new < c.dlowval) | (snow_new > 800.0), 0.0,
                       snag)
    cdrn_i = (c.vonkar / torch.log(za / ZLND)) ** 2
    u1 = torch.where(delt < 0.0,
                     WTUR + 2.0 * torch.sqrt(-torch.clamp(delt, max=0.0)),
                     WTUR)
    ribd_i = usw ** 2 + vsw ** 2 + u1 ** 2
    vspda_i = torch.sqrt(ribd_i)
    br_i = za * c.egrav * (delt / tatm) / ribd_i
    cdr = _bulk_drag(cdrn_i, br_i)
    cdrn_s = (c.vonkar / torch.log(za / ZSNO)) ** 2
    ribl = (1.0 - 271.5 / tatm) * za * c.egrav / ribd_i
    clead = torch.where(ribl < 0.0,
                        cdrn_s * (1.0 + 24.5
                                  * torch.sqrt(cdrn_s * torch.abs(ribl))),
                        cdrn_s / (1.0 + 11.5 * br_i))
    cdrx_i = (1.0 - AAREA) * cdr + AAREA * clead
    drag_i = cdrx_i * vspda_i * rhox
    qice = 3.3e-3 * c.stdp / sfps
    qgrnd = ((1.0 - AAREA) * cdr * qgrd + AAREA * clead * qice) / cdrx_i
    tgb = ((1.0 - AAREA) * cdr * tgl
           + AAREA * clead * (c.tzero - 1.8)) / cdrx_i
    delt_i = tatm - tgb
    delq_i = qs - qgrnd
    evpr_i = -drag_i * delq_i
    sent_i = -drag_i * c.cpd * delt_i
    toth = ice_new + snow_new
    sent_i = torch.where(toth > HREF,
                         sent_i * (HREF / torch.clamp(toth, min=HREF))
                         ** STEEPF, sent_i)

    sent = torch.where(icefree, sent_w, sent_i)
    evpr = torch.where(icefree, evpr_w, evpr_i)
    drag = torch.where(icefree, drag_w, drag_i)
    sent = torch.where(torch.abs(sent) < c.dlowval, 0.0, sent)
    evpr = torch.where(torch.abs(evpr) < c.dlowval, 0.0, evpr)

    m = lakmsk > 0.5
    return LakeOut(
        tlak=torch.where(m[None], tlak_new, tlak),
        lakhi=torch.where(m, hi_new, lakhi),
        lakice=torch.where(m, ice_new, lakice),
        laksnow=torch.where(m, snow_new, laksnow),
        laksnag=torch.where(m, snag, laksnag),
        tg=torch.where(m, tgl, tg_in),
        sent=torch.where(m, sent, 0.0),
        evpr=torch.where(m, evpr, 0.0),
        drag=torch.where(m, drag, 0.0))
